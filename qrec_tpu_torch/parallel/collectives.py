"""The collectives that the JAX package's ``shard_map`` and GSPMD insert, as
calls on a mesh's groups (``parallel/mesh.py``).

They carry values. Autograd reaches them only inside the
``torch.autograd.Function``s of the sharded routes
(``ops/spmm.ShardedSegmentMatmul``, ``ops/spmm.ShardedJointMatmul``,
``ops/losses.ShardedInfoNCELoss``), whose backward each writes under the
mesh's gradient invariant, and the trainer reduces the gradients once a
step (:func:`reduce_gradients`); the ranking gathers its lists of ids and
scores over the default group (``ops/topk.CatalogRanker``). A
gather with a generic backward would not keep the invariant: the rule
depends on what the route computed from its shard. Every call enters the
collective, on a group of one rank too, so that a run on one GPU takes
the code path of a run on many.

Shards are cut as ``torch.tensor_split`` cuts them: the first ``n % parts``
shards one longer.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


def split_sizes(n: int, parts: int) -> List[int]:
    """The lengths of ``torch.tensor_split``'s ``parts`` shards of n."""
    base, extra = divmod(n, parts)
    return [base + (1 if p < extra else 0) for p in range(parts)]


def split_range(n: int, parts: int, index: int) -> Tuple[int, int]:
    """[start, stop) of shard ``index`` of :func:`split_sizes`."""
    sizes = split_sizes(n, parts)
    start = sum(sizes[:index])
    return start, start + sizes[index]


def gather_shards(x: torch.Tensor, sizes: Sequence[int], group=None) -> torch.Tensor:
    """The row shards of the ranks of ``group`` (the default group's when
    None), ``sizes[r]`` rows on its rank r, concatenated in rank order. A
    shorter shard travels padded to the longest (the list form of
    ``all_gather`` takes equal shapes). Exact: the bits travel unchanged."""
    full = max(sizes)
    if x.shape[0] < full:
        x = torch.cat([x, x.new_zeros((full - x.shape[0], *x.shape[1:]))])
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in sizes]
    dist.all_gather(parts, x, group=group)
    return torch.cat([p[:s] for p, s in zip(parts, sizes)])


def gather_rows(x: torch.Tensor, mesh, sizes: Sequence[int]) -> torch.Tensor:
    """The data ranks' row shards, ``sizes[r]`` rows on data rank r,
    concatenated in rank order over the mesh's ``data`` group
    (:func:`gather_shards`)."""
    return gather_shards(x, sizes, mesh.data_group)


def gather_cols(x: torch.Tensor, mesh) -> torch.Tensor:
    """The model ranks' equal column slices concatenated in rank order over
    the mesh's ``model`` group. Exact."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.model)]
    dist.all_gather(parts, x, group=mesh.model_group)
    return torch.cat(parts, dim=1)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over the ranks of ``group``, in place; every rank
    receives the same bits."""
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


# host reads of the summed gradient flags in :func:`reduce_gradients`
flag_reads = 0


def reduce_gradients(params: Sequence[torch.Tensor], mesh,
                     reached: Optional[Dict[Tuple[bool, ...], Tuple[bool, ...]]] = None) -> None:
    """The step's one reduction: the gradients of ``params`` summed over the
    mesh's ``data`` group in one flattened buffer. A rank may hold no
    gradient for a parameter that only a term of another rank reaches (a
    table's regulariser, which data rank 0 alone adds): its gradient
    travels as zeros, so that the buffer has one layout on every rank, and
    one flag a parameter, summed with it, tells whether any rank held a
    gradient. A parameter that no rank reached keeps ``grad`` None, as in
    one process, where the optimizer then skips it.

    Which parameters a loss reaches is a property of its graph, not of the
    batch: the flags reach the host (``flag_reads``) only where this rank
    lacks a gradient, and with ``reached`` (a dict the caller keeps beside
    its optimizer, one a phase) once for each pattern of gradients this
    rank holds: the answer is kept under the pattern and read again only
    when the pattern changes. Without ``reached`` they are read at every
    such step."""
    global flag_reads
    if not params:
        return
    held_here = tuple(p.grad is not None for p in params)
    # the flags are filled on the device: a tensor built from a host list
    # would copy, and a blocking copy waits for the step's backward
    flags = params[0].new_ones(len(params))
    for k, held in enumerate(held_here):
        if not held:
            flags[k] = 0.0
    flat = torch.cat([p.grad.reshape(-1) if held else p.new_zeros(p.numel())
                      for p, held in zip(params, held_here)] + [flags])
    all_reduce_sum(flat, mesh.data_group)
    any_rank = None
    if not all(held_here):
        any_rank = None if reached is None else reached.get(held_here)
        if any_rank is None:
            flag_reads += 1
            any_rank = tuple(f > 0 for f in flat[-len(params):].tolist())
            if reached is not None:
                reached[held_here] = any_rank
    offset = 0
    for k, (p, held) in enumerate(zip(params, held_here)):
        g = flat[offset: offset + p.numel()].view_as(p)
        offset += p.numel()
        if held:
            p.grad.copy_(g)
        elif any_rank[k]:
            p.grad = g.clone()


def barrier() -> None:
    """Every rank of the default group waits for the others (a writer's
    file is whole before any rank reads it); nothing outside a process
    group."""
    if dist.is_initialized():
        dist.barrier()


def broadcast_int(value: int) -> int:
    """Rank 0's ``value`` on every rank of the default group (exact); the
    value itself outside a process group. The integer travels as an int64
    tensor on the CPU under gloo and on the current CUDA device under
    NCCL."""
    if not dist.is_initialized():
        return value
    device = torch.device("cuda", torch.cuda.current_device()) if (
        dist.get_backend() == "nccl") else torch.device("cpu")
    t = torch.tensor([value], dtype=torch.int64, device=device)
    dist.broadcast(t, src=0)
    return int(t.item())
