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

from typing import List, Sequence, Tuple

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


def reduce_gradients(params: Sequence[torch.Tensor], mesh) -> None:
    """The step's one reduction: the gradients of ``params`` summed over the
    mesh's ``data`` group in one flattened buffer (every rank holds a
    gradient for the same parameters: the ranks run the same graph)."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = all_reduce_sum(torch.cat([g.reshape(-1) for g in grads]), mesh.data_group)
    offset = 0
    for g in grads:
        g.copy_(flat[offset: offset + g.numel()].view_as(g))
        offset += g.numel()
