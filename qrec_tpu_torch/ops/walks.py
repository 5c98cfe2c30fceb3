"""Random walks on the host and skip-gram embeddings on the device
(counterpart of the JAX package's ``ops/walks.py``; reference
model/ranking/CUNE_BPR.py:156-258).

* ``cooccurrence_network`` and ``walk_pairs`` are numpy/scipy copies of the
  JAX package's, equal bit for bit;
* ``random_walks`` runs the host library's xorshift128+ walker
  (``native.random_walks``) seeded with one ``randint(0, 2**31)`` draw of
  the caller's ``RandomState``, as the JAX package runs its C++ walker by
  default, so the same state gives the same walks bit for bit;
  ``random_walks_numpy``, its plain version, is the JAX package's
  vectorised numpy walk (every walker advances one step per iteration by a
  ``searchsorted`` over the globally accumulated edge weights) after the
  same seed draw, so the same state gives the JAX numpy path's walks;
* ``train_skipgram`` is skip-gram with negative sampling (SGNS) under Adam,
  its random inputs drawn by a :class:`SkipgramDraws` that a caller can
  replace; on a CUDA device its steps run as CUDA graphs of
  ``SGNS_GRAPH_STEPS`` steps, replayed through each epoch;
* ``topk_cosine_neighbors`` ranks cosine neighbours in row chunks, ties to
  the lower index, as ``lax.top_k`` orders them.

The reference's gensim CBOW becomes SGNS, as in the JAX package.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from .. import native
from ..device import f32_products
from ..runtime import trainer as T
from ..runtime.profiling import StepTimer


def cooccurrence_network(data, min_raters: int = 2) -> sp.csr_matrix:
    """Collaborative user network: weight(u, v) = |I_u ∩ I_v| over the items
    with at least ``min_raters`` raters (CUNE_BPR.py:160-180)."""
    raters = np.diff(data.i_indptr)
    keep_items = np.where(raters >= min_raters)[0]
    sel = np.isin(data.train_i[data.csr_sel], keep_items)
    u = data.train_u[data.csr_sel][sel]
    i = data.train_i[data.csr_sel][sel]
    r = sp.csr_matrix((np.ones(len(u), dtype=np.float32), (u, i)),
                      shape=(data.num_users, data.num_items))
    c = (r @ r.T).tocsr()
    c.setdiag(0)
    c.eliminate_zeros()
    return c


def random_walks(net: sp.csr_matrix, walk_count: int, walk_length: int,
                 rng: np.random.RandomState) -> Tuple[np.ndarray, np.ndarray]:
    """Weighted random walks, ``walk_count`` from every non-isolated node:
    (walks (n_walkers, walk_length) int32, active nodes int32), by the host
    library's walker seeded from ``rng`` (``qrec_tpu/ops/walks.py:61-67``)."""
    seed = int(rng.randint(0, 2**31))
    active = np.where(np.diff(net.indptr) > 0)[0].astype(np.int32)
    if len(active) == 0:
        return np.zeros((0, walk_length), dtype=np.int32), active
    cum = np.cumsum(net.data.astype(np.float64))
    starts = np.repeat(active, walk_count)
    return native.random_walks(net.indptr, net.indices, cum, starts, walk_length, seed), active


def random_walks_numpy(net: sp.csr_matrix, walk_count: int, walk_length: int,
                       rng: np.random.RandomState) -> Tuple[np.ndarray, np.ndarray]:
    """:func:`random_walks`' plain version: the same walks' distribution
    from numpy's stream (the JAX package's numpy path bit for bit)."""
    # the walker's seed draw first, as the JAX package makes it also when
    # it walks in numpy; the same draw keeps the two streams in step
    rng.randint(0, 2**31)
    indptr = net.indptr
    deg = np.diff(indptr)
    active = np.where(deg > 0)[0].astype(np.int32)
    if len(active) == 0:
        return np.zeros((0, walk_length), dtype=np.int32), active
    flat_cum = np.cumsum(net.data.astype(np.float64))
    row_base = np.concatenate([[0.0], flat_cum])[indptr]
    row_total = np.asarray(net.sum(axis=1)).ravel()
    cur = np.repeat(active, walk_count)
    walks = np.empty((len(cur), walk_length), dtype=np.int32)
    walks[:, 0] = cur
    for step in range(1, walk_length):
        targets = row_base[cur] + rng.random_sample(len(cur)) * row_total[cur]
        pos = np.searchsorted(flat_cum, targets, side="right")
        pos = np.minimum(pos, len(net.indices) - 1)
        cur = net.indices[pos].astype(np.int32)
        walks[:, step] = cur
    return walks, active


def walk_pairs(walks: np.ndarray, window: int) -> Tuple[np.ndarray, np.ndarray]:
    """All (center, context) pairs within ±window along each walk, in the
    JAX package's order: offset by offset, forward pairs then backward."""
    centers, contexts = [], []
    length = walks.shape[1]
    for off in range(1, window + 1):
        if off >= length:
            break
        centers.append(walks[:, :-off].ravel())
        contexts.append(walks[:, off:].ravel())
        centers.append(walks[:, off:].ravel())
        contexts.append(walks[:, :-off].ravel())
    if not centers:
        return np.zeros(0, dtype=np.int32), np.zeros(0, dtype=np.int32)
    return np.concatenate(centers).astype(np.int32), np.concatenate(contexts).astype(np.int32)


class SkipgramDraws:
    """The random inputs of one :func:`train_skipgram` run, from a
    ``torch.Generator`` seeded ``seed`` on ``device`` (not the JAX package's
    key sequence): the initial ``in`` table, U(-0.5, 0.5)/dim, then per
    epoch the permutation of the pairs and the negatives' positions in the
    active nodes."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device).manual_seed(seed)

    def initial_table(self, num_nodes: int, dim: int) -> torch.Tensor:
        u = torch.rand((num_nodes, dim), generator=self.gen, device=self.device)
        return (u - 0.5) / dim

    def epoch(self, n: int, num_batches: int, batch_size: int, negatives: int,
              num_active: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """(permutation (n,), negative positions (num_batches, batch_size,
        negatives)), int64 on the device."""
        perm = torch.randperm(n, generator=self.gen, device=self.device)
        neg = torch.randint(0, num_active, (num_batches, batch_size, negatives),
                            generator=self.gen, device=self.device)
        return perm, neg


SGNS_BATCH = 8192  # the JAX package's SGNS batch
# the steps of one replayed SGNS graph on a CUDA device: a replayed epoch
# is device-bound whatever the graph holds, while its capture (a warm-up of
# as many steps, and the tail's) grows with it; an epoch at the lastfm
# shape is 324 to 1,331 steps
SGNS_GRAPH_STEPS = 16


def skipgram_steps(num_pairs: int, epochs: int = 3, batch_size: int = SGNS_BATCH) -> int:
    """The optimizer steps of a :func:`train_skipgram` run."""
    return epochs * max(1, -(-num_pairs // batch_size))


def skipgram_graph_steps(graph_steps: Optional[int], device) -> int:
    """The steps of one replayed program of :func:`train_skipgram`:
    ``graph_steps`` where given, else ``SGNS_GRAPH_STEPS`` on a CUDA device
    and 0 (the per-step loop) elsewhere."""
    if graph_steps is not None:
        return graph_steps
    return SGNS_GRAPH_STEPS if torch.device(device).type == "cuda" else 0


def skipgram_stats(num_pairs: int, timer: StepTimer, device, graph_steps: Optional[int] = None,
                   epochs: int = 3, batch_size: int = SGNS_BATCH) -> dict:
    """One SGNS channel's numbers from the ``timer`` of its
    :func:`train_skipgram` run with ``graph_steps``: its optimizer steps,
    its seconds without its CUDA graphs' capture, the capture's seconds
    (its warm-up included) and the steps a replayed graph holds (0: the
    per-step loop)."""
    capture_s = sum(timer.captures)
    return {"steps": skipgram_steps(num_pairs, epochs, batch_size),
            "s": sum(timer.times) - capture_s, "capture_s": capture_s,
            "graph_steps": min(skipgram_graph_steps(graph_steps, device),
                               skipgram_steps(num_pairs, 1, batch_size))}


def skipgram_loss(t_in: torch.Tensor, t_out: torch.Tensor, c, ctx, negs) -> torch.Tensor:
    """``-Σ log(σ(v_c·u_ctx) + 1e-10) - Σ log(σ(-v_c·u_neg) + 1e-10)``
    summed over the batch."""
    vc = t_in[c]
    pos = (vc * t_out[ctx]).sum(dim=1)
    neg = torch.einsum("bd,bkd->bk", vc, t_out[negs])
    return -(torch.log(torch.sigmoid(pos) + 1e-10).sum()
             + torch.log(torch.sigmoid(-neg) + 1e-10).sum())


def train_skipgram(
    centers: np.ndarray,
    contexts: np.ndarray,
    num_nodes: int,
    dim: int,
    active_nodes: np.ndarray,
    epochs: int = 3,
    negatives: int = 5,
    batch_size: int = SGNS_BATCH,
    lr: float = 0.05,
    seed: int = 0,
    device="cpu",
    draws: Callable[[int, object], SkipgramDraws] = SkipgramDraws,
    timer: Optional[StepTimer] = None,
    graph_steps: Optional[int] = None,
) -> torch.Tensor:
    """SGNS over the (center, context) pairs; returns the ``in`` table
    (num_nodes, dim) on ``device``. Both tables are dense parameters with
    dense gradients under one Adam (optax.adam's moves every row whose
    moments are non-zero); ``out`` starts at
    zero. Each epoch shuffles the pairs and pads them to whole batches with
    pair 0 (not the permutation's first), unmasked, as the JAX package
    does; negatives are uniform over ``active_nodes``. ``draws(seed,
    device)`` gives the random inputs; ``timer`` times each epoch and the
    capture of the replayed form.

    ``graph_steps`` picks the form (:func:`skipgram_graph_steps`): 0 runs
    every step from Python; k > 0 writes each epoch's draws into buffers
    made once a run and runs a program of k steps (``min(k, batches)``),
    which reads them at a device step counter, ``batches // k`` times, then
    one of the remaining steps: on a CUDA device each program is a CUDA
    graph, captured once a run (``runtime/trainer.GraphProgram``) and
    replayed; elsewhere it runs as written. Both forms step the same
    arithmetic and give the same bits."""
    device = torch.device(device)
    n = len(centers)
    if n == 0:
        return torch.zeros((num_nodes, dim), device=device)
    source = draws(seed, device)
    t_in = source.initial_table(num_nodes, dim).to(device).requires_grad_()
    t_out = torch.zeros((num_nodes, dim), device=device, requires_grad=True)
    optimizer = T.make_optimizer([t_in, t_out], "adam", lr)
    num_batches = max(1, (n + batch_size - 1) // batch_size)
    padded = num_batches * batch_size
    as_long = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int64, device=device)  # noqa: E731
    centers_d, contexts_d, active_d = as_long(centers), as_long(contexts), as_long(active_nodes)
    timer = timer if timer is not None else StepTimer(n, device)
    steps = min(skipgram_graph_steps(graph_steps, device), num_batches)
    replayed = _ReplayedSkipgram(t_in, t_out, optimizer, num_batches, batch_size, negatives,
                                 steps, device) if steps else None
    with f32_products():
        for _ in range(epochs):
            with timer:
                perm, neg_idx = source.epoch(n, num_batches, batch_size, negatives, len(active_d))
                pad = torch.cat([perm, perm.new_zeros(padded - n)]).to(device)
                neg_idx = neg_idx.to(device)
                if replayed is not None:
                    replayed.epoch(centers_d, contexts_d, active_d, pad, neg_idx, timer)
                    continue
                cs = centers_d[pad].view(num_batches, batch_size)
                xs = contexts_d[pad].view(num_batches, batch_size)
                negs = active_d[neg_idx]
                for step in range(num_batches):
                    loss = skipgram_loss(t_in, t_out, cs[step], xs[step], negs[step])
                    optimizer.zero_grad(set_to_none=True)
                    loss.backward()
                    optimizer.step()
    return t_in.detach()


class _ReplayedSkipgram:
    """The replayed form of :func:`train_skipgram`: the epoch's centers,
    contexts and negatives in buffers made once a run, a device step
    counter ``at`` that each step reads them at and advances, and the
    programs of ``steps`` steps (run ``batches // steps`` times an epoch)
    and of the remaining steps (once), which share one ``LoopState``: the
    tables, Adam's state and the counter, committed before any step."""

    def __init__(self, t_in, t_out, optimizer, num_batches: int, batch_size: int,
                 negatives: int, steps: int, device):
        self.cs = torch.empty((num_batches, batch_size), dtype=torch.int64, device=device)
        self.xs = torch.empty_like(self.cs)
        self.negs = torch.empty((num_batches, batch_size, negatives), dtype=torch.int64,
                                device=device)
        self.at = torch.zeros(1, dtype=torch.int64, device=device)
        T.init_adam_state(optimizer)
        state = T.LoopState(0, [t_in, t_out], optimizer, None, extra=[self.at])
        full, tail = divmod(num_batches, steps)
        buffers = (t_in, t_out, optimizer, self.cs, self.xs, self.negs, self.at)
        self.programs = [(T.GraphProgram(state, device, _skipgram_steps(steps, *buffers)), full)]
        if tail:
            self.programs.append(
                (T.GraphProgram(state, device, _skipgram_steps(tail, *buffers)), 1))
        self.device = torch.device(device)

    def epoch(self, centers_d, contexts_d, active_d, pad, neg_idx, timer: StepTimer) -> None:
        """One epoch on its draws: the buffers filled, the programs captured
        at the first epoch (on a CUDA device), the counter reset, the
        programs run."""
        torch.index_select(centers_d, 0, pad, out=self.cs.view(-1))
        torch.index_select(contexts_d, 0, pad, out=self.xs.view(-1))
        torch.index_select(active_d, 0, neg_idx.view(-1), out=self.negs.view(-1))
        if self.device.type == "cuda" and self.programs[0][0].graph is None:
            with timer.capture():
                for program, _ in self.programs:
                    program.capture()
        self.at.zero_()
        for program, times in self.programs:
            for _ in range(times):
                program.run()


def _skipgram_steps(k: int, t_in, t_out, optimizer, cs, xs, negs, at) -> Callable[[], None]:
    """``k`` SGNS steps on the buffers' rows at the counter ``at``, each
    advancing it (a closure over tensors alone, no program)."""

    def body() -> None:
        for _ in range(k):
            loss = skipgram_loss(t_in, t_out, cs.index_select(0, at)[0],
                                 xs.index_select(0, at)[0], negs.index_select(0, at)[0])
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
            optimizer.step()
            at.add_(1)

    return body


def topk_cosine_neighbors(emb: torch.Tensor, active, k: int, chunk: int = 1024):
    """The ``k`` most cosine-similar *active* nodes of each active node:
    (ids, sims), each (A, k), ids as node ids. Rows are normalised as
    ``emb / (‖emb‖ + 1e-12)``; the similarities of a chunk of rows (chunk ×
    A in memory) get the node's own entry at -inf and are cut at ``k`` by a
    stable descending sort, so the lower index comes first among equal
    values, as ``lax.top_k`` orders them."""
    active = torch.as_tensor(np.asarray(active), dtype=torch.int64, device=emb.device)
    with f32_products():
        normed = emb / (torch.linalg.vector_norm(emb, dim=1, keepdim=True) + 1e-12)
        act = normed[active]
        a = act.shape[0]
        ids, sims = [], []
        for start in range(0, a, chunk):
            block = act[start:start + chunk]
            s = block @ act.T
            rows = torch.arange(block.shape[0], device=emb.device)
            s[rows, start + rows] = -torch.inf
            vals, idx = torch.sort(s, dim=1, descending=True, stable=True)
            ids.append(active[idx[:, :k]])
            sims.append(vals[:, :k])
    if not ids:
        return active.new_zeros((0, k)), emb.new_zeros((0, k))
    return torch.cat(ids), torch.cat(sims)
