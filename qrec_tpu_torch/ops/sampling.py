"""Device-side negative sampling (counterpart of the JAX package's
``ops/sampling.py``).

* ``pack_bitmask`` — the packed (U, ceil(I/32)) rated-item bitmask, built
  on the host. It is stored as int32 holding the uint32 bit pattern,
  because torch has no usable uint32 arithmetic; shifts and ``& 1`` read
  the same bits.
* ``csr_member`` and ``sample_from_rows`` — membership in, and a uniform
  draw from, a user's row of any CSR table (the social rankers' friend-item
  and tie-item tables).
* ``sample_negatives`` — K-try uniform rejection against the bitmask,
  falling back to the exact rejection-free draw for the queries where all
  K tries hit positives, so a sampled negative is never a training positive;
  no step reads the host, so an epoch's sampling can be a CUDA graph.
* ``pairwise_epoch`` — one epoch of shuffled (user, pos, neg, weight)
  batches; ``weight`` zeroes the padded tail.
* ``pointwise_epoch`` — one epoch of (user, item, label, weight) batches,
  each positive followed by its negatives.

Randomness comes from an explicit ``torch.Generator`` on the tensors'
device; the streams differ from ``jax.random``, so parity with the JAX
package is checked on properties and on injected batches.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch


def _bisect_iters(n: int) -> int:
    return max(1, int(math.ceil(math.log2(max(n, 2)))) + 1)


def pack_bitmask(u_indptr, u_indices, num_users: int, num_items: int) -> np.ndarray:
    """Packed (U, ceil(I/32)) rated bitmask as int32 (host build, numpy):
    bit ``i & 31`` of word ``i >> 5`` of row u is set iff u rated i."""
    words = (num_items + 31) // 32
    mask = np.zeros((num_users, words), dtype=np.uint32)
    rows = np.repeat(np.arange(num_users, dtype=np.int64), np.diff(u_indptr))
    cols = np.asarray(u_indices, dtype=np.int64)
    np.bitwise_or.at(
        mask, (rows, cols >> 5), (np.uint32(1) << (cols & 31).astype(np.uint32))
    )
    return mask.view(np.int32)


def bitmask_member(mask: torch.Tensor, users: torch.Tensor, items: torch.Tensor) -> torch.Tensor:
    """Vectorized membership probe against a packed bitmask (bool)."""
    words = mask[users, items >> 5]
    return ((words >> (items & 31)) & 1) > 0


def csr_searchsorted_right(indices, lo, hi, queries, n_iters: int = 32):
    """Per-row ``searchsorted(side='right')``: insertion point after the
    last entry <= each query in ``indices[lo:hi)``, by a fixed number of
    bisection steps."""
    nnz = indices.shape[0]
    for _ in range(n_iters):
        active = lo < hi
        mid = (lo + hi) >> 1
        v = indices[torch.clamp(mid, max=nnz - 1)]
        go_right = v <= queries
        new_lo = torch.where(go_right, mid + 1, lo)
        new_hi = torch.where(go_right, hi, mid)
        lo = torch.where(active, new_lo, lo)
        hi = torch.where(active, new_hi, hi)
    return lo


def csr_member(indices, indptr, users, items, n_iters: int = 32) -> torch.Tensor:
    """Whether each ``items[b]`` lies in CSR row ``users[b]`` (bool, the
    shape of ``items``; ``users`` broadcasts against it): the last entry <=
    the item, found by bisection, equals it."""
    if indices.numel() == 0:
        return torch.zeros(items.shape, dtype=torch.bool, device=items.device)
    lo = indptr[users]
    pos = csr_searchsorted_right(indices, lo, indptr[users + 1], items, n_iters)
    return (pos > lo) & (indices[torch.clamp(pos - 1, min=0)] == items)


def sample_from_rows(gen: torch.Generator, indptr, indices, users):
    """One uniform column of each user's CSR row: ``(items, has, idx)``, with
    ``has`` false and the item meaningless where the row is empty, and
    ``idx`` the entry's position in ``indices`` (the JAX package's
    ``_sample_from_rows``, ``models/social_ranking.py:39-46``)."""
    lo = indptr[users]
    deg = indptr[users + 1] - lo
    r = torch.rand(users.shape, generator=gen, device=users.device)
    off = torch.floor(r * torch.clamp_min(deg, 1)).long()
    if indices.numel() == 0:
        zero = torch.zeros_like(users)
        return zero, deg > 0, zero
    idx = torch.clamp(lo + off, max=indices.shape[0] - 1)
    return indices[idx], deg > 0, idx


def sample_negatives_exact(
    gen: torch.Generator,
    users: torch.Tensor,
    num_items: int,
    indices: torch.Tensor,
    indptr: torch.Tensor,
    row_iters: int = 32,
) -> torch.Tensor:
    """Rejection-free uniform negatives: for user u draw k ~ U[0, I - deg(u))
    and return the k-th non-rated item. With the row's sorted positives
    p_0 < p_1 < ..., p_t has p_t - t non-rated items below it, a
    non-decreasing count, so the k-th non-rated item is ``k + m`` with m the
    number of positives whose count is <= k: one bisection over the row
    (``row_iters`` steps, enough for the longest row). A row that holds
    every item has no negative: it gets item ``num_items - 1``, as the JAX
    package's search ends there."""
    lo_row = indptr[users]
    hi_row = indptr[users + 1]
    span = torch.clamp(num_items - (hi_row - lo_row), min=1)
    draw = torch.rand(users.shape, generator=gen, device=users.device, dtype=torch.float64)
    k = torch.minimum((draw * span).long(), span - 1)
    nnz = indices.shape[0]
    if nnz == 0:
        return k
    lo, hi = lo_row, hi_row
    for _ in range(row_iters):
        active = lo < hi
        mid = (lo + hi) >> 1
        below = indices[torch.clamp(mid, max=nnz - 1)] - (mid - lo_row)
        go_right = below <= k
        lo = torch.where(active & go_right, mid + 1, lo)
        hi = torch.where(active & ~go_right, mid, hi)
    return torch.clamp(k + (lo - lo_row), max=num_items - 1)


def sample_negatives(
    gen: torch.Generator,
    users: torch.Tensor,
    num_items: int,
    indices: torch.Tensor,
    indptr: torch.Tensor,
    bitmask: torch.Tensor,
    num_tries: int = 8,
    row_iters: int = 32,
    also_exclude: Optional[Callable] = None,
) -> torch.Tensor:
    """K-try rejection sampling with exact fallback: ``num_tries`` uniform
    candidates per query, the first that is not a positive wins; queries
    whose tries all hit positives take the exact sampler's draw.
    ``also_exclude(users, items) -> bool`` rejects more candidates in the
    tries (SBPR's friend items; its exact fallback avoids the positives
    alone, as the JAX package's does).

    The exact draw is made for every query and selected where the tries
    failed (the JAX package's ``lax.cond`` runs it only when one did):
    asking the host whether any failed would stop the device once an
    epoch, and no CUDA graph can hold the question. The generator's stream
    is therefore the same whatever the tries found."""
    b = users.shape[0]
    cands = torch.randint(
        0, num_items, (b, num_tries), generator=gen, device=users.device, dtype=torch.int64
    )
    bad = bitmask_member(bitmask, users[:, None], cands)
    if also_exclude is not None:
        bad = bad | also_exclude(users[:, None], cands)
    ok = ~bad
    first_ok = ok.to(torch.int8).argmax(dim=1)
    chosen = cands.gather(1, first_ok[:, None])[:, 0]
    exact = sample_negatives_exact(gen, users, num_items, indices, indptr, row_iters)
    return torch.where(ok.any(dim=1), chosen, exact)


def pairwise_epoch(
    gen: torch.Generator,
    train_u: torch.Tensor,
    train_i: torch.Tensor,
    indices: torch.Tensor,
    indptr: torch.Tensor,
    bitmask: torch.Tensor,
    num_items: int,
    batch_size: int,
    num_tries: int = 8,
    row_iters: int = 32,
    shuffle: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Shuffled (user, pos, neg, weight) int64/int64/int64/f32 tensors shaped
    ``(num_batches, batch_size)`` (next_batch_pairwise,
    deepRecommender.py:29-52): shuffle the training pairs, then one uniform
    non-positive negative per positive. ``shuffle=False`` keeps the
    training pairs in file order with fresh negatives every epoch, as BPR's
    own TF batcher iterates them (BPR.py:57-64)."""
    n = train_u.shape[0]
    device = train_u.device
    if shuffle:
        perm = torch.randperm(n, generator=gen, device=device)
    else:
        perm = torch.arange(n, device=device)
    num_batches = (n + batch_size - 1) // batch_size
    padded = num_batches * batch_size
    pad_idx = torch.cat([perm, torch.zeros(padded - n, dtype=perm.dtype, device=device)])
    users = train_u[pad_idx]
    pos = train_i[pad_idx]
    weight = (torch.arange(padded, device=device) < n).float()
    neg = sample_negatives(gen, users, num_items, indices, indptr, bitmask, num_tries, row_iters)
    shape = (num_batches, batch_size)
    return users.view(shape), pos.view(shape), neg.view(shape), weight.view(shape)


def pointwise_epoch(
    gen: torch.Generator,
    train_u: torch.Tensor,
    train_i: torch.Tensor,
    indices: torch.Tensor,
    indptr: torch.Tensor,
    bitmask: torch.Tensor,
    num_items: int,
    batch_size: int,
    num_negatives: int = 4,
    num_tries: int = 8,
    row_iters: int = 32,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pointwise (user, item, label, weight) int64/int64/f32/f32 tensors
    shaped ``(num_batches, batch_size * (1 + num_negatives))``
    (next_batch_pointwise, deepRecommender.py:54-77): the training pairs
    shuffled and padded to whole batches, each positive (label 1) followed
    by ``num_negatives`` uniform non-positive items of its user (label 0);
    ``weight`` is 0 on the padded tail's positives and their negatives."""
    n = train_u.shape[0]
    device = train_u.device
    perm = torch.randperm(n, generator=gen, device=device)
    num_batches = (n + batch_size - 1) // batch_size
    padded = num_batches * batch_size
    pad_idx = torch.cat([perm, torch.zeros(padded - n, dtype=perm.dtype, device=device)])
    users_pos = train_u[pad_idx]
    items_pos = train_i[pad_idx]
    w_pos = (torch.arange(padded, device=device) < n).float()
    users_neg = users_pos.repeat_interleave(num_negatives)
    negs = sample_negatives(gen, users_neg, num_items, indices, indptr, bitmask, num_tries, row_iters)
    k = 1 + num_negatives
    users = torch.cat([users_pos[:, None], users_neg.view(padded, num_negatives)], dim=1)
    items = torch.cat([items_pos[:, None], negs.view(padded, num_negatives)], dim=1)
    labels = torch.zeros((padded, k), device=device)
    labels[:, 0] = 1.0
    weight = w_pos.repeat_interleave(k)
    shape = (num_batches, batch_size * k)
    return users.reshape(shape), items.reshape(shape), labels.reshape(shape), weight.reshape(shape)
