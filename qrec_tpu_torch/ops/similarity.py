"""Similarities over the dense rating matrix (counterpart of the JAX
package's ``ops/similarity.py``; reference util/qmath.py's per-pair dict
loops): per trust edge, and pairwise for the KNN models.

The social regularizers need one similarity per trust edge (u, v): SoReg
blends Pearson with the trust weight, LOCABAL matches cosine. Both are
computed on the device from the rows of the dense (U, I) rating matrix, in
chunks of ``chunk`` edges, so the two gathered (chunk, I) blocks stay bounded
whatever the size of the trust file. The semantics are the reference's
sparse-dict versions:

* :func:`edge_pearson_sp` (qmath.py:58-76): means over each user's own
  rated items, sums over the common support, 1.0 when the denominator is
  zero but the supports overlap, else 0;
* :func:`edge_cosine_sp` (qmath.py:19-32): numerator and both norms over
  the common support only.

UserKNN and ItemKNN need every query row (a test user or item) against
every row: :func:`pairwise_pearson`, :func:`pairwise_cosine_sp` and
:func:`pairwise_euclidean_sp` give the (Q, N) block as masked products
with the same edge cases.
"""

from __future__ import annotations

from typing import Callable

import torch


def _chunked(fn: Callable, u_idx: torch.Tensor, v_idx: torch.Tensor, chunk: int) -> torch.Tensor:
    """``fn(u, v)`` over consecutive chunks of the edges, concatenated."""
    parts = [fn(u_idx[s : s + chunk], v_idx[s : s + chunk]) for s in range(0, len(u_idx), chunk)]
    return torch.cat(parts) if parts else torch.zeros(0, device=u_idx.device)


def edge_pearson_sp(r_dense: torch.Tensor, u_idx: torch.Tensor, v_idx: torch.Tensor,
                    chunk: int = 512) -> torch.Tensor:
    """(E,) f32: ``pearson_sp(row_u, row_v)`` of each edge; ``r_dense`` is
    the (U, I) f32 rating matrix, 0 where a user did not rate."""

    def one_chunk(u, v):
        x1, x2 = r_dense[u], r_dense[v]
        m1, m2 = (x1 > 0).float(), (x2 > 0).float()
        common = m1 * m2
        mean1 = x1.sum(dim=1) / torch.clamp_min(m1.sum(dim=1), 1)
        mean2 = x2.sum(dim=1) / torch.clamp_min(m2.sum(dim=1), 1)
        c1 = (x1 - mean1[:, None]) * common
        c2 = (x2 - mean2[:, None]) * common
        total = (c1 * c2).sum(dim=1)
        denom = torch.sqrt((c1**2).sum(dim=1)) * torch.sqrt((c2**2).sum(dim=1))
        overlapped = common.sum(dim=1) > 0
        return torch.where(denom > 0, total / torch.clamp_min(denom, 1e-12),
                           overlapped.float())

    return _chunked(one_chunk, u_idx, v_idx, chunk)


def edge_cosine_sp(r_dense: torch.Tensor, u_idx: torch.Tensor, v_idx: torch.Tensor,
                   chunk: int = 512) -> torch.Tensor:
    """(E,) f32: ``cosine_sp(row_u, row_v)`` of each edge, over the common
    support."""

    def one_chunk(u, v):
        x1, x2 = r_dense[u], r_dense[v]
        common = ((x1 > 0) & (x2 > 0)).float()
        total = (x1 * x2 * common).sum(dim=1)
        denom = torch.sqrt((x1**2 * common).sum(dim=1)) * torch.sqrt((x2**2 * common).sum(dim=1))
        return torch.where(denom > 0, total / torch.clamp_min(denom, 1e-12),
                           torch.zeros_like(total))

    return _chunked(one_chunk, u_idx, v_idx, chunk)


def _supports(rows: torch.Tensor, query: torch.Tensor):
    return (rows > 0).float(), (query > 0).float()


def pairwise_pearson(rows: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """(Q, N) f32: ``pearson_sp`` of every query row against every row (the
    KNN models' neighbour scores), means over each row's own support, sums
    over the common support as masked products; 1.0 where the rows overlap
    but the denominator is 0, 0 where they do not overlap."""
    m_r, m_q = _supports(rows, query)
    mean_r = rows.sum(dim=1) / torch.clamp_min(m_r.sum(dim=1), 1)
    mean_q = query.sum(dim=1) / torch.clamp_min(m_q.sum(dim=1), 1)
    cr = (rows - mean_r[:, None]) * m_r
    cq = (query - mean_q[:, None]) * m_q
    # cq is zero off the query's support and cr off the row's, so each
    # product sums over the common support only
    num = cq @ cr.T
    denom = torch.sqrt((cq**2) @ m_r.T) * torch.sqrt(m_q @ (cr**2).T)
    overlapped = (m_q @ m_r.T) > 0
    return torch.where(denom > 0, num / torch.clamp_min(denom, 1e-12), overlapped.float())


def pairwise_euclidean_sp(rows: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """(Q, N) f32: the reference's ``euclidean_sp`` (qmath.py:34-43), ``1 /
    Σ_common (x1² − x2²)`` with its signs, 0 where ``|total| <= 1e-12``."""
    m_r, m_q = _supports(rows, query)
    total = (query**2) @ m_r.T - m_q @ (rows**2).T
    return torch.where(total.abs() > 1e-12, 1.0 / total, torch.zeros_like(total))


def pairwise_cosine_sp(rows: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """(Q, N) f32: the common-support cosine of every query row against
    every row, 0 where the denominator is 0."""
    m_r, m_q = _supports(rows, query)
    num = query @ rows.T  # both are zero off their supports
    denom = torch.sqrt((query**2) @ m_r.T) * torch.sqrt(m_q @ (rows**2).T)
    return torch.where(denom > 0, num / torch.clamp_min(denom, 1e-12), torch.zeros_like(num))
