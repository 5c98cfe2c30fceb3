"""Host-side graph construction (one time, numpy and scipy).

The joint LightGCN adjacency ``D^-1/2 [[0, R], [Rᵀ, 0]] D^-1/2`` over U+I
nodes (base/graphRecommender.py:10-29, ratings treated binary) in two
forms:

* factored (:func:`factored_adjacency`): ``diag(deg_u^-1/2) · R ·
  diag(deg_i^-1/2)`` on its off-diagonal block, with the binary (U, I)
  interaction matrix R and both degree vectors, for the dense path;
* sparse (:func:`joint_normalized_adjacency`, :func:`joint_bipartite_coo`):
  a row-sorted COO triple of the whole (U+I) x (U+I) matrix for the
  segment-SpMM path, the port's copies of the JAX package's
  ``data/graph.py`` functions.

:func:`normalized_interaction` and :func:`normalized_social_adjacency` give
the normalized (U, I) rating matrix and (U, U) trust matrix as COO triples,
as the JAX package's functions of those names do.

The two joint forms count a duplicated (user, item) rating differently, as the JAX
package does: the factored R and its degrees come from the deduplicated
CSR (``csr_sel``), so a pair counts once; :func:`joint_normalized_adjacency`
sums every training record, so a duplicated pair weighs 2 there.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import scipy.sparse as sp


def factored_adjacency(data) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(R int8 (U, I), row_scale (U,), col_scale (I,))``: R is 1 where the
    user rated the item (duplicates count once), ``row_scale = deg_u^-1/2``
    and ``col_scale = deg_i^-1/2`` in float32, with degrees clamped to at
    least 1 so an empty row or column gets a finite scale."""
    rb = np.zeros((data.num_users, data.num_items), dtype=np.int8)
    rb[data.train_u[data.csr_sel], data.train_i[data.csr_sel]] = 1
    deg_u = np.maximum(np.diff(data.u_indptr), 1).astype(np.float32)
    deg_i = np.maximum(np.diff(data.i_indptr), 1).astype(np.float32)
    return rb, 1.0 / np.sqrt(deg_u), 1.0 / np.sqrt(deg_i)


class COO(NamedTuple):
    """Row-sorted COO sparse matrix."""

    rows: np.ndarray  # (nnz,) int32, sorted ascending
    cols: np.ndarray  # (nnz,) int32
    vals: np.ndarray  # (nnz,) float32
    shape: tuple

    @classmethod
    def from_scipy(cls, m: sp.spmatrix) -> "COO":
        coo = m.tocoo()
        order = np.lexsort((coo.col, coo.row))
        return cls(
            coo.row[order].astype(np.int32),
            coo.col[order].astype(np.int32),
            coo.data[order].astype(np.float32),
            m.shape,
        )

    @property
    def nnz(self) -> int:
        return len(self.rows)

    def to_scipy(self) -> sp.csr_matrix:
        return sp.csr_matrix((self.vals, (self.rows, self.cols)), shape=self.shape)


def joint_bipartite_coo(data):
    """Unnormalized joint adjacency structure with undirected-edge ids.

    Returns ``(rows, cols, edge_ids, n_nodes)``: both directions of every
    deduplicated (user, item) interaction, row-sorted, where ``edge_ids[k]``
    indexes the originating interaction (0..E-1). A keep flag per
    interaction, read through ``edge_ids``, drops both directions of an
    edge together (SGL's views, SGL.py:113-155)."""
    u = data.train_u[data.csr_sel]
    i = data.train_i[data.csr_sel]
    e = len(u)
    rows = np.concatenate([u, i + data.num_users]).astype(np.int32)
    cols = np.concatenate([i + data.num_users, u]).astype(np.int32)
    edge_ids = np.concatenate([np.arange(e), np.arange(e)]).astype(np.int32)
    order = np.lexsort((cols, rows))
    n = data.num_users + data.num_items
    return rows[order], cols[order], edge_ids[order], n


def interaction_matrix(data, binary: bool = False) -> sp.csr_matrix:
    """|U|×|I| rating matrix as scipy CSR (duplicate records summed)."""
    vals = np.ones_like(data.train_r) if binary else data.train_r
    return sp.csr_matrix(
        (vals, (data.train_u, data.train_i)),
        shape=(data.num_users, data.num_items),
    )


def _inv_power(deg: np.ndarray, p: float) -> sp.dia_matrix:
    """``diag(deg^p)``, 0 where the degree is 0."""
    return sp.diags(np.power(deg, p, where=deg > 0, out=np.zeros_like(deg)))


def normalized_interaction(data, mode: str = "sym") -> COO:
    """Normalized |U|×|I| rating matrix (base/graphRecommender.py:41-61),
    ratings treated binary: ``sym`` = D_u^-1/2 R D_i^-1/2, ``row`` =
    D_u^-1 R."""
    r = interaction_matrix(data, binary=True)
    deg_u = np.asarray(r.sum(axis=1)).ravel()
    deg_i = np.asarray(r.sum(axis=0)).ravel()
    if mode == "sym":
        return COO.from_scipy(_inv_power(deg_u, -0.5) @ r @ _inv_power(deg_i, -0.5))
    if mode == "row":
        return COO.from_scipy(_inv_power(deg_u, -1.0) @ r)
    raise ValueError(f"unknown normalization mode {mode!r}")


def normalized_social_adjacency(social, mode: str = "row") -> COO:
    """Normalized U×U trust adjacency of a
    :class:`~qrec_tpu_torch.data.social.SocialGraph` (SocialMF's sparse
    social product, model/rating/SocialMF.py:69-90): ``row`` = D^-1 S,
    ``sym`` = D^-1/2 S D^-1/2, D the weighted out-degrees."""
    s = social.scipy_adjacency()
    deg = np.asarray(s.sum(axis=1)).ravel()
    if mode == "row":
        return COO.from_scipy(_inv_power(deg, -1.0) @ s)
    if mode == "sym":
        d = _inv_power(deg, -0.5)
        return COO.from_scipy(d @ s @ d)
    raise ValueError(f"unknown normalization mode {mode!r}")


def joint_normalized_adjacency(data, self_loop: bool = False) -> COO:
    """Symmetric-normalized joint adjacency ``D^-1/2 [[0, R], [R^T, 0]] D^-1/2``
    over U+I nodes (base/graphRecommender.py:10-29; ratings treated binary,
    every training record counted)."""
    n = data.num_users + data.num_items
    r = interaction_matrix(data, binary=True)
    # the JAX package fills a lil_matrix block by block, which takes tens of
    # seconds at the yelp2018 shape; bmat builds the same matrix. The
    # degrees are sums of small integers and every value is d[r] * a * d[c],
    # entry by entry, so each is the same float whatever the order of a
    # row's entries
    a = sp.bmat([[None, r], [r.T, None]], format="csr", dtype=np.float32)
    if self_loop:
        a = a + sp.eye(n, dtype=np.float32, format="csr")
    deg = np.asarray(a.sum(axis=1)).ravel()
    d_inv_sqrt = np.power(deg, -0.5, where=deg > 0, out=np.zeros_like(deg))
    d_mat = sp.diags(d_inv_sqrt)
    return COO.from_scipy(d_mat @ a @ d_mat)
