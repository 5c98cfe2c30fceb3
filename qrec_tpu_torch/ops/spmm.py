"""Joint LightGCN propagation over the factored dense adjacency.

Counterpart of the JAX package's ``ops/spmm.py`` restricted to the
``graph.dense.quant=factored`` form of ``DenseJoint``: the normalized joint
adjacency ``[[0, Ŝ], [Ŝᵀ, 0]]`` with ``Ŝ = diag(su) · R · diag(si)``, R the
binary interaction matrix in int8 and ``su = deg_u^-1/2``,
``si = deg_i^-1/2``. Every application runs through the dual kernel
(:func:`~qrec_tpu_torch.ops.kernels.bipartite_dual_matmul`), which reads R
in both orientations from one copy: no transposed R is stored.

SGL's augmented views (``factored_edge_drop_view``,
``factored_node_drop_view``) are ``DenseJoint``s too, with a masked table
or renormalized scales, so :func:`joint_matmul` on a view is the JAX
package's ``factored_view_matmul``. Their random inputs come in as tensors
that the caller draws.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..data.graph import factored_adjacency
from .kernels import bipartite_dual_matmul

# entry budget for the dense-bipartite path (same value as the JAX package)
DENSE_JOINT_LIMIT = 600_000_000


class DenseJoint(NamedTuple):
    """Factored dense joint adjacency on one device."""

    r: torch.Tensor  # (U, I) int8, binary
    row_scale: torch.Tensor  # (U,) f32, deg_u^-1/2
    col_scale: torch.Tensor  # (I,) f32, deg_i^-1/2

    @property
    def num_users(self) -> int:
        return self.r.shape[0]

    @property
    def num_rows(self) -> int:
        return self.r.shape[0] + self.r.shape[1]

    @classmethod
    def from_interactions(cls, data, device) -> "DenseJoint":
        rb, su, si = factored_adjacency(data)
        return cls(
            torch.from_numpy(rb).to(device),
            torch.from_numpy(su).to(device),
            torch.from_numpy(si).to(device),
        )


def factored_call(adj: DenseJoint, x: torch.Tensor) -> torch.Tensor:
    """``[[0, Ŝ], [Ŝᵀ, 0]] @ x`` for x (U+I, d) f32, as the JAX package's
    ``_int8_call``: scale, cast to bf16, one dual-kernel pass, scale the f32
    results."""
    nu = adj.num_users
    su = adj.row_scale[:, None]
    si = adj.col_scale[:, None]
    xu = (x[:nu] * su).to(torch.bfloat16).contiguous()
    xi = (x[nu:] * si).to(torch.bfloat16).contiguous()
    ou, oi = bipartite_dual_matmul(adj.r, xu, xi)
    return torch.cat([ou * su, oi * si])


class JointMatmul(torch.autograd.Function):
    """``y = M @ x`` with M the symmetric joint adjacency. The gradient is
    ``dx = M @ dy``: the backward is the same dual-kernel call on the
    cotangent, never autograd through a transpose of R."""

    @staticmethod
    def forward(ctx, x, r, row_scale, col_scale):
        adj = DenseJoint(r, row_scale, col_scale)
        ctx.adj = adj
        return factored_call(adj, x)

    @staticmethod
    def backward(ctx, grad):
        return factored_call(ctx.adj, grad.contiguous()), None, None, None


def joint_matmul(adj: DenseJoint, x: torch.Tensor) -> torch.Tensor:
    return JointMatmul.apply(x, adj.r, adj.row_scale, adj.col_scale)


def lightgcn_propagate(adj: DenseJoint, embeddings: torch.Tensor, num_layers: int) -> torch.Tensor:
    """K-layer linear propagation ``E ← ÂE`` with layer-mean readout
    (model/ranking/LightGCN.py:17-33)."""
    acc = embeddings
    e = embeddings
    for _ in range(num_layers):
        e = joint_matmul(adj, e)
        acc = acc + e
    return acc / (num_layers + 1)


_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2**32`` for int64 ``x`` in [0, 2**32) and a 32-bit
    constant, in 16-bit halves of ``c`` so no product leaves int64."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def pair_hash_keep(ru: torch.Tensor, ci: torch.Tensor, drop_rate: float) -> torch.Tensor:
    """Bernoulli(1-p) keep flags from a position-independent pair hash:
    murmur3's finalizer on the wraparound sum of two per-axis uint32 draws
    (the JAX package's ``_pair_hash_keep``, ``ops/spmm.py:345-361``).
    ``ru`` and ``ci`` are int64 tensors holding uint32 values that
    broadcast against each other; the uint32 arithmetic is done in int64
    and masked to 32 bits after each step."""
    x = (ru + ci) & _M32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return x >= min(2**32 - 1, int(drop_rate * 2**32))


def _renormalize(deg: torch.Tensor) -> torch.Tensor:
    """deg^-1/2 where deg > 0, else 0."""
    return torch.where(deg > 0, torch.rsqrt(torch.clamp_min(deg, 1e-12)), torch.zeros_like(deg))


def factored_edge_drop_view(
    adj: DenseJoint,
    edges: Tuple[torch.Tensor, torch.Tensor],
    ru: torch.Tensor,
    ci: torch.Tensor,
    drop_rate: float,
) -> DenseJoint:
    """Edge-dropout view (SGL.py:128-141, aug types 1/2): ``R · keep(ru, ci)``
    in R's layout, one int8 table, renormalized by the kept degrees, which
    are exact f32 row and column sums of it. ``edges`` holds the (rows,
    cols) of R's nonzeros; the hash is evaluated there only, since the
    product is 0 elsewhere whatever the hash says."""
    rows, cols = edges
    keep = pair_hash_keep(ru[rows], ci[cols], drop_rate)
    r = torch.zeros_like(adj.r)
    r[rows, cols] = keep.to(torch.int8)
    deg_u = r.sum(dim=1, dtype=torch.float32)
    deg_i = r.sum(dim=0, dtype=torch.float32)
    return DenseJoint(r, _renormalize(deg_u), _renormalize(deg_i))


def factored_node_drop_view(adj: DenseJoint, keep_u: torch.Tensor, keep_i: torch.Tensor) -> DenseJoint:
    """Node-dropout view (SGL.py:113-126, aug type 0): R stays unmasked; a
    dropped node's scale is 0, which removes its edges. The kept degrees
    are the binary matvecs ``R @ keep_i`` and ``Rᵀ @ keep_u`` (one dual
    product at width 1, exact: 0/1 operands, f32 sums), masked by the
    node's own keep flag."""
    ku = keep_u.to(torch.bfloat16)[:, None].contiguous()
    ki = keep_i.to(torch.bfloat16)[:, None].contiguous()
    deg_u, deg_i = bipartite_dual_matmul(adj.r, ku, ki)
    return DenseJoint(
        adj.r,
        _renormalize(deg_u[:, 0] * keep_u),
        _renormalize(deg_i[:, 0] * keep_i),
    )
