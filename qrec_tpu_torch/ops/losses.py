"""Loss building blocks (counterpart of the JAX package's ``ops/losses.py``
and of the ``infonce_loss`` custom VJP in its ``ops/pallas_kernels.py``).

Losses take an optional per-example ``weight`` so padded batch tails
contribute zero gradient.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..errors import ConfigError
from ..parallel.collectives import split_range
from .kernels import INFONCE_MASKED, infonce_bwd, infonce_fwd

SSL_BACKENDS = ("auto", "xla", "pallas")


def bpr_loss(
    pos_scores: torch.Tensor,
    neg_scores: torch.Tensor,
    weight: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``-Σ log σ(s+ − s−)`` with the reference's 1e-7 stabilizer
    (util/loss.py:3-6)."""
    loss = -torch.log(10e-8 + torch.sigmoid(pos_scores - neg_scores))
    if weight is not None:
        loss = loss * weight
    return loss.sum()


def unique_padded(ids: torch.Tensor, fill: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Static-shape ``tf.unique`` substitute, as ``jnp.unique(ids,
    size=len(ids), fill_value=fill)``: the sorted distinct ids, then ``fill``
    in the remaining slots, and an f32 mask that is 1 on the distinct ids.
    Built from a sort and a first-occurrence flag with no host sync
    (``torch.unique`` has a data-dependent size)."""
    srt, _ = torch.sort(ids)
    first = torch.ones_like(srt, dtype=torch.bool)
    first[1:] = srt[1:] != srt[:-1]
    slot = torch.cumsum(first, dim=0) - 1
    # every copy of an id writes the same value into its slot
    uniq = torch.full_like(srt, fill).scatter_(0, slot, srt)
    mask = torch.zeros(ids.shape, dtype=torch.float32, device=ids.device)
    mask.scatter_(0, slot, torch.ones_like(mask))
    return uniq, mask


def _l2n(x: torch.Tensor) -> torch.Tensor:
    """Zero-row-safe L2 normalization, ``x · rsqrt(max(Σx², 1e-12))``: a zero
    row gives zero output and a finite gradient."""
    return x * torch.rsqrt(torch.clamp_min((x * x).sum(dim=1, keepdim=True), 1e-12))


def _l2n_bwd(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """VJP of :func:`_l2n` at ``x`` applied to the cotangent ``g``."""
    s = (x * x).sum(dim=1, keepdim=True)
    inv = torch.rsqrt(torch.clamp_min(s, 1e-12))
    gx = g * inv
    corr = x * (g * x).sum(dim=1, keepdim=True) * (inv * inv * inv)
    return torch.where(s > 1e-12, gx - corr, gx)


def masked_infonce(
    view1: torch.Tensor,  # (B, d)
    view2: torch.Tensor,  # (B, d)
    mask: torch.Tensor,  # (B,) 1 = real row, 0 = pad
    temperature: float,
) -> torch.Tensor:
    """InfoNCE over L2-normalized aligned views where pad rows neither
    contribute positives nor appear as negatives; the plain function, with
    autograd through its (B, B) logits."""
    v1, v2 = _l2n(view1), _l2n(view2)
    logits = (v1 @ v2.T) / temperature
    # finite mask value: with -inf, pad rows give 0·inf = NaN in the value
    logits = torch.where(mask[None, :] > 0, logits, torch.full_like(logits, INFONCE_MASKED))
    pos = torch.diagonal(logits)
    lse = torch.logsumexp(logits, dim=1)
    return (mask * (lse - pos)).sum()


class InfoNCELoss(torch.autograd.Function):
    """:func:`masked_infonce` with its forward on K3 and its backward on K4
    (``ops/kernels.infonce_fwd`` / ``infonce_bwd``): the (B, B) logits never
    reach device memory. Normalization stays outside the kernels, as in
    the JAX package's ``infonce_loss`` custom VJP."""

    @staticmethod
    def forward(ctx, view1, view2, mask, temperature):
        v1, v2 = _l2n(view1), _l2n(view2)
        m = mask.to(torch.float32).contiguous()
        loss, lse = infonce_fwd(v1, v2, m, m, temperature)
        ctx.save_for_backward(view1, view2, v1, v2, m, lse)
        ctx.temperature = temperature
        return loss

    @staticmethod
    def backward(ctx, g):
        view1, view2, v1, v2, m, lse = ctx.saved_tensors
        dv1, dv2 = infonce_bwd(v1, v2, m, m, lse, ctx.temperature)
        return _l2n_bwd(view1, g * dv1), _l2n_bwd(view2, g * dv2), None, None


class ShardedInfoNCELoss(torch.autograd.Function):
    """:class:`InfoNCELoss` with its rows sharded over a mesh's ``data`` axis
    (the JAX package's ``sharded_infonce_loss``,
    ``qrec_tpu/ops/pallas_kernels.py:366-470``). Data rank r takes
    ``torch.tensor_split``'s block r of the B rows, ``[o0, o1)``, and K3
    computes their loss against every column with ``row_offset`` o0. The
    value is the rank's *share* of the loss (``parallel/mesh.py``): the
    JAX package's ``psum`` of the loss is the trainer's sum of the epoch's
    shares. Backward: K4 with the same offset gives dv1 of the rank's rows
    (zero elsewhere) and its share of dv2; the JAX package's ``psum`` of
    dv2 is left to the step's one gradient reduction. K3 and K4 take any
    row count, so the rows are not padded to the JAX kernel's
    ``ROW_TILE``."""

    @staticmethod
    def forward(ctx, view1, view2, mask, temperature, mesh):
        o0, o1 = split_range(view1.shape[0], mesh.data, mesh.data_index)
        v1, v2 = _l2n(view1[o0:o1]), _l2n(view2)
        m = mask.to(torch.float32).contiguous()
        rm = m[o0:o1].contiguous()
        loss, lse = infonce_fwd(v1, v2, m, rm, temperature, row_offset=o0)
        ctx.save_for_backward(view1, view2, v1, v2, m, rm, lse)
        ctx.rows, ctx.temperature = (o0, o1), temperature
        return loss

    @staticmethod
    def backward(ctx, g):
        view1, view2, v1, v2, m, rm, lse = ctx.saved_tensors
        o0, o1 = ctx.rows
        dv1, dv2 = infonce_bwd(v1, v2, m, rm, lse, ctx.temperature, row_offset=o0)
        dview1 = torch.zeros_like(view1)
        dview1[o0:o1] = _l2n_bwd(view1[o0:o1], g * dv1)
        return dview1, _l2n_bwd(view2, g * dv2), None, None, None


def infonce_dispatch(
    view1: torch.Tensor, view2: torch.Tensor, mask: torch.Tensor, temperature: float,
    mesh=None,
) -> torch.Tensor:
    """The SSL models' InfoNCE. The JAX package picks between its plain
    function and the fused kernel by ``ssl.backend`` and pads rows to the
    kernel's tile; here every ``ssl.backend`` takes :class:`InfoNCELoss`,
    whose kernels take any B >= 1, so the value does not depend on it. On
    a ``mesh`` the rows are sharded over ``data``
    (:class:`ShardedInfoNCELoss`) and the value is the rank's share."""
    view1, view2 = view1.contiguous(), view2.contiguous()
    if mesh is not None:
        return ShardedInfoNCELoss.apply(view1, view2, mask, float(temperature), mesh)
    return InfoNCELoss.apply(view1, view2, mask, float(temperature))


def check_ssl_backend(config) -> None:
    """ConfigError unless ``ssl.backend`` (``auto`` by default) is one of
    auto|xla|pallas. It selects nothing: see :func:`infonce_dispatch`."""
    backend = config.get("ssl.backend", "auto")
    if backend not in SSL_BACKENDS:
        raise ConfigError(f"unknown ssl.backend {backend!r} (expected auto|xla|pallas)")
