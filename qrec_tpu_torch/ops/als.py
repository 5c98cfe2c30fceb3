"""Batched weighted-ridge solves on the device (counterpart of the JAX
package's ``ops/als.py``; reference WRMF.py:17-67's per-row
``np.linalg.inv`` loops and ExpoMF.py:118-135's process pools).

WRMF's confidence form and ExpoMF's exposure form are one problem: each
row solves ``(Yᵀ diag(w) Y + reg·I) x = Yᵀ (w ⊙ t)``, with ``w = 1 + 10r``
(WRMF) or the exposure posterior (ExpoMF, SERec, CoFactor's user side) and
``t`` the rated indicator.

The normal matrices of a chunk of rows are one product ``w @ (y ⊗ y)``,
``y ⊗ y`` the (N, d²) table of each row's outer product, so no (B, N, d)
block of ``w ⊙ y`` is ever formed; the solves are ``torch.linalg.solve_ex``,
which leaves a singular row inf/nan as ``jnp.linalg.solve`` does and never
reads the LU status back to the host. Rows are independent, so the chunk
(:func:`chunk_rows`, from a memory budget) changes a row's solution only by
the rounding of its sums; the JAX package's 256-row chunks and their
padding rows are a TPU memory choice that the port does not copy. Every
product is f32.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..device import f32_products

# device memory that one chunk's temporaries may take
CHUNK_BYTES = 256 << 20


def chunk_rows(n_cols: int, d: int) -> int:
    """Rows per chunk whose ``w ⊙ t`` row, normal matrix, right-hand side
    and LU copy fit ``CHUNK_BYTES`` of f32."""
    return max(1, CHUNK_BYTES // (4 * (n_cols + 2 * d * d + 2 * d)))


def outer_rows(y: torch.Tensor) -> torch.Tensor:
    """(N, d²): each row of ``y`` times its own transpose, flattened."""
    return (y[:, :, None] * y[:, None, :]).reshape(y.shape[0], -1)


def weighted_ridge_batch(
    y: torch.Tensor,
    w_batch: torch.Tensor,
    t_batch: torch.Tensor,
    reg: float,
    extra_a: Optional[torch.Tensor] = None,
    extra_b: Optional[torch.Tensor] = None,
    yy: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(B, d): the solution of each row of ``w_batch`` / ``t_batch`` (B, N)
    against the fixed factors ``y`` (N, d); ``extra_a`` (B, d, d) and
    ``extra_b`` (B, d) are added to the normal matrices and right-hand
    sides (CoFactor's context blocks); ``yy`` is :func:`outer_rows` of
    ``y`` when the caller has it."""
    d = y.shape[1]
    with f32_products():
        if yy is None:
            yy = outer_rows(y)
        a = (w_batch @ yy).view(-1, d, d) + reg * torch.eye(d, device=y.device)
        b = (w_batch * t_batch) @ y
    if extra_a is not None:
        a = a + extra_a
    if extra_b is not None:
        b = b + extra_b
    return torch.linalg.solve_ex(a, b[..., None])[0][..., 0]


def solve_factors(
    y: torch.Tensor,
    weights: torch.Tensor,
    targets: torch.Tensor,
    reg: float,
    chunk: Optional[int] = None,
    extra_a: Optional[torch.Tensor] = None,
    extra_b: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(M, d): every row of ``weights`` / ``targets`` (M, N) solved against
    ``y`` (N, d), ``chunk`` rows at a time (by default :func:`chunk_rows`),
    with the rows of ``extra_a`` (M, d, d) and ``extra_b`` (M, d) added
    where given."""
    m, n = weights.shape
    d = y.shape[1]
    chunk = chunk or chunk_rows(n, d)
    yy = outer_rows(y)
    part = lambda t, s: None if t is None else t[s : s + chunk]  # noqa: E731
    out = [weighted_ridge_batch(y, weights[s : s + chunk], targets[s : s + chunk], reg,
                                part(extra_a, s), part(extra_b, s), yy=yy)
           for s in range(0, m, chunk)]
    return torch.cat(out) if out else y.new_zeros((0, d))


def exposure_posterior(
    theta_batch: torch.Tensor,
    beta: torch.Tensor,
    rated: torch.Tensor,
    lam_y: float,
    mu: torch.Tensor,
    eps: float = 1e-8,
) -> torch.Tensor:
    """(B, I): the posterior of the exposure variables (ExpoMF.py:89-96),
    1 where rated; ``mu`` is (I,) (ExpoMF) or (B, I) (SERec)."""
    with f32_products():
        scores = theta_batch @ beta.T
    # the f32 square root of the f32 constant, as ``jnp.sqrt`` takes it
    scale = float(np.sqrt(np.float32(lam_y / (2 * np.pi))))
    p_ex = scale * torch.exp(-lam_y * scores**2 / 2)
    mu_b = mu if mu.dim() == 2 else mu[None, :]
    a = (p_ex + eps) / (p_ex + eps + (1 - mu_b) / torch.clamp_min(mu_b, 1e-12))
    return torch.where(rated > 0, torch.ones_like(a), a)
