"""The device rule of every entry point: CUDA unless the caller asks for
the CPU, and no silent fallback when there is no card."""

from __future__ import annotations

from contextlib import contextmanager

import torch

from .errors import DeviceUnavailableError


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA device; a CUDA request with no card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise DeviceUnavailableError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


@contextmanager
def f32_products():
    """Float32 matrix products inside the block, never TF32, whatever the
    caller set (the JAX package's ``preferred_element_type=float32``);
    the caller's setting comes back after it."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)
