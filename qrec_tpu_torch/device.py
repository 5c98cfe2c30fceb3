"""The device rule of every entry point: CUDA unless the caller asks for
the CPU, and no silent fallback when there is no card."""

from __future__ import annotations

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
