"""Carry weights across from the JAX package.

The JAX package keeps the trainable state of its graph models as a flat
pytree: ``{"user_emb": (U, d), "item_emb": (I, d)}`` for LightGCN, SGL and
SimGCL, plus NGCF's (d, d) transforms ``W_{k}_1`` and ``W_{k}_2``. Arrays
arrive here as numpy, so this module needs no JAX.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def embedding_params_from_jax(params: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` of a graph model (LightGCN, NGCF, SGL,
    SimGCL) from the JAX parameter dict: the two embedding tables and every
    ``W_*`` transform, under the same names:
    ``model.load_state_dict(embedding_params_from_jax(p, device))``."""
    names = ["user_emb", "item_emb"] + sorted(k for k in params if k.startswith("W_"))
    return {
        name: torch.tensor(np.asarray(params[name], dtype=np.float32), device=device)
        for name in names
    }


# the name of slice 1, when LightGCN was the only such model
lightgcn_params_from_jax = embedding_params_from_jax
