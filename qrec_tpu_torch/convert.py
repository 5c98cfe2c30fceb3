"""Carry weights across from the JAX package.

The JAX package keeps the trainable state of LightGCN, SGL and SimGCL as
the pytree ``{"user_emb": (U, d), "item_emb": (I, d)}``; arrays arrive here
as numpy, so this module needs no JAX.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def embedding_params_from_jax(params: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` of an embedding graph model (LightGCN, SGL,
    SimGCL) from the JAX parameter dict:
    ``model.load_state_dict(embedding_params_from_jax(p, device))``."""
    return {
        name: torch.tensor(np.asarray(params[name], dtype=np.float32), device=device)
        for name in ("user_emb", "item_emb")
    }


# the name of slice 1, when LightGCN was the only such model
lightgcn_params_from_jax = embedding_params_from_jax
