"""Carry weights across from the JAX package.

The JAX package keeps a model's trainable state as a flat pytree:
``{"user_emb": (U, d), "item_emb": (I, d)}`` for LightGCN, SGL, SimGCL and
the MF family, plus NGCF's (d, d) transforms ``W_{k}_1`` and ``W_{k}_2``
and SVD's ``user_bias`` (U,) and ``item_bias`` (I,); MostPopular keeps its
``scores`` (I,). Arrays arrive here as numpy, so this module needs no JAX.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

# the JAX names the port's models use for the same tensors
_NAMES = ("user_emb", "item_emb", "user_bias", "item_bias", "scores")


def embedding_params_from_jax(params: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` of a model from the JAX parameter dict:
    the embedding tables, SVD's biases, MostPopular's scores and every
    ``W_*`` transform present, under the same names:
    ``model.load_state_dict(embedding_params_from_jax(p, device))``."""
    names = [n for n in _NAMES if n in params] + sorted(k for k in params if k.startswith("W_"))
    return {
        name: torch.tensor(np.asarray(params[name], dtype=np.float32), device=device)
        for name in names
    }


# the name of slice 1, when LightGCN was the only such model
lightgcn_params_from_jax = embedding_params_from_jax
