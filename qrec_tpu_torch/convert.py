"""Carry weights across from the JAX package.

The JAX package keeps a model's trainable state as a pytree of arrays:
flat for most models (``{"user_emb": (U, d), "item_emb": (I, d)}`` for
LightGCN, SGL, SimGCL, APR and the MF family, plus NGCF's ``W_{k}_1`` and
``W_{k}_2``, SVD's biases, MostPopular's ``scores``, NeuMF's ``PG``, ``QG``,
``PM``, ``QM``, ``h_mf``, ``h_mlp``, ``W1..W3``, ``b1..b3``, DMF's
``uW1 ... ib2``, CDAE's ``V``, ``enc_*``, ``dec_*``, MHCN's
``gating{c}``, ``gating_bias{c}``, ``sgating{c}``, ``sgating_bias{c}``,
``attention`` and ``attention_mat``, DiffNet's ``W{k}``, DHCF's
``layer{k}``, BUIR's ``W`` and ``b``, SoRec's ``Z``, LOCABAL's ``H``,
SREE's ``user_bias`` and ``item_bias``, SocialFD's ``H`` and both biases,
EE's ``user_emb``, ``item_emb``, ``user_bias`` and ``item_bias``, SVD++'s
the same and ``Y``, the walk models' (CUNE_MF, CUNE_BPR, IF_BPR)
``user_emb`` and ``item_emb``),
one dict per player for the GANs, ESRF and RSGAN (CFGAN's ``g`` and ``d``,
IRGAN's ``gen`` and ``dis``, ESRF's ``d`` with ``user_emb`` and
``item_emb`` and ``g`` with ``relation_emb`` and ``selector``, RSGAN's
``d`` with ``user_emb`` and ``item_emb`` and ``g`` with ``V``, ``enc_w``,
``enc_b``, ``dec_w``, ``dec_b`` and ``item_selection``). The skip-gram
tables are ``in`` and ``out`` in both packages; the port's
``ops/walks.train_skipgram`` takes its initial ``in`` table from a
``SkipgramDraws`` that a caller replaces (``out`` starts at zero in
both). The port's modules
hold the same tensors under the same names, a nested dict's under its key
as a prefix (``gen.user_emb``; BUIR's momentum target, which the JAX
package keeps beside its parameters, as ``{"target": {"user_emb": ...,
"item_emb": ...}}`` into the buffers ``target.user_emb`` and
``target.item_emb``). The ALS models keep no parameter pytree: their
initial tables are one dict each (WRMF's ``x`` and ``y``; CoFactor's those
and ``g``, ``w``, ``c``; ExpoMF's and SERec's ``theta``, ``beta`` and
``mu``), which ``init_tables()`` returns, so a test replaces that method
to start from the JAX package's tables. Arrays arrive here as numpy, so
this module needs no JAX.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def params_from_jax(params: Mapping, device, prefix: str = "") -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` of a model from its JAX parameter pytree:
    every array as an f32 tensor on ``device``, a nested dict's entries
    under ``key.``:
    ``model.load_state_dict(params_from_jax(p, device))``."""
    out: Dict[str, torch.Tensor] = {}
    for key, value in params.items():
        if isinstance(value, Mapping):
            out.update(params_from_jax(value, device, f"{prefix}{key}."))
        else:
            out[prefix + key] = torch.tensor(np.asarray(value, dtype=np.float32), device=device)
    return out


# the names of earlier slices, kept for their callers
embedding_params_from_jax = lightgcn_params_from_jax = params_from_jax
