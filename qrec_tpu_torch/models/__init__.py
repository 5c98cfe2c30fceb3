"""Model registry: an explicit name→class map that grows slice by slice
(reference: QRec.py:51-56's ``exec``-based import)."""

from __future__ import annotations

from ..errors import ModelNotFoundError
from .graph import NGCF, SGL, LightGCN, SimGCL

MODELS = {"LightGCN": LightGCN, "NGCF": NGCF, "SGL": SGL, "SimGCL": SimGCL}

# display name -> canonical conf-key name (the reference's conf files key
# model arguments under the class name: SVD++.conf carries
# ``SVDPlusPlus=-y 0.01``)
ALIASES = {
    "SVD++": "SVDPlusPlus",
}


def get_model(name: str):
    if name not in MODELS:
        raise ModelNotFoundError(
            f"model {name!r} is not ported yet (ROADMAP.md Queue 1 names its "
            "slice: MF/deep/GAN slice 3, social slice 4, ALS/classical/walks slice 5); "
            f"available: {sorted(MODELS)}"
        )
    return MODELS[name]
