"""Model registry: an explicit name→class map of every model the JAX
package registers (reference: QRec.py:51-56's ``exec``-based import)."""

from __future__ import annotations

from ..errors import ModelNotFoundError
from .adversarial_social import ESRF, RSGAN
from .als import WRMF, CoFactor, ExpoMF, SERec
from .baselines import ItemMean, MostPopular, Rand, UserMean
from .classical import EE, ItemKNN, SlopeOne, SVDPlusPlus, UserKNN
from .deep import APR, CDAE, CFGAN, DMF, NeuMF
from .gan import IRGAN
from .graph import NGCF, SGL, LightGCN, SimGCL
from .ifbpr import IF_BPR
from .mf import BPR, PMF, SVD, BasicMF
from .social_graph import BUIR, DHCF, MHCN, SEPT, DiffNet
from .social_mf import LOCABAL, RSTE, SREE, SoRec, SoReg, SocialFD, SocialMF
from .social_ranking import SBPR, TBPR
from .walk import CUNE_BPR, CUNE_MF

MODELS = {
    "LightGCN": LightGCN, "NGCF": NGCF, "SGL": SGL, "SimGCL": SimGCL,
    "BasicMF": BasicMF, "PMF": PMF, "SVD": SVD, "BPR": BPR,
    "UserMean": UserMean, "ItemMean": ItemMean, "MostPopular": MostPopular, "Rand": Rand,
    "NeuMF": NeuMF, "DMF": DMF, "CDAE": CDAE, "CFGAN": CFGAN, "APR": APR, "IRGAN": IRGAN,
    "MHCN": MHCN, "SEPT": SEPT, "BUIR": BUIR, "DiffNet": DiffNet, "DHCF": DHCF,
    "SoRec": SoRec, "SoReg": SoReg, "SocialMF": SocialMF, "RSTE": RSTE, "LOCABAL": LOCABAL,
    "SREE": SREE, "SocialFD": SocialFD, "SBPR": SBPR, "TBPR": TBPR, "ESRF": ESRF,
    "WRMF": WRMF, "ExpoMF": ExpoMF, "CoFactor": CoFactor, "SERec": SERec,
    "UserKNN": UserKNN, "ItemKNN": ItemKNN, "SlopeOne": SlopeOne, "EE": EE,
    "SVDPlusPlus": SVDPlusPlus, "SVD++": SVDPlusPlus,
    "CUNE_MF": CUNE_MF, "CUNE_BPR": CUNE_BPR, "IF_BPR": IF_BPR, "RSGAN": RSGAN,
}

# display name -> canonical conf-key name (the reference's conf files key
# model arguments under the class name: SVD++.conf carries
# ``SVDPlusPlus=-y 0.01``)
ALIASES = {
    "SVD++": "SVDPlusPlus",
}


def get_model(name: str):
    if name not in MODELS:
        raise ModelNotFoundError(f"unknown model {name!r}; available: {sorted(MODELS)}")
    return MODELS[name]
