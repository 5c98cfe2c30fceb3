"""qrec_tpu_torch — the PyTorch/CUDA port of qrec_tpu.

Same 3-line API as the JAX package; runs on the CUDA device unless asked
for the CPU::

    from qrec_tpu_torch import ModelConf, QRec
    measure = QRec(ModelConf('./config/LightGCN.conf')).execute()

Ported so far: LightGCN, NGCF, SimGCL and SGL; BasicMF, PMF, SVD and BPR;
UserMean, ItemMean, MostPopular and Rand — trained and ranked (or rated)
under the ``-ap``, ``-testSet``, ``-cv`` and ``-predict`` protocols, with
hand-written CUDA kernels for propagation, the contrastive loss and the
masked full-catalog top-k.
"""

from .config import ModelConf, OptionConf
from .runtime.session import QRec

__all__ = ["ModelConf", "OptionConf", "QRec"]
