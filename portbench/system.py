"""The system under test: ``qrec_tpu_torch``, reached through its normal
path. The one module of the benchmark that imports it.

:func:`build` loads the rating files through the session's data path
(``runtime/session.QRec``: ``io.load_ratings`` on the host tokenizer and
the ``-testSet`` file), builds ``data.Interactions`` and
the model as ``runtime/session.run_fold`` does, and prepares the model's
adjacency (``GraphRecommender.joint_adj``).
"""

from __future__ import annotations

import time
from typing import Dict, NamedTuple

import torch


class System(NamedTuple):
    conf: object  # qrec_tpu_torch.config.ModelConf
    data: object  # qrec_tpu_torch.data.dataset.Interactions
    model: object  # a qrec_tpu_torch model
    load_s: float
    build_s: float


def model_conf(config: Dict, ratings: str, test: str, seed: int, overrides: Dict[str, str]):
    """The configuration's ``.conf`` keys with the rating file, the test
    file, the run's seed and the traffic's ``overrides``."""
    from qrec_tpu_torch.config import ModelConf

    keys = dict(config["conf"])
    keys.update(overrides)
    keys["ratings"] = ratings
    keys["seed"] = str(seed)
    keys["evaluation.setup"] = keys["evaluation.setup"].replace("{test}", test)
    return ModelConf(keys)


def build(config: Dict, ratings: str, test: str, seed: int, device,
          overrides: Dict[str, str]) -> System:
    from qrec_tpu_torch.data.dataset import Interactions
    from qrec_tpu_torch.models import get_model
    from qrec_tpu_torch.runtime.session import QRec

    conf = model_conf(config, ratings, test, seed, overrides)
    t0 = time.perf_counter()
    session = QRec(conf, seed=seed, device=device)
    data = Interactions(conf, session.training_data, session.test_data, seed=seed)
    t1 = time.perf_counter()
    model = get_model(conf["model.name"])(conf, data, fold="[1]", device=device)
    model.prepare_graph()
    if model.device.type == "cuda":
        torch.cuda.synchronize()
    return System(conf, data, model, t1 - t0, time.perf_counter() - t1)


def set_tables(model, user: torch.Tensor, item: torch.Tensor) -> None:
    """The model's embedding tables made ``user`` and ``item`` (no copy)."""
    model.user_emb.data = user
    model.item_emb.data = item


def tables(model):
    """The model's embedding tables (user, item), the parameters it trains."""
    return [model.user_emb, model.item_emb]


def ranker(model, data, k: int):
    """The ranker of the final evaluation, as ``runtime/evaluator.eval_ranking``
    makes it."""
    from qrec_tpu_torch.ops.topk import CatalogRanker

    return CatalogRanker(data, k=k, device=model.device, bitmask=model.rated_bitmask,
                         batch_size=model.eval_batch_size, mesh=model.mesh)


def kernels_built() -> None:
    """The system's CUDA kernels and host library, built where missing
    (into the checkout's ``build/qrec_tpu_torch/``)."""
    from qrec_tpu_torch import native
    from qrec_tpu_torch.ops import kernels

    kernels.build()
    native.build()
