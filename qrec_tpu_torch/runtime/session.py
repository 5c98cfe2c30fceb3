"""Session orchestrator — the reference's ``QRec`` class (QRec.py:7-118;
the JAX package's ``runtime/session.py``) for the ``-ap`` and ``-testSet``
protocols.

``QRec(conf, seed=0, device=None)`` runs on the CUDA device unless the
caller passes ``device="cpu"``; with no card it raises
:class:`DeviceUnavailableError` rather than falling back.
"""

from __future__ import annotations

import random as _random
from typing import List

from .. import io as qio
from ..config import ModelConf, OptionConf
from ..data.dataset import Interactions
from ..data.split import data_split
from ..device import resolve_device
from ..errors import ConfigError, EvaluationError
from ..log import Log, timestamp
from ..models import get_model
from ..models.base import check_graph_settings
from . import evaluator

# config keys and protocols the port does not run yet -> ROADMAP.md item
_NOT_PORTED_KEYS = {
    "parallel.setup": "Queue 1, slice 7: multi-GPU",
    "checkpoint.setup": "Queue 1, slice 6: checkpoint/resume",
    "model.setup": "Queue 1, slice 6: model save/load",
}
_NOT_PORTED_PROTOCOLS = {
    "-cv": "Queue 1, slice 1 deferrals: -cv cross-validation",
    "-predict": "Queue 1, slice 1 deferrals: -predict user lists",
}


def _asks_for(config: ModelConf, key: str) -> bool:
    """Whether ``key`` asks for something, as the JAX package reads it: its
    main switch on for ``parallel.setup`` and ``checkpoint.setup``
    (``models/base.py`` mesh, ``runtime/checkpoint.from_config``), ``-save``
    or ``-load`` for ``model.setup`` (``runtime/session.run_fold``)."""
    if not config.contains(key):
        return False
    opts = config.options(key)
    if key == "model.setup":
        return opts.contains("-save") or opts.contains("-load")
    return opts.isMainOn()


def check_ported(config: ModelConf) -> None:
    for key, item in _NOT_PORTED_KEYS.items():
        if _asks_for(config, key):
            raise ConfigError(f"{key} is not ported yet (ROADMAP.md {item})")
    evaluation = OptionConf(config["evaluation.setup"])
    for flag, item in _NOT_PORTED_PROTOCOLS.items():
        if evaluation.contains(flag):
            raise ConfigError(f"evaluation.setup {flag} is not ported yet (ROADMAP.md {item})")
    check_graph_settings(config)


def run_fold(config: ModelConf, train, test, fold: str, seed: int, device):
    """Train + evaluate one fold; returns (measure lines, model)."""
    model_cls = get_model(config["model.name"])
    data = Interactions(config, train, test, seed=seed)
    model = model_cls(config, data, fold=fold, device=device)
    log = Log(model.model_name, model.model_name + fold + " " + timestamp())
    log.add("### model configuration ###")
    for k in config:
        log.add(k + "=" + config[k])
    if fold == "[1]":
        model.print_config()
    print(f"Building Model {fold}...")
    model.fit()
    s = model.timer.summary()
    log.add(
        "### training throughput ###\n"
        f"epochs={int(s['epochs'])} "
        f"epoch_seconds={s['epoch_seconds']:.4f} "
        f"examples_per_second={s['examples_per_second']:.0f}"
    )
    print(f"Predicting {fold}...")
    measure = evaluator.evaluate(model, data, config, fold, log)
    return measure, model


class QRec:
    def __init__(self, config: ModelConf, seed: int = 0, device=None):
        self.config = config
        self.seed = seed
        self.device = resolve_device(device)
        self.training_data: List[list] = []
        self.test_data: List[list] = []
        self.measure: List[str] = []
        if not config.contains("evaluation.setup"):
            raise ConfigError("Wrong configuration of evaluation!")
        check_ported(config)
        self.evaluation = OptionConf(config["evaluation.setup"])
        binarized = False
        bottom = 0.0
        if self.evaluation.contains("-b"):
            binarized = True
            bottom = float(self.evaluation["-b"])

        ratings_path = config["ratings"]
        if self.evaluation.contains("-testSet"):
            self.training_data = qio.load_ratings(
                config, ratings_path, binarized=binarized, threshold=bottom
            )
            self.test_data = qio.load_ratings(
                config, self.evaluation["-testSet"], binarized=binarized, threshold=bottom
            )
        elif self.evaluation.contains("-ap"):
            all_data = qio.load_ratings(
                config, ratings_path, binarized=binarized, threshold=bottom
            )
            self.training_data, self.test_data = data_split(
                all_data,
                test_ratio=float(self.evaluation["-ap"]),
                binarized=binarized,
                rng=_random.Random(seed),
            )
        else:
            raise EvaluationError(
                "evaluation.setup must contain one of -testSet/-ap"
            )
        print("Reading data and preprocessing...")

    def execute(self) -> List[str]:
        self.measure, self.model = run_fold(
            self.config, self.training_data, self.test_data, "[1]", self.seed, self.device
        )
        return self.measure
