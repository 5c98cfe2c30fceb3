"""Session orchestrator — the reference's ``QRec`` class (QRec.py:7-118;
the JAX package's ``runtime/session.py``) for the ``-ap``, ``-testSet``,
``-cv`` and ``-predict`` protocols.

``QRec(conf, seed=0, device=None)`` reads the ``social`` relation file
when the config names one and hands it to every fold (a social model
without one raises); it runs on the CUDA device unless the caller passes
``device="cpu"``; with no card it raises
:class:`DeviceUnavailableError` rather than falling back. Cross-validation
folds run one after another on that device; their measures are averaged as
strings and the summary file is written whatever ``output.setup`` says, as
the reference does (QRec.py:91-107). ``model.setup=-load <path>`` restores
a saved model in place of training and ``-save <path>`` writes it after
the evaluation (every fold of ``-cv`` writes the same path), as in the JAX
package's ``run_fold``.
"""

from __future__ import annotations

import random as _random
from typing import List, Optional

from .. import io as qio
from ..config import ModelConf, OptionConf
from ..data.dataset import Interactions
from ..data.social import SocialGraph
from ..data.split import cross_validation, data_split
from ..device import resolve_device
from ..errors import ConfigError, EvaluationError
from ..log import Log, timestamp
from ..models import get_model
from ..models.base import check_graph_settings
from . import evaluator

# config keys the port does not run yet -> ROADMAP.md item
_NOT_PORTED_KEYS = {
    "parallel.setup": "Queue 1 item 19, slice 7: multi-GPU",
}


def check_ported(config: ModelConf) -> None:
    """Refuse a key the port does not run yet when its main switch is on,
    as the JAX package reads it (its mesh, ``models/base.py``)."""
    for key, item in _NOT_PORTED_KEYS.items():
        if config.contains(key) and config.options(key).isMainOn():
            raise ConfigError(f"{key} is not ported yet (ROADMAP.md {item})")
    check_graph_settings(config)


def run_fold(config: ModelConf, train, test, relation, fold: str, seed: int, device):
    """Train + evaluate one fold; returns (measure lines, model). A social
    model gets the trust ``relation`` cleaned against the fold's training
    users (``SocialGraph``)."""
    model_cls = get_model(config["model.name"])
    data = Interactions(config, train, test, seed=seed)
    kwargs = {}
    if model_cls.requires_social:
        if relation is None:
            raise ConfigError(
                f"model {config['model.name']} requires a 'social' relation file in the config"
            )
        kwargs["social"] = SocialGraph(relation, data)
    model = model_cls(config, data, fold=fold, device=device, **kwargs)
    log = Log(model.model_name, model.model_name + fold + " " + timestamp())
    log.add("### model configuration ###")
    for k in config:
        log.add(k + "=" + config[k])
    if fold == "[1]":
        model.print_config()
    setup = config.options("model.setup") if config.contains("model.setup") else None
    if setup is not None and setup.contains("-load"):
        print(f"Loading model {fold}...")
        model.load_model(setup["-load"])
    else:
        print(f"Building Model {fold}...")
        model.fit()
    if model.timer is not None and model.timer.times:
        s = model.timer.summary()
        log.add(
            "### training throughput ###\n"
            f"epochs={int(s['epochs'])} "
            f"epoch_seconds={s['epoch_seconds']:.4f} "
            f"examples_per_second={s['examples_per_second']:.0f}"
        )
    print(f"Predicting {fold}...")
    measure = evaluator.evaluate(model, data, config, fold, log)
    if setup is not None and setup.contains("-save"):
        print(f"Saving model {fold}...")
        model.save_model(setup["-save"])
    return measure, model


class QRec:
    def __init__(self, config: ModelConf, seed: int = 0, device=None):
        self.config = config
        self.seed = seed
        self.device = resolve_device(device)
        self.training_data: List[list] = []
        self.test_data: List[list] = []
        self.relation: Optional[List[list]] = None
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
        self.binarized = binarized

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
        elif self.evaluation.contains("-cv"):
            self.training_data = qio.load_ratings(
                config, ratings_path, binarized=binarized, threshold=bottom
            )
        elif self.evaluation.contains("-predict"):
            self.training_data = qio.load_ratings(
                config, ratings_path, binarized=binarized, threshold=bottom
            )
            self.test_data = qio.load_user_list(self.evaluation["-predict"])
        else:
            raise EvaluationError(
                "evaluation.setup must contain one of -testSet/-ap/-cv/-predict"
            )
        if config.contains("social"):
            self.relation = qio.load_relations(config, config["social"])
        print("Reading data and preprocessing...")

    def _run_fold(self, train, test, fold: str) -> List[str]:
        measure, self.model = run_fold(
            self.config, train, test, self.relation, fold, self.seed, self.device
        )
        return measure

    def execute(self) -> List[str]:
        if not self.evaluation.contains("-cv"):
            self.measure = self._run_fold(self.training_data, self.test_data, "[1]")
            return self.measure
        k = int(self.evaluation["-cv"])
        if k < 2 or k > 10:
            raise EvaluationError("k for cross-validation should be between 2 and 10")
        if self.evaluation.contains("-p"):
            print(
                "-p parallel folds need one device per process; a single card "
                "cannot be shared — running folds sequentially"
            )
        fold_measures = [
            self._run_fold(train, test, f"[{i + 1}]")
            for i, (train, test) in enumerate(
                cross_validation(self.training_data, k, binarized=self.binarized)
            )
        ]
        self.measure = average_folds(fold_measures)
        # the summary is written whatever output.setup's main switch says
        # (QRec.py:103-106)
        output = OptionConf(self.config["output.setup"])
        file_name = self.config["model.name"] + "@" + timestamp() + "-" + str(k) + "-fold-cv.txt"
        qio.write_file(output.get("-dir", "./results/"), file_name, self.measure)
        print("The result of %d-fold cross validation:\n%s" % (k, "".join(self.measure)))
        return self.measure


def average_folds(fold_measures: List[List[str]]) -> List[str]:
    """The folds' measure lines averaged as the reference averages them
    (QRec.py:91-107): a ``Top N`` line is kept, every ``name:value`` line
    becomes ``name:`` and the mean of the folds' values as ``str`` writes
    it."""
    k = len(fold_measures)
    res = []
    for i, line in enumerate(fold_measures[0]):
        if line[:3] == "Top":
            res.append(line)
            continue
        metric = line.split(":")[0]
        total = sum(float(fold_measures[j][i].split(":")[1]) for j in range(k))
        res.append(metric + ":" + str(total / k) + "\n")
    return res
