"""The port's conf handling against the JAX package's on the same input:
model-option aliases, setup keys that ask for nothing, and the learning-rate
and regularization flags that both packages require."""

import random

import numpy as np
import pytest
import torch

from qrec_tpu import config as jconfig
from qrec_tpu.data.dataset import Interactions as JInteractions
from qrec_tpu.data.split import data_split
from qrec_tpu.errors import ConfigError as JConfigError
from qrec_tpu.models.graph import LightGCN as JLightGCN
from qrec_tpu_torch import ModelConf, QRec
from qrec_tpu_torch.config import ModelConf as TModelConf
from qrec_tpu_torch.data.dataset import Interactions
from qrec_tpu_torch.errors import ConfigError
from qrec_tpu_torch.models.graph import LightGCN


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _conf(extra=None):
    base = {
        "ratings": "unused",
        "ratings.setup": "-columns 0 1 2",
        "model.name": "LightGCN",
        "evaluation.setup": "-ap 0.2",
        "item.ranking": "on -topN 5",
        "num.factors": "8",
        "num.max.epoch": "2",
        "batch_size": "16",
        "learnRate": "-init 0.01 -max 1",
        "reg.lambda": "-u 0.001 -i 0.001 -b 0.2 -s 0.2",
        "LightGCN": "-n_layer 2",
        "graph.dense.quant": "factored",
        "output.setup": "off -dir ./results/",
        "seed": "5",
    }
    base.update(extra or {})
    return base


@pytest.mark.parametrize(
    "options",
    [
        {"model.name": "SVD++", "SVDPlusPlus": "-y 0.01"},  # under the alias only
        {"model.name": "SVD++", "SVD++": "-y 0.5", "SVDPlusPlus": "-y 0.01"},  # display name first
        {"model.name": "SVDPlusPlus", "SVDPlusPlus": "-y 0.01"},
        {"model.name": "SVD++"},  # no arguments at all
    ],
)
def test_model_options_read_aliases_as_jax(options):
    j = jconfig.ModelConf(options).model_options()
    t = TModelConf(options).model_options()
    assert (t is None) == (j is None)
    if j is not None:
        assert t.options == j.options


def test_svdpp_conf_file_options_match_jax():
    j = jconfig.ModelConf("config/SVD++.conf")
    t = TModelConf("config/SVD++.conf")
    assert t["model.name"] == "SVD++"
    assert t.model_options() is not None
    assert t.model_options().options == j.model_options().options


def _planted(tmp_path):
    rng = np.random.RandomState(0)
    path = tmp_path / "ratings.txt"
    path.write_text("".join(
        f"u{u} i{i} 1\n"
        for u in range(24)
        for i in rng.choice(10, size=6, replace=False) + (0 if u < 12 else 10)
    ))
    return _conf({"ratings": str(path), "num.max.epoch": "3"})


def test_setup_keys_switched_off_run_as_without_them(tmp_path):
    base = _planted(tmp_path)
    off = dict(base, **{"parallel.setup": "off", "checkpoint.setup": "off -dir ckpt",
                        "model.setup": "off"})
    runs = []
    for conf in (base, off):
        rec = QRec(ModelConf(conf), seed=3, device="cpu")
        measure = rec.execute()
        runs.append((rec.model.epoch_losses, measure))
    assert runs[1][0] == runs[0][0]
    assert runs[1][1] == runs[0][1]


def _split():
    rng = np.random.RandomState(5)
    records = [
        [f"u{u}", f"i{i}", 1.0]
        for u in range(14)
        for i in rng.choice(24, size=7, replace=False)
    ]
    return data_split(records, 0.25, rng=random.Random(2))


@pytest.mark.parametrize(
    "key,value",
    [
        ("learnRate", "-init 0.01"),  # no -max
        ("reg.lambda", "-u 0.001 -b 0.2 -s 0.2"),  # no -i
        ("reg.lambda", "-i 0.001 -b 0.2"),  # no -u
    ],
)
def test_missing_required_flags_raise_in_both_packages(key, value):
    train, test = _split()
    conf = _conf({key: value})
    jd = JInteractions(jconfig.ModelConf(conf), train, test)
    td = Interactions(ModelConf(conf), train, test)
    with pytest.raises(JConfigError):
        JLightGCN(jconfig.ModelConf(conf), jd)
    with pytest.raises(ConfigError):
        LightGCN(ModelConf(conf), td, device="cpu")


def test_flags_stored_as_jax_stores_them():
    train, test = _split()
    conf = _conf({"learnRate": "-init 0.01 -max 0.5", "reg.lambda": "-u 0.002 -i 0.003"})
    j = JLightGCN(jconfig.ModelConf(conf), JInteractions(jconfig.ModelConf(conf), train, test))
    t = LightGCN(ModelConf(conf), Interactions(ModelConf(conf), train, test), device="cpu")
    for name in ("lrate", "max_lrate", "reg_u", "reg_i", "reg_b"):
        assert getattr(t, name) == getattr(j, name), name
    assert t.reg_b == 0.0
