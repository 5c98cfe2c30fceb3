"""Rating evaluation of the PyTorch port against the JAX package: the
predictions of BasicMF, PMF, SVD, UserMean and ItemMean on the same
parameters (with users and items unknown in training), the
rating-predictions file line for line and the MAE/RMSE measure.

Tolerances: predictions within 1e-5 (f32 dot products summed in another
order); a line of the predictions file may differ only by one rounding
step of its 3-decimal prediction (a prediction within 1e-5 of a rounding
boundary); MAE and RMSE within 1e-6."""

import random

import numpy as np
import pytest
import torch

from qrec_tpu import config as jconfig
from qrec_tpu.data.dataset import Interactions as JInteractions
from qrec_tpu.data.split import data_split
from qrec_tpu.models import baselines as jbaselines
from qrec_tpu.models import mf as jmf
from qrec_tpu.ops import metrics as jmetrics
from qrec_tpu.runtime import evaluator as jevaluator
from qrec_tpu_torch import ModelConf
from qrec_tpu_torch.convert import embedding_params_from_jax
from qrec_tpu_torch.data.dataset import Interactions
from qrec_tpu_torch.models import baselines, mf
from qrec_tpu_torch.ops import metrics
from qrec_tpu_torch.runtime import evaluator

MODELS = ["BasicMF", "PMF", "SVD", "UserMean", "ItemMean"]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _conf(name, out_dir):
    return {
        "ratings": "unused",
        "ratings.setup": "-columns 0 1 2",
        "model.name": name,
        "evaluation.setup": "-ap 0.3",
        "item.ranking": "off -topN 5",
        "num.factors": "5",
        "num.max.epoch": "2",
        "batch_size": "16",
        "learnRate": "-init 0.02 -max 1",
        "reg.lambda": "-u 0.01 -i 0.01 -b 0.01 -s 0.2",
        "output.setup": f"on -dir {out_dir}/",
        "seed": "4",
    }


def _split():
    rng = np.random.RandomState(8)
    records = [
        [f"u{u}", f"i{i}", float(rng.randint(1, 9)) / 2]
        for u in range(16)
        for i in rng.choice(25, size=7, replace=False)
    ]
    train, test = data_split(records, 0.3, rng=random.Random(1))
    # test users and items unknown in training: every fallback of the chain
    test += [["ghost", "i1", 3.0], ["u2", "ghost_item", 1.5], ["ghost", "ghost_item", 2.0]]
    return train, test


def _models(name, tmp_path):
    """The JAX model and the port's with the same final parameters
    (the JAX package's initial ones, mapped by each one's ``finalize``)."""
    train, test = _split()
    jconf = jconfig.ModelConf(_conf(name, tmp_path / "jax"))
    tconf = ModelConf(_conf(name, tmp_path / "torch"))
    jdata, tdata = JInteractions(jconf, train, test), Interactions(tconf, train, test)
    if name in ("UserMean", "ItemMean"):
        return (getattr(jbaselines, name)(jconf, jdata), jdata,
                getattr(baselines, name)(tconf, tdata, device="cpu"), tdata)
    jmodel = getattr(jmf, name)(jconf, jdata)
    spec = jmodel.build()
    jmodel.finalize(spec.params, spec)
    tmodel = getattr(mf, name)(tconf, tdata, device="cpu")
    tmodel.load_state_dict(embedding_params_from_jax(
        {k: np.asarray(v) for k, v in spec.params.items()}, "cpu"))
    tmodel.finalize(tmodel.build())
    return jmodel, jdata, tmodel, tdata


@pytest.mark.parametrize("name", MODELS)
def test_predict_ratings_match_jax(name, tmp_path):
    jmodel, jdata, tmodel, _ = _models(name, tmp_path)
    users = [e[0] for e in jdata.test_data]
    items = [e[1] for e in jdata.test_data]
    want = jmodel.predict_ratings(users, items)
    got = tmodel.predict_ratings(users, items)
    assert got.dtype == np.float64 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def _rows(path):
    return [line.split() for line in path.read_text().splitlines()]


@pytest.mark.parametrize("name", MODELS)
def test_rating_files_and_measures_match_jax(name, tmp_path):
    jmodel, jdata, tmodel, tdata = _models(name, tmp_path)
    jmeasure = jevaluator.evaluate(jmodel, jdata, jmodel.config, "[1]")
    measure = evaluator.evaluate(tmodel, tdata, tmodel.config, "[1]")
    got = {k: float(v) for k, v in (line.split(":") for line in measure)}
    want = {k: float(v) for k, v in (line.split(":") for line in jmeasure)}
    assert list(got) == ["MAE", "RMSE"] == list(want)
    for key in got:
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-6, err_msg=key)
    files = {}
    for side in ("jax", "torch"):
        names = sorted(p.name for p in (tmp_path / side).iterdir())
        assert len(names) == 2 and "-measure[1].txt" in names[0]
        assert "-rating-predictions[1].txt" in names[1]
        files[side] = _rows(tmp_path / side / names[1])
    assert files["torch"][0] == files["jax"][0]  # the header
    assert len(files["torch"]) == len(files["jax"]) == len(jdata.test_data) + 1
    off = 0
    for mine, theirs in zip(files["torch"][1:], files["jax"][1:]):
        assert mine[:3] == theirs[:3]
        if mine[3] != theirs[3]:
            assert abs(float(mine[3]) - float(theirs[3])) <= 0.001 + 1e-9, (mine, theirs)
            off += 1
    assert off <= 1


def test_rating_measure_matches_jax():
    rng = np.random.RandomState(0)
    records = [[f"u{k}", f"i{k}", float(rng.randint(1, 9)) / 2, float(rng.rand() * 4)]
               for k in range(50)]
    assert metrics.rating_measure(records) == jmetrics.rating_measure(records)
    assert metrics.rating_measure([]) == jmetrics.rating_measure([])


@pytest.mark.parametrize("pred", [-1.0, 0.5, 0.74949, 2.0005, 3.99951, 4.0, 7.5])
def test_clamp_rating_matches_jax(pred):
    scale = [0.5, 1.0, 2.5, 4.0]
    assert evaluator.clamp_rating(pred, scale) == jevaluator.clamp_rating(pred, scale)
