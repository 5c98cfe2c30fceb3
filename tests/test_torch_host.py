"""Host layer of the PyTorch port against the JAX package: config parsing,
rating IO, the -ap split, Interactions arrays and the factored adjacency."""

import random

import numpy as np
import pytest
import torch

from qrec_tpu import config as jconfig
from qrec_tpu import io as jio
from qrec_tpu.data import dataset as jdataset
from qrec_tpu.data import split as jsplit
from qrec_tpu.ops.spmm import DenseJoint as JDenseJoint
from qrec_tpu_torch import config as tconfig
from qrec_tpu_torch import io as tio
from qrec_tpu_torch.data import dataset as tdataset
from qrec_tpu_torch.data import split as tsplit
from qrec_tpu_torch.errors import ConfigError
from qrec_tpu_torch.ops.spmm import DenseJoint


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _records(seed=7, users=12, items=20, per_user=6, rating_max=5):
    rng = np.random.RandomState(seed)
    out = []
    for u in range(users):
        for i in rng.choice(items, size=per_user, replace=False):
            out.append([f"u{u}", f"i{i}", float(rng.randint(1, rating_max + 1))])
    # a duplicate (u, i) pair: the last rating must win
    out.append(["u0", out[0][1], 9.0])
    return out


def _conf_dict(evaluation="-ap 0.2"):
    return {
        "ratings": "unused",
        "ratings.setup": "-columns 0 1 2",
        "model.name": "LightGCN",
        "evaluation.setup": evaluation,
        "item.ranking": "on -topN 5",
        "num.factors": "8",
        "num.max.epoch": "2",
        "batch_size": "16",
        "learnRate": "-init 0.01 -max 1",
        "reg.lambda": "-u 0.001 -i 0.001 -b 0.2 -s 0.2",
        "LightGCN": "-n_layer 2",
        "output.setup": "off -dir ./results/",
    }


@pytest.mark.parametrize(
    "text",
    [
        "on -topN 10,20 -dir ./results/",
        "-columns 0 1 2",
        "-ap 0.2 -b 1",
        "-x -1 -y 2",
        "off",
        "on -k -1 -l",
        "-u 0.001 -i 0.001 -b 0.2 -s 0.2",
    ],
)
def test_option_conf_matches_jax(text):
    j, t = jconfig.OptionConf(text), tconfig.OptionConf(text)
    assert t.options == j.options
    assert t.isMainOn() == j.isMainOn()


def test_model_conf_file_matches_jax():
    j = jconfig.ModelConf("config/LightGCN.conf")
    t = tconfig.ModelConf("config/LightGCN.conf")
    assert t.config == j.config
    assert t.model_options().options == j.model_options().options
    with pytest.raises(ConfigError):
        tconfig.ModelConf("config/does-not-exist.conf")
    with pytest.raises(ConfigError):
        t["missing.key"]


def test_load_ratings_matches_jax(tmp_path):
    rows = ["user item rating\n"] + [
        f"u{u}\ti{(u * 7) % 11},{r}\n" for u in range(30) for r in (1, 3, 5)
    ]
    path = tmp_path / "r.txt"
    path.write_text("".join(rows))
    for setup, binarized, threshold in [
        ("-columns 0 1 2 -header", False, 0.0),
        ("-columns 0 1 2 -header", True, 3.0),
        ("-columns 0 1 -header", False, 0.0),
    ]:
        j = jio.load_ratings(jconfig.ModelConf({"ratings.setup": setup}), str(path), binarized, threshold)
        t = tio.load_ratings(tconfig.ModelConf({"ratings.setup": setup}), str(path), binarized, threshold)
        assert t == j


@pytest.mark.parametrize("ratio,binarized", [(0.2, False), (0.3, True), (1.5, False)])
def test_data_split_matches_jax(ratio, binarized):
    data = _records()
    data.append(["u1", "i99", 0.0])
    j = jsplit.data_split(data, ratio, binarized, rng=random.Random(0))
    t = tsplit.data_split(data, ratio, binarized, rng=random.Random(0))
    assert t == j


def _both_interactions(evaluation):
    data = _records()
    train, test = jsplit.data_split(data, 0.25, rng=random.Random(1))
    test = test + [["ghost", "i3", 4.0], ["u2", "new-item", 3.0]]
    j = jdataset.Interactions(jconfig.ModelConf(_conf_dict(evaluation)), train, test, seed=5)
    t = tdataset.Interactions(tconfig.ModelConf(_conf_dict(evaluation)), train, test, seed=5)
    return j, t


@pytest.mark.parametrize("evaluation", ["-ap 0.2", "-ap 0.2 -val 0.3", "-ap 0.2 -cold 4"])
def test_interactions_match_jax(evaluation):
    j, t = _both_interactions(evaluation)
    assert t.user == j.user and t.item == j.item
    assert t.id2user == j.id2user and t.id2item == j.id2item
    assert t.r_scale == j.r_scale
    assert t.global_mean == j.global_mean
    assert list(t.test_set_u.items()) == list(j.test_set_u.items())
    for name in (
        "train_u", "train_i", "train_r", "user_means", "item_means", "csr_sel",
        "u_indptr", "u_indices", "u_values", "i_indptr", "i_indices", "i_values",
    ):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name), err_msg=name)
    je, te = j.test_eval_arrays(), t.test_eval_arrays()
    assert te["names"] == je["names"]
    for name in ("uids", "test_ids", "test_counts"):
        np.testing.assert_array_equal(te[name], je[name], err_msg=name)


def test_factored_adjacency_matches_jax():
    j, t = _both_interactions("-ap 0.2")
    jadj = JDenseJoint.from_interactions(j, quant="factored")
    tadj = DenseJoint.from_interactions(t, "cpu")
    assert tadj.r.dtype == torch.int8
    # R is stored with zero columns up to a multiple of 16 (the dual kernel's layout)
    i = tadj.num_items
    assert tadj.r.shape[1] % 16 == 0 and not tadj.r[:, i:].any()
    np.testing.assert_array_equal(tadj.r[:, :i].numpy(), np.asarray(jadj.q8))
    np.testing.assert_array_equal(tadj.r[:, :i].numpy().T, np.asarray(jadj.q8_t))
    np.testing.assert_array_equal(tadj.row_scale.numpy(), np.asarray(jadj.row_scale))
    np.testing.assert_array_equal(tadj.col_scale.numpy(), np.asarray(jadj.col_scale))
