"""Slice 7c of the port on the CPU: the social and hypergraph graph models
(MHCN, SEPT, BUIR, DiffNet, DHCF) trained data-parallel on gloo groups of
spawned ranks (``test_torch_parallel_ranks.py``), and the run's lifecycle
on the mesh (checkpoint resume, ``model.setup -save/-load``, ``-cv k
-p``).

Each model runs three epochs (SEPT one warm-up and two joint) from the JAX
package's initial parameters, on its sampler's batches and with its draws,
as ``tests/test_torch_social_graph.py`` injects them, on four ranks (data
2 x model 2; MHCN also on three, data 3 x model 1, where the user rows and
the batch cut unevenly), in one process of the port and in the JAX package.

Bounds. The first step's loss (the data ranks' shares summed) within rtol
1e-5 of one process's; the losses within rtol 1e-3 and the tables within
1e-4 of one process's and the JAX package's (the drift bounds of
``tests/test_torch_lightgcn.py``); the first step's gradients within the
f32 bound that ``tests/test_torch_social_graph.py`` holds the one-process
port to, for every model and form; the ranks equal bit for bit."""

import random

import jax
import numpy as np
import pytest
import torch

import test_torch_parallel_ranks as R
from qrec_tpu import config as jconfig
from qrec_tpu.data.dataset import Interactions as JInteractions
from qrec_tpu.data.social import SocialGraph as JSocialGraph
from qrec_tpu.data.split import data_split
from qrec_tpu_torch import ModelConf
from qrec_tpu_torch.data.dataset import Interactions
from qrec_tpu_torch.data.social import SocialGraph
from qrec_tpu_torch.models.social_graph import mhcn_channel_mim, sept_neighbor_ssl
from qrec_tpu_torch.ops import metrics
from qrec_tpu_torch.ops.losses import _l2n
from qrec_tpu_torch.parallel.collectives import split_range
from test_torch_parallel import _planted_file
from test_torch_social_graph import (
    BF16,
    J_MODELS,
    T_MODELS,
    _close_f32,
    _conf,
    _jax_epochs,
    _jax_problem,
    _lines,
    _relation,
)

MESH = "on -model 2"  # four ranks: data 2 x model 2
COO = {"graph.aux.dense": "off", "graph.backend": "coo"}
# name -> (model, the port's keys, the JAX package's keys where they
# differ). SEPT's rec view is the joint
# adjacency as published (``auto``: the factored dense form, route 6 on a
# mesh; the JAX package's ``auto`` is its bf16 form off a TPU); BUIR's
# views as published ride the segment kernel (route 4 on a mesh; the JAX
# package honours an explicit ``pallas`` on every device, in interpret
# mode), its scoring the factored form
FITS = {
    "MHCN": ("MHCN", {}, None),
    "SEPT": ("SEPT", {"graph.aux.dense": "off"},
             {"graph.aux.dense": "off", "graph.dense.quant": "factored"}),
    "BUIR-auto": ("BUIR", {}, {"graph.backend": "pallas"}),
    "BUIR-coo": ("BUIR", COO, None),
    "DiffNet": ("DiffNet", COO, None),
    "DHCF-dense": ("DHCF", {"graph.aux.dense": "on", "learnRate": "-init 0.001 -max 1"}, None),
    "DHCF-coo": ("DHCF", {"graph.aux.dense": "off"}, None),
}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _same_on_every_rank(values):
    for v in values[1:]:
        for a, b in zip(jax.tree_util.tree_leaves(values[0]), jax.tree_util.tree_leaves(v)):
            np.testing.assert_array_equal(a, b)


def _case(label):
    """The JAX package's run of ``label`` (losses, parameters after every
    epoch, BUIR's final target) and the port's case: the conf, the split,
    the relation, the JAX initial parameters, batches and draws."""
    name, extra, jextra = FITS[label]
    ratings, _ = _lines()
    records = [line.split()[:2] + [1.0] for line in ratings]
    train, test = data_split(records, 0.2, rng=random.Random(3))
    conf = _conf(name, extra)
    jconf = jconfig.ModelConf(_conf(name, extra if jextra is None else jextra))
    rel = None if name in ("BUIR", "DHCF") else _relation()  # they take no relation
    jd = JInteractions(jconf, train, test)
    jmodel = J_MODELS[name](jconf, jd, social=JSocialGraph(_relation(), jd))
    td = Interactions(ModelConf(conf), train, test)
    tmodel = T_MODELS[name](ModelConf(conf), td, device="cpu", social=SocialGraph(_relation(), td))
    tmodel.prepare_graph()
    with pytest.MonkeyPatch.context() as mp:
        params, target, phases = _jax_problem(name, jmodel, mp)
    init = {k: np.asarray(v) for k, v in params.items()}
    if target is not None:
        init["target"] = {k: np.asarray(v) for k, v in target.items()}
    batches, losses, jparams, draws, jtarget = _jax_epochs(name, jmodel, tmodel, params, target,
                                                           phases)
    jax_run = {"losses": losses,
               "tables": [{k: np.asarray(v) for k, v in p.items()} for p in jparams],
               "target": None if jtarget is None else {k: np.asarray(v) for k, v in jtarget.items()}}
    case = {"conf": conf, "train": train, "test": test, "relation": rel, "params": init,
            "batches": batches, "draws": R.as_numpy(draws)}
    return case, jax_run


def _lifecycle_confs(tmp):
    """LightGCN (``config/LightGCN.conf``'s settings: route 6) and BUIR
    (route 4 views) on the planted blocks, each unbroken for 2 epochs,
    stopped after epoch 1 with ``checkpoint.setup -every 1``, resumed to 2
    with ``-save``, then ``-load``ed; LightGCN under ``-cv 2`` and ``-cv 2
    -p``. Every rank shares each directory."""
    ratings = str(_planted_file(tmp))
    base = {"ratings": ratings, "ratings.setup": "-columns 0 1 2", "evaluation.setup": "-ap 0.2",
            "item.ranking": "on -topN 10", "num.factors": "16", "num.max.epoch": "2",
            "batch_size": "64", "learnRate": "-init 0.05 -max 1",
            "reg.lambda": "-u 0.001 -i 0.001 -b 0.1 -s 0.1", "seed": "7", "parallel.setup": MESH}
    confs = {}
    for name, args in (("LightGCN", "-n_layer 2"), ("BUIR", "-n_layer 2 -tau 0.99 -drop_rate 0.2")):
        conf = dict(base, **{"model.name": name, name: args,
                             "output.setup": f"on -dir {tmp / name / 'out'}/"})
        ckpt = f"on -dir {tmp / name / 'ckpt'} -every 1"
        saved = str(tmp / name / "saved" / "model")
        confs[f"{name}-unbroken"] = conf
        confs[f"{name}-stopped"] = dict(conf, **{"num.max.epoch": "1", "checkpoint.setup": ckpt})
        confs[f"{name}-resumed"] = dict(conf, **{"checkpoint.setup": ckpt,
                                                 "model.setup": f"-save {saved}"})
        confs[f"{name}-loaded"] = dict(conf, **{"model.setup": f"-load {saved}"})
    cv = dict(base, **{"model.name": "LightGCN", "LightGCN": "-n_layer 2", "num.max.epoch": "1"})
    for label, setup in (("cv", "-cv 2"), ("cv -p", "-cv 2 -p")):
        confs[label] = dict(cv, **{"evaluation.setup": setup,
                                   "output.setup": f"on -dir {tmp / label.replace(' ', '')}/"})
    return confs


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The JAX package's runs, the port's in one process, the port's on
    four ranks (with the lifecycle) and MHCN's on three."""
    cases, jax_runs = {}, {}
    for label in FITS:
        cases[label], jax_runs[label] = _case(label)
    one = {label: R.fit_case(case) for label, case in cases.items()}
    on_mesh = {label: dict(case, conf=dict(case["conf"], **{"parallel.setup": MESH}))
               for label, case in cases.items()}
    tmp = tmp_path_factory.mktemp("social4")
    four = R.spawn(R.social, 4, tmp, on_mesh, _lifecycle_confs(tmp))
    conf = dict(cases["MHCN"]["conf"], **{"parallel.setup": "on"})
    three = R.spawn(R.social, 3, tmp_path_factory.mktemp("social3"),
                    {"MHCN": dict(cases["MHCN"], conf=conf)}, None)
    return jax_runs, one, {4: four, 3: three}, tmp


WORLD_FITS = [(4, label) for label in FITS] + [(3, "MHCN")]


@pytest.mark.parametrize("world,label", WORLD_FITS,
                         ids=[f"{label}-{world}ranks" for world, label in WORLD_FITS])
def test_social_models_train_on_the_mesh_as_one_process_and_jax(trained, world, label):
    """Three epochs on the JAX sampler's batches and draws: each data rank's
    share of the first step's loss sums to one process's, the losses and
    tables (BUIR's target too) stay within the drift bounds of one process
    and the JAX package, and the best epoch is one process's."""
    jax_run, one, ranks = trained[0][label], trained[1][label], trained[2][world]
    got = ranks[0]["fits"][label]
    model = 2 if world == 4 else 1
    assert got["mesh"] == {"data": world // model, "model": model} and one["mesh"] is None
    if label == "SEPT":
        assert (got["adj"], one["adj"]) == ("ShardedDenseJoint", "DenseJoint")
    first = sum(r["fits"][label]["first_loss"] for r in ranks[::model])
    np.testing.assert_allclose(first, one["first_loss"], rtol=1e-5)
    if world // model > 1:  # the shares differ: each rank sums only its rows
        assert ranks[0]["fits"][label]["first_loss"] != ranks[model]["fits"][label]["first_loss"]
    np.testing.assert_allclose(got["losses"], one["losses"], rtol=1e-3)
    np.testing.assert_allclose(got["losses"], jax_run["losses"], rtol=1e-3)
    assert got["best"] == one["best"]
    want = jax_run["tables"][(got["best"] or len(got["losses"])) - 1]
    # DHCF's DenseMat hypergraphs: the one-process port parts from the JAX
    # package's tables by 2.2e-4 in three epochs at lr 0.001 (a flipped
    # bf16 rounding), and the mesh by the same; held at the bf16 bound there
    jax_bound = BF16 if label == "DHCF-dense" else {"atol": 1e-4}
    for key, value in got["params"].items():
        np.testing.assert_allclose(value, one["params"][key], atol=1e-4, err_msg=key)
        np.testing.assert_allclose(value, want[key], **jax_bound, err_msg=key)
    if label.startswith("BUIR"):
        for key in ("user_emb", "item_emb"):
            buf = got["buffers"][f"target.{key}"]
            np.testing.assert_allclose(buf, one["buffers"][f"target.{key}"], atol=1e-4, err_msg=key)
            np.testing.assert_allclose(buf, jax_run["target"][key], atol=1e-4, err_msg=key)
    np.testing.assert_allclose(got["U"], one["U"], atol=1e-4)
    np.testing.assert_allclose(got["V"], one["V"], atol=1e-4)


@pytest.mark.parametrize("world,label", WORLD_FITS,
                         ids=[f"{label}-{world}ranks" for world, label in WORLD_FITS])
def test_social_first_step_gradients_match_one_process(trained, world, label):
    """The gradient invariant: after the step's reduction over ``data``,
    every parameter's gradient on every rank is one process's, within the
    one-process port's f32 bound against the JAX package."""
    one, ranks = trained[1][label], trained[2][world]
    for rank in ranks:
        grads = rank["fits"][label]["grads"]
        assert sorted(grads) == sorted(one["grads"])
        for key, ref in one["grads"].items():
            _close_f32(grads[key], ref)


@pytest.mark.parametrize("world", [4, 3])
def test_social_ranks_stay_equal_bit_for_bit(trained, world):
    ranks = trained[2][world]
    labels = list(FITS) if world == 4 else ["MHCN"]
    for label in labels:
        _same_on_every_rank([{k: r["fits"][label][k] for k in
                              ("losses", "params", "buffers", "U", "V", "grads", "best")}
                             for r in ranks])


# ---------------------------------------------------------------------------
# the units: the step's reduction and the row ranges
# ---------------------------------------------------------------------------


def test_reduce_gradients_carries_a_gradient_only_data_rank_0_holds(trained):
    """``b`` reaches the loss on data rank 0 alone, ``c`` on none: after the
    reduction every rank holds one process's gradients (``a`` summed over
    the two data ranks, ``b`` rank 0's, ``c`` still None)."""
    ranks = trained[2][4]
    assert [r["none_gradients"]["held"] for r in ranks] == [
        (True, True, False), (True, True, False), (True, False, False), (True, False, False)]
    for r in ranks:
        got = r["none_gradients"]
        np.testing.assert_array_equal(got["a"], np.full((2, 3), 3.0, np.float32))
        np.testing.assert_array_equal(got["b"], (2 * torch.linspace(-1.0, 1.0, 4)).numpy())
        assert got["c"] is None


def _rng_views(n, d, seed):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(n, d).astype(np.float32)) for _ in range(4)]


@pytest.mark.parametrize("parts", [2, 3, 4])
def test_mhcn_channel_mim_sums_over_row_ranges(parts):
    """The term summed over ``torch.tensor_split``'s row blocks is the whole
    term within f32 rounding; the readout is every row's mean."""
    n, d = 23, 6
    em, edge, _, _ = _rng_views(n, d, parts)
    g = torch.Generator().manual_seed(parts)
    perms = (torch.randperm(n, generator=g),
             (torch.randperm(d, generator=g), torch.randperm(n, generator=g)),
             (torch.randperm(d, generator=g), torch.randperm(n, generator=g)))
    whole = mhcn_channel_mim(em, edge, perms)
    assert torch.equal(mhcn_channel_mim(em, edge, perms, (0, n)), whole)
    shares = [mhcn_channel_mim(em, edge, perms, split_range(n, parts, k)) for k in range(parts)]
    np.testing.assert_allclose(sum(s.item() for s in shares), whole.item(), rtol=1e-6)
    assert len({s.item() for s in shares}) == parts


@pytest.mark.parametrize("parts", [2, 3, 4])
def test_sept_neighbor_ssl_sums_over_row_ranges(parts):
    """SEPT's neighbour discrimination over the row blocks of a padded user
    list (pad slots masked) sums to the whole term within f32 rounding."""
    n, d = 19, 5
    aug, friend, share, rec = (_l2n(x) for x in _rng_views(n, d, 10 + parts))
    um = torch.ones(n)
    um[-4:] = 0.0
    whole = sept_neighbor_ssl(aug, friend, share, rec, um, 3)
    assert torch.equal(sept_neighbor_ssl(aug, friend, share, rec, um, 3, (0, n)), whole)
    shares = [sept_neighbor_ssl(aug, friend, share, rec, um, 3, split_range(n, parts, k))
              for k in range(parts)]
    np.testing.assert_allclose(sum(s.item() for s in shares), whole.item(), rtol=1e-6)


# ---------------------------------------------------------------------------
# the lifecycle on four ranks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["LightGCN", "BUIR"])
def test_stopped_and_resumed_mesh_run_repeats_the_unbroken_one(trained, name):
    """Stopped after epoch 1 under ``checkpoint.setup -every 1`` and resumed
    to 2: the losses, factors, measures and BUIR's target buffers equal the
    unbroken mesh run's bit for bit on every rank; rank 0 alone wrote the
    step files."""
    ranks = trained[2][4]
    for r, rank in enumerate(ranks):
        life = rank["lifecycle"]
        unbroken, stopped, resumed = (life[f"{name}-{k}"] for k in ("unbroken", "stopped",
                                                                    "resumed"))
        assert resumed["mesh"] == {"data": 2, "model": 2}
        assert (stopped["resumed"], resumed["resumed"]) == (None, 1)
        assert stopped["losses"] == unbroken["losses"][:1]
        assert resumed["losses"] == unbroken["losses"][1:]
        assert resumed["measure"] == unbroken["measure"]
        for key in ("U", "V"):
            np.testing.assert_array_equal(resumed[key], unbroken[key])
        assert sorted(resumed["buffers"]) == (
            ["target.item_emb", "target.user_emb"] if name == "BUIR" else [])
        for key, value in unbroken["buffers"].items():
            np.testing.assert_array_equal(resumed["buffers"][key], value)
        written = [step for d, step in life["steps"] if d.endswith(f"/{name}/ckpt")]
        assert written == ([] if r else [1, 2]), (r, life["steps"])
    # every rank wrote one model's steps to one shared directory, rank 0 only
    assert sorted(p.name for p in (trained[3] / name / "ckpt").iterdir()) == [
        "step_1.pt", "step_2.pt"]


@pytest.mark.parametrize("name", ["LightGCN", "BUIR"])
def test_saved_model_loads_on_the_mesh(trained, name):
    """Rank 0 alone writes the ``-save`` npz; a ``-load`` of it on the four
    ranks gives the saving run's measures and factors."""
    ranks = trained[2][4]
    for r, rank in enumerate(ranks):
        life = rank["lifecycle"]
        saved = [p for p in life["savez"] if f"/{name}/saved/" in p]
        assert saved == ([] if r else [str(trained[3] / name / "saved" / "model")]), (r, saved)
        loaded, resumed = life[f"{name}-loaded"], life[f"{name}-resumed"]
        assert loaded["measure"] == resumed["measure"] and loaded["losses"] == []
        np.testing.assert_array_equal(loaded["U"], resumed["U"])
        np.testing.assert_array_equal(loaded["V"], resumed["V"])


def test_cross_validation_with_p_runs_its_folds_in_turn_on_the_mesh(trained):
    """``-cv 2 -p`` on the mesh gives ``-cv 2``'s summary on every rank, and
    rank 0 alone writes its summary file."""
    ranks = trained[2][4]
    for rank in ranks:
        life = rank["lifecycle"]
        assert life["cv -p"]["mesh"] == {"data": 2, "model": 2}
        assert life["cv -p"]["measure"] == life["cv"]["measure"]
    parsed = metrics.parse_measure(ranks[0]["lifecycle"]["cv -p"]["measure"])["Top 10"]
    assert 0 <= parsed["Recall"] <= 1
    summaries = [p.name for p in (trained[3] / "cv-p").iterdir() if p.name.endswith("-2-fold-cv.txt")]
    assert len(summaries) == 1
