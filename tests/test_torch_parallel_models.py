"""Slice 7d of the port on the CPU: the own-loop, ALS and untrained models
(CFGAN, IRGAN, RSGAN, IF_BPR, WRMF, ExpoMF, CoFactor, SERec, UserMean,
ItemMean, MostPopular, Rand, UserKNN, ItemKNN, SlopeOne) on gloo groups of
spawned ranks (``test_torch_parallel_ranks.py``), and the mesh that forms
by itself on a CUDA device under a launcher (``parallel/mesh.mesh_wanted``).

Each model runs its ``config/`` file at a small size (d=8, 2 epochs, batch
64, 10 neighbours; IF_BPR's walks as small as ``tests/test_torch_ifbpr.py``
keeps them) through ``QRec(conf).execute()`` under ``parallel.setup=on
-model 2`` on four ranks (data 2 x model 2), in one process of the port
and, for WRMF, CoFactor, MostPopular and the five rating models, in the JAX
package's session on the same split. WRMF and CoFactor start from the JAX
package's ``x`` and ``y`` (``init_tables`` replaced, as
``tests/test_torch_als.py`` does). The ranked models use planted blocks
(40 users, two blocks of 15 items, 10 a user; 35 test users), the rating
models 40 users' integer ratings of 30 items (8 a user).

Bounds. Every rank against one process of the port: equal bit for bit
(tables, scores buffer, predictions, losses, lists and measure lines):
the ranks run the same code on the same numbers with no collective in
the loop, and the ranking's gather moves bits unchanged. Against the JAX
package: every test user's top-10 ids equal; WRMF's and CoFactor's final
tables within rtol 1e-3 and atol 1e-4 of the table's largest entry after
two epochs (the bound of ROADMAP Queue 3 item 32 for three);
MostPopular's scores and the mean, KNN and SlopeOne predictions equal bit
for bit (item 32), with their measure lines."""

import os
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import test_torch_parallel_ranks as R
from qrec_tpu import config as jconfig
from qrec_tpu.runtime.session import QRec as JQRec
from qrec_tpu_torch import ModelConf
from qrec_tpu_torch.data.dataset import Interactions
from qrec_tpu_torch.data.social import SocialGraph
from qrec_tpu_torch.models import get_model
from qrec_tpu_torch.parallel import mesh as M
from qrec_tpu_torch.parallel.collectives import split_range, split_sizes
from test_torch_als import _jax_uniform_tables

CONFIG = Path(__file__).resolve().parents[1] / "config"
WORLD = 4
RANKED = ["MostPopular", "Rand", "WRMF", "ExpoMF", "CoFactor", "SERec", "CFGAN", "IRGAN",
          "IF_BPR", "RSGAN"]
RATED = ["UserMean", "ItemMean", "UserKNN", "ItemKNN", "SlopeOne"]
MODELS = RANKED + RATED
# ranked whole on every rank: a score block (CFGAN) and random scores (Rand)
WHOLE = ("CFGAN", "Rand")
# held to the JAX package; WRMF and CoFactor start from its x and y (the
# number of keys its fit splits)
JAX_CASES = ["WRMF", "CoFactor", "MostPopular"] + RATED
JAX_KEYS = {"WRMF": 2, "CoFactor": 3}
# the route-7 models also run on three ranks (data 3 x model 1)
THREE = ["WRMF", "MostPopular", "IRGAN"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One thread, as every spawned rank runs, before the module's runs: the
    CPU's sums take another order on more threads."""
    torch.set_num_threads(1)


def _write_files(tmp: Path) -> dict:
    """The planted-block file with its trust links (tests/test_torch_ifbpr.py's
    ``_rows``) and the rating file."""
    rng = np.random.RandomState(0)
    (tmp / "ranked.txt").write_text("".join(
        f"u{u} i{i} 1\n" for u in range(40)
        for i in rng.choice(15, size=10, replace=False) + (0 if u < 20 else 15)))
    trust = [f"u{u} u{f} 1\n" for u in range(40)
             for f in rng.choice(20, size=4, replace=False) + (0 if u < 20 else 20) if f != u]
    trust += [f"u{u} u{u + 1} 1\nu{u + 1} u{u} 1\n" for u in range(0, 40, 2)]
    (tmp / "trust.txt").write_text("".join(trust))
    rng = np.random.RandomState(1)
    (tmp / "rated.txt").write_text("".join(
        f"u{u} i{i} {rng.randint(1, 6)}\n" for u in range(40)
        for i in rng.choice(30, size=8, replace=False)))
    return {"ranked": str(tmp / "ranked.txt"), "rated": str(tmp / "rated.txt"),
            "trust": str(tmp / "trust.txt"), "out": str(tmp / "out")}


def _conf(name: str, files: dict, out_dir: str, setup="on -model 2") -> dict:
    """``config/<name>.conf`` at the test's size, writing under ``out_dir``;
    ``setup`` None leaves ``parallel.setup`` out."""
    conf = ModelConf(str(CONFIG / f"{name}.conf"))
    extra = {"ratings": files["rated" if name in RATED else "ranked"],
             "evaluation.setup": "-ap 0.2", "num.factors": "8", "num.max.epoch": "2",
             "batch_size": "64", "num.neighbors": "10", "seed": "7",
             "output.setup": f"on -dir {out_dir}"}
    if conf.contains("social"):
        extra.update({"social": files["trust"], "social.setup": "-columns 0 1 2"})
    if name == "IF_BPR":
        extra["IF_BPR"] = "-L 20 -l 16 -w 5 -k 10 -a 0.1 -ep 10 -neg 3 -r 0.2"
    if name == "CoFactor":
        extra["CoFactor"] = "-k 2 -gamma 0.1 -filter 1"
    if setup is not None:
        extra["parallel.setup"] = setup
    out = dict(conf.config)
    out.update(extra)
    return out


def _top_lists(out_dir: str) -> dict:
    """{user: [item, ...]} of the top-N list file under ``out_dir``."""
    (path,) = [p for p in Path(out_dir).iterdir() if "-top-" in p.name]
    lines = path.read_text().splitlines()[1:]
    return {line.split(":")[0]: re.findall(r"\(([^,()]+),", line) for line in lines}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return _write_files(tmp_path_factory.mktemp("slice7d"))


@pytest.fixture(scope="module")
def jax_runs(files):
    """The JAX package's session of each ``JAX_CASES`` model (seed 3: the
    port's split): its model, measures and top-10 lists."""
    out = {}
    for name in JAX_CASES:
        out_dir = os.path.join(files["out"], "jax", name)
        conf = _conf(name, files, out_dir, setup=None)
        rec = JQRec(jconfig.ModelConf(conf), seed=3)
        measure = rec.execute()
        out[name] = {"model": rec.model, "measure": measure, "test": rec.test_data,
                     "lists": _top_lists(out_dir) if name in RANKED else None}
    return out


def _inits(jax_runs) -> dict:
    return {name: _jax_uniform_tables(jax_runs[name]["model"], keys)
            for name, keys in JAX_KEYS.items()}


@pytest.fixture(scope="module")
def runs(files, jax_runs):
    """One process of the port and four ranks, every model, then on the four
    ranks WRMF saved and loaded (one path every rank shares) and
    MostPopular asked to save."""
    inits = _inits(jax_runs)
    one = {}
    for name in MODELS:
        conf = _conf(name, files, os.path.join(files["out"], "one", name))
        one[name] = R.replicated_run(conf, inits.get(name))
    cases = {name: (dict(_conf(name, files, ""), out_dir=os.path.join(files["out"], "four")),
                    inits.get(name)) for name in MODELS}
    saved = os.path.join(files["out"], "saved", "wrmf")
    life_dir = os.path.join(files["out"], "life")
    lifecycle = {
        "WRMF-save": dict(_conf("WRMF", files, life_dir), **{"model.setup": f"-save {saved}"}),
        "WRMF-load": dict(_conf("WRMF", files, life_dir), **{"model.setup": f"-load {saved}"}),
        "MostPopular-save": dict(_conf("MostPopular", files, life_dir),
                                 **{"model.setup": f"-save {saved}-popular"}),
    }
    store = Path(files["out"]) / "store4"
    store.mkdir(parents=True)
    four = R.spawn(R.replicated, WORLD, store, cases, lifecycle)
    return {"one": one, "four": four, "saved": saved}


@pytest.fixture(scope="module")
def three(files, jax_runs):
    """``THREE`` on three ranks under ``parallel.setup=on`` (data 3 x model
    1: 35 test users cut 12, 12, 11)."""
    inits = _inits(jax_runs)
    cases = {name: (dict(_conf(name, files, "", setup="on"),
                         out_dir=os.path.join(files["out"], "three")), inits.get(name))
             for name in THREE}
    store = Path(files["out"]) / "store3"
    store.mkdir(parents=True)
    return R.spawn(R.replicated, 3, store, cases, {})


def _equal(a, b, where):
    """The same nested values, arrays bit for bit."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), where
        for k in a:
            _equal(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for n, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{where}/{n}")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), where
    else:
        assert a == b, where


# what every rank must hold as one process does (the files and the K2
# calls are checked apart)
HELD = ("measure", "params", "buffers", "tables", "U", "V", "item_bias", "predictions",
        "losses", "thresholds", "ranked")


# ---------------------------------------------------------------------------
# the 15 models on four ranks against one process
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", MODELS)
def test_every_rank_equals_one_process_bit_for_bit(runs, name):
    """The mesh forms on the four ranks (and none in one process), and every
    rank's tables (or scores buffer, or predictions), losses, lists and
    measure lines are one process's bits."""
    one = runs["one"][name]
    assert one["mesh"] is None
    for rank, got in enumerate(runs["four"]):
        assert got[name]["mesh"] == {"data": 2, "model": 2}, rank
        for key in HELD:
            _equal(got[name][key], one[key], f"rank {rank} {name} {key}")
    # the run held something to compare
    held = one["params"] or one["buffers"] or one["tables"] or one["predictions"] is not None
    assert held or name == "Rand"
    if name in RANKED:
        assert len(one["ranked"]) == 1 and one["ranked"][0][0].shape == (35, 10)


@pytest.mark.parametrize("name", MODELS)
def test_only_rank_0_writes_the_result_files(runs, name):
    """The list (or rating-predictions) file and the measure file, on rank
    0 alone; the same names as one process's but for their timestamps."""
    files = [got[name]["files"] for got in runs["four"]]
    assert [len(f) for f in files] == [2, 0, 0, 0]
    suffix = lambda f: f.split("@")[1][len("2026-01-01 00-00-00"):]  # noqa: E731
    assert sorted(map(suffix, files[0])) == sorted(map(suffix, runs["one"][name]["files"]))


@pytest.mark.parametrize("name", MODELS)
def test_k2_calls_cover_this_ranks_share(runs, name):
    """A ranked ``ScoreForm`` calls K2 (its plain twin here) once a ranking
    on each rank, on exactly this rank's ``tensor_split`` share of the test
    users, in order (``ceil(share / eval_batch_size)`` = 1 call at 35
    users); CFGAN's score block and Rand's draws make no K2 call and rank
    whole, as the rating runs make none."""
    one = runs["one"][name]["k2_calls"]
    calls = [got[name]["k2_calls"] for got in runs["four"]]
    if name in WHOLE or name in RATED:
        assert one == [] and calls == [[]] * WORLD
        return
    (users,) = one
    assert len(users) == 35
    for rank, got in enumerate(calls):
        s0, s1 = split_range(len(users), WORLD, rank)
        assert len(got) == 1, rank
        np.testing.assert_array_equal(got[0], users[s0:s1])
    assert [len(c[0]) for c in calls] == split_sizes(35, WORLD) == [9, 9, 9, 8]


@pytest.mark.parametrize("name", THREE)
def test_three_ranks_cut_the_test_users_unevenly(three, runs, name):
    """On three ranks (data 3 x model 1) each rank calls K2 once on its 12,
    12 or 11 test users, and every rank holds one process's bits."""
    one = runs["one"][name]
    users = one["k2_calls"][0]
    for rank, got in enumerate(three):
        assert got[name]["mesh"] == {"data": 3, "model": 1}
        s0, s1 = split_range(len(users), 3, rank)
        assert len(got[name]["k2_calls"]) == 1
        np.testing.assert_array_equal(got[name]["k2_calls"][0], users[s0:s1])
        for key in HELD:
            _equal(got[name][key], one[key], f"rank {rank} {name} {key}")
    assert [len(got[name]["k2_calls"][0]) for got in three] == [12, 12, 11]


# ---------------------------------------------------------------------------
# the slice against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", JAX_CASES)
def test_four_ranks_match_the_jax_package(files, runs, jax_runs, name):
    """Rank 0's top-10 lists equal the JAX package's for every test user
    (the ranked cases); WRMF's and CoFactor's final tables within item 32's
    bound; MostPopular's scores and the rating models' predictions and
    measures equal bit for bit."""
    got, want = runs["four"][0][name], jax_runs[name]
    jmodel = want["model"]
    if name in RANKED:
        lists = _top_lists(os.path.join(files["out"], "four", name, "rank0"))
        assert lists == want["lists"] and len(lists) == 35
    if name in JAX_KEYS:
        for key, table in (("U", jmodel.U), ("V", jmodel.V)):
            table = np.asarray(table)
            np.testing.assert_allclose(got[key], table, rtol=1e-3,
                                       atol=1e-4 * np.abs(table).max(), err_msg=key)
    if name == "MostPopular":
        _equal(got["buffers"]["scores"], np.asarray(jmodel.scores, dtype=np.float32), "scores")
        assert got["measure"] == want["measure"]
    if name in RATED:
        users = [e[0] for e in want["test"]]
        items = [e[1] for e in want["test"]]
        _equal(got["predictions"], np.asarray(jmodel.predict_ratings(users, items)),
               "predictions")
        assert got["measure"] == want["measure"]


# ---------------------------------------------------------------------------
# the lifecycle on four ranks
# ---------------------------------------------------------------------------


def test_wrmf_saves_on_rank_0_and_loads_on_every_rank(runs):
    """``-save``: rank 0 alone writes the one npz; ``-load`` on four ranks
    ranks to the saving run's measures with its factors, on every rank."""
    four = runs["four"]
    assert [got["savez"] for got in four] == [[runs["saved"]], [], [], []]
    assert os.path.exists(runs["saved"] + ".npz")
    for rank, got in enumerate(four):
        saved, loaded = got["WRMF-save"], got["WRMF-load"]
        assert loaded["measure"] == saved["measure"] == four[0]["WRMF-save"]["measure"], rank
        _equal(loaded["U"], saved["U"], f"rank {rank} U")
        _equal(loaded["V"], saved["V"], f"rank {rank} V")


def test_saving_a_model_without_factors_raises_on_every_rank(runs):
    """MostPopular's ``-save`` raises its RuntimeError on every rank before
    any barrier (ROADMAP Queue 3 item 44), so no rank waits on another."""
    for got in runs["four"]:
        assert "nothing to save" in got["MostPopular-save"]["raised"]
    assert not os.path.exists(runs["saved"] + "-popular.npz")


# ---------------------------------------------------------------------------
# item 55: the mesh forms by itself on a CUDA device under a launcher
# ---------------------------------------------------------------------------

LAUNCHERS = {
    "qrec": {"QREC_COORDINATOR": "host0:8476", "QREC_NUM_PROCESSES": "2",
             "QREC_PROCESS_ID": "1", "LOCAL_RANK": "1"},
    "torchrun": {"MASTER_ADDR": "localhost", "WORLD_SIZE": "4", "RANK": "3",
                 "LOCAL_RANK": "3"},
    "qrec-one": {"QREC_COORDINATOR": "host0:8476", "QREC_NUM_PROCESSES": "1",
                 "QREC_PROCESS_ID": "0"},
}
ENV_KEYS = ("QREC_COORDINATOR", "QREC_NUM_PROCESSES", "QREC_PROCESS_ID", "MASTER_ADDR",
            "WORLD_SIZE", "RANK", "LOCAL_RANK")


def _stub_group(monkeypatch, env: dict, group: int = 0):
    """The launcher's ``env`` set, ``init_process_group``, the world size,
    ``make_mesh`` and the card's device calls stubbed (as
    ``tests/test_torch_parallel.py`` stubs the group); ``group`` > 0 makes
    a default group of that many ranks already. Returns the groups joined
    and the devices set."""
    for key in ENV_KEYS:
        monkeypatch.delenv(key, raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    joined, devices = [], []
    world = group or M.launcher_world()

    def init(**kw):
        joined.append(kw)
        monkeypatch.setattr(M.dist, "is_initialized", lambda: True)

    monkeypatch.setattr(M.dist, "is_initialized", lambda: group > 0)
    monkeypatch.setattr(M.dist, "init_process_group", init)
    monkeypatch.setattr(M.dist, "get_world_size", lambda group=None: world)
    monkeypatch.setattr(M, "make_mesh", lambda model_parallel=None: ("mesh", world, model_parallel))
    monkeypatch.setattr(M.torch.cuda, "set_device", devices.append)
    monkeypatch.setattr(M.torch.cuda, "device_count", lambda: 8)
    return joined, devices


# (launcher, setting, device, a group already made) -> (mesh, group joined)
AUTO_CASES = {
    "absent-cuda-qrec": ("qrec", None, "cuda", 0, ("mesh", 2, None), "tcp://host0:8476"),
    "absent-cuda-torchrun": ("torchrun", None, "cuda", 0, ("mesh", 4, None), "env://"),
    "absent-cuda-group": (None, None, "cuda:0", 2, ("mesh", 2, None), None),
    "off-cuda-qrec": ("qrec", "off", "cuda", 0, None, None),
    "absent-cuda-one-process": ("qrec-one", None, "cuda", 0, None, None),
    "absent-cpu-qrec": ("qrec", None, "cpu", 0, None, None),
    "on-cpu-qrec": ("qrec", "on -model 1", "cpu", 0, ("mesh", 2, 1), "tcp://host0:8476"),
}


@pytest.mark.parametrize("case", list(AUTO_CASES))
def test_mesh_forms_by_itself_on_cuda_under_a_launcher(monkeypatch, case):
    """``mesh_from_config`` with ``parallel.setup`` absent: a CUDA process
    under a launcher naming more than one process (the ``QREC_*`` triplet
    or torchrun's) joins the group, takes ``cuda:{LOCAL_RANK}`` and builds
    the default mesh, as does one in a default group of more than one rank;
    ``parallel.setup=off``, a launcher of one process and the CPU build
    none and join nothing (the JAX package's automatic mesh is TPU-only);
    ``on`` keeps its meaning on the CPU."""
    launcher, setting, device, group, mesh, joined_at = AUTO_CASES[case]
    joined, devices = _stub_group(monkeypatch, LAUNCHERS.get(launcher, {}), group)
    conf = ModelConf({"model.name": "WRMF"} if setting is None else
                     {"model.name": "WRMF", "parallel.setup": setting})
    assert M.mesh_from_config(conf, device) == mesh
    assert M.mesh_wanted(conf, device)[0] == (mesh is not None)
    if joined_at is None:
        assert joined == [] and devices == []
    else:
        backend = "nccl" if device.startswith("cuda") else "gloo"
        assert [(j["backend"], j["init_method"]) for j in joined] == [(backend, joined_at)]
        assert devices == ([int(LAUNCHERS[launcher]["LOCAL_RANK"])] if backend == "nccl" else [])


def _tiny_model(name: str):
    """``name`` on a small planted split on the CPU (a social model with its
    trust links)."""
    rng = np.random.RandomState(0)
    records = [[f"u{u}", f"i{i}", 1.0] for u in range(12) for i in rng.choice(10, 4, replace=False)]
    conf = {"ratings": "unused", "ratings.setup": "-columns 0 1 2", "model.name": name,
            "evaluation.setup": "-ap 0.2", "item.ranking": "on -topN 5", "num.factors": "4",
            "num.max.epoch": "1", "batch_size": "8", "learnRate": "-init 0.01 -max 1",
            "reg.lambda": "-u 0.01 -i 0.01 -b 0.1 -s 0.1", "output.setup": "off -dir ./r/",
            "CDAE": "-co 0.8 -nh 8", "APR": "-eps 0.5 -regA 1 -advEpoch 1"}
    data = Interactions(ModelConf(conf), records[:40], records[40:])
    cls = get_model(name)
    kwargs = {}
    if cls.requires_social:
        kwargs["social"] = SocialGraph([[f"u{u}", f"u{(u + 1) % 12}", 1.0] for u in range(12)],
                                       data)
    return cls(ModelConf(conf), data, device="cpu", **kwargs)


@pytest.mark.parametrize("name", ["DMF", "CDAE", "APR", "NeuMF", "WRMF", "MostPopular"])
def test_a_launcher_refuses_and_admits_as_parallel_setup_on_does(monkeypatch, name):
    """Under a launcher of two processes with ``parallel.setup`` absent, on
    a CUDA device (the stubbed group of
    :func:`test_mesh_forms_by_itself_on_cuda_under_a_launcher`), every
    model gets the mesh, as under ``parallel.setup=on``: four that train
    data-parallel (DMF, CDAE, APR and NeuMF) and two that train whole on
    every rank (WRMF, MostPopular)."""
    model = _tiny_model(name)
    _stub_group(monkeypatch, LAUNCHERS["qrec"])
    model.device = torch.device("cuda")
    assert model.mesh == ("mesh", 2, None)


def test_no_mesh_on_the_cpu_without_the_setting(files, runs, tmp_path):
    """Two gloo ranks on the CPU with ``parallel.setup`` absent build no mesh,
    as the JAX package builds none off its accelerator: each rank ranks
    every test user itself (one K2 call on all 35) to one process's bits;
    rank 0 of the group alone writes."""
    case = (dict(_conf("MostPopular", files, "", setup=None), out_dir=str(tmp_path / "out")),
            None)
    out = R.spawn(R.replicated, 2, tmp_path, {"MostPopular": case}, {})
    one = runs["one"]["MostPopular"]
    for rank, got in enumerate(out):
        got = got["MostPopular"]
        assert got["mesh"] is None
        (users,) = got["k2_calls"]
        np.testing.assert_array_equal(users, one["k2_calls"][0])
        for key in HELD:
            _equal(got[key], one[key], f"rank {rank} {key}")
    assert [len(got["MostPopular"]["files"]) for got in out] == [2, 0]
