"""The port's model lifecycle on the CPU: ``model.setup=-save/-load``,
``checkpoint.setup`` resume and the profiler trace, against the JAX package
where it has the same surface.

* ``-save`` then ``-load`` reproduces the measure lines exactly (BPR,
  LightGCN factored at d=8, SVD rated and ranked, SVD++, EE, IRGAN);
* an npz written by the JAX package's ``-save`` loads in the port with the
  JAX package's own ``-load`` ranked lists and measure lines, and the
  reverse (BPR, LightGCN, SVD);
* the departures: the JAX package's loaded SVD++ and IRGAN fail where the
  port's rank with their saved biases; NeuMF, which has no factors, refuses
  to save in both packages;
* a run stopped and resumed under ``checkpoint.setup`` ends with factors,
  losses and (SimGCL) best epoch bit-identical to an unbroken run, in the
  bold mode (PMF, as the JAX package's tests/test_runtime_aux.py) and under
  Adam (BPR with ``-tf``, LightGCN, SimGCL);
* NeuMF's three phases save distinct steps;
* ``trace()`` writes a Chrome trace file.

Data: 30 users rating 8 of 20 items (1-5), split ``-ap 0.2``, the same
file in both packages.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from qrec_tpu import QRec as JQRec
from qrec_tpu.config import ModelConf as JModelConf
from qrec_tpu_torch import ModelConf, QRec
from qrec_tpu_torch.data.dataset import Interactions
from qrec_tpu_torch.models import get_model
from qrec_tpu_torch.runtime import checkpoint as C
from qrec_tpu_torch.runtime.profiling import trace

CONFIG = Path(__file__).resolve().parents[1] / "config"
SMALL = {"num.factors": "8", "batch_size": "32", "evaluation.setup": "-ap 0.2", "seed": "11"}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def ratings(tmp_path):
    rng = np.random.RandomState(0)
    path = tmp_path / "ratings.txt"
    path.write_text("".join(f"u{u} i{i} {rng.randint(1, 6)}\n"
                            for u in range(30) for i in rng.choice(20, size=8, replace=False)))
    return path


def _conf(name, ratings, tmp_path, epochs=3, **extra):
    conf = dict(ModelConf(str(CONFIG / f"{name}.conf")).config)
    conf.update(SMALL, ratings=str(ratings), **{"num.max.epoch": str(epochs)})
    conf["output.setup"] = f"on -dir {tmp_path / 'out'}/"
    if name == "LightGCN":
        conf["graph.dense.quant"] = "factored"
    conf.update(extra)
    return conf


def _top_lists(tmp_path):
    """The top-N list file of the last ranked run, without its timestamp."""
    files = sorted((tmp_path / "out").glob("*-top-*items*.txt"), key=lambda p: p.stat().st_mtime)
    return files[-1].read_text()


def _port(conf, device="cpu"):
    rec = QRec(ModelConf(conf), device=device)
    return rec.execute(), rec.model


# ---------------------------------------------------------------------------
# -save / -load
# ---------------------------------------------------------------------------

ROUND_TRIP = [
    ("BPR", {}), ("LightGCN", {}), ("SVD", {}), ("SVD", {"item.ranking": "on -topN 5"}),
    ("SVD++", {}), ("SVD++", {"item.ranking": "on -topN 5"}), ("EE", {}), ("IRGAN", {}),
]


@pytest.mark.parametrize("name,extra", ROUND_TRIP)
def test_save_then_load_repeats_the_measures(tmp_path, ratings, name, extra):
    path = str(tmp_path / "saved" / "model")
    want, fitted = _port(_conf(name, ratings, tmp_path, **{"model.setup": f"-save {path}"}, **extra))
    assert (tmp_path / "saved" / "model.npz").exists()
    got, loaded = _port(_conf(name, ratings, tmp_path, **{"model.setup": f"-load {path}"}, **extra))
    assert got == want and len(got) > 0
    assert loaded.timer is None  # -load replaces fit
    torch.testing.assert_close(loaded.U, fitted.U, rtol=0, atol=0)
    torch.testing.assert_close(loaded.V, fitted.V, rtol=0, atol=0)
    with np.load(path + ".npz") as z:
        keys = sorted(z.files)
    extras = {"SVD": ["item_bias", "user_bias"], "SVD++": ["item_bias", "user_bias"],
              "EE": ["item_bias", "user_bias"], "IRGAN": ["item_bias"]}.get(name, [])
    assert keys == sorted(["U", "V", *extras])


def test_every_fold_saves_the_same_path_and_a_missing_file_raises(tmp_path, ratings):
    path = str(tmp_path / "m.npz")
    conf = _conf("BPR", ratings, tmp_path, epochs=1, **{"model.setup": f"-save {path}",
                                                          "evaluation.setup": "-cv 2"})
    rec = QRec(ModelConf(conf), device="cpu")
    rec.execute()
    with np.load(path) as z:
        np.testing.assert_array_equal(z["U"], rec.model.U.numpy())  # the last fold's
    with pytest.raises(FileNotFoundError):
        _port(_conf("BPR", ratings, tmp_path, **{"model.setup": f"-load {tmp_path / 'none'}"}))


def test_save_before_fit_and_a_foreign_shape_raise(tmp_path, ratings):
    conf = ModelConf(_conf("BPR", ratings, tmp_path))
    rec = QRec(conf, device="cpu")
    model = get_model("BPR")(conf, Interactions(conf, rec.training_data, rec.test_data), device="cpu")
    with pytest.raises(RuntimeError, match="nothing to save"):
        model.save_model(str(tmp_path / "x"))
    np.savez(tmp_path / "wrong.npz", U=np.zeros((3, 8), np.float32), V=np.zeros((20, 8), np.float32))
    with pytest.raises(ValueError, match="3 users"):
        model.load_model(str(tmp_path / "wrong"))


def test_neumf_has_no_factors_to_save_in_either_package(tmp_path, ratings):
    conf = _conf("NeuMF", ratings, tmp_path, epochs=1, **{"model.setup": f"-save {tmp_path / 'n'}"})
    with pytest.raises(RuntimeError, match="nothing to save"):
        _port(conf)
    with pytest.raises(RuntimeError, match="nothing to save"):
        JQRec(JModelConf(conf)).execute()


@pytest.mark.parametrize("name,extra", [("BPR", {}), ("LightGCN", {}), ("SVD", {}),
                                        ("SVD", {"item.ranking": "on -topN 5"})])
def test_npz_of_either_package_loads_in_the_other(tmp_path, ratings, name, extra):
    """The JAX package's ``-save`` file ranks in the port as in the JAX
    package's own ``-load`` (the same lists and measure lines), and the
    port's file in the JAX package as in the port."""
    jpath, tpath = str(tmp_path / "jax_model"), str(tmp_path / "port_model")
    ranked = _conf(name, ratings, tmp_path, **extra)
    JQRec(JModelConf(dict(ranked, **{"model.setup": f"-save {jpath}"}))).execute()
    _port(dict(ranked, **{"model.setup": f"-save {tpath}"}))
    ranking = ranked["item.ranking"].startswith("on")
    for path in (jpath, tpath):
        load = dict(ranked, **{"model.setup": f"-load {path}"})
        want = JQRec(JModelConf(load)).execute()
        want_lists = _top_lists(tmp_path) if ranking else None
        got, _ = _port(load)
        assert got == want
        if ranking:
            # the lists' scores print as each package's float32 sums; the
            # ids and hit marks agree
            strip = lambda text: [[p.split(",")[0] + p[-1:] for p in line.split(" (")[1:]]  # noqa: E731
                                  for line in text.splitlines()[1:]]
            assert strip(_top_lists(tmp_path)) == strip(want_lists)


@pytest.mark.parametrize("name", ["SVD++", "IRGAN"])
def test_jax_loaded_model_lacks_its_biases_where_the_port_saves_them(tmp_path, ratings, name):
    """Departure: the JAX package saves U and V alone for SVD++ (and EE,
    SREE, SocialFD) and IRGAN, and its loaded model has no biases to score
    with; the port saves them beside the factors and ranks with them."""
    extra = {"item.ranking": "on -topN 5"}
    jpath, tpath = str(tmp_path / "jax_model"), str(tmp_path / "port_model")
    JQRec(JModelConf(_conf(name, ratings, tmp_path, **extra, **{"model.setup": f"-save {jpath}"}))).execute()
    with np.load(jpath + ".npz") as z:
        assert sorted(z.files) == ["U", "V"]
    with pytest.raises(AttributeError):
        JQRec(JModelConf(_conf(name, ratings, tmp_path, **extra, **{"model.setup": f"-load {jpath}"}))).execute()
    with pytest.raises(ValueError, match="holds no"):
        _port(_conf(name, ratings, tmp_path, **extra, **{"model.setup": f"-load {jpath}"}))
    want, _ = _port(_conf(name, ratings, tmp_path, **extra, **{"model.setup": f"-save {tpath}"}))
    got, _ = _port(_conf(name, ratings, tmp_path, **extra, **{"model.setup": f"-load {tpath}"}))
    assert got == want


# ---------------------------------------------------------------------------
# checkpoint / resume
# ---------------------------------------------------------------------------

RESUME = [
    ("PMF", {"item.ranking": "off -topN 5"}),  # bold
    ("BPR", {"evaluation.setup": "-ap 0.2 -tf"}),  # Adam
    ("LightGCN", {}),
    ("SimGCL", {}),  # tracks the best epoch; draws its noise from the loop's generator
]


def _fit(conf, data):
    model = get_model(conf["model.name"])(conf, data, device="cpu")
    model.fit()
    return model


@pytest.mark.parametrize("name,extra", RESUME)
def test_stopped_and_resumed_run_repeats_the_unbroken_one(tmp_path, ratings, name, extra, capsys):
    ckpt = f"on -dir {tmp_path / 'ck'} -every 2"
    base = _conf(name, ratings, tmp_path, epochs=6, **extra)
    data_conf = ModelConf(base)
    rec = QRec(data_conf, device="cpu")
    data = Interactions(data_conf, rec.training_data, rec.test_data)
    unbroken = _fit(ModelConf(base), data)
    # stopped after epoch 3: the checkpoint of epoch 2 is the latest
    stopped = _fit(ModelConf(dict(base, **{"num.max.epoch": "3", "checkpoint.setup": ckpt})), data)
    assert C.Checkpointer(str(tmp_path / "ck")).steps() == [2]
    resumed = _fit(ModelConf(dict(base, **{"checkpoint.setup": ckpt})), data)
    assert "resumed from checkpoint step 2 (epoch 2/6)" in capsys.readouterr().out
    assert resumed.resumed_step == 2 and stopped.resumed_step is None
    assert stopped.epoch_losses == unbroken.epoch_losses[:3]
    assert resumed.epoch_losses == unbroken.epoch_losses[2:]
    assert torch.equal(resumed.U, unbroken.U) and torch.equal(resumed.V, unbroken.V)
    if unbroken.tracker is not None:
        assert resumed.tracker.best_epoch == unbroken.tracker.best_epoch
    assert C.Checkpointer(str(tmp_path / "ck")).steps() == [2, 4, 6]


def test_checkpointer_keeps_the_newest_and_writes_whole_files(tmp_path):
    ck = C.Checkpointer(str(tmp_path / "c"), max_to_keep=2)
    assert ck.latest_step() is None and ck.restore() is None
    for step in (1, 5, 3, 7):
        ck.save(step, {"x": torch.full((2,), float(step)), "lr": 0.5})
    assert ck.steps() == [5, 7] and ck.latest_step() == 7
    assert torch.equal(ck.restore()["x"], torch.full((2,), 7.0)) and ck.restore(5)["lr"] == 0.5
    assert not list((tmp_path / "c").glob("*.tmp"))
    conf = ModelConf({"checkpoint.setup": f"on -dir {tmp_path / 'd'}"})
    assert C.from_config(conf).directory == str(tmp_path / "d") and C.checkpoint_every(conf) == 10
    assert C.from_config(ModelConf({"checkpoint.setup": "off -dir x"})) is None
    assert C.from_config(ModelConf({})) is None and C.checkpoint_every(ModelConf({})) == 0


def test_neumf_phases_save_distinct_steps(tmp_path, ratings, monkeypatch):
    """NeuMF trains 5, 2 and 1 epochs in three phases; ``_epochs_done`` runs
    across them, so every epoch saves its own step (the JAX package's
    counter stays at 0: its later phases reuse the first phase's steps)."""
    saved = []
    real = C.Checkpointer.save
    monkeypatch.setattr(C.Checkpointer, "save", lambda self, step, state: saved.append(step)
                        or real(self, step, state))
    conf = _conf("NeuMF", ratings, tmp_path, epochs=5,
                 **{"checkpoint.setup": f"on -dir {tmp_path / 'ck'} -every 1"})
    _port(conf)
    assert saved == list(range(1, 9))
    assert C.Checkpointer(str(tmp_path / "ck")).steps() == [6, 7, 8]


def test_cross_validation_folds_keep_their_own_steps(tmp_path, ratings):
    conf = _conf("BPR", ratings, tmp_path, epochs=2,
                 **{"evaluation.setup": "-cv 2", "checkpoint.setup": f"on -dir {tmp_path / 'ck'} -every 1"})
    _port(conf)
    assert C.Checkpointer(str(tmp_path / "ck")).steps() == [1, 2]
    assert C.Checkpointer(str(tmp_path / "ck" / "fold_2")).steps() == [1, 2]


# ---------------------------------------------------------------------------
# trace
# ---------------------------------------------------------------------------


def test_trace_writes_a_chrome_trace(tmp_path, ratings):
    conf = ModelConf(_conf("BPR", ratings, tmp_path, epochs=1))
    rec = QRec(conf, device="cpu")
    with trace(str(tmp_path / "trace")) as prof:
        rec.execute()
    path = Path(prof.trace_path)
    assert path.parent == tmp_path / "trace" and path.exists()
    events = json.loads(path.read_text())["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)
