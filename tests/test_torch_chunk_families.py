"""``train.chunk`` for the social-graph and deep families in the PyTorch
port: MHCN, SEPT (both phases, one tracker), DiffNet, DHCF, NeuMF (three
phases), APR (two), DMF, CDAE and BUIR run ``train.chunk`` epochs a
dispatch through ``runtime/trainer.ChunkedLoop`` (MHCN and SEPT with the
device vote), bit for bit the per-epoch loop; the port on the JAX
package's batches and draws
under ``train.chunk=auto`` stays within the bounds of
``tests/test_torch_social_graph.py`` and ``tests/test_torch_deep.py``.

On the CPU a chunk runs its epochs as written; the CUDA graphs are checked
on a card (``chip_smoke.py`` and ``tests/test_torch_kernels_cuda.py``)."""

import inspect
import random
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from qrec_tpu.data.split import data_split
from qrec_tpu_torch import ModelConf
from qrec_tpu_torch.convert import params_from_jax
from qrec_tpu_torch.data.dataset import Interactions
from qrec_tpu_torch.data.social import SocialGraph
from qrec_tpu_torch.models import MODELS
from qrec_tpu_torch.runtime import trainer as T
from qrec_tpu_torch.runtime.adam import Adam
from tests import test_torch_deep as deep_tests
from tests import test_torch_social_graph as social_tests

SOCIAL = ("MHCN", "SEPT", "DiffNet", "DHCF")
DEEP = ("NeuMF", "APR", "DMF", "CDAE")
# epochs of each model's run: every phase of at least two epochs but
# NeuMF's, and a phase that chunks of 3 cut unevenly
EPOCHS = {"MHCN": 5, "SEPT": 7, "DiffNet": 4, "DHCF": 4, "NeuMF": 10, "APR": 6, "DMF": 4,
          "CDAE": 5, "BUIR": 3}
# the epochs of each phase of those runs
PHASES = {"MHCN": [5], "SEPT": [2, 5], "DiffNet": [4], "DHCF": [4], "NeuMF": [10, 5, 2],
          "APR": [3, 3], "DMF": [4], "CDAE": [5]}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _model(name, chunk, epochs=None, extra=None):
    """The port's model on the social tests' planted blocks and relation
    (BUIR and the social-graph family) or the deep tests' records."""
    extra = dict({"train.chunk": chunk, "num.max.epoch": str(epochs or EPOCHS[name])},
                 **(extra or {}))
    if name in DEEP:
        conf = ModelConf(deep_tests._conf(name, extra))
        train, test = deep_tests._records()
        return MODELS[name](conf, Interactions(conf, train, test), device="cpu")
    conf = ModelConf(social_tests._conf(name, dict(social_tests.COO, **extra)))
    records = [line.split()[:2] + [1.0] for line in social_tests._lines()[0]]
    train, test = data_split(records, 0.2, rng=random.Random(3))
    data = Interactions(conf, train, test)
    social = SocialGraph(social_tests._relation(), data) if name != "BUIR" else None
    return MODELS[name](conf, data, device="cpu", social=social)


def _outcome(model):
    """What a fit leaves: losses by phase, parameters, buffers, final
    factors and the tracker's best epoch, measures and parameters."""
    t = model.tracker
    best = None if t is None else (t.best_epoch, dict(t.best_metrics), t.epoch_offset,
                                   [b.detach().clone() for b in t.best_params])
    clone = lambda x: None if x is None else x.detach().clone()  # noqa: E731
    return dict(losses=[list(p) for p in model.phase_losses],
                params={k: v.detach().clone() for k, v in model.named_parameters()},
                buffers={k: v.detach().clone() for k, v in model.named_buffers()},
                U=clone(model.U), V=clone(model.V), best=best)


def _assert_same(got, want):
    assert got["losses"] == want["losses"]
    for part in ("params", "buffers"):
        assert got[part].keys() == want[part].keys()
        for k in want[part]:
            assert torch.equal(got[part][k], want[part][k]), k
    for k in ("U", "V"):
        assert (got[k] is None) == (want[k] is None)
        if want[k] is not None:
            assert torch.equal(got[k], want[k]), k
    assert (got["best"] is None) == (want["best"] is None)
    if want["best"] is not None:
        assert got["best"][:3] == want["best"][:3]
        assert all(torch.equal(a, b) for a, b in zip(got["best"][3], want["best"][3]))


_PER_EPOCH = {}


def _per_epoch(name):
    if name not in _PER_EPOCH:
        model = _model(name, "1")
        model.fit()
        assert all(t.captures == [] and {e for _, e in t.chunks} == {1}
                   for t in model.phase_timers)
        _PER_EPOCH[name] = _outcome(model)
    return _PER_EPOCH[name]


def _cut(epochs, chunk):
    """The chunks ``train`` cuts a phase into: per epoch for a phase of one."""
    if epochs == 1:
        return [1]
    return [min(chunk, epochs - k) for k in range(0, epochs, chunk)]


@pytest.mark.parametrize("name", SOCIAL + DEEP)
@pytest.mark.parametrize("chunk", ["3", "auto"])
def test_chunked_family_run_equals_per_epoch_bit_for_bit(name, chunk, capsys):
    """Losses of every phase, final parameters, buffers, factors and, for
    MHCN and SEPT, the best epoch, its measures and parameters: the same
    bits under ``train.chunk`` 3 and ``auto`` as under 1."""
    want = _per_epoch(name)
    model = _model(name, chunk)
    model.fit()
    _assert_same(_outcome(model), want)
    size = 8 if chunk == "auto" else 3
    assert [[e for _, e in t.chunks] for t in model.phase_timers] == [
        _cut(n, size) for n in PHASES[name]]
    assert all(t.captures == [] for t in model.phase_timers)  # no CUDA graph on the CPU
    assert "not applied" not in capsys.readouterr().out
    if name in ("MHCN", "SEPT"):
        assert model.tracker.epoch_offset == EPOCHS[name]


def test_sept_tracker_is_seeded_across_its_phases_and_written_back_once_each(monkeypatch):
    """SEPT chunked: the joint phase's device vote starts from what the
    warm-up's vote wrote back to the shared tracker (its best measures and
    epoch), numbers its epochs after the warm-up's, and each phase writes
    back once."""
    seeds, writes = [], []
    init, write_back = T.DeviceVote.__init__, T.DeviceVote.write_back

    def spy_init(self, params, tracker, next_epoch):
        seeds.append((None if tracker.best_metrics is None else dict(tracker.best_metrics),
                      tracker.best_epoch, next_epoch))
        init(self, params, tracker, next_epoch)

    def spy_write_back(self, tracker):
        write_back(self, tracker)
        writes.append((dict(tracker.best_metrics), tracker.best_epoch))

    monkeypatch.setattr(T.DeviceVote, "__init__", spy_init)
    monkeypatch.setattr(T.DeviceVote, "write_back", spy_write_back)
    model = _model("SEPT", "auto")
    model.fit()
    assert len(seeds) == 2 and len(writes) == 2
    assert seeds[0] == (None, None, 0)
    assert seeds[1] == (writes[0][0], writes[0][1], PHASES["SEPT"][0])
    assert writes[1] == (model.tracker.best_metrics, model.tracker.best_epoch)
    want = _per_epoch("SEPT")["best"]
    assert (model.tracker.best_epoch, model.tracker.best_metrics) == want[:2]


def test_neumf_pretraining_phases_leave_the_other_tower_unchanged(monkeypatch):
    """Chunked, NeuMF's GMF phase moves no MLP parameter and its MLP phase
    no GMF parameter: Adam skips a parameter without a gradient, though the
    chunked loop makes its state before the first step."""
    model = _model("NeuMF", "auto")
    real = model.run_training
    snapshots = []

    def run_training(params, loss_fn, sampler, **kw):
        before = {k: v.detach().clone() for k, v in model.named_parameters()}
        out = real(params, loss_fn, sampler, **kw)
        snapshots.append((before, {k: v.detach().clone() for k, v in model.named_parameters()}))
        return out

    monkeypatch.setattr(model, "run_training", run_training)
    model.fit()
    gmf, mlp = {"PG", "QG", "h_mf"}, {"PM", "QM", "h_mlp", "W1", "b1", "W2", "b2", "W3", "b3"}
    for (before, after), frozen, moved in zip(snapshots[:2], (mlp, gmf), (gmf, mlp)):
        assert all(torch.equal(before[k], after[k]) for k in frozen)
        assert all(not torch.equal(before[k], after[k]) for k in moved)
    assert [[e for _, e in t.chunks] for t in model.phase_timers] == [[8, 2], [5], [2]]


def test_buir_runs_per_epoch_and_says_why(capsys, monkeypatch):
    """BUIR's step is chunkable: under ``train.chunk=4`` its 3 epochs run
    as one chunk with no note; it runs every epoch on its own only where
    the per-step loop is asked for (``epoch_graphs=False``, which no conf
    sets), also without a note, and both runs are the same bits."""
    model = _model("BUIR", "4")
    model.fit()
    out = capsys.readouterr().out
    assert "not applied" not in out and "BUIR [1] epoch 3: loss = " in out
    assert [[e for _, e in t.chunks] for t in model.phase_timers] == [[EPOCHS["BUIR"]]]
    monkeypatch.setattr(type(model), "epoch_graphs", False)
    per_epoch = _model("BUIR", "4")
    per_epoch.fit()
    assert "not applied" not in capsys.readouterr().out
    assert [[e for _, e in t.chunks] for t in per_epoch.phase_timers] == [[1] * EPOCHS["BUIR"]]
    _assert_same(_outcome(model), _outcome(per_epoch))


def test_a_tf_run_says_it_is_not_chunked(capsys):
    """A bold spec under ``-tf`` trains with Adam and, since the bold specs
    are ``chunkable``, chunks where the ranking reads no epoch: no note. A
    phase whose step is not chunkable still runs per epoch with the
    default reason, which no longer names ``-tf``."""
    model = _model("APR", "4", extra={"evaluation.setup": "-ap 0.25 -tf"})
    assert model._chunk_for("adam", True, True) == 4
    assert "not applied" not in capsys.readouterr().out
    assert model._chunk_for("adam", False, True) == 1
    out = capsys.readouterr().out
    assert "not applied, runs per epoch: its step is not chunkable" in out
    assert "-tf" not in out


@pytest.mark.parametrize("name", ["DMF", "CDAE"])
def test_dense_row_caches_are_made_by_build(name):
    """DMF's item columns and training pairs and CDAE's rated mask exist
    once the spec is built, before a capture's warm-up epoch could put
    them on the device (a host-to-device copy there fails the capture)."""
    model = _model(name, "auto")
    made = ["_dense_r", "_dense_rt", "_train_arrays"] if name == "DMF" else ["_dense_r", "_rated"]
    assert not any(hasattr(model, k) for k in made)
    model.build()
    assert all(hasattr(model, k) for k in made)


def _made_optimizers(monkeypatch, fit) -> list:
    """The optimizers that ``trainer.make_optimizer`` made during ``fit()``."""
    made, real = [], T.make_optimizer
    monkeypatch.setattr(T, "make_optimizer", lambda *a: made.append(real(*a)) or made[-1])
    fit()
    monkeypatch.undo()
    return made


def test_capturable_adam_where_a_phase_may_chunk(monkeypatch, tmp_path):
    """One Adam in every phase (``runtime/adam.Adam``), capturable on a
    card by itself, whatever the phase's length, ``train.chunk``, a
    checkpoint or a mesh says: ``train`` takes no ``capturable``, and each
    optimizer's form follows its parameters' device alone (the device form
    on a card, ``torch.optim.Adam``'s own step on the CPU), so ``1`` and
    ``auto``, a checkpointed run and the unbroken one, and a mesh and one
    process step the same arithmetic."""
    assert "capturable" not in inspect.signature(T.train).parameters
    for chunk, ckpt in (("1", False), ("auto", False), ("auto", True)):
        for epochs in (1, 2):
            setup = f"on -dir {tmp_path / str(epochs)} -every 1"
            model = _model("DMF", chunk, epochs=epochs,
                           extra={"checkpoint.setup": setup} if ckpt else None)
            made = _made_optimizers(monkeypatch, model.fit)
            assert [type(o) for o in made] == [Adam]
            assert made[0].device_scalars is None and not made[0]._device_form()
            assert not made[0].param_groups[0]["capturable"]
    model._mesh = SimpleNamespace(data=2, data_index=0, model=1)
    assert model._chunk_for("adam", True, True) == 1
    assert type(T.make_optimizer(list(model.parameters()), "adam", 0.01)) is Adam


@pytest.mark.parametrize("epochs,capturable", [(1, [False] * 3), (2, [False] * 3),
                                                (10, [False] * 3)])
def test_each_phase_asks_for_capturable_adam_by_its_length(monkeypatch, epochs, capturable):
    """NeuMF's phases of ``epochs``, ``epochs // 2`` and ``epochs // 5``
    (at least 1), under ``train.chunk=1`` as under ``auto``: whatever a
    phase's length, it asks for nothing, its optimizer is the one Adam, and
    torch's own ``capturable`` flag stays off in every phase (the one
    Adam's device form is capturable with plain Adam's arithmetic)."""
    for chunk in ("1", "auto"):
        made = _made_optimizers(monkeypatch, _model("NeuMF", chunk, epochs=epochs).fit)
        assert [type(o) for o in made] == [Adam] * 3
        assert [o.param_groups[0]["capturable"] for o in made] == capturable
        assert all(o.device_scalars is None for o in made)


# ---------------------------------------------------------------------------
# against the JAX package, under train.chunk=auto
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", SOCIAL)
def test_social_family_on_jax_batches_under_auto_matches_jax(name, monkeypatch):
    """Three epochs (SEPT: one warm-up, two joint) on the JAX sampler's
    batches with the JAX draws, chunked: within
    ``test_torch_social_graph.py``'s epoch bounds."""
    jmodel, tmodel = social_tests._both(name, dict(social_tests.COO, **{"train.chunk": "auto"}))
    params, target, phases = social_tests._jax_problem(name, jmodel, monkeypatch)
    social_tests._load(tmodel, params, target)
    tmodel.prepare_graph()
    batches, jlosses, jparams, draws, _ = social_tests._jax_epochs(
        name, jmodel, tmodel, params, target, phases)
    stream = iter(draws)
    tmodel.draw = lambda gen: next(stream)
    losses = tmodel.fit(epoch_batches=batches)
    assert next(stream, None) is None
    want_chunks = [[1], [2]] if name == "SEPT" else [[3]]
    assert [[e for _, e in t.chunks] for t in tmodel.phase_timers] == want_chunks
    np.testing.assert_allclose(losses, jlosses, rtol=1e-3)
    final = jparams[tmodel.tracker.best_epoch - 1] if tmodel.tracker else jparams[-1]
    want = params_from_jax({k: np.asarray(v) for k, v in final.items()}, "cpu")
    for key, value in want.items():
        np.testing.assert_allclose(getattr(tmodel, key).detach().numpy(), value.numpy(),
                                   atol=1e-4, err_msg=key)


@pytest.mark.parametrize("name,phase_epochs", [("NeuMF", [4, 2, 1]), ("APR", [2, 2])])
def test_deep_phases_on_jax_batches_under_auto_match_jax(name, phase_epochs, monkeypatch):
    """NeuMF's three phases and APR's two on the batches the JAX sampler
    drew inside the JAX model's own ``fit`` (run per epoch, so the sampler
    runs eagerly), the port chunked: within ``test_torch_deep.py``'s
    bounds."""
    jmodel, _ = deep_tests.both(name)
    train, test = deep_tests._records()
    conf = ModelConf(deep_tests._conf(name, {"train.chunk": "auto"}))
    tmodel = MODELS[name](conf, Interactions(conf, train, test), device="cpu")
    initial = jmodel._init_params() if name == "NeuMF" else jmodel.init_embeddings("normal")
    deep_tests.load(tmodel, initial)
    phases, batches, jlosses = deep_tests.captured_fit(jmodel, monkeypatch)
    assert [e for _, e in phases] == phase_epochs
    losses = tmodel.fit(epoch_batches=batches)
    assert [[e for _, e in t.chunks] for t in tmodel.phase_timers] == [_cut(n, 8)
                                                                       for n in phase_epochs]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-3)
    final = jmodel.params if name == "NeuMF" else {"user_emb": jmodel.U, "item_emb": jmodel.V}
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, final), "cpu")
    for key, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[key].numpy(), atol=1e-4, err_msg=key)
