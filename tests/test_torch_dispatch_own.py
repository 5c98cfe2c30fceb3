"""The own training loops of the PyTorch port as one dispatch an epoch, on
the CPU: ESRF's three phases (one program a phase, run through
``runtime/trainer.ChunkedLoop``), BUIR (``train.chunk`` epochs a dispatch),
and IRGAN, RSGAN (its pretraining step and its epoch) and CFGAN (one
program an epoch, their losses read at the epochs they print):

* the captured form (``epoch_graphs=True``: the program's body run as
  written) bit for bit the per-step loop (``False``): losses, tables,
  buffers, factors and both players' Adam states;
* on the JAX package's batches and draws, within the bounds of the parity
  tests that hold the per-step loop (tests/test_torch_social_ranking.py for
  ESRF, test_torch_social_graph.py for BUIR, test_torch_deep.py for IRGAN
  and CFGAN, test_torch_ifbpr.py for RSGAN), and the same bits as the
  per-step loop on them;
* the host reads losses only at chunk ends (ESRF, BUIR) or at the printed
  epochs (IRGAN, RSGAN, CFGAN);
* every program is freed as soon as its fit returns, with the cyclic
  collector off.

On the CPU a program runs its body as written; the CUDA graphs are checked
on a card (tests/test_torch_kernels_cuda.py and ``chip_smoke.py``)."""

import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qrec_tpu_torch import ModelConf
from qrec_tpu_torch.data.dataset import Interactions
from qrec_tpu_torch.models import MODELS
from qrec_tpu_torch.runtime import trainer as T
from tests import test_torch_chunk_families as families
from tests import test_torch_deep as deep_tests
from tests import test_torch_ifbpr as ifbpr_tests
from tests import test_torch_social_graph as social_tests
from tests import test_torch_social_ranking as ranking_tests
from tests.test_torch_ifbpr import rsgan_run  # noqa: F401  (a fixture)
from tests.test_torch_social_ranking import esrf_run  # noqa: F401  (a fixture)

LOOPS = ("ESRF", "BUIR", "IRGAN", "RSGAN", "CFGAN")
# epochs of the bit-for-bit runs: ESRF 2 a phase, the others more than one
EPOCHS = {"ESRF": 6, "BUIR": 4, "IRGAN": 3, "RSGAN": 3, "CFGAN": 3}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _model(name, tmp, epochs, extra=None):
    """The port's model on the small data of its parity tests: ESRF on
    tests/test_torch_social_ranking.py's planted blocks and links (segment
    16, ``graph.backend=coo``), BUIR on test_torch_social_graph.py's,
    IRGAN and CFGAN on test_torch_deep.py's records, RSGAN on
    test_torch_ifbpr.py's with a seeded 0/1 friend profile in place of its
    meta-path friends."""
    extra = dict({"num.max.epoch": str(epochs)}, **(extra or {}))
    if name == "ESRF":
        _, model = ranking_tests._models("ESRF", extra)
        model.segment = ranking_tests.SEGMENT
    elif name == "BUIR":
        model = families._model("BUIR", extra.pop("train.chunk", "auto"), epochs=epochs,
                                extra=extra)
    elif name == "RSGAN":
        _, model = ifbpr_tests._models("RSGAN", tmp, True, extra)
        profile = (np.random.RandomState(3).rand(model.num_users, model.num_users) < 0.3)
        model.seeded_friends = lambda: profile.astype(np.float32)
    else:
        conf = ModelConf(deep_tests._conf(name, extra))
        train, test = deep_tests._records()
        model = MODELS[name](conf, Interactions(conf, train, test), device="cpu")
    return model


def _fit(model, graphs, **kw):
    """``model.fit(**kw)`` in the form ``graphs``; returns the optimizers it
    made, in order."""
    opts = []
    real = T.make_optimizer

    def record(*a, **k):
        opts.append(real(*a, **k))
        return opts[-1]

    model.epoch_graphs = graphs
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(T, "make_optimizer", record)
        model.fit(**kw)
    return opts


def _outcome(model, opts):
    """What a fit leaves: its losses, tables, buffers, final factors and
    each optimizer's state."""
    clone = lambda x: None if x is None else x.detach().clone()  # noqa: E731
    return dict(
        losses={k: list(getattr(model, k)) for k in ("epoch_losses", "g_losses", "pretrain_losses")
                if hasattr(model, k)},
        phases=[list(p) for p in model.phase_losses],
        params={k: clone(v) for k, v in model.named_parameters()},
        buffers={k: clone(v) for k, v in model.named_buffers()},
        U=clone(model.U), V=clone(model.V),
        adam=[[clone(t) for _, state in sorted(o.state_dict()["state"].items())
               for _, t in sorted(state.items())] for o in opts])


def _assert_same(got, want):
    assert got["losses"] == want["losses"] and got["phases"] == want["phases"]
    for part in ("params", "buffers"):
        assert got[part].keys() == want[part].keys()
        for k in want[part]:
            assert torch.equal(got[part][k], want[part][k]), k
    for k in ("U", "V"):  # CFGAN scores from a block, with no factors
        assert (got[k] is None and want[k] is None) or torch.equal(got[k], want[k]), k
    assert len(got["adam"]) == len(want["adam"]) and got["adam"]
    for a, b in zip(got["adam"], want["adam"]):
        assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def _epochs_a_dispatch(model):
    return [[e for _, e in t.chunks] for t in (model.phase_timers or [model.timer])]


# ---------------------------------------------------------------------------
# the captured form against the per-step loop
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", LOOPS)
def test_captured_form_equals_per_step_loop_bit_for_bit(name, tmp_path):
    """Each loop's programs run as written (``epoch_graphs=True``) against
    its per-step loop (``False``) from the same seed: every loss, table,
    buffer (BUIR's target), factor and Adam state the same bits. ESRF's
    phases and BUIR run one dispatch of all their epochs (``train.chunk``
    auto); no CUDA graph is captured on the CPU."""
    epochs = EPOCHS[name]
    runs = {}
    for graphs in (False, True):
        model = _model(name, tmp_path, epochs)
        opts = _fit(model, graphs)
        runs[graphs] = (model, _outcome(model, opts))
    _assert_same(runs[True][1], runs[False][1])
    model, got = runs[True]
    assert len(got["losses"]["epoch_losses"]) == epochs
    assert len(got["adam"]) == (1 if name == "BUIR" else 2)
    assert all(np.isfinite(v).all() for v in got["losses"].values())
    if name == "ESRF":
        assert _epochs_a_dispatch(model) == [[2]] * 3
        assert _epochs_a_dispatch(runs[False][0]) == [[1, 1]] * 3
    elif name == "BUIR":
        assert _epochs_a_dispatch(model) == [[epochs]]
        assert _epochs_a_dispatch(runs[False][0]) == [[1] * epochs]
    assert all(t.captures == [] for t in (model.phase_timers or [model.timer]))


@pytest.mark.parametrize("chunk", ["3", "auto"])
def test_buir_chunks_equal_per_epoch_bit_for_bit(chunk):
    """BUIR at ``train.chunk`` 3 (3 + 3 + 1 epochs) and ``auto`` (one of
    7) against ``train.chunk=1``: losses, tables, target and factors the
    same bits; its epoch lines, every 5th and the last, after the reads."""
    runs = {}
    for c in ("1", chunk):
        model = families._model("BUIR", c, epochs=7)
        model.fit()
        runs[c] = model
    assert _epochs_a_dispatch(runs[chunk]) == ([[3, 3, 1]] if chunk == "3" else [[7]])
    assert _epochs_a_dispatch(runs["1"]) == [[1] * 7]
    families._assert_same(families._outcome(runs[chunk]), families._outcome(runs["1"]))


def test_buir_emit_takes_eval_fused(capsys):
    """``ChunkedLoop`` hands ``_emit`` ``eval_fused``: BUIR's takes it and
    prints every 5th epoch and the last, as before."""
    model = families._model("BUIR", "auto", epochs=7)
    for epoch in range(7):
        model._emit(epoch, 1.5, 0.01, 0.1, None, eval_fused=True)
    lines = capsys.readouterr().out.splitlines()
    assert lines == ["BUIR [1] epoch 5: loss = 1.5000", "BUIR [1] epoch 7: loss = 1.5000"]


def test_a_mesh_keeps_esrf_and_buir_per_step_on_plain_adam():
    """On a mesh ESRF and BUIR step with collectives, so they run per step
    on plain Adam whatever ``epoch_graphs`` says; IRGAN, RSGAN and CFGAN,
    which train whole on every rank, keep their programs there."""
    from types import SimpleNamespace

    mesh = SimpleNamespace(data=2, data_index=0, model=1)
    buir = families._model("BUIR", "auto", epochs=4)
    buir._mesh = mesh
    assert buir._chunk_for("adam", True, True) == 1
    assert not buir._capturable("adam", True, 4, True)
    esrf = _model("ESRF", None, 6)
    esrf.epoch_graphs = True
    assert esrf.own_loop_form(2, collectives=True) == (True, True)
    esrf._mesh = mesh
    assert esrf.own_loop_form(2, collectives=True) == (False, False)
    irgan = _model("IRGAN", None, 3)
    irgan._mesh, irgan.epoch_graphs = mesh, True
    assert irgan.own_loop_form(3) == (True, True)


def test_own_loop_form_by_device_and_epochs():
    """With ``epoch_graphs`` None, the captured form on a card where the
    loop runs more than one epoch and the per-step loop elsewhere; True
    and False as set. Capturable Adam wherever the loop captures or runs
    more than one epoch."""
    model = _model("IRGAN", None, 3)
    assert model.own_loop_form(3) == (False, True) and model.own_loop_form(1) == (False, False)
    model.device = torch.device("cuda")
    assert model.own_loop_form(3) == (True, True) and model.own_loop_form(1) == (False, False)
    model.epoch_graphs = True
    assert model.own_loop_form(1) == (True, True)
    model.epoch_graphs = False
    assert model.own_loop_form(3) == (False, True) and model.own_loop_form(1) == (False, False)


# ---------------------------------------------------------------------------
# host reads
# ---------------------------------------------------------------------------


def _count_epochs(model, name):
    """A counter of the epochs ``model`` has run, kept by wrapping its
    epoch (BUIR's target update, once a step)."""
    seen = [0]
    if name == "BUIR":
        steps = -(-model.train_size // model.batch_size)
        real = model.update_target

        def update_target():
            seen[0] += 1
            real()

        model.update_target = update_target
        return lambda: seen[0] // steps
    real = model.train_epoch

    def train_epoch(*a, **k):
        seen[0] += 1
        return real(*a, **k)

    model.train_epoch = train_epoch
    return lambda: seen[0]


# (epochs, extra conf, epochs done at each loss checked on the host)
READS = {
    # 3 epochs a phase, chunks of 2: reads after epochs 2, 3 | 5, 6 | 8, 9
    "ESRF": (9, {"train.chunk": "2"}, [2, 2, 3, 5, 5, 6, 8, 8, 9]),
    "BUIR": (7, {"train.chunk": "3"}, [3] * 3 + [6] * 3 + [7]),
    # D and G losses, read at the 5th epoch and the 7th
    "IRGAN": (7, {}, [5] * 10 + [7] * 4),
    # the 30 pretraining losses once after them, then the 5th and the 7th
    "RSGAN": (7, {}, [0] * 30 + [5] * 5 + [7] * 2),
    "CFGAN": (21, {}, [20] * 40 + [21] * 2),
}


@pytest.mark.parametrize("graphs", [True, False])
@pytest.mark.parametrize("name", LOOPS)
def test_losses_are_read_only_at_chunk_ends_or_printed_epochs(name, graphs, tmp_path, monkeypatch,
                                                              capsys):
    """Every loss reaches the host (and its NaN check) at a chunk's end
    (ESRF's phases and BUIR, in the captured form) or at an epoch the loop
    prints (IRGAN, RSGAN and CFGAN, in either form: every 5th and the last,
    CFGAN's every 20th and the last), in one read there; ESRF's per-step
    loop reads every epoch, BUIR's per-epoch loop each epoch's loss after
    the next epoch is enqueued (lag-1)."""
    epochs, extra, want = READS[name]
    model = _model(name, tmp_path, epochs, dict(extra))
    done = _count_epochs(model, name)
    checked = []
    real = T.check_finite

    def spy(loss):
        checked.append(done())
        real(loss)

    monkeypatch.setattr(T, "check_finite", spy)
    model.epoch_graphs = graphs
    capsys.readouterr()
    model.fit()
    if not graphs and name == "ESRF":
        want = list(range(1, epochs + 1))
    elif not graphs and name == "BUIR":  # lag-1: each loss after the next epoch
        want = list(range(2, epochs + 1)) + [epochs]
    assert checked == want
    lines = [line for line in capsys.readouterr().out.splitlines() if " epoch " in line]
    if name in ("IRGAN", "RSGAN", "CFGAN"):
        printed = [5, 7] if name != "CFGAN" else [20, 21]
        assert [line.split(":")[0] for line in lines] == [
            f"{name} [1] epoch {e}" for e in printed]


# ---------------------------------------------------------------------------
# the programs' lifetime
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", LOOPS)
def test_programs_are_freed_without_the_cyclic_collector(name, tmp_path, monkeypatch):
    """Every program a fit makes (ESRF's three phases, BUIR's epoch, RSGAN's
    pretraining step and epoch, IRGAN's and CFGAN's epochs) holds no
    reference cycle: with the cyclic collector off through the fit, each is
    freed by the time the fit returns. On a card a CUDA graph left in a
    cycle would be freed by the collector at any later time, inside
    another capture too, which invalidates that capture."""
    made = []

    class Recorded(T.EpochProgram):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(weakref.ref(self))

    monkeypatch.setattr(T, "EpochProgram", Recorded)
    model = _model(name, tmp_path, EPOCHS[name])
    model.epoch_graphs = True
    gc.collect()
    enabled = gc.isenabled()
    gc.disable()
    try:
        model.fit()
        assert len(made) == {"ESRF": 3, "RSGAN": 2}.get(name, 1)
        assert all(ref() is None for ref in made)
    finally:
        if enabled:
            gc.enable()


# ---------------------------------------------------------------------------
# on the JAX package's batches and draws
# ---------------------------------------------------------------------------


def test_esrf_phases_on_injected_draws_match_jax(esrf_run):  # noqa: F811
    """tests/test_torch_social_ranking.py's three phases on the JAX
    package's batches, segment starts and Gumbel uniforms, each phase one
    program (its one epoch a chunk): within that test's bounds, and the
    same bits as the per-step loop."""
    jmodel, runs, _ = esrf_run
    batches, draws = [], []
    for phase, (args, _) in enumerate(runs):
        b, re = args[4], args[5]
        batches.append(tuple(np.asarray(a) for a in b))
        for r in jax.random.split(re, b[0].shape[0]):
            if phase > 0:
                draws.append(r)
            if phase == 2:
                draws.append(jax.random.fold_in(r, 9))
    got = {}
    for graphs in (True, False):
        tmodel = ranking_tests._esrf_port(jmodel, runs)
        stream = iter([ranking_tests._esrf_draws(r, tmodel) for r in draws])
        tmodel.draw = lambda gen, stream=stream: next(stream)
        opts = _fit(tmodel, graphs, epoch_batches=batches)
        assert next(stream, None) is None
        got[graphs] = (tmodel, _outcome(tmodel, opts))
    _assert_same(got[True][1], got[False][1])
    tmodel = got[True][0]
    assert _epochs_a_dispatch(tmodel) == [[1]] * 3
    np.testing.assert_allclose(tmodel.epoch_losses, [float(out[4]) for _, out in runs], rtol=1e-3)
    for key, value in runs[-1][1][0].items():
        np.testing.assert_allclose(tmodel.d[key].detach().numpy(), np.asarray(value), atol=1e-4,
                                   err_msg=key)
    np.testing.assert_allclose(tmodel.U.numpy(), np.asarray(jmodel.U), atol=1e-4)
    np.testing.assert_allclose(tmodel.V.numpy(), np.asarray(jmodel.V), atol=1e-4)


def test_buir_on_injected_batches_matches_jax(monkeypatch):
    """tests/test_torch_social_graph.py's three BUIR epochs on the JAX
    sampler's batches and draws, as one chunk: within that test's bounds
    (losses rtol 1e-3, tables and target 1e-4), and the same bits as the
    per-epoch loop."""
    got = {}
    for graphs in (True, False):
        jmodel, tmodel = social_tests._both("BUIR", social_tests.COO)
        params, target, phases = social_tests._jax_problem("BUIR", jmodel, monkeypatch)
        social_tests._load(tmodel, params, target)
        tmodel.prepare_graph()
        batches, jlosses, jparams, draws, jtarget = social_tests._jax_epochs(
            "BUIR", jmodel, tmodel, params, target, phases)
        stream = iter(draws)
        tmodel.draw = lambda gen, stream=stream: next(stream)
        opts = _fit(tmodel, graphs, epoch_batches=batches)
        assert next(stream, None) is None
        got[graphs] = (tmodel, _outcome(tmodel, opts))
    _assert_same(got[True][1], got[False][1])
    tmodel = got[True][0]
    assert _epochs_a_dispatch(tmodel) == [[3]]
    np.testing.assert_allclose(tmodel.epoch_losses, jlosses, rtol=1e-3)
    want = {k: np.asarray(v) for k, v in jparams[-1].items()}
    for key, value in want.items():
        np.testing.assert_allclose(getattr(tmodel, key).detach().numpy(), value, atol=1e-4,
                                   err_msg=key)
    for key in ("user_emb", "item_emb"):
        np.testing.assert_allclose(getattr(tmodel.target, key).numpy(), np.asarray(jtarget[key]),
                                   atol=1e-4, err_msg=key)


def test_irgan_epoch_program_on_injected_samples_matches_jax(monkeypatch):
    """tests/test_torch_deep.py's IRGAN epoch on injected samples, run as
    the captured form: the D and G losses within rtol 1e-3, the tables
    within 1e-4, and the same bits as the per-step loop."""
    jmodel, tmodel = deep_tests.both("IRGAN", {"num.max.epoch": "1"})
    injected = deep_tests._irgan_injection(tmodel)
    captured = deep_tests._irgan_jax_epoch(jmodel, {k: v.numpy().T for k, v in injected.items()},
                                           monkeypatch)
    initial = deep_tests._irgan_initial(jmodel)
    got = {}
    for graphs in (True, False):
        _, tmodel = deep_tests.both("IRGAN", {"num.max.epoch": "1"})
        tmodel.draw = lambda probs, k, rng: injected[k]
        deep_tests.load(tmodel, initial)
        got[graphs] = (tmodel, _outcome(tmodel, _fit(tmodel, graphs)))
    _assert_same(got[True][1], got[False][1])
    tmodel = got[True][0]
    np.testing.assert_allclose(tmodel.epoch_losses, [captured[tmodel.d_steps - 1][1]], rtol=1e-3)
    np.testing.assert_allclose(tmodel.g_losses, [captured[-1][1]], rtol=1e-3, atol=1e-6)
    want = {"gen": jmodel.gen, "dis": jmodel.dis}
    for key, p in tmodel.named_parameters():
        player, table = key.split(".")
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want[player][table]), atol=1e-4,
                                   err_msg=key)


def test_rsgan_programs_on_injected_draws_match_jax(rsgan_run):  # noqa: F811
    """tests/test_torch_ifbpr.py's RSGAN fit (30 pretraining steps, one GAN
    epoch on the JAX batches and Gumbel uniforms) with both programs run
    as written: the pretraining losses within rtol 1e-4, the epoch's loss
    within 1e-3, the discriminator's tables within 1e-4, and the same bits
    as the per-step loop."""
    _, jmodel, _, _, calls = rsgan_run
    (_, _, _, _, batches, re), out = calls["run_epoch"][0]
    keys = []
    for r in jax.random.split(re, batches[0].shape[0]):
        keys += [r, jax.random.fold_in(r, 1)]
    got = {}
    for graphs in (True, False):
        tmodel = ifbpr_tests._rsgan_port(rsgan_run)
        stream = iter([ifbpr_tests._gumbel_uniforms(k, tmodel) for k in keys])
        tmodel.draw = lambda gen, stream=stream: next(stream)
        opts = _fit(tmodel, graphs, epoch_batches=[tuple(np.asarray(a) for a in batches)])
        assert next(stream, None) is None
        got[graphs] = (tmodel, _outcome(tmodel, opts))
    _assert_same(got[True][1], got[False][1])
    tmodel = got[True][0]
    np.testing.assert_allclose(tmodel.epoch_losses, [float(out[4])], rtol=1e-3)
    np.testing.assert_allclose(tmodel.pretrain_losses,
                               [float(o[2]) for _, o in calls["g_pre_step"]], rtol=1e-4)
    for key, value in out[0].items():
        np.testing.assert_allclose(tmodel.d[key].detach().numpy(), np.asarray(value), atol=1e-4,
                                   err_msg=key)
    np.testing.assert_allclose(tmodel.U.numpy(), np.asarray(jmodel.U), atol=1e-4)


def _cfgan_jax_fit(jmodel):
    """The JAX package's CFGAN fit with its jitted epoch's inputs and
    outputs recorded (by wrapping ``jax.jit``)."""
    calls = []
    real_jit = jax.jit

    def jit(fn, **kw):
        compiled = real_jit(fn, **kw)
        if getattr(fn, "__name__", "") != "epoch":
            return compiled

        def recorded(*args):
            out = compiled(*args)
            calls.append((args, out))
            return out

        return recorded

    jax.jit = jit
    try:
        jmodel.fit()
    finally:
        jax.jit = real_jit
    return calls


def _cfgan_draws(rng, model):
    """An epoch's users and Bernoulli draws as the JAX package's
    ``batch_data`` makes them from the epoch's key."""
    r1, r2, r3 = jax.random.split(rng, 3)
    shape = (model.batch_size, model.num_items)
    uids = jax.random.randint(r1, (model.batch_size,), 0, model.num_users, dtype=jnp.int32)
    zr = jax.random.bernoulli(r2, model.s_zr, shape)
    pm = jax.random.bernoulli(r3, model.s_pm, shape)
    return tuple(torch.from_numpy(np.array(a)) for a in (uids, zr, pm))


def test_cfgan_epoch_program_on_injected_draws_matches_jax():
    """Two CFGAN epochs (one D step and three G steps each) on the JAX
    package's users and Bernoulli masks (drawn at 0.2 in both packages, so
    the masks are busy), from its initial tables, the epoch run as the
    captured form: the D and G losses within rtol 1e-3 and the tables
    within 1e-4 (tests/test_torch_deep.py's bounds after whole phases), and
    the same bits as the per-step loop."""
    jmodel, _ = deep_tests.both("CFGAN", {"num.max.epoch": "2"})
    jmodel.s_zr = jmodel.s_pm = 0.2
    calls = _cfgan_jax_fit(jmodel)
    assert len(calls) == 2
    g0, d0 = calls[0][0][:2]
    got = {}
    for graphs in (True, False):
        _, tmodel = deep_tests.both("CFGAN", {"num.max.epoch": "2"})
        deep_tests.load(tmodel, {"g": g0, "d": d0})
        stream = iter([_cfgan_draws(args[4], jmodel) for args, _ in calls])
        tmodel.draw = lambda gen, stream=stream: next(stream)
        got[graphs] = (tmodel, _outcome(tmodel, _fit(tmodel, graphs)))
        assert next(stream, None) is None
    _assert_same(got[True][1], got[False][1])
    tmodel = got[True][0]
    np.testing.assert_allclose(tmodel.epoch_losses, [float(out[4]) for _, out in calls], rtol=1e-3)
    np.testing.assert_allclose(tmodel.g_losses, [float(out[5]) for _, out in calls], rtol=1e-3)
    g1, d1 = calls[-1][1][:2]
    for player, tables in (("g", g1), ("d", d1)):
        for key, value in tables.items():
            np.testing.assert_allclose(tmodel.get_parameter(f"{player}.{key}").detach().numpy(),
                                       np.asarray(value), atol=1e-4, err_msg=f"{player}.{key}")
