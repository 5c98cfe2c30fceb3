"""The dispatch of ``-tf`` runs, SGNS and IF_BPR in the PyTorch port, on
the CPU:

* under ``evaluation.setup ... -tf`` a bold spec trains with Adam and, where
  the ranking is on, chunks: BPR, SBPR, TBPR, CUNE_BPR, SVD++ and SocialMF
  at ``train.chunk`` 3 and ``auto`` bit for bit their ``train.chunk=1``
  runs; a ``-tf`` rating run, which prints MAE/RMSE every epoch, stays per
  epoch on plain Adam; the bold mode is unchanged;
* SGNS's replayed form (``train_skipgram(graph_steps=k)``: the epoch's
  draws in fixed buffers, programs of k steps that read them at a device
  step counter) bit for bit the per-step loop, and on the JAX package's
  draws within tests/test_torch_walks.py's bound (5e-5, measured 8.3e-6);
* IF_BPR's captured form (``epoch_graphs=True``: the epoch's body over
  fixed buffers) bit for bit the per-step epochs, on the JAX batches within
  tests/test_torch_ifbpr.py's bounds, and its losses read on the host only
  at the epochs it prints.

On the CPU a program runs its body as written; the CUDA graphs are checked
on a card (``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py``)."""

import gc
import random
import weakref

import jax
import numpy as np
import pytest
import torch

from qrec_tpu.data.split import data_split
from qrec_tpu.ops import walks as jw
from qrec_tpu_torch import ModelConf
from qrec_tpu_torch.convert import params_from_jax
from qrec_tpu_torch.data.dataset import Interactions
from qrec_tpu_torch.data.social import SocialGraph
from qrec_tpu_torch.models import MODELS
from qrec_tpu_torch.models import ifbpr as ifbpr_module
from qrec_tpu_torch.ops import walks as W
from qrec_tpu_torch.runtime import trainer as T
from qrec_tpu_torch.runtime.profiling import StepTimer
from tests import test_torch_ifbpr as ifbpr_tests
from tests import test_torch_social_ranking as ranking_tests
from tests import test_torch_walks as walk_tests

TF = "-ap 0.2 -tf"
ARGS = {"TBPR": ("TBPR", "-regT 0.01"),
        "CUNE_BPR": ("CUNE-BPR", "-T 10 -L 10 -l 16 -w 5 -k 10 -s 2 -ep 10"),
        "SVD++": ("SVDPlusPlus", "-y 0.01")}
SOCIAL = ("SBPR", "TBPR", "SocialMF")
RATING = ("SocialMF", "SVD++", "BasicMF")
EPOCHS = 5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _model(name, chunk, extra=None):
    """The port's model on the planted blocks of tests/test_torch_social_ranking.py
    (40 users, 2 blocks of 15 items; explicit 1-5 ratings for the rating
    models), with its trust links for the social ones, under ``-tf``."""
    ratings, trust = ranking_tests._rows("SBPR")
    if name in RATING:
        rng = np.random.RandomState(1)
        ratings = [[u, i, float(rng.randint(1, 6))] for u, i, _ in ratings]
    conf = {
        "ratings": "unused", "ratings.setup": "-columns 0 1 2",
        "social": "unused", "social.setup": "-columns 0 1 2",
        "model.name": name, "evaluation.setup": TF, "item.ranking": "on -topN 10",
        "num.factors": "8", "num.max.epoch": str(EPOCHS), "batch_size": "64",
        "learnRate": "-init 0.02 -max 1", "reg.lambda": "-u 0.01 -i 0.02 -b 0.1 -s 0.1",
        "output.setup": "off -dir ./results/", "seed": "7", "train.chunk": chunk,
    }
    if name in ARGS:
        key, args = ARGS[name]
        conf[key] = args
    conf.update(extra or {})
    train, test = data_split(ratings, 0.2, rng=random.Random(3))
    data = Interactions(ModelConf(conf), train, test)
    social = SocialGraph(trust, data) if name in SOCIAL else None
    kw = {"social": social} if social is not None else {}
    return MODELS[name](ModelConf(conf), data, device="cpu", **kw)


def _outcome(model):
    return dict(losses=list(model.epoch_losses),
                params={k: v.detach().clone() for k, v in model.named_parameters()},
                U=model.U.clone(), V=model.V.clone())


def _chunks(model):
    """The epochs of every dispatch of the fit's phases."""
    return [e for t in model.phase_timers for _, e in t.chunks]


_PER_EPOCH = {}


def _per_epoch(name):
    if name not in _PER_EPOCH:
        model = _model(name, "1")
        model.fit()
        assert _chunks(model) == [1] * EPOCHS
        _PER_EPOCH[name] = _outcome(model)
    return _PER_EPOCH[name]


# ---------------------------------------------------------------------------
# -tf runs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["BPR", "SBPR", "TBPR", "CUNE_BPR", "SVD++", "SocialMF"])
@pytest.mark.parametrize("chunk", ["3", "auto"])
def test_tf_ranking_run_chunks_bit_for_bit(name, chunk, capsys):
    """A ``-tf`` run with the ranking on: its epochs in chunks of 3 (3 + 2)
    or ``auto`` (one of 5), its losses, parameters and final factors the
    same bits as under ``train.chunk=1``, and no note that it runs per
    epoch."""
    want = _per_epoch(name)
    model = _model(name, chunk)
    capsys.readouterr()
    model.fit()
    got = _outcome(model)
    assert got["losses"] == want["losses"] and len(got["losses"]) == EPOCHS
    assert got["params"].keys() == want["params"].keys()
    for k in want["params"]:
        assert torch.equal(got["params"][k], want["params"][k]), k
    assert torch.equal(got["U"], want["U"]) and torch.equal(got["V"], want["V"])
    assert _chunks(model) == ([3, 2] if chunk == "3" else [5])
    assert all(t.captures == [] for t in model.phase_timers)  # no CUDA graph on the CPU
    out = capsys.readouterr().out
    assert "not applied" not in out and "not chunked" not in out


@pytest.mark.parametrize("name", RATING)
def test_tf_rating_run_stays_per_epoch_on_plain_adam(name, monkeypatch, capsys):
    """A ``-tf`` rating run prints MAE/RMSE every epoch, so it runs per
    epoch, as in the JAX package, with plain Adam's arithmetic, the one
    Adam's of every loop (``train`` takes no ``capturable``: no loop picks
    an Adam); its note under ``train.chunk=4`` gives that reason, not
    ``-tf``."""
    seen = []
    real = T.train

    def spy(*a, **k):
        seen.append((k["chunk"], "capturable" in k, k["mode"]))
        return real(*a, **k)

    monkeypatch.setattr(T, "train", spy)
    model = _model(name, "4", extra={"item.ranking": "off -topN 10"})
    model.fit()
    assert seen == [(1, False, "adam")]
    assert _chunks(model) == [1] * EPOCHS
    out = capsys.readouterr().out
    assert out.count("not applied") == 1
    assert "runs per epoch: its per-epoch measures are read on the host" in out
    assert "-tf" not in out and "MAE:" in out


@pytest.mark.parametrize("name", ["BPR", "SBPR"])
def test_bold_mode_is_unchanged(name, capsys):
    """Without ``-tf`` the spec is the bold driver's: ``_chunk_for`` gives
    1 before it reads ``chunkable``, and a set ``train.chunk`` is named as
    not applied for the bold mode's reason."""
    model = _model(name, "3", extra={"evaluation.setup": "-ap 0.2"})
    assert model.build().chunkable and model.build().mode == "bold"
    assert model._chunk_for("bold", True, True) == 1
    model.fit()
    assert _chunks(model) == [1] * len(model.epoch_losses)
    assert ("runs per epoch: the bold-driver mode reads every epoch's loss"
            in capsys.readouterr().out)


# ---------------------------------------------------------------------------
# SGNS
# ---------------------------------------------------------------------------


def _clique_pairs():
    walks, active = jw.random_walks(walk_tests._cliques(), 30, 8, np.random.RandomState(0))
    centers, contexts = jw.walk_pairs(walks, 3)
    return centers, contexts, active


SGNS = dict(epochs=3, negatives=5, batch_size=512, lr=0.05, seed=4)


@pytest.mark.parametrize("graph_steps", [4, 13, 64])
def test_replayed_skipgram_equals_per_step_loop_bit_for_bit(graph_steps):
    """26 steps an epoch: programs of 4 (six times) and a tail of 2, of 13
    (twice), or one of all 26 (k above the epoch's steps): the ``in``
    table the same bits as the per-step loop's, each epoch timed, no
    capture on the CPU."""
    centers, contexts, active = _clique_pairs()
    assert -(-len(centers) // 512) == 26
    want = W.train_skipgram(centers, contexts, 14, 8, active, graph_steps=0, **SGNS)
    timer = StepTimer(len(centers))
    got = W.train_skipgram(centers, contexts, 14, 8, active, graph_steps=graph_steps,
                           timer=timer, **SGNS)
    assert torch.equal(got, want)
    assert len(timer.times) == 3 and timer.captures == []
    # the CPU's default is the per-step loop
    assert torch.equal(W.train_skipgram(centers, contexts, 14, 8, active, **SGNS), want)
    stats = W.skipgram_stats(len(centers), timer, "cpu", graph_steps, batch_size=512)
    assert stats["steps"] == 78 and stats["graph_steps"] == min(graph_steps, 26)
    assert stats["capture_s"] == 0 and stats["s"] == sum(timer.times)
    assert W.skipgram_stats(len(centers), timer, "cpu", batch_size=512)["graph_steps"] == 0


def test_replayed_skipgram_with_jax_draws_matches_jax(monkeypatch):
    """The replayed form on the JAX package's draws (its numpy walks)
    within tests/test_torch_walks.py's bound."""
    monkeypatch.setattr("qrec_tpu.native.random_walks_native", lambda *a: None)
    centers, contexts, active = _clique_pairs()
    want = np.asarray(jw.train_skipgram(centers, contexts, 14, 8, active, **SGNS))
    got = W.train_skipgram(centers, contexts, 14, 8, active, draws=walk_tests.JaxDraws,
                           graph_steps=4, **SGNS)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=5e-5)
    eager = W.train_skipgram(centers, contexts, 14, 8, active, draws=walk_tests.JaxDraws,
                             graph_steps=0, **SGNS)
    assert torch.equal(got, eager)


def test_skipgram_graph_steps_by_device():
    assert W.skipgram_graph_steps(None, "cpu") == 0
    assert W.skipgram_graph_steps(None, "cuda") == W.SGNS_GRAPH_STEPS
    assert W.skipgram_graph_steps(0, "cuda") == 0 and W.skipgram_graph_steps(5, "cpu") == 5


# ---------------------------------------------------------------------------
# IF_BPR
# ---------------------------------------------------------------------------


def _ifbpr(tmp, epoch_graphs, epochs=3, with_negative=True):
    _, model = ifbpr_tests._models("IF_BPR", tmp, with_negative,
                                   {"num.max.epoch": str(epochs)})
    model.epoch_graphs = epoch_graphs
    return model


def _ifbpr_outcome(model):
    return dict(losses=list(model.epoch_losses),
                thresholds=[(t.clone(), a.clone()) for t, a in model.thresholds],
                acc=model.acc.clone(),
                params={k: v.detach().clone() for k, v in model.named_parameters()},
                U=model.U.clone(), V=model.V.clone())


def _assert_same_ifbpr(got, want):
    assert got["losses"] == want["losses"]
    assert len(got["thresholds"]) == len(want["thresholds"])
    for (t, a), (wt, wa) in zip(got["thresholds"], want["thresholds"]):
        assert torch.equal(t, wt) and torch.equal(a, wa)
    assert torch.equal(got["acc"], want["acc"])
    for k in want["params"]:
        assert torch.equal(got["params"][k], want["params"][k]), k
    assert torch.equal(got["U"], want["U"]) and torch.equal(got["V"], want["V"])


@pytest.mark.parametrize("with_negative", [False, True])
def test_ifbpr_captured_form_equals_per_step_epochs_bit_for_bit(tmp_path, with_negative):
    """IF_BPR's epoch body over its fixed buffers (the sampler, the steps
    with their threshold sums, the threshold update, the summed loss) run
    as written: each epoch's loss, thresholds and mean similarities, the
    last epoch's sums, the tables and factors the same bits as the
    per-step epochs'; every epoch's thresholds are copies, not the
    buffers."""
    want = _ifbpr(tmp_path, False, with_negative=with_negative)
    want.fit()
    got = _ifbpr(tmp_path, True, with_negative=with_negative)
    got.fit()
    _assert_same_ifbpr(_ifbpr_outcome(got), _ifbpr_outcome(want))
    thr = [t for t, _ in got.thresholds]
    assert not torch.equal(thr[0], thr[-1])  # they moved, each epoch kept apart
    assert got.timer.captures == [] and len(got.timer.times) == 3


@pytest.fixture(scope="module")
def jax_ifbpr(tmp_path_factory):
    """The JAX package's IF_BPR fit with the negative channel, its friend
    lists, jitted epoch and calls recorded (tests/test_torch_ifbpr.py's
    ``ifbpr_run``)."""
    tmp = tmp_path_factory.mktemp("negative")
    jmodel, _ = ifbpr_tests._models("IF_BPR", tmp, True)
    with pytest.MonkeyPatch.context() as mp:
        ifbpr_tests._patch(mp)
        friends, fns, calls = ifbpr_tests._record_fit(jmodel)
    return tmp, True, jmodel, friends, fns, calls


def test_ifbpr_captured_form_on_jax_batches_matches_jax(jax_ifbpr):
    """Three epochs on the JAX package's batches from its perturbed tables
    (tests/test_torch_ifbpr.py's
    ``test_three_epochs_on_injected_batches_match_jax``), the batches copied
    into the captured form's buffers: within that test's bounds of the JAX
    epochs, and the same bits as the per-step epochs on the same batches."""
    _, _, _, _, fns, calls = jax_ifbpr
    runs = calls["run_epoch"]
    params, _, thr, avg, _, _ = runs[0][0]
    rng = np.random.RandomState(9)
    params = dict(params, user_emb=params["user_emb"]
                  + 0.01 * rng.randn(*params["user_emb"].shape).astype(np.float32))
    epoch = jax.jit(fns["run_epoch"])
    state = ifbpr_tests._closure(fns["run_epoch"])["optimizer"].init(params)
    outs, p = [], params
    for args, _ in runs:
        p, state, thr, avg, loss = epoch(p, state, thr, avg, args[4], args[5])
        outs.append((p, thr, avg, float(loss)))
    batches = [tuple(np.asarray(a) for a in args[4]) for args, _ in runs]
    got = {}
    for graphs in (True, False):
        tmodel = ifbpr_tests._port(jax_ifbpr)
        tmodel.epoch_graphs = graphs
        tmodel.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params), "cpu"))
        tmodel.fit(epoch_batches=batches)
        got[graphs] = _ifbpr_outcome(tmodel)
    _assert_same_ifbpr(got[True], got[False])
    np.testing.assert_allclose(got[True]["losses"], [o[3] for o in outs], rtol=1e-3)
    for (thr, avg), (_, jthr, javg, _) in zip(got[True]["thresholds"], outs):
        np.testing.assert_allclose(thr.numpy(), np.asarray(jthr), rtol=0, atol=1e-5)
        np.testing.assert_allclose(avg.numpy(), np.asarray(javg), rtol=0, atol=1e-5)
    for key, value in outs[-1][0].items():
        np.testing.assert_allclose(got[True]["params"][key].numpy(), np.asarray(value),
                                   atol=1e-4, err_msg=key)


@pytest.mark.parametrize("epoch_graphs", [True, False])
def test_ifbpr_reads_losses_only_at_printed_epochs(tmp_path, epoch_graphs, monkeypatch, capsys):
    """Seven epochs: the losses wait on the device and reach the host at
    the 5th and the 7th (the printed epochs, as the JAX package reads
    them), each checked for NaN there, each epoch's line printed then."""
    checked = []
    real = T.check_finite
    model = _ifbpr(tmp_path, epoch_graphs, epochs=7, with_negative=False)

    def spy(loss):
        checked.append(len(model.timer.times))
        real(loss)

    monkeypatch.setattr(T, "check_finite", spy)
    capsys.readouterr()
    model.fit()
    assert checked == [5] * 5 + [7] * 2
    out = capsys.readouterr().out
    assert [line.split(":")[0] for line in out.splitlines() if "loss =" in line] == [
        "IF_BPR [1] epoch 5", "IF_BPR [1] epoch 7"]
    assert len(model.epoch_losses) == 7 and all(np.isfinite(model.epoch_losses))


# ---------------------------------------------------------------------------
# the programs' lifetime
# ---------------------------------------------------------------------------


def _epoch_program():
    w = torch.nn.Parameter(torch.ones(4))
    opt = T.make_optimizer([w], "adam", 0.1)
    T.init_adam_state(opt)
    st = T.LoopState(0, [w], opt, torch.Generator().manual_seed(0))
    program = T.EpochProgram(st, lambda batch, gen: (w * batch[0]).sum(),
                             lambda gen: (torch.ones((2, 4)),), "cpu")
    program.run(0)
    return program


def _skipgram_program():
    t_in = torch.zeros((5, 3), requires_grad=True)
    t_out = torch.zeros((5, 3), requires_grad=True)
    opt = T.make_optimizer([t_in, t_out], "adam", 0.1)
    replayed = W._ReplayedSkipgram(t_in, t_out, opt, 3, 4, 2, 2, "cpu")
    for buf in (replayed.cs, replayed.xs, replayed.negs):
        buf.zero_()
    program = replayed.programs[-1][0]
    program.run()
    return program


def _ifbpr_program(tmp):
    model = _ifbpr(tmp, True, with_negative=False)
    model.begin_fit()
    model.prepare_graph()
    opt = T.make_optimizer([model.user_emb, model.item_emb], "adam", 0.1)
    thr = torch.zeros(model.num_users)
    program = ifbpr_module._EpochGraph(model, opt, torch.Generator().manual_seed(0), thr, thr)
    program.run()
    return program


@pytest.mark.parametrize("kind", ["epoch", "skipgram", "ifbpr"])
def test_programs_are_freed_without_the_cyclic_collector(tmp_path, kind):
    """An epoch program, an SGNS program and IF_BPR's epoch graph hold no
    reference cycle: once the garbage of their making is collected, each
    is freed as soon as it is dropped, with the cyclic collector off. On a
    card a CUDA graph left in a cycle would be freed by the collector at
    any later time, inside another capture too, which invalidates that
    capture."""
    make = {"epoch": _epoch_program, "skipgram": _skipgram_program,
            "ifbpr": lambda: _ifbpr_program(tmp_path)}[kind]
    program = make()
    enabled = gc.isenabled()
    gc.collect()
    gc.disable()
    try:
        ref = weakref.ref(program)
        del program
        assert ref() is None
    finally:
        if enabled:
            gc.enable()
