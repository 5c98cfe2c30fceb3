"""``train.chunk`` in the PyTorch port: the chunked loops (``ChunkedLoop``
with and without the device vote) against the per-epoch loop bit for bit,
the committed loop state after a failed chunk, the sync-free sampler, the
lag-1 loss, the repairs the CUDA graphs needed (launch counts under
replay, the ranker's IDCG table), and the port and the JAX package on
the JAX sampler's batches under ``train.chunk=auto``.

On the CPU a chunk runs its epochs as written, with the one host read a
chunk and the device vote of the CUDA path; the CUDA graphs themselves are
checked on a card (``chip_smoke.py``'s ``chunk_phases`` and
``tests/test_torch_kernels_cuda.py``)."""

import random
import re

import jax
import numpy as np
import optax
import pytest
import torch

from qrec_tpu import config as jconfig
from qrec_tpu.data.dataset import Interactions as JInteractions
from qrec_tpu.data.split import data_split
from qrec_tpu.models.graph import SGL as JSGL
from qrec_tpu.models.graph import LightGCN as JLightGCN
from qrec_tpu.models.graph import SimGCL as JSimGCL
from qrec_tpu.runtime import trainer as jtrainer
from qrec_tpu_torch import ModelConf, QRec
from qrec_tpu_torch.convert import embedding_params_from_jax, lightgcn_params_from_jax
from qrec_tpu_torch.data.dataset import Interactions
from qrec_tpu_torch.errors import ConfigError
from qrec_tpu_torch.models.graph import SGL, LightGCN, SimGCL
from qrec_tpu_torch.ops import kernels as K
from qrec_tpu_torch.ops import sampling as S
from qrec_tpu_torch.ops.metrics import device_ranking_metrics, idcg_table
from qrec_tpu_torch.runtime import trainer as T
from qrec_tpu_torch.runtime.profiling import StepTimer

ARGS = {
    "LightGCN": "-n_layer 2",
    "SimGCL": "-n_layer 2 -lambda 0.1 -eps 0.1",
    "SGL": "-n_layer 2 -lambda 0.02 -droprate 0.5 -augtype 1 -temp 0.2",
}
CLASSES = {"LightGCN": LightGCN, "SimGCL": SimGCL, "SGL": SGL}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _conf(name, chunk="auto", epochs=5, extra=None):
    base = {
        "ratings": "unused",
        "ratings.setup": "-columns 0 1 2",
        "model.name": name,
        "evaluation.setup": "-ap 0.2",
        "item.ranking": "on -topN 5",
        "num.factors": "8",
        "num.max.epoch": str(epochs),
        "batch_size": "16",
        "learnRate": "-init 0.01 -max 1",
        "reg.lambda": "-u 0.001 -i 0.001 -b 0.2 -s 0.2",
        name: ARGS[name],
        "graph.dense.quant": "factored",
        "output.setup": "off -dir ./results/",
        "seed": "11",
        "train.chunk": chunk,
    }
    base.update(extra or {})
    return base


def _records():
    rng = np.random.RandomState(5)
    records = [[f"u{u}", f"i{i}", 1.0] for u in range(14) for i in rng.choice(24, size=7, replace=False)]
    return data_split(records, 0.25, rng=random.Random(2))


def _model(name, chunk="auto", epochs=5, extra=None):
    conf = ModelConf(_conf(name, chunk, epochs, extra))
    train, test = _records()
    return CLASSES[name](conf, Interactions(conf, train, test), device="cpu")


def _outcome(model):
    """What a fit leaves: losses, parameters, and the tracker's best."""
    t = model.tracker
    best = None if t is None else (t.best_epoch, dict(t.best_metrics),
                                   [b.detach().clone() for b in t.best_params])
    return (list(model.epoch_losses), {k: v.detach().clone() for k, v in model.named_parameters()},
            model.U.clone(), model.V.clone(), best)


def _assert_same(a, b):
    assert a[0] == b[0]
    for k in a[1]:
        assert torch.equal(a[1][k], b[1][k]), k
    assert torch.equal(a[2], b[2]) and torch.equal(a[3], b[3])
    assert (a[4] is None) == (b[4] is None)
    if a[4] is not None:
        assert a[4][0] == b[4][0] and a[4][1] == b[4][1]
        assert all(torch.equal(x, y) for x, y in zip(a[4][2], b[4][2]))


_PER_EPOCH = {}


def _per_epoch(name):
    if name not in _PER_EPOCH:
        m = _model(name, "1")
        m.fit()
        _PER_EPOCH[name] = _outcome(m)
    return _PER_EPOCH[name]


@pytest.mark.parametrize("name", ["LightGCN", "SimGCL"])
@pytest.mark.parametrize("chunk,chunks", [("3", [3, 2]), ("auto", [5])])
def test_chunked_run_equals_per_epoch_bit_for_bit(name, chunk, chunks, capsys):
    want = _per_epoch(name)
    capsys.readouterr()
    model = _model(name, chunk)
    model.fit()
    _assert_same(_outcome(model), want)
    timer = model.phase_timers[0]
    assert [e for _, e in timer.chunks] == chunks
    assert timer.captures == []  # no CUDA graph on the CPU
    # each epoch's line carries its chunk's wall / E
    assert len(timer.times) == 5
    assert timer.times[0] == pytest.approx(timer.chunks[0][0] / chunks[0])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if " epoch " in ln and "loss" in ln]
    assert len(lines) == 5
    assert all((" incl. eval" in ln) == (name == "SimGCL") for ln in lines)


@pytest.mark.parametrize("name", ["LightGCN", "SimGCL"])
def test_per_epoch_run_is_not_chunked(name):
    model = _model(name, "1")
    model.fit()
    timer = model.phase_timers[0]
    assert [e for _, e in timer.chunks] == [1] * 5 and timer.captures == []


def _two_phases(chunk):
    """SimGCL trained in two phases of 3 epochs that share one tracker."""
    model = _model("SimGCL", chunk)
    spec = model.build()
    model.begin_fit()
    tracker = T.BestTracker()
    for return_best in (False, True):
        model.run_training(spec.params, spec.loss_fn, spec.sampler, track_best=True,
                           max_epoch=3, tracker=tracker, return_best=return_best,
                           quick_eval=lambda: model.quick_eval(spec), chunkable=True,
                           eval_vector=lambda: model.quick_eval_vector(spec))
    return model, tracker


def test_shared_tracker_is_seeded_and_written_back():
    host, host_tracker = _two_phases("1")
    dev, dev_tracker = _two_phases("auto")
    assert [[e for _, e in pt.chunks] for pt in dev.phase_timers] == [[3], [3]]
    assert dev.epoch_losses == host.epoch_losses
    assert dev_tracker.epoch_offset == host_tracker.epoch_offset == 6
    assert dev_tracker.best_epoch == host_tracker.best_epoch
    assert dev_tracker.best_metrics == host_tracker.best_metrics
    assert all(torch.equal(a, b) for a, b in zip(dev_tracker.best_params, host_tracker.best_params))
    assert torch.equal(dev.user_emb, host.user_emb) and torch.equal(dev.item_emb, host.item_emb)


def test_device_vote_seeds_from_a_tracker_and_votes_as_it_does():
    """Epochs that tie, lose and win against a seeded best: the device vote
    picks what ``BestTracker.update`` picks."""
    p = [torch.zeros(3)]
    tracker = T.BestTracker()
    tracker.update(0, dict(zip(T.METRIC_KEYS, [0.2, 0.2, 0.2, 0.2])))
    tracker.best_params = [torch.full((3,), 7.0)]
    vote = T.DeviceVote(p, tracker, next_epoch=1)
    host = T.BestTracker()
    host.update(0, dict(tracker.best_metrics))
    for k, vec in enumerate([[0.2, 0.2, 0.2, 0.2], [0.1, 0.3, 0.1, 0.3], [0.1, 0.3, 0.3, 0.3],
                             [0.0, 0.0, 0.0, 0.0]], start=1):
        p[0].fill_(float(k))
        vote.vote(torch.tensor(vec), p)
        if host.update(k, dict(zip(T.METRIC_KEYS, vec))):
            host.best_params = [p[0].clone()]
    vote.write_back(tracker)
    assert tracker.best_epoch == host.best_epoch and tracker.best_metrics == pytest.approx(host.best_metrics)
    assert torch.equal(tracker.best_params[0], torch.full((3,), float(host.best_epoch - 1)))


@pytest.mark.parametrize("fail_epoch,boundary", [(1, 0), (4, 3)], ids=["first-chunk", "second-chunk"])
def test_failed_dispatch_leaves_the_committed_boundary(fail_epoch, boundary):
    """A step raising in a chunk's second epoch: the error propagates and
    the loop state is the last committed chunk boundary, parameters,
    optimizer state and generator included."""
    def chunked(loss_fn=None):
        """A fresh spec's chunked loop in chunks of 3, as ``train`` builds it."""
        model = _model("LightGCN")
        spec = model.build()
        model.begin_fit()
        opt = T.make_optimizer(spec.params, "adam", model.lrate)
        T.init_adam_state(opt)
        st = T.LoopState(0, spec.params, opt, torch.Generator().manual_seed(model.seed + 1))
        prog = T.EpochProgram(st, loss_fn or spec.loss_fn, spec.sampler, "cpu")
        return spec, st, T.ChunkedLoop(prog, 3, timer=StepTimer(1), emit=None, lr=model.lrate)

    calls = [0]

    def failing(batch, gen):
        calls[0] += 1
        if calls[0] == fail_epoch * steps + 1:
            raise RuntimeError("injected failure")
        return spec.loss_fn(batch, gen)

    spec, st, loop = chunked(failing)
    steps = spec.sampler(torch.Generator().manual_seed(0))[0].shape[0]
    with pytest.raises(RuntimeError, match="injected failure"):
        loop.run(st, 6)
    assert st.epoch == boundary
    clean_spec, clean, clean_loop = chunked()
    clean_loop.run(clean, boundary)
    for got, want in zip(spec.params, clean_spec.params):
        assert torch.equal(got, want)
    assert {float(st.optimizer.state[p]["step"]) for p in spec.params} == {float(boundary * steps)}
    assert torch.equal(st.generator.get_state(), clean.generator.get_state())


def test_train_chunk_setting_is_read_as_the_jax_package_reads_it(capsys):
    assert _model("LightGCN", "auto").train_chunk() == 8
    assert _model("LightGCN", "3").train_chunk() == 3
    assert _model("LightGCN", "0").train_chunk() == 1
    with pytest.raises(ConfigError):
        _model("LightGCN", "eight").train_chunk()
    # no chunk under checkpoint.setup (nor bold, a rating run, a mesh)
    m = _model("LightGCN", "4", extra={"checkpoint.setup": "on -dir ckpt -every 1"})
    assert m._chunk_for("adam", True, True) == 1
    assert "train.chunk=4 not applied, runs per epoch: checkpoint.setup" in capsys.readouterr().out
    m = _model("LightGCN", "4")
    assert m._chunk_for("bold", True, True) == 1
    assert m._chunk_for("adam", True, True) == 4
    assert m._chunk_for("adam", True, False) == 1


@pytest.mark.parametrize("chunk,noted", [("4", True), ("auto", False)])
def test_a_spec_that_is_not_chunkable_says_it_runs_per_epoch(tmp_path, capsys, chunk, noted):
    """BPR's spec is not chunked in the port: a conf asking for chunks of 4
    gets one line saying so, ``auto`` none."""
    ratings = tmp_path / "r.txt"
    rng = np.random.RandomState(0)
    ratings.write_text("".join(f"u{u} i{i} 1\n" for u in range(20)
                               for i in rng.choice(30, size=6, replace=False)))
    conf = ModelConf({
        "ratings": str(ratings), "ratings.setup": "-columns 0 1 2", "model.name": "BPR",
        "evaluation.setup": "-ap 0.2", "item.ranking": "on -topN 5", "num.factors": "8",
        "num.max.epoch": "3", "batch_size": "16", "learnRate": "-init 0.01 -max 1",
        "reg.lambda": "-u 0.01 -i 0.01 -b 0.1", "output.setup": "off -dir ./results/",
        "train.chunk": chunk,
    })
    rec = QRec(conf, device="cpu")
    rec.execute()
    out = capsys.readouterr().out
    assert out.count("not applied, runs per epoch") == (1 if noted else 0)
    assert all(t.captures == [] and {e for _, e in t.chunks} == {1} for t in rec.model.phase_timers)


def test_lag1_loss_is_read_after_the_next_epoch():
    """With nothing on the host reading an epoch, epoch e's loss is read
    and printed after epoch e+1 is enqueued, and the timer does not
    synchronise; the losses are the synchronous loop's."""
    w = torch.nn.Parameter(torch.ones(3))
    events = []

    def loss_fn(batch, gen):
        events.append("step")
        return ((w - batch[0][:, None]) ** 2).sum()

    def run(quick_eval):
        with torch.no_grad():
            w.fill_(1.0)
        events.clear()
        batches = [(np.full((2, 4), float(e)),) for e in range(3)]
        losses, timer = T.train([w], loss_fn, None, max_epoch=3, lr=0.1, device="cpu",
                                generator=torch.Generator(), examples_per_epoch=8,
                                emit=lambda e, *a, **k: events.append(f"emit {e}"),
                                epoch_batches=batches, quick_eval=quick_eval)
        return losses, list(events), timer

    lagged, order, timer = run(None)
    assert order == ["step", "step", "step", "step", "emit 0", "step", "step", "emit 1", "emit 2"]
    assert not timer.sync and len(timer.times) == 3
    synced, order, timer = run(lambda: {})
    assert order == ["step", "step", "emit 0", "step", "step", "emit 1", "step", "step", "emit 2"]
    assert timer.sync
    assert lagged == synced


def test_lag1_loss_still_aborts_on_nan():
    """The NaN abort of a lag-1 run comes when epoch 1's loss is read, once
    epoch 2 is enqueued."""
    w = torch.nn.Parameter(torch.ones(1))
    steps = [0]

    def loss_fn(batch, gen):
        steps[0] += 1
        return (w * 0).sum() + float("nan")

    with pytest.raises(Exception, match="NaN"):
        T.train([w], loss_fn, None, max_epoch=3, lr=0.1, device="cpu",
                generator=torch.Generator(), examples_per_epoch=1,
                epoch_batches=[(np.zeros((1, 1)),)] * 3)
    assert steps[0] == 2


def _csr(rows):
    indptr = np.concatenate([[0], np.cumsum([len(r) for r in rows])]).astype(np.int64)
    return indptr, np.concatenate([np.sort(r) for r in rows]).astype(np.int64)


@pytest.mark.parametrize("seed", range(6))
def test_sync_free_negatives_are_never_positive_and_exact_is_the_kth(seed):
    rng = np.random.RandomState(seed)
    items, users = 40, 7
    rows = [rng.choice(items, size=rng.randint(0, 30), replace=False) for _ in range(users - 2)]
    rows.append(rng.permutation(items)[: items - 1])  # one free item: the tries fail
    rows.append(rng.permutation(items))  # no free item: the JAX package's last item
    indptr, indices = _csr(rows)
    indptr_t, indices_t = torch.from_numpy(indptr), torch.from_numpy(indices)
    bm = torch.from_numpy(S.pack_bitmask(indptr, indices, users, items))
    q = torch.as_tensor(rng.randint(0, users, size=300), dtype=torch.int64)
    q[:2] = users - 1
    neg = S.sample_negatives(torch.Generator().manual_seed(seed), q, items, indices_t, indptr_t,
                             bm, num_tries=2, row_iters=S._bisect_iters(items))
    full = q == users - 1
    assert not S.bitmask_member(bm, q[~full], neg[~full]).any()
    assert (neg[q == users - 2] == np.setdiff1d(np.arange(items), rows[-2])[0]).all()
    assert (neg[full] == items - 1).all()
    # the exact draw is the k-th non-rated item of the k its uniform gives
    gen = torch.Generator().manual_seed(seed + 100)
    twin = torch.Generator()
    twin.set_state(gen.get_state())
    exact = S.sample_negatives_exact(twin, q, items, indices_t, indptr_t,
                                     row_iters=S._bisect_iters(items))
    draw = torch.rand(q.shape, generator=gen, dtype=torch.float64).numpy()
    assert ((exact >= 0) & (exact < items)).all()
    for u, d, got in zip(q.tolist(), draw, exact.tolist()):
        free = np.setdiff1d(np.arange(items), rows[u])
        k = min(int(d * len(free)), len(free) - 1)
        assert got == (free[k] if len(free) else items - 1)


def test_sampler_stream_does_not_depend_on_what_the_tries_found():
    """The generator advances by the same draws whether every try hits a
    non-positive or every query falls back: no host branch."""
    items = 16
    empty = _csr([np.array([], dtype=np.int64)] * 2)
    full = _csr([np.arange(items - 1)] * 2)
    states = []
    for indptr, indices in (empty, full):
        bm = torch.from_numpy(S.pack_bitmask(indptr, indices, 2, items))
        gen = torch.Generator().manual_seed(3)
        S.sample_negatives(gen, torch.tensor([0, 1] * 50), items, torch.from_numpy(indices),
                           torch.from_numpy(indptr), bm, num_tries=2, row_iters=6)
        states.append(gen.get_state())
    assert torch.equal(states[0], states[1])


def test_ranker_idcg_table_is_built_once_and_read():
    model = _model("LightGCN")
    ranker = model._quick_ranker()
    assert torch.equal(ranker.idcg, torch.from_numpy(idcg_table(5)))
    ids = torch.randint(0, model.num_items, (len(ranker.uids), 5), generator=torch.Generator().manual_seed(0))
    a = device_ranking_metrics(ids, ranker.test_ids, ranker.test_counts, [5])[5]
    b = device_ranking_metrics(ids, ranker.test_ids, ranker.test_counts, [5], ranker.idcg)[5]
    assert all(torch.equal(a[k], b[k]) for k in a)
    with pytest.raises(ValueError):
        device_ranking_metrics(ids, ranker.test_ids, ranker.test_counts, [5], ranker.idcg[:3])
    vec = model.quick_eval_vector(model.build())
    assert vec.dtype == torch.float32 and vec.shape == (4,)
    assert model.quick_eval(model.build()) == dict(zip(T.METRIC_KEYS, vec.tolist()))


def test_graph_launches_count_every_replay():
    """A capture's tally is added once a replay; counts a warm-up made are
    put back; a second capture cannot start inside one."""
    before = K.launch_counts()
    try:
        K.reset_launch_counts()
        launches = K.GraphLaunches()
        with launches.record():
            assert K._recording is launches.counts
            K._recording["bipartite_dual_matmul"] = 4
            K._recording["infonce_fwd"] = 1
            with pytest.raises(RuntimeError):
                with K.GraphLaunches().record():
                    pass
        assert K._recording is None
        for _ in range(3):
            launches.add()
        counts = K.launch_counts()
        assert counts["bipartite_dual_matmul"] == 12 and counts["infonce_fwd"] == 3
        K.DUAL.launches += 5
        K.set_launch_counts(counts)
        assert K.launch_counts() == counts
    finally:
        K.set_launch_counts(before)


def test_step_timer_times_chunks():
    timer = StepTimer(10)
    with timer.chunk(4):
        pass
    with timer:
        pass
    with pytest.raises(KeyError):
        with timer.chunk(3):
            raise KeyError("x")
    assert [e for _, e in timer.chunks] == [4, 1]
    assert len(timer.times) == 5 and timer.times[:4] == [timer.chunks[0][0] / 4] * 4
    with timer.capture():
        pass
    with pytest.raises(KeyError):
        with timer.capture():
            raise KeyError("x")
    assert len(timer.captures) == 1 and len(timer.times) == 5


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------


def _jax_pair(name):
    conf = _conf(name, "auto", epochs=2, extra={"learnRate": "-init 0.001 -max 1"})
    train, test = _records()
    jd = JInteractions(jconfig.ModelConf(conf), train, test)
    jmodel = {"LightGCN": JLightGCN, "SimGCL": JSimGCL, "SGL": JSGL}[name](jconfig.ModelConf(conf), jd)
    spec = jmodel.build()
    tmodel = CLASSES[name](ModelConf(conf), Interactions(ModelConf(conf), train, test), device="cpu")
    convert = lightgcn_params_from_jax if name == "LightGCN" else embedding_params_from_jax
    tmodel.load_state_dict(convert({k: np.asarray(v) for k, v in spec.params.items()}, "cpu"))
    return jmodel, spec, tmodel


@pytest.mark.parametrize("name", ["LightGCN", "SimGCL", "SGL"])
def test_chunked_port_on_jax_batches_matches_jax(name):
    """Two epochs under ``train.chunk=auto`` (one chunk) on the JAX sampler's
    batches and, for SimGCL and SGL, the JAX step keys' draws, within the
    bounds of ``tests/test_torch_lightgcn.py`` and ``tests/test_torch_ssl.py``."""
    from tests.test_torch_ssl import _draws

    jmodel, spec, tmodel = _jax_pair(name)
    optimizer = optax.adam(jmodel.lrate)
    run_epoch = jtrainer.make_epoch_runner(spec.loss_fn, optimizer)
    params, opt_state = spec.params, optimizer.init(spec.params)
    rng = jax.random.PRNGKey(0)
    batches, jlosses, jparams, draws = [], [], [], []
    for _ in range(2):
        rng, rs, rt = jax.random.split(rng, 3)
        b = spec.sampler(rs)
        batches.append(tuple(np.asarray(a) for a in b))
        if name != "LightGCN":
            draws += [_draws(tmodel, r) for r in jax.random.split(rt, b[0].shape[0])]
        params, opt_state, loss = run_epoch(params, opt_state, b, rt, spec.consts)
        jlosses.append(float(loss))
        jparams.append(params)
    if draws:
        stream = iter(draws)
        tmodel.draw = lambda gen: next(stream)
    losses = tmodel.fit(epoch_batches=batches)
    assert [e for _, e in tmodel.phase_timers[0].chunks] == [2]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-3)
    want = jparams[-1] if tmodel.tracker is None else jparams[tmodel.tracker.best_epoch - 1]
    np.testing.assert_allclose(tmodel.user_emb.detach().numpy(), np.asarray(want["user_emb"]), atol=1e-4)
    np.testing.assert_allclose(tmodel.item_emb.detach().numpy(), np.asarray(want["item_emb"]), atol=1e-4)


_LOSS = re.compile(r"epoch (\d+): loss = ([-0-9.e+]+)")


@pytest.mark.parametrize("name", ["LightGCN", "SimGCL"])
def test_jax_package_chunked_run_matches_its_per_epoch_run(name, capsys):
    """The JAX package's own claim (``tests/test_end_to_end.py:158``): its
    ``train.chunk=auto`` run gives the losses, the best epoch and the final
    tables of its ``train.chunk=1`` run."""
    train, test = _records()
    out = {}
    for chunk in ("1", "auto"):
        conf = jconfig.ModelConf(_conf(name, chunk, epochs=4))
        model = {"LightGCN": JLightGCN, "SimGCL": JSimGCL}[name](
            conf, JInteractions(conf, train, test))
        model.fit()
        text = capsys.readouterr().out
        out[chunk] = (_LOSS.findall(text), re.findall(r"best epoch (\d+)", text),
                      np.asarray(model.U), np.asarray(model.V))
    assert len(out["1"][0]) == 4 and out["auto"][0] == out["1"][0]
    assert out["auto"][1] == out["1"][1]
    np.testing.assert_array_equal(out["auto"][2], out["1"][2])
    np.testing.assert_array_equal(out["auto"][3], out["1"][3])
