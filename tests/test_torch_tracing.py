"""The port's spans and device marks (``runtime/profiling.py``): the span
tree of a chunked fit, the marks a chunk reads on the CPU (where the
device is the host), the ranker's spans, the bounded buffer, the spans
in ``torch.profiler``'s events, ``StepTimer.captures`` as a view of the
``graph.build`` spans, and the benchmark's readers of them
(``portbench/metrics``). The CUDA graph's marks are checked on a card
(``tests/test_torch_kernels_cuda.py``)."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench import harness
from qrec_tpu_torch import ModelConf
from qrec_tpu_torch.data.dataset import Interactions
from qrec_tpu_torch.models.graph import LightGCN, SimGCL
from qrec_tpu_torch.ops.topk import CatalogRanker, ScoreForm
from qrec_tpu_torch.runtime import profiling as P
from qrec_tpu_torch.runtime import trainer as T


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


ARGS = {"LightGCN": "-n_layer 2", "SimGCL": "-n_layer 2 -lambda 0.1 -eps 0.1"}


def _model(tiny_data, name="LightGCN", chunk="2", epochs=3):
    """The port's ``name`` on ``tiny_data``'s records, ``epochs`` epochs in
    chunks of ``chunk`` (batches of 8: 3 steps an epoch)."""
    conf = ModelConf({
        "ratings": "unused", "ratings.setup": "-columns 0 1 2", "model.name": name,
        "evaluation.setup": "-ap 0.2", "item.ranking": "on -topN 5", "num.factors": "8",
        "num.max.epoch": str(epochs), "batch_size": "8", "learnRate": "-init 0.01 -max 1",
        "reg.lambda": "-u 0.001 -i 0.001 -b 0.2 -s 0.2", name: ARGS[name],
        "output.setup": "off -dir ./results/", "seed": "11", "train.chunk": chunk,
    })
    data = Interactions(conf, tiny_data.training_data, tiny_data.test_data)
    return CLASSES[name](conf, data, device="cpu")


CLASSES = {"LightGCN": LightGCN, "SimGCL": SimGCL}


def _fit_spans(model):
    return [s for s in P.recorder().spans if s.fit == model.fit_id]


def _inside(child, parent) -> bool:
    return parent.start_ns <= child.start_ns <= child.end_ns <= parent.end_ns


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------


def test_span_tree_of_a_chunked_fit(tiny_data):
    model = _model(tiny_data)
    model.fit()
    spans = _fit_spans(model)
    by_id = {s.id: s for s in spans}
    names = [s.name for s in spans]
    assert {"fit", "fit.spec", "graph.adjacency", "trainer.optimizer", "loop.chunk", "loop.read",
            "loop.commit", "loop.emit", "model.finalize"} == set(names)
    assert all(s.end_ns is not None and s.start_ns <= s.end_ns for s in spans)
    # one fit: its span holds every other span of the fit, through parents
    # that belong to it
    (fit,) = [s for s in spans if s.name == "fit"]
    assert model.fit_id == fit.fit and P.recorder().fit is None
    for s in spans:
        if s is not fit:
            assert s.parent in by_id and _inside(s, by_id[s.parent])
    parents = {s.name: by_id[s.parent].name for s in spans if s is not fit}
    assert parents == {"fit.spec": "fit", "graph.adjacency": "fit.spec",
                       "trainer.optimizer": "fit", "loop.chunk": "fit", "loop.read": "loop.chunk",
                       "loop.commit": "loop.chunk", "loop.emit": "loop.chunk",
                       "model.finalize": "fit"}
    # one loop.chunk a chunk, each with one read, commit and emit
    chunks = [s for s in spans if s.name == "loop.chunk"]
    assert [(s.attrs["epoch"], s.attrs["epochs"]) for s in chunks] == [(0, 2), (2, 1)]
    assert [e for _, e in model.phase_timers[0].chunks] == [2, 1]
    for c in chunks:
        kids = [s.name for s in spans if s.parent == c.id]
        assert kids == ["loop.read", "loop.commit", "loop.emit"]
    # the spans in the order they started, ids rising
    assert [s.id for s in spans] == sorted(s.id for s in spans)
    assert [s.start_ns for s in spans] == sorted(s.start_ns for s in spans)


def test_model_spans_outside_the_fit(tiny_data):
    before = P.recorder().last_fit
    model = _model(tiny_data, chunk="1", epochs=1)
    inits = [s for s in P.recorder().spans if s.name == "model.init"]
    assert inits and inits[-1].fit is None and inits[-1].parent is None
    # the construction is one span, however many classes' __init__ run
    assert not any(s.parent == inits[-1].id for s in P.recorder().spans)
    model.fit()
    assert model.fit_id == P.recorder().last_fit == (before or 0) + 1
    # the per-epoch loop: no chunk, no marks
    assert not any(s.name.startswith("loop.") for s in _fit_spans(model))
    assert not [r for r in P.recorder().readings if r["fit"] == model.fit_id]


def test_a_span_ended_by_an_exception_names_it():
    rec = P.Recorder()
    with pytest.raises(KeyError):
        with rec.span("outer", epoch=3):
            with rec.span("inner"):
                raise KeyError("x")
    outer, inner = rec.spans
    assert outer.attrs == {"epoch": 3, "error": "KeyError"} and inner.attrs == {"error": "KeyError"}
    assert inner.parent == outer.id and outer.parent is None
    assert rec._local.stack == []


def test_a_span_inside_one_of_its_name_folds_into_it():
    rec = P.Recorder()
    with rec.span("a") as a:
        with rec.span("a") as inner:
            with rec.span("b"):
                pass
    assert inner is a and [s.name for s in rec.spans] == ["a", "b"]
    assert rec.spans[1].parent == a.id


def test_spanned_wraps_every_call(monkeypatch):
    rec = P.Recorder()
    monkeypatch.setattr(P, "_RECORDER", rec)

    @P.spanned("work")
    def work(x, y=1):
        return x + y

    assert work(2, y=3) == 5 and work.__name__ == "work"
    assert [s.name for s in rec.spans] == ["work"]


def test_bounded_buffer_counts_what_it_drops():
    rec = P.Recorder(capacity=4)
    for k in range(10):
        with rec.span(f"s{k}"):
            pass
    assert [s.name for s in rec.spans] == ["s6", "s7", "s8", "s9"]
    assert rec.dropped == 6 and len(rec.spans) == 4
    assert [s.id for s in rec.spans] == [6, 7, 8, 9]
    rec.clear()
    assert rec.dropped == 0 and not rec.spans
    with rec.span("t"):
        pass
    assert rec.dropped == 0 and rec.spans[0].id == 10
    rec = P.Recorder(readings=2)
    for k in range(3):
        rec.reading(epoch=k)
    assert [r["epoch"] for r in rec.readings] == [1, 2]


def test_spans_enter_the_profiler_only_while_it_records(monkeypatch):
    rec = P.Recorder()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with rec.span("outer"):
            with rec.span("inner"):
                torch.ones(4).sum()
    names = {e.name for e in prof.events()}
    assert {"qrec.outer", "qrec.inner"} <= names

    def refused(name):
        raise AssertionError(f"record_function({name!r}) entered without a profiler")

    monkeypatch.setattr(P, "record_function", refused)
    with rec.span("quiet"):
        pass
    assert rec.spans[-1].name == "quiet" and rec.spans[-1].end_ns is not None


def test_a_span_that_outlives_the_profiler_closes():
    rec = P.Recorder()
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    with rec.span("across"):
        prof.stop()
    assert rec.spans[0].end_ns is not None and "qrec.across" in {e.name for e in prof.events()}


def test_ranker_spans_of_one_topk(tiny_data):
    model = _model(tiny_data)
    data = model.data
    gen = torch.Generator().manual_seed(3)
    form = ScoreForm(torch.rand((data.num_users, 8), generator=gen),
                     torch.rand((data.num_items, 8), generator=gen))
    ranker = CatalogRanker(data, k=3, device="cpu", bitmask=model.rated_bitmask, batch_size=2)
    start = P.recorder()._ids
    ids, scores = ranker.topk(form)
    assert ids.shape == (len(ranker.uids), 3) and ids.dtype == np.int32
    spans = [s for s in P.recorder().spans if s.id >= start]
    assert [s.name for s in spans] == ["ranker.topk", "ranker.enqueue", "ranker.host_copy"]
    topk, enqueue, copy = spans
    assert enqueue.parent == copy.parent == topk.id and topk.parent is None
    assert _inside(enqueue, topk) and _inside(copy, topk) and enqueue.end_ns <= copy.start_ns


# ---------------------------------------------------------------------------
# marks
# ---------------------------------------------------------------------------


def test_cpu_marks_of_a_chunked_fit(tiny_data):
    model = _model(tiny_data, "SimGCL")
    model.fit()
    readings = [r for r in P.recorder().readings if r["fit"] == model.fit_id]
    chunks = model.phase_timers[0].chunks
    assert [(r["epoch"], r["epochs"]) for r in readings] == [(1, 2), (2, 1)]
    for r, (wall, epochs) in zip(readings, chunks):
        phases = ("sampler_ms", "steps_ms", "eval_ms", "step_ms", "forward_ms", "backward_ms",
                  "optimizer_ms")
        assert all(r[k] > 0 for k in phases), r
        # the chunk's last epoch lies inside the chunk; a chunk of one
        # epoch is its wall over its epochs
        assert r["sampler_ms"] + r["steps_ms"] + r["eval_ms"] <= wall * 1e3
        # the marked step is one of the epoch's steps
        assert r["step_ms"] <= r["steps_ms"]
        assert r["forward_ms"] + r["backward_ms"] + r["optimizer_ms"] == pytest.approx(
            r["step_ms"])


def test_marks_leave_the_numbers_as_they_were(tiny_data):
    """The chunked form with its marks, the per-epoch form without any:
    the same losses and tables, bit for bit."""
    a, b = _model(tiny_data, chunk="2"), _model(tiny_data, chunk="1")
    a.fit()
    b.fit()
    assert a.epoch_losses == b.epoch_losses
    assert torch.equal(a.user_emb, b.user_emb) and torch.equal(a.item_emb, b.item_emb)


def test_own_loop_reads_its_marks_at_printed_epochs():
    rec = P.recorder()
    fit = rec.begin_fit()
    try:
        table = torch.zeros(3)

        def epoch_fn(batches, gen):
            table.add_(1.0)
            return table[:1].clone()

        rows = T.run_own_epochs([table], [], None, epoch_fn, epochs=5, every=2, device="cpu",
                                timer=P.StepTimer(3), graphs=True, emit=lambda e, row: None)
    finally:
        rec.end_fit()
    assert rows == [[1.0], [2.0], [3.0], [4.0], [5.0]]
    readings = [r for r in rec.readings if r["fit"] == fit]
    assert [(r["epoch"], r["epochs"]) for r in readings] == [(1, 2), (3, 2), (4, 1)]
    assert all(r["sampler_ms"] >= 0 and r["steps_ms"] > 0 and "step_ms" not in r
               for r in readings)


def test_step_marks_only_inside_steps():
    marks = P.DeviceMarks("cpu")
    assert P.step_marks() is None
    with marks.steps():
        assert P.step_marks() is marks
    assert P.step_marks() is None
    assert marks.read() == {} and marks.ms("start", "sampled") is None
    marks.mark("start")
    marks.mark("sampled")
    assert list(marks.read()) == ["sampler_ms"] and marks.read()["sampler_ms"] >= 0


def test_step_timer_captures_are_graph_build_spans():
    timer = P.StepTimer(10)
    start = P.recorder()._ids
    with timer.capture():
        pass
    with pytest.raises(KeyError):
        with timer.capture():
            raise KeyError("x")
    with timer.capture():
        pass
    builds = [s for s in P.recorder().spans if s.id >= start and s.name == "graph.build"]
    assert len(builds) == 3 and builds[1].attrs == {"error": "KeyError"}
    assert timer.captures == [builds[0].seconds, builds[2].seconds]
    assert all(c >= 0 for c in timer.captures)


# ---------------------------------------------------------------------------
# the benchmark's readers
# ---------------------------------------------------------------------------


def _span(rec, name, ms, fit=None, parent=None):
    """A closed span ``name`` of ``ms`` milliseconds, made by hand after
    the recorder's last one."""
    s = P.Span(rec, name, None, [])
    s.id, s.parent, s.fit = rec._ids, parent, fit
    rec._ids += 1
    last = rec.spans[-1].end_ns if rec.spans else 0
    s.start_ns = last + 1000
    s.end_ns = s.start_ns + int(ms * 1e6)
    rec.spans.append(s)
    return s


def _hand_made():
    """A recorder holding an earlier fit, then the fit the readers read,
    then three evaluations outside any fit."""
    rec = P.Recorder()
    old = rec.begin_fit()
    _span(rec, "graph.warmup", 900.0, old)
    rec.reading(sampler_ms=9.0, eval_ms=9.0, step_ms=1.0, optimizer_ms=0.9)
    rec.end_fit()
    fit = rec.begin_fit()
    _span(rec, "trainer.optimizer", 1500.0, fit)
    _span(rec, "trainer.optimizer", 2.0, fit)
    _span(rec, "graph.warmup", 400.0, fit)
    _span(rec, "graph.capture", 100.0, fit)
    _span(rec, "graph.warmup", 40.0, fit)
    _span(rec, "graph.capture", 10.0, fit)
    for ms in (0.02, 0.03, 0.5):
        _span(rec, "graph.replay", ms, fit)
    for sampler, evaluate, step, opt in ((1.0, 3.0, 2.0, 0.5), (2.0, 4.0, 4.0, 1.0),
                                         (9.0, 5.0, 1.0, 0.1)):
        rec.reading(epoch=1, epochs=2, sampler_ms=sampler, steps_ms=10.0, eval_ms=evaluate,
                    step_ms=step, optimizer_ms=opt)
    rec.end_fit()
    for finalize, enqueue in ((1.0, 2.0), (1.5, 2.5), (3.0, 9.0)):
        _span(rec, "model.finalize", finalize)
        top = _span(rec, "ranker.topk", enqueue + 1.0)
        _span(rec, "ranker.enqueue", enqueue, parent=top.id)
        _span(rec, "ranker.host_copy", 0.5, parent=top.id)
    return rec


READERS = {
    "warmup_s": 0.44, "capture_s": 0.11, "optimizer_init_s": 1.5,
    "graph_launch_ms.train": 0.03, "graph_launch_ms.lastfm": 0.03,
    "sampler_ms.train": 2.0, "sampler_ms.lastfm": 2.0,
    "optimizer_share.train": 25.0, "optimizer_share.lastfm": 25.0,
    "quick_eval_ms.train": 4.0, "rank_enqueue_ms.rank": 4.0,
}


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_from_a_hand_made_recorder(name, monkeypatch):
    rec = _hand_made()
    monkeypatch.setattr(P, "recorder", lambda: rec)
    assert harness.metric_module(name).read({}, None) == pytest.approx(READERS[name])


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_without_its_spans(name, monkeypatch):
    rec = P.Recorder()
    monkeypatch.setattr(P, "recorder", lambda: rec)
    reader = harness.metric_module(name)
    assert reader.read({}, None) is None
    # a fit without the spans and readings it reads
    rec.begin_fit()
    with rec.span("fit"):
        rec.reading(epoch=0, epochs=1)
    rec.end_fit()
    assert reader.read({}, None) is None
    # a program with no recorder at all
    monkeypatch.delattr(P, "recorder")
    assert reader.read({}, None) is None
