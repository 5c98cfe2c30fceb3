"""The work counts against hand arithmetic at tiny shapes, the trace's
interval arithmetic, and the metric readers on hand-made records."""

from __future__ import annotations

import pytest

from portbench import harness, trace, work


def test_propagation_count():
    # U=3, I=4, 5 nonzeros, d=2: 2 x 2 x 5 x 2 operations; indices 5 x 4,
    # row pointers 4 x 4, scales 7 x 4, input 7 x 2 x 2, output 7 x 2 x 4
    w = work.propagation(3, 4, 5, 2)
    assert w.flops == 40
    assert w.bytes == 20 + 16 + 28 + 28 + 56


def test_infonce_and_topk_counts():
    w = work.infonce(3, 2)
    assert w.flops == 2 * 9 * 2 + 6 * 9 * 2
    assert w.bytes == 2 * 3 * 2 * 4 + 2 * 3 * 2 * 4
    t = work.topk(2, 33, 4, 3)
    assert t.flops == 2 * 2 * 33 * 4
    assert t.bytes == 2 * 4 * 4 + 33 * 4 * 4 + 2 * 2 * 4 + 2 * 3 * 8


def test_least_time_takes_the_larger_bound():
    w = work.Work(989e12, 0.0)
    assert w.least_s(work.PEAK_BF16) == pytest.approx(1.0)
    w = work.Work(0.0, 3.35e12)
    assert w.least_s(work.PEAK_BF16) == pytest.approx(1.0)


SHAPES = {"model": "SimGCL", "users": 3, "items": 4, "edges": 5, "d": 2, "layers": 2,
          "batch": 4, "pairs": 5, "steps": 2, "test_users": 2, "top_n": 3, "evaluates": True,
          "unique_users": 3.0, "unique_items": 2.0}


def test_epoch_counts():
    step = work.step_propagation(SHAPES)
    assert step == (work.propagation(3, 4, 5, 2) + work.propagation(3, 4, 5, 6)).scaled(2)
    epoch = work.epoch_propagation(SHAPES)
    assert epoch == step.scaled(2) + work.propagation(3, 4, 5, 2).scaled(2)
    inf = work.epoch_infonce(SHAPES)
    assert inf.flops == 2 * 8 * (9 + 4) * 2
    model = work.epoch_model(SHAPES)
    assert model.flops == pytest.approx(epoch.flops + inf.flops + 30 * 5 * 2 + 2 * 2 * 4 * 2)
    light = dict(SHAPES, model="LightGCN", evaluates=False)
    assert work.step_propagation(light) == work.propagation(3, 4, 5, 2).scaled(4)
    assert work.epoch_infonce(light) == work.NONE


def test_busy_union_and_gaps():
    merged = trace.busy_union([(5, 7), (0, 2), (1, 3), (6, 9), (12, 13)])
    assert merged == [(0, 3), (5, 9), (12, 13)]
    assert trace.gaps(merged) == [(3, 5), (9, 12)]
    host = [(0, 10, "a"), (2, 4, "b"), (8, 20, "c")]
    starts = [h[0] for h in host]
    assert trace._host_label(host, starts, 3) == "b"
    assert trace._host_label(host, starts, 9) == "c"
    assert trace._host_label(host, starts, 25) == "idle host"


class _Summary:
    def __init__(self, by_name_ms, busy_s):
        self.by_name_ms, self.busy_s = by_name_ms, busy_s


def test_readers_on_a_hand_made_record():
    rec = {"shapes": SHAPES, "profiled_epochs": 1, "window_s": 2.0, "epochs": 4,
           "chunk_walls": [0.9, 0.9], "boundary_walls": [1.0, 1.0], "fit_lead_s": 0.75,
           "host_build_s": 3.0}
    summ = _Summary({"void dual_regions<true>(Args)": 1.0, "reduce_partials": 1.0,
                     "infonce_fwd_tiles": 0.5, "other": 3.0}, 0.75)
    read = lambda name, s=summ: harness.metric_module(name).read(rec, s)  # noqa: E731
    need = work.epoch_propagation(SHAPES).least_s(work.PEAK_BF16)
    assert read("propagation_roofline.train") == pytest.approx(need / 2e-3 * 100)
    need = work.epoch_infonce(SHAPES).least_s(work.PEAK_TF32)
    assert read("infonce_roofline") == pytest.approx(need / 0.5e-3 * 100)
    assert read("device_idle_share.train") == pytest.approx(25.0)
    assert read("host_gap_share.train") == pytest.approx(10.0)
    assert read("fit_lead_s") == pytest.approx(0.75)
    assert read("host_build_s") == 3.0
    flops = work.epoch_model(SHAPES).flops * 4
    assert read("train_mfu") == pytest.approx(flops / (2.0 * work.PEAK_BF16) * 100)
    assert read("propagation_roofline.train", None) is None
    assert read("device_idle_share.train", None) is None


def test_rank_readers():
    rec = {"shapes": SHAPES, "profiled_evaluations": 2, "evaluations": 10, "window_s": 1.0}
    summ = _Summary({"catalog_tiles<4>": 2.0, "dual_regions": 1.0}, 0.1)
    read = lambda name: harness.metric_module(name).read(rec, summ)  # noqa: E731
    assert read("device_idle_share.rank") == pytest.approx((1 - 0.1 / 0.2) * 100)
    need = work.topk(2, 4, 2, 3).scaled(2).least_s(work.PEAK_TF32)
    assert read("topk_roofline.rank") == pytest.approx(need / 2e-3 * 100)
    need = work.propagation(3, 4, 5, 2).scaled(4).least_s(work.PEAK_BF16)
    assert read("propagation_roofline.rank") == pytest.approx(need / 1e-3 * 100)
    assert read("rank_mfu") == pytest.approx(
        work.evaluation(SHAPES).flops * 10 / work.PEAK_BF16 * 100)


@pytest.mark.parametrize("base", ["host_gap_share.train", "propagation_roofline.train",
                                  "device_idle_share.train", "train_mfu"])
def test_lastfm_twins_read_as_their_base(base):
    rec = {"shapes": SHAPES, "profiled_epochs": 1, "window_s": 2.0, "epochs": 4,
           "chunk_walls": [0.9, 0.9], "boundary_walls": [1.0, 1.0]}
    summ = _Summary({"void dual_regions<true>(Args)": 1.0, "other": 3.0}, 0.75)
    twin = base.replace(".train", "") + ".lastfm"
    got = harness.metric_module(twin).read(rec, summ)
    assert got is not None and got == harness.metric_module(base).read(rec, summ)
