"""Whole runs of the three cells on the CPU at tiny shapes, past the
harness's look for a card: the port's CPU path against the reference, the
control (the reference in the precision below the configuration's) failing
the cells' limits, and each fault a cell can have, planted in the timed
path underneath, turning ``correct`` false."""

from __future__ import annotations

import copy
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import harness, readings

MAN = harness.manifest()
CELLS = [c["name"] for c in MAN["workloads"]]
TRAIN = [c for c in CELLS if harness.traffic(harness.workload(MAN, c)["traffic"])["kind"] == "train"]
RANK = [c for c in CELLS if c not in TRAIN]
SEED = 3_141_592_653


def tiny(cell: str) -> dict:
    """The cell's configuration at 40 users x 60 items x 500 interactions,
    d=8, batches of 64."""
    cfg = copy.deepcopy(harness.config(MAN, harness.workload(MAN, cell)))
    cfg["dataset"].update(users=40, items=60, interactions=500)
    cfg["conf"].update({"num.factors": "8", "batch_size": "64"})
    cfg["model"]["batch_size"] = 64
    return cfg


def run(cell: str, seed: int = SEED) -> dict:
    return harness.run(cell, seed, 0.2, False, device="cpu", config_override=tiny(cell))


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    result = run(cell)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    e2e = [m["name"] for m in MAN["end_to_end"] if harness.reports(MAN, m, cell)]
    assert list(result["metrics"]) == e2e
    assert list(result)[-1] == "checks"
    json.dumps(result)


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_limits(cell):
    limits = harness.limits(cell)["limits"]
    numbers = readings.control_reading(cell, SEED + 1, "control", torch.device("cpu"), tiny(cell))
    assert any(numbers[k] > limit for k, limit in limits.items()), numbers


def _run_epoch_without_step(params, optimizer, loss_fn, batches, generator, after_step=None,
                            mesh=None):
    """A step that returns its state unchanged: the losses, no update."""
    total = torch.zeros((), dtype=torch.float32, device=batches[0].device)
    for k in range(batches[0].shape[0]):
        total = total + loss_fn(tuple(t[k] for t in batches), generator).detach()
    return total


def _half_batch(run_epoch):
    def patched(params, optimizer, loss_fn, batches, generator, after_step=None, mesh=None):
        half = batches[0].shape[1] // 2

        def loss_half(batch, gen):
            return loss_fn(tuple(t[:half] for t in batch), gen) * 2

        return run_epoch(params, optimizer, loss_half, batches, generator, after_step, mesh)

    return patched


@pytest.mark.parametrize("cell", TRAIN)
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
def test_training_faults_turn_correct_false(cell, fault, monkeypatch):
    from qrec_tpu_torch.runtime import trainer

    patched = (_run_epoch_without_step if fault == "state_unchanged"
               else _half_batch(trainer.run_epoch))
    monkeypatch.setattr(trainer, "run_epoch", patched)
    result = run(cell)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("cell", RANK)
@pytest.mark.parametrize("fault", ["listed_twice", "rated_item"])
def test_an_altered_answer_turns_correct_false(cell, fault, monkeypatch):
    from qrec_tpu_torch.ops.kernels import expand_bitmask
    from qrec_tpu_torch.ops.topk import CatalogRanker

    topk = CatalogRanker.topk

    def altered(self, form):
        ids, scores = topk(self, form)
        ids = ids.copy()
        if fault == "listed_twice":
            ids[0, 0] = ids[0, -1]
        else:
            uid = self._uids[:1].clamp(min=0)
            rated = expand_bitmask(self.bitmask[uid], self.data.num_items)
            ids[0, 0] = int(rated[0].nonzero()[0])
        return ids, scores

    monkeypatch.setattr(CatalogRanker, "topk", altered)
    result = run(cell)
    assert not result["correct"], result["checks"]


def _reference_lists(k: int):
    """A small reference split with a test user unseen in training, its
    tables, and the reference's own lists of one evaluation."""
    from portbench import drive
    from portbench.reference import REFERENCE
    from portbench.reference import dataset as RD
    from portbench.reference import graph_cf as G
    from portbench.reference import ranking as RR

    rng = np.random.default_rng(7)
    train = sorted({(str(u), str(i)) for u, i in zip(rng.integers(0, 12, 150),
                                                     rng.integers(0, 30, 150))})
    test = [(str(u), str(i)) for u, i in zip(rng.integers(0, 12, 30), rng.integers(0, 30, 30))]
    test.append(("unseen", "3"))
    ref = RD.Dataset(train, test)
    model = G.Model("LightGCN", 2, 1e-3, 1e-3, 16, k)
    cpu = torch.device("cpu")
    tables = drive.make_tables("normal", ref.num_users, ref.num_items, 4,
                               drive.generator(cpu, 11, 1), cpu)
    with torch.no_grad():
        enc = G.encode(model, G.Adjacency(ref, cpu), torch.cat(tables), REFERENCE)
    ids, scores = RR.rank(RR.Ranking(ref, cpu), enc[: ref.num_users], enc[ref.num_users:], k,
                          REFERENCE)
    return model, ref, [tables], ids.numpy().copy(), scores.numpy().copy()


@pytest.mark.parametrize("fault", [None, "listed_twice", "unseen_list", "outside"])
def test_rank_checks_on_the_references_own_lists(fault):
    from portbench import drive

    model, ref, sets, ids, scores = _reference_lists(5)
    seen = np.flatnonzero(ref.test_uids >= 0)
    unseen = np.flatnonzero(ref.test_uids < 0)
    assert len(unseen) == 1
    if fault == "listed_twice":
        ids[seen[0], 1] = ids[seen[0], 0]
        scores[seen[0], 1] = scores[seen[0], 0]
    elif fault == "unseen_list":
        ids[unseen[0]] = ids[unseen[0]][::-1]
    elif fault == "outside":
        ids[seen[0], 0] = ref.num_items
    numbers = drive.rank_checks(model, ref, sets, [(0, ids, scores)], torch.device("cpu"))
    if fault is None:
        assert numbers["rank_gap"] < 1e-5 and numbers["score_gap"] < 1e-5, numbers
    else:
        assert numbers["rank_gap"] == float("inf"), numbers


def test_same_seed_same_inputs():
    from portbench import data as D

    for cell in CELLS:
        ds = tiny(cell)["dataset"]
        a, b = D.draw(ds, SEED), D.draw(ds, SEED)
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
        c = D.draw(ds, SEED + 1)
        assert not np.array_equal(a.users, c.users)
        # another seed: the same structure under other names and in another order
        for x, y in zip(a, c):
            assert np.array_equal(np.sort(np.unique(x, return_counts=True)[1]),
                                  np.sort(np.unique(y, return_counts=True)[1]))


def test_results_never_written_outside(tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", None)
    before = set(Path(tmp_path).iterdir())
    run(CELLS[0])
    assert set(Path(tmp_path).iterdir()) == before
