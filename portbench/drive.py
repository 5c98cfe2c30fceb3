"""The two kinds of traffic, as data files of ``portbench/traffic`` name
them (``"kind"``), and what a run of each measures and compares.

``train`` — the training phase as a user's run trains it:
``Recommender.fit`` with ``num.max.epoch`` far past the window, through
``trainer.train``, ``ChunkedLoop`` and ``EpochProgram`` (one CUDA graph an
epoch). The capture with its warm-up epoch and the first chunk are set-up;
the window holds the whole chunks after it. The run ends the phase from
the model's per-epoch ``emit`` hook, which ``ChunkedLoop`` calls after a
chunk's commit: at the chunk boundary after ``--seconds`` ran out the hook
raises :class:`Stop`. With ``--trace 1`` one more chunk runs under the
profiler first. The first chunk is compared with the plain reference,
which follows it from the same tables and the same random stream.

``rank`` — the run's final evaluation: ``Recommender.finalize`` (the
forward pass to the scoring tables) and ``CatalogRanker.topk`` of the
model's score form, as ``runtime/evaluator.eval_ranking`` calls it, ending
in the host copy of the lists. The evaluations cycle through weight sets
made on the device from the seed. A sample of them, drawn from the seed,
is compared with the plain reference after the window.
"""

from __future__ import annotations

import contextlib
import gc
import math
import random
import time
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from . import data as D
from . import system, trace
from .reference import REFERENCE
from .reference import dataset as RD
from .reference import graph_cf as G
from .reference import ranking as RR


class Stop(Exception):
    """Ends a training phase at a chunk boundary."""


class Context(NamedTuple):
    cell: Dict
    config: Dict
    traffic: Dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    tmpdir: str
    # (phase, time.perf_counter()) at the end of each phase of the set-up
    marks: List

    def mark(self, phase: str) -> None:
        self.marks.append((phase, time.perf_counter()))


class Outcome(NamedTuple):
    """What a run reports: the window's start (perf_counter), the
    end-to-end metrics, the attempted and failed units, the numbers that
    can be compared (the cell's limits file says which are), the device
    figures, the record the per-layer metrics read, the traced run's
    summary, and what differed at the start, if anything."""

    window_start: float
    metrics: Dict[str, float]
    attempted: int
    failed: int
    checks: Dict[str, float]
    memory_peak_bytes: int
    record: Dict
    summary: Optional[trace.Summary]
    note: str


def generator(device, seed: int, stream: int) -> torch.Generator:
    """The benchmark's own generator on ``device`` for ``stream`` of ``seed``
    (the system's draws use ``seed + 1``)."""
    return torch.Generator(device=device).manual_seed(
        (seed * 0x9E3779B97F4A7C15 + stream) % (1 << 63))


def make_tables(init: str, users: int, items: int, d: int, gen: torch.Generator, device):
    """(user (U, d), item (I, d)) float32 tables on ``device`` with the
    model's own initial distribution: ``xavier`` uniform (SimGCL,
    ``SimGCL.py:42-44``) or ``normal`` truncated at two sigma, sigma 0.005
    (QRec's deep models, ``deepRecommender.py:21-22``)."""
    out = []
    for rows in (users, items):
        t = torch.empty((rows, d), dtype=torch.float32, device=device)
        if init == "xavier":
            bound = math.sqrt(6.0 / (rows + d))
            t.uniform_(-bound, bound, generator=gen)
        elif init == "normal":
            torch.nn.init.trunc_normal_(t, std=0.005, a=-0.01, b=0.01, generator=gen)
        else:
            raise ValueError(f"unknown init {init!r} (expected xavier|normal)")
        out.append(t)
    return out


def reference_model(config: Dict) -> G.Model:
    m = config["model"]
    return G.Model(m["name"], m["layers"], m["reg"], m["lr"], m["batch_size"], m["top_n"],
                   m.get("cl_rate", 0.0), m.get("eps", 0.0))


def reference_data(inter: D.Interactions) -> RD.Dataset:
    """The reference's :class:`~.reference.dataset.Dataset` of the drawn
    training and test records."""
    names = lambda u, i: [(str(a), str(b)) for a, b in zip(u.tolist(), i.tolist())]  # noqa: E731
    return RD.Dataset(names(inter.users, inter.items), names(inter.test_users, inter.test_items))


def start_matches(ref: RD.Dataset, maps, train_u, train_i) -> Optional[str]:
    """None where the system's id maps and training arrays are the
    reference's, else what differs: the reference follows the system's
    random stream only on the same ids."""
    users, items = maps
    if users != ref.user or items != ref.item:
        return "the system's user or item ids differ from QRec's first-appearance order"
    if not (np.array_equal(train_u, ref.train_u) and np.array_equal(train_i, ref.train_i)):
        return "the system's training pairs differ from the split's"
    return None


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _peak(device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if torch.device(device).type == "cuda" else 0


def _free() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------


class _Hook:
    """The model's ``_emit`` wrapped, the per-epoch hook that ``ChunkedLoop``
    calls after a chunk's commit with each epoch's loss, measures and wall
    (the chunk's wall over its epochs). It keeps the first chunk's losses
    and measures, takes the model's tables and Adam's first moments at the
    first chunk's boundary, times every boundary, keeps every chunk's wall,
    runs the profiled chunk and raises :class:`Stop`. ``optimizers`` is
    filled by :func:`stepped_optimizers` around the fit."""

    def __init__(self, model, chunk: int, seconds: float, traced: bool):
        self.model = model
        self.emit = model._emit
        self.chunk = chunk
        self.seconds = seconds
        self.traced = traced
        self.losses: List[float] = []
        self.measures: List[Dict[str, float]] = []
        self.boundaries: List[float] = []
        self.walls: List[float] = []
        self.optimizers: List = []
        self.first_arrival = None
        self.snapshot = None
        self.prof = None
        self.prof_start = self.prof_wall = None

    def __call__(self, epoch, loss, lr, wall, metrics=None, eval_fused=False):
        arrival = time.perf_counter()
        self.emit(epoch, loss, lr, wall, metrics, eval_fused=eval_fused)
        if epoch < self.chunk:
            self.losses.append(float(loss))
            if metrics is not None:
                self.measures.append(dict(metrics))
        if (epoch + 1) % self.chunk:
            return
        self.walls.append(wall * self.chunk)
        if self.snapshot is None:
            self.first_arrival = arrival
            tables = system.tables(self.model)
            opt = self.optimizers[-1] if self.optimizers else None
            with torch.no_grad():
                self.snapshot = ([t.detach().clone() for t in tables],
                                 first_moments(opt, tables) if opt is not None else None)
            self.boundaries.append(time.perf_counter())
            return
        now = time.perf_counter()
        if self.prof is not None:
            trace.stop(self.prof)
            self.prof_wall = now - self.prof_start
            raise Stop
        self.boundaries.append(now)
        if now - self.boundaries[0] < self.seconds:
            return
        if not self.traced:
            raise Stop
        self.prof = trace.start()
        self.prof_start = time.perf_counter()


@contextlib.contextmanager
def stepped_optimizers(found: List):
    """Appends to ``found`` every optimizer that steps inside the block,
    once each in the order of their first steps, through torch's global
    step hook (``torch.optim.optimizer.register_optimizer_step_post_hook``).
    A captured epoch's replays run no Python step; the capture's warm-up
    epoch does."""

    def seen(optimizer, args, kwargs):
        if not any(o is optimizer for o in found):
            found.append(optimizer)

    from torch.optim.optimizer import register_optimizer_step_post_hook

    handle = register_optimizer_step_post_hook(seen)
    try:
        yield found
    finally:
        handle.remove()


def first_moments(optimizer, tables) -> Optional[List[torch.Tensor]]:
    """Copies of Adam's first moment of each of ``tables``, from the
    optimizer's state dict (``torch.optim.Adam``'s layout: ``state[k]
    ["exp_avg"]``, ``k`` the parameter's place in its groups); None where
    the optimizer does not hold a table or keeps no such moment."""
    params = [p for g in optimizer.param_groups for p in g["params"]]
    state = optimizer.state_dict()["state"]
    out = []
    for t in tables:
        k = next((k for k, p in enumerate(params) if p is t), None)
        if k is None or "exp_avg" not in state.get(k, {}):
            return None
        out.append(state[k]["exp_avg"].detach().clone())
    return out


def train(ctx: Context) -> Outcome:
    config, traffic, device, seed = ctx.config, ctx.traffic, ctx.device, ctx.seed
    inter = D.draw(config["dataset"], seed)
    files = D.write_files(inter, ctx.tmpdir)
    ctx.mark("data drawn and written")
    sysm = system.build(config, files.ratings, files.test, seed, device, traffic["conf"])
    ctx.mark("load, split, Interactions, model, graph")
    model = sysm.model
    d = model.emb_size
    init = make_tables(config["model"]["init"], model.num_users, model.num_items, d,
                       generator(device, seed, 1), device)
    system.set_tables(model, init[0].clone(), init[1].clone())
    ctx.mark("initial tables")
    chunk = model.train_chunk()
    hook = _Hook(model, chunk, ctx.seconds, ctx.trace)
    model._emit = hook
    fit_start = time.perf_counter()
    try:
        with stepped_optimizers(hook.optimizers):
            model.fit()
    except Stop:
        pass
    _sync(device)
    peak = _peak(device)
    b = hook.boundaries
    fit_lead_s = hook.first_arrival - fit_start - hook.walls[0]
    ctx.marks.append(("fit's lead: the spec, the optimizer, the capture", fit_start + fit_lead_s))
    ctx.marks.append(("first chunk", b[0]))
    window_s = b[-1] - b[0]
    window_chunks = len(b) - 1
    epochs = window_chunks * chunk
    shapes = {
        "model": config["model"]["name"], "users": model.num_users, "items": model.num_items,
        "edges": int(len(sysm.data.csr_sel)), "d": d, "layers": model.n_layers,
        "batch": model.batch_size, "pairs": model.train_size,
        "steps": -(-model.train_size // model.batch_size),
        "test_users": len(sysm.data.test_set_u), "top_n": config["model"]["top_n"],
        "evaluates": bool(model.track_best),
    }
    record = {
        "shapes": shapes, "host_build_s": sysm.load_s + sysm.build_s,
        "window_s": window_s, "epochs": epochs, "chunk_epochs": chunk,
        "chunk_walls": hook.walls[1: 1 + window_chunks],
        "boundary_walls": [t1 - t0 for t0, t1 in zip(b, b[1:])],
        "fit_lead_s": fit_lead_s,
        "profiled_epochs": chunk if hook.prof is not None else 0,
        "profiled_wall_s": hook.prof_wall,
    }
    summary = trace.summarise(hook.prof) if hook.prof is not None else None
    maps = (sysm.data.user, sysm.data.item)
    train_u, train_i = sysm.data.train_u.copy(), sysm.data.train_i.copy()
    tables, moments = hook.snapshot
    losses, measures = hook.losses, hook.measures
    del sysm, model, hook
    _free()

    # the reference follows the first chunk from the same tables and stream
    ref = reference_data(inter)
    note = start_matches(ref, maps, train_u, train_i)
    if moments is None:
        note = note or "Adam's first moments of the model's tables were not found"
    followed = G.train(reference_model(config), ref, init, seed, chunk, REFERENCE, device,
                       evaluate=shapes["evaluates"])
    checks = train_checks(losses, measures, tables, moments, init, followed)
    shapes["unique_users"], shapes["unique_items"] = followed.unique
    return Outcome(b[0], {"train_examples_per_s": epochs * shapes["pairs"] / window_s}, epochs,
                   0, checks, peak, record, summary, note or "")


def kept_leaves(moments: List[torch.Tensor]) -> List[bool]:
    """The leaves the norms compare: a leaf whose reference gradient (its
    first moment) is under a thousandth of the median leaf's moves by
    round-off alone."""
    norms = [float(torch.linalg.vector_norm(m.double())) for m in moments]
    median = float(np.median(norms))
    return [n >= 1e-3 * median for n in norms]


def train_checks(losses, measures, tables, moments, init, ref: G.Followed) -> Dict[str, float]:
    """The compared numbers of a training cell, against the reference's run
    over the same epochs: ``loss_gap`` the worst epoch's relative gap of the
    summed loss; ``change_gap`` and ``moment_gap`` the worst leaf's gap of
    the norms of the tables' change and of Adam's first moment (the
    gradients as the optimizer got them), against the larger of the
    reference's norm of that leaf and of the median leaf; ``eval_gap`` the
    worst epoch's and measure's absolute gap of the per-epoch evaluation;
    ``first_loss_gap`` the first epoch's loss gap, steadier from seed to seed
    than the numbers over the whole chunk, whose later steps amplify
    rounding (read, not compared)."""
    gaps = [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(losses, ref.losses)]
    full = len(losses) >= len(ref.losses) and gaps
    out = {"loss_gap": max(gaps) if full else math.inf,
           "first_loss_gap": gaps[0] if gaps else math.inf}
    keep = kept_leaves(ref.moments)
    dev = ref.tables[0].device
    ours = [t.to(dev).double() - i.to(dev).double() for t, i in zip(tables, init)]
    theirs = [t.double() - i.to(dev).double() for t, i in zip(ref.tables, init)]
    out["change_gap"] = G.gap_of_norms(ours, theirs, keep)
    out["moment_gap"] = (math.inf if moments is None else
                         G.gap_of_norms([m.to(dev) for m in moments], ref.moments, keep))
    if ref.measures:
        gaps = [abs(m[k] - r[k]) for m, r in zip(measures, ref.measures) for k in r]
        out["eval_gap"] = max(gaps) if len(measures) == len(ref.measures) else math.inf
    return out


# ---------------------------------------------------------------------------
# rank
# ---------------------------------------------------------------------------


def top_n(conf) -> int:
    """The list length of the final evaluation (``eval_ranking``)."""
    n = max(int(t) for t in conf.options("item.ranking")["-topN"].split(","))
    return 10 if n > 100 or n < 1 else n


def rank(ctx: Context) -> Outcome:
    config, traffic, device, seed = ctx.config, ctx.traffic, ctx.device, ctx.seed
    inter = D.draw(config["dataset"], seed)
    files = D.write_files(inter, ctx.tmpdir)
    ctx.mark("data drawn and written")
    sysm = system.build(config, files.ratings, files.test, seed, device, traffic["conf"])
    ctx.mark("load, split, Interactions, model, graph")
    model, data = sysm.model, sysm.data
    spec = model.build()
    ranker = system.ranker(model, data, top_n(sysm.conf))
    gen = generator(device, seed, 2)
    sets = [make_tables(config["model"]["init"], model.num_users, model.num_items,
                        model.emb_size, gen, device) for _ in range(traffic["weight_sets"])]

    def evaluate(k: int):
        system.set_tables(model, *sets[k % len(sets)])
        model.finalize(spec)
        return ranker.topk(model.score_form())

    for k in range(traffic["warmup_evaluations"]):
        evaluate(k)
    _sync(device)
    ctx.mark("weight sets and warm-up evaluations")
    sample = random.Random(seed)
    keep = traffic["compared_evaluations"]
    kept: List = []
    times: List[float] = []
    start = time.perf_counter()
    end = start
    n = 0
    while end - start < ctx.seconds:
        t0 = time.perf_counter()
        ids, scores = evaluate(n)
        end = time.perf_counter()
        times.append(end - t0)
        # a reservoir sample of the evaluations, drawn from the seed
        slot = n if n < keep else sample.randrange(n + 1)
        if slot < keep:
            entry = (n % len(sets), ids, scores)
            if n < keep:
                kept.append(entry)
            else:
                kept[slot] = entry
        n += 1
    window_s = end - start
    peak = _peak(device)
    summary, prof_wall, prof_n = None, None, 0
    if ctx.trace:
        prof_n = traffic["profiled_evaluations"]
        prof = trace.start()
        t0 = time.perf_counter()
        for k in range(prof_n):
            evaluate(n + k)
        _sync(device)
        prof_wall = time.perf_counter() - t0
        trace.stop(prof)
        summary = trace.summarise(prof)
    shapes = {
        "model": config["model"]["name"], "users": model.num_users, "items": model.num_items,
        "edges": int(len(data.csr_sel)), "d": model.emb_size, "layers": model.n_layers,
        "test_users": len(ranker.uids), "top_n": ranker.k,
    }
    record = {
        "shapes": shapes, "host_build_s": sysm.load_s + sysm.build_s, "window_s": window_s,
        "evaluations": n, "profiled_evaluations": prof_n, "profiled_wall_s": prof_wall,
    }
    maps = (data.user, data.item)
    train_u, train_i = data.train_u.copy(), data.train_i.copy()
    names = list(ranker.names)
    del sysm, model, data, spec, ranker, evaluate
    _free()

    ref = reference_data(inter)
    note = start_matches(ref, maps, train_u, train_i)
    if note is None and names != ref.test_names:
        note = "the system's test users differ from the test records' first-appearance order"
    checks = rank_checks(reference_model(config), ref, sets, kept, device)
    metrics = {"rank_ms": window_s / n * 1e3,
               "rank_ms_p95": float(np.percentile(np.asarray(times), 95)) * 1e3}
    return Outcome(start, metrics, n, 0, checks, peak, record, summary, note or "")


def rank_checks(rmodel: G.Model, ref: RD.Dataset, sets, kept, device) -> Dict[str, float]:
    """The compared numbers of a ranking cell, over the kept evaluations
    (weight set, ids, scores): ``rank_gap`` the widest gap by which a listed
    item's reference score lies below the reference's score at that
    position of its own list, and ``score_gap`` the widest gap between a
    listed score and the reference's score of that item, each against the
    mean of the test users' best reference scores of that evaluation. A
    list that names an item twice or one outside the catalogue, or a test
    user unseen in training whose list is not items 0..k-1 (the fixed list
    of QRec's order), reads ``rank_gap`` infinite."""
    adj = G.Adjacency(ref, device)
    ranking = RR.Ranking(ref, device)
    seen = ranking.uids >= 0
    rank_gap = score_gap = 0.0
    for k, ids, scores in kept:
        with torch.no_grad():
            tables = G.encode(rmodel, adj, torch.cat(sets[k]), REFERENCE)
        users, items = tables[: ref.num_users], tables[ref.num_users:]
        ids = torch.as_tensor(np.asarray(ids), dtype=torch.int64, device=device)
        scores = torch.as_tensor(np.asarray(scores), dtype=torch.float32, device=device)
        below = listed = best_sum = 0.0
        count = 0
        for s0 in range(0, ranking.uids.shape[0], RR.BLOCK_USERS):
            sl = slice(s0, s0 + RR.BLOCK_USERS)
            uids = ranking.uids[sl]
            s = RR.scores_of(ranking, users, items, uids.clamp(min=0), REFERENCE)
            best = torch.sort(s, dim=1, descending=True, stable=True)[0][:, : ids.shape[1]]
            bad = (ids[sl] < 0) | (ids[sl] >= ref.num_items)
            got = s.gather(1, ids[sl].clamp(0, ref.num_items - 1))
            m = seen[sl][:, None] & ~bad
            twice = torch.sort(ids[sl], dim=1)[0]
            fixed = torch.arange(ids.shape[1], device=device)[None, :]
            if (bool((bad & seen[sl][:, None]).any())
                    or bool((twice[:, 1:] == twice[:, :-1]).any())
                    or bool((ids[sl][~seen[sl]] != fixed).any())):
                below = math.inf
            below = max(below, float(torch.where(m, best - got, 0.0).max()))
            listed = max(listed, float(torch.where(m, (scores[sl] - got).abs(), 0.0).max()))
            best_sum += float(best[:, 0][seen[sl]].abs().sum())
            count += int(seen[sl].sum())
        scale = max(best_sum / max(count, 1), 1e-30)
        rank_gap = max(rank_gap, below / scale)
        score_gap = max(score_gap, listed / scale)
    return {"rank_gap": rank_gap, "score_gap": score_gap}


KINDS = {"train": train, "rank": rank}
