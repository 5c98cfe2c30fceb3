#!/usr/bin/env python3
"""Times K2, the port's masked catalog scorer, on one CUDA card and prints
one JSON line per shape: the fused top-k entry at its own plan and at other
row tiles and item splits, the scores entry, the ranking path of another
tree (``--parent``: its scores kernel on the gathered rows, the unseen
rows filled, a stable sort of every row and the first k columns, as its
ranker did) and that tree's scores kernel alone, and the library (the
gathered rows' ``torch.matmul``, ``masked_fill`` with the mask already
expanded, ``torch.topk``), in turns inside one loop
(``chip_smoke.Timer.paired``: the L2 flushed and the card held while the
host enqueues). Before timing it checks the fused entry against the scores
entry followed by a stable sort (bit for bit) and against its plain version
(ids equal but at near-ties), and the scores entry against the other
tree's scores kernel (bit for bit); with the bounds, the share of f32 peak,
the CUDA kernels of one call and each path's peak device memory. With
``--parent`` the other tree's fused top-k is timed too and must give this
tree's bits (its entry without biases). The biased top-k (SVD's score
form: an item bias, a user bias and an offset) is timed beside the library
with the same adds, and checked bit for bit against the scores entry with
an all-zero mask, the adds in torch, the mask and a stable sort.

Compare with a parent commit unpacked under ``build/parent`` (``git
archive``):

    python3 k2_paired.py --parent build/parent

Shapes: one batch of 1,024 users at the lastfm shape (1,892 x 16,591, d=50,
top-10), at NGCF's width there (d=150) and at the yelp2018 shape (19,539 x
21,266, d=64, top-20), on seeded tables of the scale training leaves
(N(0, 0.1) entries) and up to 40 rated items a user; every 50th unseen.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

SHAPES = [("lastfm", 1892, 16591, 50, 10), ("lastfm d=150", 1892, 16591, 150, 10),
          ("yelp2018", 19539, 21266, 64, 20)]
BATCH = 1024


def tables(torch, users: int, items: int, d: int, seed: int):
    """(user table, item table, packed bitmask, uids): 40 rated items a user
    drawn with replacement, every 50th user of the batch unseen (-1)."""
    import numpy as np

    from qrec_tpu_torch.ops.sampling import pack_bitmask

    g = torch.Generator(device="cuda").manual_seed(seed)
    u = torch.randn((users, d), generator=g, device="cuda") * 0.1
    v = torch.randn((items, d), generator=g, device="cuda") * 0.1
    rng = np.random.default_rng(seed)
    draws = np.sort(rng.integers(0, items, (users, 40)), axis=1)
    keep = np.ones_like(draws, dtype=bool)
    keep[:, 1:] = draws[:, 1:] != draws[:, :-1]
    indptr = np.concatenate([[0], np.cumsum(keep.sum(1))])
    bitmask = torch.as_tensor(pack_bitmask(indptr, draws[keep], users, items), device="cuda")
    uids = torch.arange(BATCH, device="cuda")
    uids[::50] = -1
    return u, v, bitmask, uids


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", default=None, help="a tree whose ranking path is timed beside")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("k2_paired: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as CS
    from k5_paired import load_parent_kernels
    from qrec_tpu_torch.ops import kernels as K

    K.build([K.SCORES, K.TOPK])
    parent = None
    if args.parent:
        parent = load_parent_kernels(os.path.abspath(args.parent))
        parent.build([parent.SCORES])
    card = CS.card_line()
    timer = CS.Timer(torch)
    gm = 0.5
    failed = []
    for label, users, n_items, d, k in SHAPES:
        u, v, bitmask, uids = tables(torch, users, n_items, d, seed=d + k)
        safe = uids.clamp(min=0)
        ub, mb = u[safe].contiguous(), bitmask[safe].contiguous()
        rated = K.expand_bitmask(mb, n_items)
        plan = K._masked_catalog_plan(u.device, BATCH, n_items, d, k)
        tiles = -(-n_items // K.CATALOG_TILE)
        lib = K.SCORES.load()
        plans = [plan]
        for bm in K.CATALOG_BLOCK_ROWS:
            for splits in (4, 8, 12, 16):
                p = (bm, 0, -(-tiles // splits))
                real = -(-tiles // p[2])
                if p not in plans and lib.qrec_masked_blocks_per_sm(bm, d, 0, k, real) >= 1:
                    plans.append(p)
        names, calls = [], []
        for p in plans:
            real = -(-tiles // p[2])
            names.append(f"topk bm {p[0]} x {real} splits" + (" (plan)" if p == plan else ""))
            calls.append(lambda p=p: K.masked_catalog_topk(u, v, bitmask, uids, gm, k, plan=p))
        names.append("scores entry")
        calls.append(lambda: K.masked_catalog_scores(ub, v, mb, 0.0))

        def path(scores_fn):
            return CS.scores_then_sort(torch, scores_fn, u, v, bitmask, uids, gm, k)

        if parent is not None:
            names += ["parent path", "parent scores kernel"]
            calls += [lambda: path(parent.masked_catalog_scores),
                      lambda: parent.masked_catalog_scores(ub, v, mb, 0.0)]
        names.append("library")
        calls.append(lambda: torch.topk(torch.matmul(u[safe], v.T).masked_fill_(rated, 0.0), k))
        g = torch.Generator(device="cuda").manual_seed(k)
        bias = dict(item_bias=torch.randn(n_items, generator=g, device="cuda") * 0.1,
                    user_bias=torch.randn(users, generator=g, device="cuda") * 0.1, offset=0.375)
        names += ["biased topk", "biased library"]
        calls += [lambda: K.masked_catalog_topk(u, v, bitmask, uids, gm, k, **bias),
                  lambda: torch.topk(K.biased_scores(torch.matmul(u[safe], v.T), safe, **bias)
                                     .masked_fill_(rated, 0.0), k)]
        if parent is not None:
            names.append("parent topk")
            calls.append(lambda: parent.masked_catalog_topk(u, v, bitmask, uids, gm, k))

        # checks: bit for bit against the scores entry and a stable sort, at
        # every plan; the scores entry against the other tree's kernel
        ids, vals = K.masked_catalog_topk(u, v, bitmask, uids, gm, k)
        want_ids, want = path(K.masked_catalog_scores)
        same = {n: bool(torch.equal(c()[0], want_ids) and torch.equal(
            c()[1].view(torch.int32), want.view(torch.int32))) for n, c in zip(names, calls)
            if n.startswith("topk")}
        pids, pvals = K.masked_catalog_topk_plain(u, v, bitmask, uids, gm, k)
        rows_equal = (ids == pids).all(1)
        near = (vals - pvals).abs().max(1).values <= 1e-5
        plain_ok = bool((rows_equal | near).all())
        bids, bvals = K.masked_catalog_topk(u, v, bitmask, uids, gm, k, **bias)
        want_bids, want_b = CS.scores_then_sort(torch, K.masked_catalog_scores, u, v, bitmask,
                                                uids, gm, k, **bias)
        biased_same = bool(torch.equal(bids, want_bids)
                           and torch.equal(bvals.view(torch.int32), want_b.view(torch.int32)))
        scores_same = topk_same = None
        if parent is not None:
            p_ids, p_vals = parent.masked_catalog_topk(u, v, bitmask, uids, gm, k)
            topk_same = bool(torch.equal(p_ids, ids)
                             and torch.equal(p_vals.view(torch.int32), vals.view(torch.int32)))
            scores_same = bool(torch.equal(K.masked_catalog_scores(ub, v, mb, 0.0).view(torch.int32),
                                           parent.masked_catalog_scores(ub, v, mb, 0.0)
                                           .view(torch.int32)))
        kernels = {"topk": CS.kernels_per_call(torch, calls[0]),
                   "scores entry": CS.kernels_per_call(torch, calls[names.index("scores entry")])}
        memory = {}
        for n in ("topk", "parent path", "library"):
            c = next((c for nm, c in zip(names, calls) if nm.startswith(n)), None)
            if c is None:
                continue
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            c()
            torch.cuda.synchronize()
            memory[n] = (torch.cuda.max_memory_allocated() - base) / 2**20
        times = timer.paired(calls)
        warm = [0, names.index("scores entry")]
        warm_ms = dict(zip([names[i] for i in warm],
                           timer.paired([calls[i] for i in warm], flush=False)))
        words = bitmask.shape[1]
        flop = 2 * BATCH * n_items * d
        inputs = BATCH * d * 4 + n_items * d * 4 + BATCH * words * 4
        bound_ms, bound_by = CS.bound(inputs + BATCH * 8 + BATCH * k * 12, flop, CS.PEAK_F32)
        biased_bound = CS.bound(inputs + BATCH * 8 + BATCH * k * 12 + (n_items + BATCH) * 4,
                                flop + 3 * BATCH * n_items, CS.PEAK_F32)
        scores_bound, scores_by = CS.bound(inputs + BATCH * n_items * 4, flop, CS.PEAK_F32)
        ms = dict(zip(names, times))
        print(json.dumps({
            "shape": f"{label}: B={BATCH} I={n_items} d={d} k={k}", "card": card,
            "plan": list(plan), "ms": ms, "warm_ms": warm_ms,
            "bit_for_bit_vs_scores_and_sort": same, "plain_ids_equal_but_near_ties": plain_ok,
            "rows_equal_to_plain": int(rows_equal.sum()),
            "scores_entry_bit_for_bit_vs_parent": scores_same,
            "topk_bit_for_bit_vs_parent": topk_same,
            "biased_topk_bit_for_bit_vs_unfused": biased_same,
            "cuda_kernels_per_call": kernels, "peak_extra_MiB": memory,
            "bound_ms": bound_ms, "bound_by": bound_by, "biased_bound_ms": biased_bound[0],
            "biased_bound_by": biased_bound[1],
            "scores_bound_ms": scores_bound, "scores_bound_by": scores_by,
            "share_of_f32_peak": {n: flop / CS.PEAK_F32 * 1e3 / t for n, t in ms.items()},
        }), flush=True)
        if not all(same.values()) or not plain_ok or False in (scores_same, topk_same, biased_same):
            failed.append(label)
    if failed:
        sys.exit(f"k2_paired: checks failed at {failed}")


if __name__ == "__main__":
    main()
