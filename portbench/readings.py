#!/usr/bin/env python3
"""The readings that the limits of ``portbench/limits`` are set from. Not
part of a benchmark run:

    python3 portbench/readings.py --workload <cell> --program 12 --control 3 \\
        [--fault half_batch --fault altered] [--seed-base N] [--out FILE]

In one process: ``--program`` sound runs of the cell on as many seeds (the
timed path with a short window; the numbers that the run compares, the
lower readings), then for ``--control`` seeds the control: the plain
reference put in the system's place in the nearest precision below the
configuration's (``reference.CONTROL``), compared with the reference as a
run compares the system (the upper readings); and each ``--fault`` on as
many seeds, planted in the reference put in the system's place:
``half_batch`` (a training step's loss on the first half of its batch,
doubled) or ``altered`` (one user's best item replaced by the best item
outside its list, in a ranking). Prints one JSON line a reading and writes them all to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# a sound run's window: its numbers come from the set-up's first chunk (train)
# or from the sample of its evaluations (rank)
SECONDS = 1.0


def control_reading(cell_name: str, seed: int, variant: str, device, config_override=None) -> dict:
    import torch

    from portbench import data as D
    from portbench import drive, harness
    from portbench.reference import CONTROL, REFERENCE
    from portbench.reference import graph_cf as G
    from portbench.reference import ranking as RR

    man = harness.manifest()
    cell = harness.workload(man, cell_name)
    cfg = config_override or harness.config(man, cell)
    mix = harness.traffic(cell["traffic"])
    inter = D.draw(cfg["dataset"], seed)
    ref = drive.reference_data(inter)
    rmodel = drive.reference_model(cfg)
    d = int(cfg["conf"]["num.factors"])
    if mix["kind"] == "train":
        chunk = cfg["conf"].get("train.chunk", "auto")
        chunk = 8 if chunk == "auto" else int(chunk)
        init = drive.make_tables(cfg["model"]["init"], ref.num_users, ref.num_items, d,
                                 drive.generator(device, seed, 1), device)
        evaluate = rmodel.name == "SimGCL"
        base = G.train(rmodel, ref, init, seed, chunk, REFERENCE, device, evaluate=evaluate)
        prec = CONTROL if variant == "control" else REFERENCE
        fault = None if variant == "control" else variant
        other = G.train(rmodel, ref, init, seed, chunk, prec, device, evaluate=evaluate,
                        fault=fault)
        return drive.train_checks(other.losses, other.measures, other.tables, other.moments,
                                  init, base)
    gen = drive.generator(device, seed, 2)
    sets = [drive.make_tables(cfg["model"]["init"], ref.num_users, ref.num_items, d, gen, device)
            for _ in range(mix["weight_sets"])]
    adj = G.Adjacency(ref, device)
    ranking = RR.Ranking(ref, device)
    prec = CONTROL if variant == "control" else REFERENCE
    kept = []
    for k in range(len(sets)):
        with torch.no_grad():
            tables = G.encode(rmodel, adj, torch.cat(sets[k]).to(prec.dtype), prec)
            ids, scores = RR.rank(ranking, tables[: ref.num_users], tables[ref.num_users:],
                                  rmodel.top_n, prec)
        ids, scores = ids.cpu().numpy(), scores.cpu().numpy()
        if variant == "altered":
            # the first seen test user's best item replaced by the best item
            # outside its list, with that item's score
            b = int((ranking.uids >= 0).nonzero()[0])
            with torch.no_grad():
                s = RR.scores_of(ranking, tables[: ref.num_users], tables[ref.num_users:],
                                 ranking.uids[b: b + 1], prec)
                v, i = torch.sort(s[0], descending=True, stable=True)
            ids[b, 0], scores[b, 0] = int(i[rmodel.top_n]), float(v[rmodel.top_n])
        kept.append((k, ids, scores))
    return drive.rank_checks(rmodel, ref, sets, kept, device)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--program", type=int, default=12)
    parser.add_argument("--control", type=int, default=3)
    parser.add_argument("--fault", action="append", default=[])
    parser.add_argument("--seed-base", type=int, default=3_000_000_000)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import contextlib

    import torch

    from portbench import harness

    device = torch.device("cuda")
    rows = []

    def emit(row):
        rows.append(row)
        print(json.dumps(row), flush=True)

    seeds = [args.seed_base + 7919 * k for k in range(args.program + args.control)]
    for seed in seeds[: args.program]:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            result = harness.run(args.workload, seed, SECONDS, False)
        numbers = {k: c["value"] for k, c in result["checks"].items()}
        numbers.update(result["readings"])
        emit({"side": "program", "seed": seed, "numbers": numbers, "correct": result["correct"],
              "seconds": time.perf_counter() - t0})
    for variant in ["control"] + args.fault:
        for seed in seeds[args.program:]:
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(sys.stderr):
                numbers = control_reading(args.workload, seed, variant, device)
            emit({"side": variant, "seed": seed, "numbers": numbers,
                  "seconds": time.perf_counter() - t0})
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"workload": args.workload, "device": torch.cuda.get_device_name(0),
                       "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
