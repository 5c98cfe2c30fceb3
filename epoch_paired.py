#!/usr/bin/env python3
"""Times per-epoch training of the ``qrec_tpu_torch`` package found under
``--root`` on one CUDA card, and prints one JSON line.

Two versions compare only on one card, in turns, inside one call, e.g. with
a parent commit unpacked under ``build/parent`` (``git archive``):

    for r in build/parent . . build/parent; do python3 epoch_paired.py --root $r; done

On ``chip_smoke.lastfm_records`` (1,892 users x 17,632 items), through
``QRec`` (the user's entry point), ``--epochs`` epochs each:

* LightGCN (``config/LightGCN.conf``) under ``train.chunk=1`` (a tree that
  does not read the key runs per epoch anyway), and under ``auto`` where
  the tree reads it and ``--per-epoch`` is not given;
* BPR (``config/BPR.conf``: the bold driver, SGD, its own negatives).

"steady" is the mean epoch ms after the first two epochs, "median" their
median. Then, on
LightGCN's spec: one epoch's sampler call alone (its pairs and negatives;
median of 20, CUDA events), and where the trainer has ``run_epoch``, the
per-epoch loop's epochs (``run_epoch``, then the host's read of the loss)
against the JAX package's lag-1 form (epoch e's loss read after epoch
e+1 is enqueued, no synchronisation but those reads, the time from one
read to the next), each with the tree's chunked-phase Adam (capturable
``torch.optim.Adam`` in a tree with ``trainer.make_capturable``, else the
one Adam that ``trainer.make_optimizer`` makes) and with
``torch.optim.Adam(foreach=True)``, in ``--rounds`` rounds.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=HERE, help="tree that holds qrec_tpu_torch")
    parser.add_argument("--epochs", type=int, default=12)
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--per-epoch", action="store_true",
                        help="skip the train.chunk=auto run (a tree whose step reads the host)")
    args = parser.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        sys.exit("epoch_paired: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from qrec_tpu_torch import ModelConf, QRec, native
    from qrec_tpu_torch.ops import kernels as K
    from qrec_tpu_torch.runtime import trainer as T

    assert os.path.abspath(K.__file__).startswith(os.path.join(root, "qrec_tpu_torch", ""))
    sys.path.insert(1, HERE)
    from chip_smoke import lastfm_records

    K.build()
    native.build()
    out = {"root": os.path.relpath(root, HERE), "card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True).stdout.strip(), "torch": torch.__version__,
        "epochs": args.epochs}
    own_loops = hasattr(T, "run_epoch")
    rows, cols, _, _ = lastfm_records()
    tmp = tempfile.mkdtemp(prefix="epoch_paired_")
    ratings = os.path.join(tmp, "lastfm_like.txt")
    with open(ratings, "w") as f:
        f.writelines(f"{a} {b} 1\n" for a, b in zip(rows, cols))

    def steady(times):
        return float(np.mean(times[2:])) * 1e3

    def run(name, chunk):
        conf = ModelConf(os.path.join(root, "config", f"{name}.conf"))
        conf["ratings"] = ratings
        conf["num.max.epoch"] = str(args.epochs)
        conf["output.setup"] = f"off -dir {os.path.join(tmp, 'results')}/"
        conf["train.chunk"] = chunk
        rec = QRec(conf)
        rec.execute()
        times = rec.model.timer.times
        out[f"{name} train.chunk={chunk}"] = {
            "epoch_ms": [round(t * 1e3, 3) for t in times], "steady_ms": steady(times),
            "median_ms": float(np.median(times[2:])) * 1e3}
        return rec.model

    model = run("LightGCN", "1")
    if own_loops and not args.per_epoch:
        run("LightGCN", "auto")
    run("BPR", "1")

    spec = model.build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for _ in range(3):
        spec.sampler(gen)
    torch.cuda.synchronize()
    pairs = []
    for _ in range(20):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        spec.sampler(gen)
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    out["LightGCN sampler ms"] = float(np.median([s.elapsed_time(e) for s, e in pairs]))

    def epochs(optimizer, lagged):
        """Epoch seconds, each from one host read of a loss to the next."""
        times, pending = [], None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.epochs):
            total = T.run_epoch(spec.params, optimizer, spec.loss_fn, spec.sampler(gen), gen)
            if lagged:
                total, pending = pending, total
            if total is not None:
                float(total)
                now = time.perf_counter()
                times.append(now - t0)
                t0 = now
        if pending is not None:
            float(pending)
            times.append(time.perf_counter() - t0)
        return times

    if own_loops:
        loops = {}
        for _ in range(args.rounds):
            for tree_adam in (True, False):
                for lagged in (True, False):
                    if tree_adam:
                        optimizer = T.make_optimizer(spec.params, "adam", model.lrate)
                        if hasattr(T, "make_capturable"):
                            T.make_capturable(optimizer)
                    else:
                        optimizer = torch.optim.Adam(spec.params, lr=model.lrate,
                                                     betas=(0.9, 0.999), eps=1e-8, foreach=True)
                    key = (f"{'lag-1' if lagged else 'read every epoch'}, "
                           f"{'the tree' if tree_adam else 'torch.optim'}'s Adam")
                    loops.setdefault(key, []).append(steady(epochs(optimizer, lagged)))
        out["LightGCN per-epoch loop steady ms"] = loops
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
