#!/usr/bin/env python3
"""Times K1, the port's dual product (``bipartite_dual_matmul`` and one
factored application of the joint adjacency, ``ops/spmm.factored_call``),
of the ``qrec_tpu_torch`` package found under ``--root`` on one CUDA card,
and prints one JSON line.

Two versions compare only on one card, in turns, inside one call, e.g. with
a parent commit unpacked under ``build/parent`` (``git archive``):

    python3 k1_paired.py --root build/parent && python3 k1_paired.py && \\
        python3 k1_paired.py && python3 k1_paired.py --root build/parent

Shapes: the lastfm training graph's R (1,892 x 16,591, 74,105 ones) at
d = 50 (LightGCN), 150 (SimGCL's fused views) and 1 (SGL's degrees); the
yelp2018 R (19,539 x 21,266, 450,884 ones) at d = 64. Times are medians
of 15 CUDA-event timings, each after a 256 MB write that flushes the L2;
the factored application also back to back without the flush, and its
CUDA kernels per application from ``torch.profiler``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=HERE, help="tree that holds qrec_tpu_torch")
    args = parser.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import torch

    if not torch.cuda.is_available():
        sys.exit("k1_paired: no CUDA device")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from qrec_tpu_torch.ops import kernels as K
    from qrec_tpu_torch.ops import spmm as S

    assert os.path.abspath(K.__file__).startswith(os.path.join(root, "qrec_tpu_torch", ""))
    K.build()
    padded = hasattr(K, "aligned_width")  # the padded R layout of DenseJoint
    scratch = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device="cuda")

    def ms(fn, iters=15, flush=True):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(iters):
            if flush:
                scratch.zero_()
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        return float(np.median([s.elapsed_time(e) for s, e in pairs]))

    def operands(u, i, nnz, seed):
        rng = np.random.default_rng(seed)
        key = np.unique(rng.integers(0, u * i, size=nnz + nnz // 50))[:nnz]
        width = K.aligned_width(i) if padded else i
        r = torch.zeros((u, width), dtype=torch.int8, device="cuda")
        r.view(-1)[torch.as_tensor(key // i * width + key % i, device="cuda")] = 1
        return r

    out = {"root": os.path.relpath(root, HERE), "card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True).stdout.strip(), "k1_ms": {}}
    g = torch.Generator(device="cuda").manual_seed(0)
    for label, (u, i, nnz, widths) in {
        "lastfm": (1892, 16591, 74105, (50, 150, 1)),
        "yelp2018": (19539, 21266, 450884, (64,)),
    }.items():
        r = operands(u, i, nnz, 1)
        for d in widths:
            xu = (torch.randn((u, d), generator=g, device="cuda") * 0.1).bfloat16()
            xi = torch.zeros((r.shape[1], d), dtype=torch.bfloat16, device="cuda")
            xi[:i] = (torch.randn((i, d), generator=g, device="cuda") * 0.1).bfloat16()
            out["k1_ms"][f"{label} d={d}"] = ms(lambda: K.bipartite_dual_matmul(r, xu, xi))
        if label == "lastfm":
            su = torch.rand(u, generator=g, device="cuda") + 0.1
            si = torch.rand(i, generator=g, device="cuda") + 0.1
            adj = S.DenseJoint(r, su, si)
            x = torch.randn((u + i, 50), generator=g, device="cuda") * 0.01
            call = lambda: S.factored_call(adj, x)  # noqa: E731
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                call()
                torch.cuda.synchronize()
            kernels = sum(e.count for e in prof.key_averages()
                          if e.device_type == DeviceType.CUDA and not e.is_user_annotation)
            out["factored"] = {"ms": ms(call), "warm_ms": ms(call, iters=50, flush=False),
                               "kernels_per_application": kernels}
        del r
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
