#!/usr/bin/env python3
"""The benchmark of ``qrec_tpu_torch`` on one NVIDIA card:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. One run is one process: it draws the cell's
interactions from the seed, writes them as rating files under ``TMPDIR``,
builds the model through the port's normal data path, warms up, measures
for ``--seconds`` and prints one JSON line, the last of its standard
output, with ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device`` and, traced, ``breakdown``; then ``checks``, each number that
decided ``correct`` beside its limit (also the last lines of standard
error). Everything the system prints goes to standard error. Python's
bytecode, like the kernels' build, is kept in the checkout's ``build/``.

It exits 2 without a result where no card, or fewer than the cell asks
for, is visible, and 3 where the JAX package or JAX itself was loaded.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Python's compiled bytecode, for every module the run imports, torch's
# too: an installation may ship none and forbid writing it beside the
# sources (PYTHONDONTWRITEBYTECODE), and every process would then compile
# torch and torch._dynamo again (about 20 s on an H100 machine). The first
# run in a checkout writes it here, at a fixed path; the later ones read it.
PYCACHE = os.path.join(REPO, "build", "portbench-pycache")


def _plain(value):
    """Non-finite numbers as null: the line stays JSON."""
    if isinstance(value, float) and not math.isfinite(value):
        return None
    if isinstance(value, dict):
        return {k: _plain(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_plain(v) for v in value]
    return value


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    sys.pycache_prefix = PYCACHE
    sys.dont_write_bytecode = False
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    from portbench import harness

    started = harness.process_start_time()
    cell = harness.workload(harness.manifest(), args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    with contextlib.redirect_stdout(sys.stderr):
        result = harness.run(args.workload, args.seed, args.seconds, bool(args.trace),
                             process_start=started)
    banned = harness.banned_modules()
    if banned:
        print(f"portbench: the run loaded {', '.join(banned)}", file=sys.stderr)
        return 3
    harness.print_checks(result)
    print(json.dumps(_plain(result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
