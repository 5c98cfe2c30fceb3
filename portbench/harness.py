"""Finds a cell's files by name and runs it.

A cell of ``BENCHMARK.json`` names a configuration, whose entry names its
file (``portbench/configs/<config>.json``), and a traffic mix, whose data
file is ``portbench/traffic/<traffic>.json`` and whose ``kind`` selects the
driver (``drive.KINDS``). The limits of the numbers that decide
``correct`` are ``portbench/limits/<cell>.json``. Each per-layer metric is
``portbench/metrics/<metric>.py``, a reader that returns a number or
None. A later cell, mix or metric adds files; it edits none.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
# top-level modules that must not be loaded in a run (the reference
# package of the port, and JAX), compared by whole top-level names
BANNED = ("jax", "jaxlib", "flax", "optax", "qrec_tpu")


def manifest() -> Dict:
    return json.loads((REPO / "BENCHMARK.json").read_text())


def workload(man: Dict, name: str) -> Dict:
    for cell in man["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(man: Dict, cell: Dict) -> Dict:
    entry = next(c for c in man["configs"] if c["name"] == cell["config"])
    return json.loads((REPO / entry["file"]).read_text())


def traffic(name: str) -> Dict:
    return json.loads((ROOT / "traffic" / f"{name}.json").read_text())


def limits(cell_name: str) -> Dict:
    return json.loads((ROOT / "limits" / f"{cell_name}.json").read_text())


def reports(man: Dict, metric: Dict, cell_name: str) -> bool:
    """Whether the cell reports ``metric``: it is in the metric's
    ``workloads``, or, without that key, it reports what the metric moves
    (an end-to-end metric without ``workloads`` is reported everywhere)."""
    if "workloads" in metric:
        return cell_name in metric["workloads"]
    moves = metric.get("moves")
    if moves is None:
        return True
    target = next(m for m in man["end_to_end"] if m["name"] == moves)
    return reports(man, target, cell_name)


def quantity(name: str) -> str:
    """The quantity an end-to-end metric reports: its name up to the first
    dot. ``train_examples_per_s.lastfm`` is the driver's
    ``train_examples_per_s`` under a bound of its own, in the cells that
    list it."""
    return name.split(".", 1)[0]


def metric_module(name: str):
    """The reader file of per-layer metric ``name``."""
    path = ROOT / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("portbench.metrics." + name.replace(".", "_"),
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def banned_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(BANNED))


def _finite_or_none(x) -> Optional[float]:
    return float(x) if x is not None and math.isfinite(float(x)) else None


def run(cell_name: str, seed: int, seconds: float, traced: bool, *, device: str = "cuda",
        process_start: Optional[float] = None, config_override: Optional[Dict] = None) -> Dict:
    """One run of a cell: the result line's object. ``process_start`` is the
    process's start on ``time.time()``'s clock (set-up counts from it);
    ``config_override`` runs another configuration in the cell's place
    (the tests' small shapes)."""
    import torch

    from . import drive, system

    t_start = time.time() if process_start is None else process_start
    perf_to_wall = time.time() - time.perf_counter()
    man = manifest()
    cell = workload(man, cell_name)
    cfg = config_override or config(man, cell)
    mix = traffic(cell["traffic"])
    lim = limits(cell_name)
    dev = torch.device(device)
    marks = [("python, torch and the harness imported", time.perf_counter())]
    if dev.type == "cuda":
        system.kernels_built()
        marks.append(("kernels built or found", time.perf_counter()))
    tmpdir = tempfile.mkdtemp(prefix="portbench-")
    try:
        ctx = drive.Context(cell, cfg, mix, seed, seconds, traced, dev, tmpdir, marks)
        out = drive.KINDS[mix["kind"]](ctx)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    for phase, at in marks:
        print(f"set-up: {phase} at {at + perf_to_wall - t_start:.3f} s", file=sys.stderr)
    setup_s = out.window_start + perf_to_wall - t_start
    checks = {k: {"value": out.checks.get(k, math.inf), "limit": limit}
              for k, limit in lim["limits"].items()}
    correct = not out.note and all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                                   for c in checks.values())
    metrics: Dict[str, Dict] = {}
    if not traced:
        values = dict(out.metrics, setup_s=setup_s)
        for m in man["end_to_end"]:
            if reports(man, m, cell_name):
                metrics[m["name"]] = {"value": values[quantity(m["name"])], "unit": m["unit"]}
    else:
        record = dict(out.record, setup_s=setup_s, metrics=out.metrics)
        for m in man["per_layer"]:
            if not reports(man, m, cell_name):
                continue
            value = _finite_or_none(metric_module(m["name"]).read(record, out.summary))
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "count": 1,
        "memory_peak_bytes": out.memory_peak_bytes,
    }
    result = {"correct": correct, "attempted": out.attempted, "failed": out.failed,
              "metrics": metrics, "device": device_info}
    if traced and out.summary is not None:
        device_info["busy_s"] = out.summary.busy_s
        device_info["window_s"] = out.record["profiled_wall_s"]
        result["breakdown"] = {"device_ops": out.summary.device_ops,
                               "idle_gaps": out.summary.idle_gaps}
    if out.note:
        result["note"] = out.note
    result["readings"] = {k: v for k, v in out.checks.items() if k not in checks}
    result["checks"] = checks
    return result


def print_checks(result: Dict, stream=sys.stderr) -> None:
    """Each compared number beside its limit, as the run's last lines."""
    if "note" in result:
        print(f"start: {result['note']}", file=stream)
    for name, c in result["checks"].items():
        print(f"{name}: {c['value']!r} limit {c['limit']!r}", file=stream)
    stream.flush()


def process_start_time() -> Optional[float]:
    """This process's start on ``time.time()``'s clock: now less the time
    since it started, from ``/proc`` (its start and the uptime both count
    from boot, in hundredths of a second); None where that cannot be
    read."""
    try:
        with open("/proc/self/stat") as f:
            started = int(f.read().rsplit(")", 1)[1].split()[19]) / os.sysconf("SC_CLK_TCK")
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - started)
    except (OSError, ValueError, IndexError):
        return None
