"""BENCHMARK.json against the benchmark's contract, and every file that it
names found by name: ``python -m pytest portbench/tests -q``."""

from __future__ import annotations

import ast
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
REPO = ROOT.parent
MAN = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
CELLS = [c["name"] for c in MAN["workloads"]]
METRICS = MAN["end_to_end"] + MAN["per_layer"]


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_and_sizes():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                        "per_layer"}
    assert len(json.dumps(MAN)) <= 64 * 1024
    assert 1 <= len(MAN["paths"]) <= 16 and all(PATH.match(p) for p in MAN["paths"])
    assert all(not p.startswith("/") and ".." not in p.split("/") for p in MAN["paths"])
    assert 1 <= len(MAN["command"]) <= 32 and all(_line(w) for w in MAN["command"])
    assert isinstance(MAN["run_seconds"], int) and 1 <= MAN["run_seconds"] <= 51
    assert 1 <= len(MAN["configs"]) <= 24 and 1 <= len(MAN["workloads"]) <= 24
    assert 1 <= len(MAN["end_to_end"]) <= 16 and 1 <= len(MAN["per_layer"]) <= 128


def test_names_units_and_lines():
    for group in (MAN["configs"], MAN["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4) and _line(w["why"])
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert _line(m["layer"])


def test_every_file_found_by_name():
    paths = [REPO / p for p in MAN["paths"]]
    used = {w["config"] for w in MAN["workloads"]}
    files = [c["file"] for c in MAN["configs"]]
    assert len(files) == len(set(files))
    for c in MAN["configs"]:
        assert c["name"] in used
        f = REPO / c["file"]
        assert f.exists() and any(p in f.parents for p in paths)
        assert json.loads(f.read_text())["name"] == c["name"]
    for w in MAN["workloads"]:
        assert json.loads((ROOT / "traffic" / f"{w['traffic']}.json").read_text())["kind"]
        assert json.loads((ROOT / "limits" / f"{w['name']}.json").read_text())["limits"]
    for m in MAN["per_layer"]:
        assert (ROOT / "metrics" / f"{m['name']}.py").exists()


def test_metric_files_agree_with_the_manifest():
    from portbench import harness

    for m in MAN["per_layer"]:
        mod = harness.metric_module(m["name"])
        assert (mod.NAME, mod.UNIT, mod.LAYER, mod.MOVES) == (m["name"], m["unit"], m["layer"],
                                                              m["moves"])


def test_cells_report_what_their_layers_move():
    from portbench import harness

    names = {m["name"] for m in MAN["end_to_end"]}
    for cell in CELLS:
        e2e = [m["name"] for m in MAN["end_to_end"] if harness.reports(MAN, m, cell)]
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = [m for m in MAN["per_layer"] if harness.reports(MAN, m, cell)]
        assert layer
        for m in layer:
            assert m["moves"] in names and m["moves"] in e2e
    for m in MAN["per_layer"] + MAN["end_to_end"]:
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    layers = {}
    for m in MAN["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
    four = sum(w["chips"] == 4 for w in MAN["workloads"])
    assert four <= max(1, len(CELLS) // 4)


@pytest.mark.parametrize("cell", CELLS)
def test_config_model_block_is_its_conf(cell):
    from portbench import harness

    cfg = harness.config(MAN, harness.workload(MAN, cell))
    conf, model = cfg["conf"], cfg["model"]
    assert conf["model.name"] == model["name"]
    assert int(conf["num.factors"]) > 0 and int(conf["batch_size"]) == model["batch_size"]
    assert float(conf["learnRate"].split()[1]) == model["lr"]
    reg = conf["reg.lambda"].split()
    assert float(reg[reg.index("-u") + 1]) == model["reg"]
    args = conf[model["name"]].split()
    assert int(args[args.index("-n_layer") + 1]) == model["layers"]
    assert max(int(n) for n in conf["item.ranking"].split()[2].split(",")) == model["top_n"]
    if model["name"] == "SimGCL":
        assert float(args[args.index("-lambda") + 1]) == model["cl_rate"]
        assert float(args[args.index("-eps") + 1]) == model["eps"]
    assert cfg["reduced"] == next(c["reduced"] for c in MAN["configs"] if c["name"] == cfg["name"])


@pytest.mark.parametrize("cell", CELLS)
def test_config_conf_is_qrecs_shipped_conf(cell):
    """Every key of QRec's shipped ``config/<model>.conf`` is the
    configuration's, but the rating file and the split (the ``-testSet``
    of the benchmark's exact split, with the conf's other options); the
    configuration adds only ``train.chunk``."""
    from portbench import harness

    conf = harness.config(MAN, harness.workload(MAN, cell))["conf"]
    shipped = {}
    for line in (REPO / "config" / f"{conf['model.name']}.conf").read_text().splitlines():
        if "=" in line:
            key, value = line.split("=", 1)
            shipped[key.strip()] = value.strip()
    assert set(conf) - set(shipped) <= {"train.chunk"}
    for key, value in shipped.items():
        if key == "ratings":
            continue
        if key == "evaluation.setup":
            assert conf[key].startswith("-testSet {test} ")
            assert conf[key].split()[2:] == [w for w in value.split() if w not in ("-ap", "0.2")]
            continue
        assert conf[key] == value, key


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_jax_and_a_reference_of_its_own():
    banned = {"jax", "jaxlib", "flax", "optax", "qrec_tpu", "bench", "chip_smoke"}
    for path in ROOT.rglob("*.py"):
        found = set(_imports(path))
        assert not found & banned, (path, found & banned)
        if "reference" in path.relative_to(ROOT).parts:
            assert "qrec_tpu_torch" not in found, path
            assert "portbench" not in found or path.name == "__init__.py", path
