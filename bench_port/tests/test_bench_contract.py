"""BENCHMARK.json against the benchmark's contract, and every file the
harness finds by name."""

import ast
import json
import re
from pathlib import Path

import pytest

from bench_port import generate, harness

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "veneur_tpu", "benchmarks"}


def _names():
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[key]:
            yield entry["name"]
    for w in BENCH["workloads"]:
        yield w["config"]
        yield w["traffic"]
    for c in BENCH["configs"]:
        yield from c["reduced"]


@pytest.mark.parametrize("name", sorted(set(_names())))
def test_names_use_the_allowed_characters(name):
    assert NAME.match(name), name


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metrics_are_well_formed(metric):
    assert UNIT.match(metric["unit"]), metric["unit"]
    assert metric["better"] in ("lower", "higher")
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    if "bound" in metric:
        assert 0.01 <= metric["bound"] <= 0.25
        assert metric["source"] in ("host_clock", "device_trace")
    else:
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
        assert "\n" not in metric["layer"] and len(metric["layer"]) <= 200
        harness.reader(metric["name"])          # its reader exists


def test_every_cell_reports_what_the_contract_asks():
    names = [m["name"] for m in BENCH["end_to_end"]]
    assert "setup_s" in names
    for w in BENCH["workloads"]:
        p = harness.plan(BENCH, w["name"])
        assert len(p["end_to_end"]) >= 2 and p["per_layer"]
        assert w["chips"] == 1 and len(w["why"]) <= 200
        cfg = harness.load_config(p["config"])
        assert cfg["interval_s"] > 0
        assert BENCH["run_seconds"] % cfg["interval_s"] == 0
        mix = generate.load_mix(w["traffic"])
        harness.kind(mix["kind"])               # its module exists
        limits = cfg["comparison"]["limits"]
        assert limits and all(v >= 0 for v in limits.values())
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_paths_and_command_stay_inside_the_benchmark():
    assert BENCH["paths"] == ["bench_port"]
    for c in BENCH["configs"]:
        assert c["file"].startswith("bench_port/")
        assert (REPO / c["file"]).exists()
    assert BENCH["command"] == ["python3", "-m", "bench_port.run"]
    assert len(json.dumps(BENCH)) < 64 * 1024


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            yield node.module.split(".", 1)[0]


@pytest.mark.parametrize("path", sorted(
    p.relative_to(REPO).as_posix()
    for p in (REPO / "bench_port").rglob("*.py")))
def test_no_module_imports_jax_or_the_jax_package(path):
    # top-level names compared whole: veneur_tpu_torch is the program
    found = set(_imports(REPO / path)) & FORBIDDEN
    assert not found, f"{path} imports {found}"


def test_the_forbidden_check_compares_whole_names(monkeypatch):
    import sys
    import types
    monkeypatch.setitem(sys.modules, "veneur_tpu_torch_probe",
                        types.ModuleType("veneur_tpu_torch_probe"))
    assert "veneur_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "veneur_tpu.probe",
                        types.ModuleType("veneur_tpu.probe"))
    assert "veneur_tpu" in harness.forbidden_modules()
