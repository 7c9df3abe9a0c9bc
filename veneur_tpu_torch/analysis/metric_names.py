"""vtlint pass: every self-telemetry metric name is registered once and
documented.

The port's telemetry registry
(veneur_tpu_torch/observability/registry.py) is the single source of
truth for `veneur.*` series:

  1. a name is REGISTERED (registry.counter/gauge/timer/callback with a
     literal name) at most once across the tree;
  2. every name the code can emit or register appears in the port's
     metric inventory in the README (between the torch-metric-inventory
     markers of its PyTorch/CUDA port section);
  3. every inventory row corresponds to a name the code actually uses.

A registration table counts as literal names: a `for name, ... in
(("veneur.x", ...), ...)` loop whose body registers `name` registers
each row's literal at that row's line.

Dynamically-built names can't be string-checked; they are documented as
a pattern in the README prose and intentionally out of scope here.
"""

from __future__ import annotations

import ast
import re
from collections import defaultdict
from typing import List

from veneur_tpu_torch.analysis.core import Finding, Project

NAME = "metric-names"
DOC = ("veneur.* series registered once and kept in lockstep with the "
       "port's README metric inventory")

SAMPLE_FNS = {"count", "gauge", "timing", "histogram", "set_", "status"}
REGISTER_FNS = {"counter", "gauge", "timer", "callback"}

INV_BEGIN = "<!-- torch-metric-inventory:begin -->"
INV_END = "<!-- torch-metric-inventory:end -->"


def _literal_name(call: ast.Call):
    if call.args and isinstance(call.args[0], ast.Constant) \
            and isinstance(call.args[0].value, str) \
            and call.args[0].value.startswith("veneur."):
        return call.args[0].value
    return None


def _table_rows(loop: ast.For):
    """(name, lineno) of each literal row of a registration-table loop:
    `for name, ... in (("veneur.x", ...), ...)` whose body passes the
    loop's first name to a registration call. Nothing for other loops."""
    t = loop.target
    if not (isinstance(t, ast.Tuple) and t.elts
            and isinstance(t.elts[0], ast.Name)
            and isinstance(loop.iter, (ast.Tuple, ast.List))):
        return []
    var = t.elts[0].id
    registers = any(
        isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
        and n.func.attr in REGISTER_FNS and n.args
        and isinstance(n.args[0], ast.Name) and n.args[0].id == var
        for stmt in loop.body for n in ast.walk(stmt))
    if not registers:
        return []
    rows = []
    for row in loop.iter.elts:
        if isinstance(row, (ast.Tuple, ast.List)) and row.elts \
                and isinstance(row.elts[0], ast.Constant) \
                and isinstance(row.elts[0].value, str) \
                and row.elts[0].value.startswith("veneur."):
            rows.append((row.elts[0].value, row.lineno))
    return rows


def _scan(ctx, emitted: dict, registered: dict) -> None:
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.For):
            for name, line in _table_rows(node):
                registered[name].append(f"{ctx.rel}:{line}")
        elif isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute):
            name = _literal_name(node)
            if name is None:
                continue
            func = node.func
            on_samples = (isinstance(func.value, ast.Name)
                          and func.value.id == "ssf_samples")
            if on_samples and func.attr in SAMPLE_FNS:
                emitted[name].append(f"{ctx.rel}:{node.lineno}")
            elif not on_samples and func.attr in REGISTER_FNS:
                registered[name].append(f"{ctx.rel}:{node.lineno}")
        elif isinstance(node, ast.Dict):
            # the self-telemetry snapshot dict: {"veneur.x": ..., ...}
            keys = [k.value for k in node.keys
                    if isinstance(k, ast.Constant)
                    and isinstance(k.value, str)
                    and k.value.startswith("veneur.")]
            if len(keys) >= 3:
                for k in keys:
                    emitted[k].append(f"{ctx.rel}:{node.lineno}")


def inventory_names(text: str):
    try:
        block = text.split(INV_BEGIN, 1)[1].split(INV_END, 1)[0]
    except IndexError:
        return None
    return set(re.findall(r"`(veneur\.[a-zA-Z0-9._]+)`", block))


def run(project: Project, pkg: str = "veneur_tpu_torch",
        readme: str = "README.md") -> List[Finding]:
    emitted: dict = defaultdict(list)
    registered: dict = defaultdict(list)
    for ctx in project.files(pkg):
        _scan(ctx, emitted, registered)

    findings: List[Finding] = []
    for name, sites in sorted(registered.items()):
        if len(sites) > 1:
            rel, _, line = sites[1].rpartition(":")
            findings.append(Finding(
                NAME, rel, int(line),
                f"{name}: registered at {len(sites)} sites "
                f"({', '.join(sites)}); one owner only"))

    known = set(emitted) | set(registered)
    readme_path = project.root / readme
    if not readme_path.is_file():
        findings.append(Finding(NAME, "", 0, f"{readme} missing"))
        inv = set()
    else:
        inv = inventory_names(readme_path.read_text())
        if inv is None:
            findings.append(Finding(
                NAME, readme, 0,
                f"lacks the {INV_BEGIN} .. {INV_END} block"))
            inv = set()
    for name in sorted(known - inv):
        sites = (emitted.get(name) or registered.get(name))[:2]
        rel, _, line = sites[0].rpartition(":")
        findings.append(Finding(
            NAME, rel, int(line),
            f"{name}: used at {', '.join(sites)} but absent from the "
            "README metric inventory"))
    for name in sorted(inv - known):
        findings.append(Finding(
            NAME, readme, 0,
            f"{name}: in the README inventory but no code emits or "
            "registers it"))
    return findings
