"""vtlint pass: key-table capacity mutation only behind the grow helper.

Per-kind key-table capacities can only change at a flush swap boundary:
the C++ engine's sentinel lanes, the Python packed-buffer layouts, the
device state's shapes the kernels are launched over, and the snapshot
sidecar all derive from the live TableSpec, so a capacity that changes
anywhere else tears the interval. `veneur_tpu_torch/tables/growth.py`
is the ONE module that owns the sequencing (stage on the engine via
`capacity_set`, apply inside the swap's reset while the tables are
empty, rebuild the backend around the same engine). This pass makes
that grow site un-bypassable:

  1. calls to a capacity mutator — `capacity_set`, `vt_capacity_set`,
     `vrm_capacity_set` — anywhere in the tree outside growth.py and
     the ctypes binding layer (veneur_tpu_torch/native/__init__.py) are
     flagged (an aggregator method delegating to the engine's
     `capacity_set` would be a second grow site);
  2. assignments to a `spec` or `pspec` attribute outside `__init__`
     (construction fixes the TableSpec; a live capacity change must be
     a whole-backend rebuild through tables/growth.py grow_swap()) are
     flagged.

Tests and the analysis package itself are out of scope — the contract
binds production code; tests exercise mutators on purpose.
"""

from __future__ import annotations

import ast
from typing import List

from veneur_tpu_torch.analysis.core import Finding, Project

NAME = "table-grow-quiesce"
DOC = ("key-table capacity / TableSpec mutation happens only behind the "
       "swap-boundary grow helper (tables/growth.py)")

# the scanned tree (production code only; tests exercise mutators)
ROOTS = ["veneur_tpu_torch"]

_MUTATORS = {"capacity_set", "vt_capacity_set", "vrm_capacity_set"}

_CALL_ALLOWED = {
    "veneur_tpu_torch/tables/growth.py",     # THE documented grow site
    "veneur_tpu_torch/native/__init__.py",   # ctypes binding internals
}

_SPEC_ATTRS = {"spec", "pspec"}


def _call_name(node: ast.Call) -> str:
    f = node.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return ""


def _attr_targets(stmt: ast.stmt):
    """Attribute names assigned by a statement (plain or augmented)."""
    if isinstance(stmt, ast.Assign):
        targets = stmt.targets
    elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
        targets = [stmt.target]
    else:
        return
    for t in targets:
        if isinstance(t, ast.Attribute):
            yield t.attr


def _scan_file(ctx) -> List[Finding]:
    findings: List[Finding] = []
    # map every node to its enclosing function name, so rule 2 can give
    # construction (__init__) its pass
    enclosing = {}

    def mark(fn_name, node):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                mark(child.name, child)
            else:
                enclosing[child] = fn_name
                mark(fn_name, child)

    mark("", ctx.tree)
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Call):
            name = _call_name(node)
            if name in _MUTATORS and ctx.rel not in _CALL_ALLOWED:
                findings.append(Finding(
                    NAME, ctx.rel, node.lineno,
                    f"{name}() outside the grow helper — per-kind "
                    "capacities may only change inside "
                    "tables/growth.py grow_swap(), where the staged "
                    "capacities apply at the swap's reset while the "
                    "tables are empty"))
        for attr in _attr_targets(node) if isinstance(node, ast.stmt) \
                else ():
            if attr in _SPEC_ATTRS and enclosing.get(node) != "__init__":
                findings.append(Finding(
                    NAME, ctx.rel, node.lineno,
                    f"assignment to .{attr} outside __init__ — the "
                    "TableSpec is fixed at construction; a live "
                    "capacity change is a whole-backend rebuild "
                    "through tables/growth.py grow_swap()"))
    return findings


def run(project: Project, roots: List[str] = None) -> List[Finding]:
    findings: List[Finding] = []
    scanned = False
    for ctx in project.files(*(roots or ROOTS)):
        scanned = True
        if ctx.rel.startswith("veneur_tpu_torch/analysis/"):
            continue   # the lint layer names mutators in strings/docs
        findings.extend(_scan_file(ctx))
    if not scanned:
        findings.append(Finding(
            NAME, (roots or ROOTS)[0], 0, "scan root missing or empty"))
    return findings
