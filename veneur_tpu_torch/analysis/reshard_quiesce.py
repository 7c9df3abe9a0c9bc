"""vtlint pass: shard-map mutation only behind the swap-boundary helper.

A shard map can only change at a buffer-swap boundary: the native
engine's staged rows are keyed under the OLD map, the reader rings hold
key-replica caches of old-map slots, and a packed batch must never
straddle two maps. `veneur_tpu_torch/reshard/quiesce.py` is the ONE
module that owns that sequencing (stage on the engine, apply inside the
swap's reset while the rings are quiesced). This pass makes the
boundary un-bypassable by review accident:

  1. calls to a shard-map mutator — `shard_map_set`,
     `vt_shard_map_set`, `vrm_shard_map_set` — anywhere in the tree
     outside quiesce.py and the ctypes binding layer
     (veneur_tpu_torch/native/__init__.py) are flagged;
  2. assignments to an `n_shards` attribute outside `__init__` (object
     construction fixes the map; everything after must go through the
     helper) are flagged;
  3. assignments to a proxy `_ring` attribute outside
     forward/proxysrv.py (whose refresh() is ring membership's own
     documented swap site) are flagged.

Tests and the analysis package itself are out of scope — the contract
binds production code; tests exercise mutators on purpose.
"""

from __future__ import annotations

import ast
from typing import List

from veneur_tpu_torch.analysis.core import Finding, Project

NAME = "reshard-quiesce"
DOC = ("shard-map / ring-membership mutation happens only behind the "
       "documented swap-boundary helper (reshard/quiesce.py)")

# the scanned tree (production code only; tests exercise mutators)
ROOTS = ["veneur_tpu_torch"]

_MUTATORS = {"shard_map_set", "vt_shard_map_set", "vrm_shard_map_set"}

# (file, reason) exemptions per rule
_CALL_ALLOWED = {
    "veneur_tpu_torch/reshard/quiesce.py",   # THE documented helper
    "veneur_tpu_torch/native/__init__.py",   # ctypes binding internals
}
_RING_ALLOWED = {
    "veneur_tpu_torch/forward/proxysrv.py",  # refresh() is ring membership's
    #                                    own documented swap site
}


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
                    f"{name}() outside the swap-boundary helper — a "
                    "shard map may only change inside "
                    "reshard/quiesce.py shard_map_swap(), where the "
                    "staged map applies at the swap's reset under the "
                    "ring quiesce"))
        for attr in _attr_targets(node) if isinstance(node, ast.stmt) \
                else ():
            if attr == "n_shards" and enclosing.get(node) != "__init__":
                findings.append(Finding(
                    NAME, ctx.rel, node.lineno,
                    "assignment to .n_shards outside __init__ — the "
                    "shard map is fixed at construction; live changes "
                    "go through reshard/quiesce.py shard_map_swap()"))
            elif attr == "_ring" and ctx.rel not in _RING_ALLOWED \
                    and enclosing.get(node) != "__init__":
                findings.append(Finding(
                    NAME, ctx.rel, node.lineno,
                    "assignment to ._ring outside forward/proxysrv.py "
                    "— ring membership changes only in the proxy's "
                    "refresh() (its documented swap site)"))
    return findings


def run(project: Project, roots: List[str] = None) -> List[Finding]:
    findings: List[Finding] = []
    scanned = False
    for ctx in project.files(*(roots or ROOTS)):
        scanned = True
        if ctx.rel.startswith("veneur_tpu_torch/analysis/"):
            continue   # the lint layer names mutators in string/docs
        findings.extend(_scan_file(ctx))
    if not scanned:
        findings.append(Finding(
            NAME, (roots or ROOTS)[0], 0, "scan root missing or empty"))
    return findings
