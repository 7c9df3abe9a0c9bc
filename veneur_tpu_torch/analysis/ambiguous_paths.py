"""vtlint pass: forward send/retry failure paths preserve exactly-once.

The exactly-once contract
(forward/envelope.py) hangs on one discipline in the send/retry code: a
failed or AMBIGUOUS send must leave the unit staged under its ORIGINAL
(source_id, epoch, seq) so the retry re-sends the same envelope and the
receiver's dedup window can suppress it.

1. Every except handler in the named send/retry functions must account
   its failure (raise / `.inc()` / `+=`). The accounting-flow pass
   additionally holds these handlers to the every-path standard.
2. No except handler may fake an ack or evict staged state
   (`.ack/.drain/.popleft/.clear` and `return True` are forbidden).
3. forward/rpc.py's _AMBIGUOUS_CODES must keep DEADLINE_EXCEEDED and
   CANCELLED, and AmbiguousResultError must still be raised there.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Set

from veneur_tpu_torch.analysis.core import Finding, Project
from veneur_tpu_torch.analysis.drop_accounting import (
    accounts_anywhere)

NAME = "ambiguous-paths"
DOC = ("send/retry except arms never fake an ack or evict staged "
       "state; ambiguous-result classification stays put")

# (file, function names lexically containing send/retry except arms)
TARGETS: Dict[str, Set[str]] = {
    "veneur_tpu_torch/forward/rpc.py": {
        "send_metrics", "send_serialized", "send_json", "_post"},
    "veneur_tpu_torch/server/server.py": {
        "_forward", "_forward_traced", "_send_forward",
        "_stage_forward_unit", "_pump_forward_units", "_pump_traced"},
    "veneur_tpu_torch/forward/proxysrv.py": {
        "handle", "_deliver_enveloped", "proxy_json_metrics",
        "_post_import"},
}

RPC_FILE = "veneur_tpu_torch/forward/rpc.py"

# calls that evict/ack staged send state; illegal in a failure arm
_EVICT_CALLS = ("ack", "drain", "popleft", "clear")


def _evicts_or_acks(handler: ast.ExceptHandler):
    """Offending nodes: spill/window eviction calls or `return True`
    (a fabricated ack) anywhere in the handler body."""
    bad = []
    for node in ast.walk(ast.Module(body=handler.body, type_ignores=[])):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _EVICT_CALLS):
            bad.append((node.lineno, f".{node.func.attr}(...)"))
        if (isinstance(node, ast.Return)
                and isinstance(node.value, ast.Constant)
                and node.value.value is True):
            bad.append((node.lineno, "return True"))
    return bad


def _function_handlers(tree: ast.AST, wanted: Set[str]):
    """Yield (funcname, ExceptHandler) for handlers lexically inside the
    wanted function defs (nested defs inherit the enclosing name)."""
    for node in ast.walk(tree):
        if (isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
                and node.name in wanted):
            for sub in ast.walk(node):
                if isinstance(sub, ast.ExceptHandler):
                    yield node.name, sub


def _present_functions(tree: ast.AST, wanted: Set[str]) -> Set[str]:
    present = set()
    for node in ast.walk(tree):
        if (isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
                and node.name in wanted):
            present.add(node.name)
    return present


def _check_classification(project: Project, rpc_rel: str) -> List[Finding]:
    """Rule 3: rpc.py still classifies DEADLINE_EXCEEDED/CANCELLED as
    ambiguous and raises AmbiguousResultError somewhere."""
    ctx = project.file(rpc_rel)
    if ctx is None:
        return [Finding(NAME, rpc_rel, 0, "file missing — update TARGETS")]
    findings = []
    codes = set()
    raises_ambiguous = False
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Assign):
            targets = [t.id for t in node.targets
                       if isinstance(t, ast.Name)]
            if "_AMBIGUOUS_CODES" in targets and isinstance(
                    node.value, (ast.Tuple, ast.List)):
                for elt in node.value.elts:
                    if isinstance(elt, ast.Attribute):
                        codes.add(elt.attr)
        if isinstance(node, ast.Raise) and node.exc is not None:
            call = node.exc
            name = (call.func if isinstance(call, ast.Call) else call)
            if (isinstance(name, ast.Name)
                    and name.id == "AmbiguousResultError"):
                raises_ambiguous = True
    for want in ("DEADLINE_EXCEEDED", "CANCELLED"):
        if want not in codes:
            findings.append(Finding(
                NAME, rpc_rel, 0,
                f"_AMBIGUOUS_CODES no longer includes {want} — "
                "ambiguous timeouts would re-send under a fresh seq "
                "and double-fold at the global tier"))
    if not raises_ambiguous:
        findings.append(Finding(
            NAME, rpc_rel, 0,
            "AmbiguousResultError is never raised — the ambiguous "
            "classification regressed"))
    return findings


def run(project: Project, targets: Dict[str, Set[str]] = None,
        rpc_rel: str = None) -> List[Finding]:
    findings: List[Finding] = []
    for rel, funcs in (targets or TARGETS).items():
        ctx = project.file(rel)
        if ctx is None:
            findings.append(Finding(
                NAME, rel, 0, "file missing — update TARGETS"))
            continue
        seen = set()
        for fname, handler in _function_handlers(ctx.tree, funcs):
            seen.add(fname)
            if not accounts_anywhere(handler):
                findings.append(Finding(
                    NAME, rel, handler.lineno,
                    f"except in {fname}() swallows a send failure "
                    "without raise/.inc()/+="))
            for lineno, what in _evicts_or_acks(handler):
                findings.append(Finding(
                    NAME, rel, lineno,
                    f"except in {fname}() contains {what} — a failure "
                    "arm must not ack or evict the staged unit (retry "
                    "must re-send the same seq)"))
        # functions with no handler are fine (all errors propagate =
        # re-send same seq) but must still EXIST so a rename doesn't
        # silently shrink the lint surface
        missing = funcs - _present_functions(ctx.tree, funcs)
        for fname in sorted(missing):
            findings.append(Finding(
                NAME, rel, 0,
                f"expected function {fname}() not found — update "
                "veneur_tpu_torch/analysis/ambiguous_paths.py TARGETS if it "
                "moved"))
    if rpc_rel is None and targets is None:
        rpc_rel = RPC_FILE
    if rpc_rel is not None:
        findings.extend(_check_classification(project, rpc_rel))
    return findings
