"""vtlint pass: every data-discarding code path increments a counter.

The overload contract is "nothing is shed silently": an operator must
be able to reconstruct sent == processed + sum(drop counters) from
telemetry alone.

1. Every `except queue.Full` / ParseError / FramingError handler must
   do accounting in its body — a counter `.inc(...)`, an `x += 1`
   increment, a re-raise, or an `.append(...)` onto a rejection
   collection. (The accounting-flow pass holds the same handlers to the
   stronger every-path standard; this pass keeps the any-path rule.)

2. The canonical drop-counter families must each still be REGISTERED
   somewhere in the tree as a string literal.
"""

from __future__ import annotations

import ast
from typing import List

from veneur_tpu_torch.analysis.core import Finding, Project

NAME = "drop-accounting"
DOC = ("drop-exception handlers account, and every required drop "
       "counter stays registered")

# the ingest + egress surface: everywhere a sample can be discarded
TARGETS = [
    "veneur_tpu_torch/server",
    "veneur_tpu_torch/samplers",
    "veneur_tpu_torch/protocol",
    "veneur_tpu_torch/forward",
    "veneur_tpu_torch/reliability",
    "veneur_tpu_torch/watch",
]

# counter families that discard sites rely on; each must appear as a
# registration literal somewhere under veneur_tpu_torch/
REQUIRED_COUNTERS = [
    "veneur.packets_dropped_total",
    "veneur.parse_errors_total",
    "veneur.worker.metrics_dropped_total",
    "veneur.overload.shed_total",
    "veneur.forward.spill.dropped_total",
    "veneur.tcp.rejected_total",
    "veneur.tcp.idle_closed_total",
    "veneur.watch.notify_dropped_total",
]

# exception names whose handlers ARE discard sites
DROP_EXCS = ("Full", "ParseError", "FramingError")

_REJECT_NAMES = ("invalid", "drop", "reject", "shed", "error")


def exc_names(node: ast.ExceptHandler) -> List[str]:
    """Leaf names of the handled exception type(s): `queue.Full` ->
    Full, `(Full, OSError)` -> both."""
    t = node.type
    if t is None:
        return []
    parts = t.elts if isinstance(t, ast.Tuple) else [t]
    names = []
    for p in parts:
        if isinstance(p, ast.Attribute):
            names.append(p.attr)
        elif isinstance(p, ast.Name):
            names.append(p.id)
    return names


def accounts_anywhere(handler: ast.ExceptHandler) -> bool:
    """True when the handler body increments something: an `.inc(...)`
    method call, an augmented `+=` assignment (the plain-int counter
    idiom), a re-raise (the caller accounts), or an `.append(...)` onto
    a rejection collection (the hand-off idiom where the CALLER counts
    the returned rejects)."""
    for stmt in ast.walk(ast.Module(body=handler.body, type_ignores=[])):
        if isinstance(stmt, ast.Raise):
            return True
        if isinstance(stmt, ast.AugAssign) and isinstance(stmt.op, ast.Add):
            return True
        if (isinstance(stmt, ast.Call)
                and isinstance(stmt.func, ast.Attribute)):
            # .inc() on a registry counter, or a *bump* counter helper
            # (the locked-increment idiom: self._bump("errors", n))
            if stmt.func.attr == "inc" or "bump" in stmt.func.attr:
                return True
            if stmt.func.attr == "append":
                target = stmt.func.value
                name = (target.id if isinstance(target, ast.Name)
                        else target.attr
                        if isinstance(target, ast.Attribute) else "")
                if any(r in name.lower() for r in _REJECT_NAMES):
                    return True
    return False


def run(project: Project, targets: List[str] = None,
        required_counters: List[str] = None,
        literal_roots: List[str] = None) -> List[Finding]:
    findings: List[Finding] = []
    for ctx in project.files(*(targets or TARGETS)):
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            dropped = [n for n in exc_names(node) if n in DROP_EXCS]
            if dropped and not accounts_anywhere(node):
                findings.append(Finding(
                    NAME, ctx.rel, node.lineno,
                    f"`except {'/'.join(dropped)}` discards data "
                    "without incrementing a drop counter"))

    literals = set()
    for ctx in project.files(*(literal_roots or ["veneur_tpu_torch"])):
        for node in ast.walk(ctx.tree):
            if (isinstance(node, ast.Constant)
                    and isinstance(node.value, str)
                    and node.value.startswith("veneur.")):
                literals.add(node.value)
    for name in (required_counters if required_counters is not None
                 else REQUIRED_COUNTERS):
        if name not in literals:
            findings.append(Finding(
                NAME, "", 0,
                f"required drop counter {name!r} is no longer "
                "registered anywhere under veneur_tpu_torch/"))
    return findings
