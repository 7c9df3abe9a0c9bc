"""vtlint pass: derived lock guards — no read-modify-write of a
lock-guarded attribute outside its lock.

The lost-update race, generalized: `self.imported_total += 1` from two
threads loses increments because `+=` on an attribute is a
read-modify-write.
Rather than asking every class to declare its locking contract, this
pass DERIVES it from the code the way a careful reader would:

  1. a lock attribute is any `self.X = threading.Lock()/RLock()/
     Condition()` assignment (alias-aware);
  2. an attribute is *guarded by* lock X when any method touches it
     inside `with self.X:` — the class itself claims X protects it;
  3. methods named `*_locked` inherit the locks held at their lexical
     `self._foo_locked()` call sites (the caller-holds-the-lock
     convention used by ForwardSpillBuffer._evict_locked and
     DedupWindow._verdict_locked);
  4. a read-modify-write of a guarded attribute (`self.a += n`,
     `self.a = self.a + n`, `self.a[k] += n`) while holding NONE of its
     guard locks is a lost-update race — flagged.

Nested function definitions reset the held-lock set: a closure defined
under a lock runs later on whatever thread calls it (exactly how
ProxyServer.start's gRPC on_reject callback raced envelope_rejected).

Attributes never touched under any lock derive no guard and are not
flagged — single-writer designs (OverloadController.state, the
aggregator's pipeline-thread counters) stay lint-silent by
construction, no annotations needed.
"""

from __future__ import annotations

import ast
from collections import defaultdict
from typing import Dict, FrozenSet, List, Set

from veneur_tpu_torch.analysis.core import (FileContext, Finding,
                                            Project)

NAME = "lock-discipline"
DOC = ("read-modify-writes of derived lock-guarded attributes happen "
       "under their lock")

# the concurrent surface: every module whose classes share state across
# threads (registry, spill/dedup/overload, proxy, spans, server, the
# aggregators, resilient sinks)
MODULES = [
    "veneur_tpu_torch/observability/registry.py",
    "veneur_tpu_torch/reliability/spill.py",
    "veneur_tpu_torch/reliability/overload.py",
    "veneur_tpu_torch/forward/envelope.py",
    "veneur_tpu_torch/forward/proxysrv.py",
    "veneur_tpu_torch/forward/rpc.py",
    "veneur_tpu_torch/server/spans.py",
    "veneur_tpu_torch/server/server.py",
    "veneur_tpu_torch/server/aggregator.py",
    "veneur_tpu_torch/server/sharded_aggregator.py",
    "veneur_tpu_torch/server/native_aggregator.py",
    "veneur_tpu_torch/sinks/base.py",
]

_LOCK_TYPES = ("threading.Lock", "threading.RLock", "threading.Condition")


def _self_attr(node: ast.AST):
    """'x' for a `self.x` attribute node, else None."""
    if isinstance(node, ast.Attribute) \
            and isinstance(node.value, ast.Name) \
            and node.value.id == "self":
        return node.attr
    return None


def _lock_attrs(cls: ast.ClassDef, ctx: FileContext) -> Set[str]:
    locks = set()
    for node in ast.walk(cls):
        if not isinstance(node, ast.Assign):
            continue
        value = node.value
        if not isinstance(value, ast.Call):
            continue
        resolved = ctx.resolve(value.func)
        if resolved in _LOCK_TYPES or (
                resolved in ("Lock", "RLock", "Condition")):
            for t in node.targets:
                attr = _self_attr(t)
                if attr:
                    locks.add(attr)
    return locks


class _Analyzer:
    """One class's lock analysis: held-set-aware walks over each method,
    with one level of caller-holds propagation into *_locked methods."""

    def __init__(self, ctx: FileContext, cls: ast.ClassDef):
        self.ctx = ctx
        self.cls = cls
        self.locks = _lock_attrs(cls, ctx)
        self.methods = {
            n.name: n for n in cls.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
        # attr -> set of locks some method holds while touching it
        self.guarded: Dict[str, Set[str]] = defaultdict(set)
        # method name -> union of lock sets held at its call sites
        self.locked_callers: Dict[str, Set[str]] = defaultdict(set)
        # (method, lineno, attr, held) read-modify-write sites
        self.rmw_sites: List[tuple] = []

    # -- phase 1: walk every method, recording accesses + RMWs --------------
    def _with_locks(self, stmt: ast.With) -> Set[str]:
        held = set()
        for item in stmt.items:
            attr = _self_attr(item.context_expr)
            if attr in self.locks:
                held.add(attr)
        return held

    def _record_access(self, node: ast.AST, held: FrozenSet[str]) -> None:
        attr = _self_attr(node)
        if attr and attr not in self.locks and held:
            self.guarded[attr] |= held

    def _rmw_attr(self, stmt: ast.stmt):
        """The self-attribute a statement read-modify-writes, or None."""
        if isinstance(stmt, ast.AugAssign):
            t = stmt.target
            if isinstance(t, ast.Subscript):
                t = t.value
            return _self_attr(t)
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
            attr = _self_attr(stmt.targets[0])
            if attr and any(_self_attr(n) == attr
                            for n in ast.walk(stmt.value)):
                return attr
        return None

    def _scan_expr(self, method: str, node: ast.AST,
                   held: FrozenSet[str]) -> None:
        if isinstance(node, ast.Lambda):
            # a lambda runs later, on an unknown thread, with no lock
            self._scan_expr(method, node.body, frozenset())
            return
        self._record_access(node, held)
        if isinstance(node, ast.Call):
            callee = _self_attr(node.func)
            if callee and callee.endswith("_locked") and held:
                self.locked_callers[callee] |= held
        for child in ast.iter_child_nodes(node):
            self._scan_expr(method, child, held)

    def _walk_body(self, stmts, method: str,
                   held: FrozenSet[str]) -> None:
        # statements with bodies need held-set threading; expressions
        # are scanned flat
        for stmt in stmts:
            rmw = self._rmw_attr(stmt)
            if rmw and rmw not in self.locks:
                self.rmw_sites.append((method, stmt.lineno, rmw, held))
            if isinstance(stmt, ast.With):
                inner = frozenset(held | self._with_locks(stmt))
                for item in stmt.items:
                    self._scan_expr(method, item.context_expr, held)
                self._walk_body(stmt.body, method, inner)
            elif isinstance(stmt, (ast.FunctionDef,
                                   ast.AsyncFunctionDef)):
                self._walk_body(stmt.body, method, frozenset())
            elif isinstance(stmt, (ast.If, ast.While)):
                self._scan_expr(method, stmt.test, held)
                self._walk_body(stmt.body, method, held)
                self._walk_body(stmt.orelse, method, held)
            elif isinstance(stmt, ast.For):
                self._scan_expr(method, stmt.target, held)
                self._scan_expr(method, stmt.iter, held)
                self._walk_body(stmt.body, method, held)
                self._walk_body(stmt.orelse, method, held)
            elif isinstance(stmt, ast.Try):
                self._walk_body(stmt.body, method, held)
                for h in stmt.handlers:
                    self._walk_body(h.body, method, held)
                self._walk_body(stmt.orelse, method, held)
                self._walk_body(stmt.finalbody, method, held)
            else:
                self._scan_expr(method, stmt, held)

    def analyze(self) -> List[Finding]:
        if not self.locks:
            return []
        for name, fn in self.methods.items():
            self._walk_body(fn.body, name, frozenset())
        # phase 2: *_locked methods re-walk under their callers' locks
        # (one level: enough for the _evict_locked/_verdict_locked
        # convention without whole-program call-graph analysis)
        for name, held in self.locked_callers.items():
            fn = self.methods.get(name)
            if fn is not None:
                self._walk_body(fn.body, name, frozenset(held))

        findings = []
        for method, lineno, attr, held in self.rmw_sites:
            if method in ("__init__", "__del__"):
                continue   # construction/teardown: no concurrency yet
            guards = self.guarded.get(attr)
            if not guards:
                continue   # never touched under a lock: no derived claim
            if held & guards:
                continue
            if method.endswith("_locked") \
                    and self.locked_callers.get(method, set()) & guards:
                continue   # caller holds the guard by convention
            lock_names = ", ".join(sorted(guards))
            findings.append(Finding(
                NAME, self.ctx.rel, lineno,
                f"{self.cls.name}.{method}() read-modify-writes "
                f"self.{attr} without a lock, but other code guards it "
                f"with self.{lock_names} — lost-update race (take the "
                "lock, or route the counter through TelemetryRegistry)"))
        return findings


def run(project: Project, modules: List[str] = None) -> List[Finding]:
    findings: List[Finding] = []
    for rel in (modules or MODULES):
        ctx = project.file(rel)
        if ctx is None:
            findings.append(Finding(
                NAME, rel, 0, "file missing — update MODULES"))
            continue
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.ClassDef):
                findings.extend(_Analyzer(ctx, node).analyze())
    return findings
