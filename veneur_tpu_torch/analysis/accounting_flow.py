"""vtlint pass: drop/send-failure handlers account on EVERY path.

Supersedes the any-account-in-body halves of drop-accounting and
ambiguous-paths with a dataflow walk: a handler that increments a
counter on one branch but early-returns on another still loses data
silently on the unaccounted branch, and the old lint couldn't see it.

The walk simulates the handler body with an accounted/unaccounted state
set: an accounting statement (raise, `+= `, `.inc(...)`, `.append` onto
a rejection collection, or a call to a same-module helper that itself
accounts on every path — one level deep) flips the state; `return`
while possibly unaccounted, or control falling off the end of the
handler while possibly unaccounted, is a finding at that line.

Surface: the drop-exception handlers (`Full`/`ParseError`/
`FramingError`) across the ingest+egress tree, plus every handler in
the exactly-once send/retry functions.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from veneur_tpu_torch.analysis import ambiguous_paths, drop_accounting
from veneur_tpu_torch.analysis.core import (FileContext, Finding,
                                            Project)

NAME = "accounting-flow"
DOC = ("every branch of a drop/send-failure handler accounts before "
       "it exits (dataflow, follows early returns + helper calls); "
       "per-ring counter drains fold across ALL rings")

_REJECT_NAMES = ("invalid", "drop", "reject", "shed", "error")

# surface 3: cross-ring counter folds. The multi-ring engine's per-ring
# drains are DESTRUCTIVE (admission deltas) or partial (one ring's
# counters); a caller that reads one ring outside a fold loop silently
# loses the other rings' counts — exactly the bug class the
# datagrams == toolong + admitted + shed invariant exists to catch.
# Calls to these names must sit inside a for/while fold over the rings;
# `*_one` accessors are exempt BY NAME (the suffix is the documented
# "caller must fold" contract this surface enforces on their callers),
# and so is a closure defined inside one: the binding's buffer-growing
# retry idiom (`def call(cap): ...` handed to `_grow_call`) runs the one
# ring's read on the accessor's behalf.
RING_DRAINS = frozenset({
    "vrm_admission_counters", "vrm_counters", "vrm_ring_stats",
    "ring_admission_drain_one", "ring_counters_one", "ring_stats_one",
    # tenant shed/demote deltas ride the same destructive per-ring drain
    # contract: one ring read outside a fold loses the others' counts
    "vrm_tenant_counters", "ring_tenant_drain_one"})
RING_TARGETS = (
    "veneur_tpu_torch/native/__init__.py",
    "veneur_tpu_torch/server/server.py",
    "veneur_tpu_torch/server/native_aggregator.py",
)


def _helper_name(call: ast.Call) -> Optional[str]:
    """Leaf name of a `self.helper(...)`/`helper(...)` call."""
    f = call.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name) \
            and f.value.id == "self":
        return f.attr
    return None


class _Flow:
    """Accounted-on-every-path analysis over one module."""

    def __init__(self, ctx: FileContext):
        self.ctx = ctx
        # leaf function name -> def node (methods + module functions)
        self.functions: Dict[str, ast.AST] = {}
        for node in ast.walk(ctx.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.functions.setdefault(node.name, node)
        self._helper_cache: Dict[str, bool] = {}

    # -- what counts as accounting ------------------------------------------
    def _accounts_stmt(self, stmt: ast.stmt, depth: int) -> bool:
        """Does executing this one statement guarantee accounting?"""
        if isinstance(stmt, ast.Raise):
            return True
        if isinstance(stmt, ast.AugAssign) \
                and isinstance(stmt.op, ast.Add):
            return True
        if isinstance(stmt, ast.Expr) \
                and isinstance(stmt.value, ast.Call):
            call = stmt.value
            if isinstance(call.func, ast.Attribute):
                if call.func.attr == "inc" or "bump" in call.func.attr:
                    return True
                if call.func.attr == "append":
                    target = call.func.value
                    name = (target.id if isinstance(target, ast.Name)
                            else target.attr
                            if isinstance(target, ast.Attribute) else "")
                    if any(r in name.lower() for r in _REJECT_NAMES):
                        return True
            if depth < 1:
                helper = _helper_name(call)
                fn = self.functions.get(helper) if helper else None
                if fn is not None and self._helper_accounts(helper, fn):
                    return True
        # a with-statement accounts if its body does on every path
        if isinstance(stmt, ast.With) and stmt.body:
            _, states = self._flow(stmt.body, {False}, [], depth)
            return states == {True}
        return False

    def _helper_accounts(self, name: str, fn) -> bool:
        if name not in self._helper_cache:
            self._helper_cache[name] = False   # break recursion cycles
            viols: List[int] = []
            _, states = self._flow(fn.body, {False}, viols, depth=1)
            self._helper_cache[name] = not viols and states <= {True}
        return self._helper_cache[name]

    # -- the state walk ------------------------------------------------------
    def _flow(self, stmts, states: Set[bool], viols: List[int],
              depth: int) -> tuple:
        """Advance the accounted-state set through a statement list.
        Returns (terminated, out_states); records violation lines for
        exits reachable while unaccounted."""
        for stmt in stmts:
            if not states:
                return True, states     # all paths already exited
            if states == {True}:
                return False, states    # accounted: rest is fine
            if self._accounts_stmt(stmt, depth):
                states = {True}
                continue
            if isinstance(stmt, ast.Return):
                if False in states:
                    viols.append(stmt.lineno)
                return True, set()
            if isinstance(stmt, (ast.Break, ast.Continue)):
                # loop-internal control flow inside the handler: the
                # handler itself continues; treat as a fallthrough
                return True, states
            if isinstance(stmt, ast.If):
                _, s1 = self._flow(stmt.body, set(states), viols, depth)
                _, s2 = self._flow(stmt.orelse, set(states), viols,
                                   depth)
                states = s1 | s2
            elif isinstance(stmt, (ast.For, ast.While)):
                _, s1 = self._flow(stmt.body, set(states), viols, depth)
                states = states | s1    # zero iterations possible
                _, s2 = self._flow(stmt.orelse, set(states), viols,
                                   depth)
                states = states | s2
            elif isinstance(stmt, ast.With):
                _, states = self._flow(stmt.body, states, viols, depth)
            elif isinstance(stmt, ast.Try):
                _, s1 = self._flow(stmt.body, set(states), viols, depth)
                out = set(s1)
                for h in stmt.handlers:
                    _, sh = self._flow(h.body, set(states), viols,
                                       depth)
                    out |= sh
                _, out = self._flow(stmt.orelse, out, viols, depth)
                _, out = self._flow(stmt.finalbody, out, viols, depth)
                states = out
            # plain statements (Assign, Expr, Pass, ...) don't change
            # the accounted state
        return False, states

    def check_handler(self, handler: ast.ExceptHandler,
                      what: str) -> List[Finding]:
        viols: List[int] = []
        _, states = self._flow(handler.body, {False}, viols, depth=0)
        findings = [
            Finding(NAME, self.ctx.rel, line,
                    f"{what} exits here on a branch that never "
                    "accounted the discarded data")
            for line in viols]
        if False in states:
            findings.append(Finding(
                NAME, self.ctx.rel, handler.lineno,
                f"{what} can fall through without accounting on at "
                "least one branch"))
        return findings


def _call_leaf(call: ast.Call) -> Optional[str]:
    f = call.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return None


def _walk_shallow(node, root):
    """ast.walk that does NOT descend into nested function defs (each
    def is analyzed as its own fold scope)."""
    stack = [node]
    while stack:
        n = stack.pop()
        if n is not root and isinstance(
                n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        yield n
        stack.extend(ast.iter_child_nodes(n))


def _ring_fold_findings(ctx: FileContext, drains) -> List[Finding]:
    """Per-ring drain calls outside a for/while fold loop, per function.
    A lone drain reads (or destructively resets) ONE ring where the
    accounting invariant needs the sum over all of them."""
    findings: List[Finding] = []
    funcs = (ast.FunctionDef, ast.AsyncFunctionDef)
    in_one = set()
    for fn in ast.walk(ctx.tree):
        if isinstance(fn, funcs) and fn.name.endswith("_one"):
            in_one.update(id(n) for n in ast.walk(fn)
                          if isinstance(n, funcs))
    for fn in ast.walk(ctx.tree):
        if not isinstance(fn, funcs):
            continue
        if id(fn) in in_one:
            continue   # per-ring accessor shim (or a closure inside
            #            one): the contract rides the accessor's name
        looped = set()
        for node in _walk_shallow(fn, fn):
            if isinstance(node, (ast.For, ast.While)):
                for sub in _walk_shallow(node, fn):
                    if sub is node:
                        continue
                    if isinstance(sub, ast.Call) \
                            and _call_leaf(sub) in drains:
                        looped.add(id(sub))
        for node in _walk_shallow(fn, fn):
            if isinstance(node, ast.Call) and _call_leaf(node) in drains \
                    and id(node) not in looped:
                findings.append(Finding(
                    NAME, ctx.rel, node.lineno,
                    f"per-ring drain `{_call_leaf(node)}` in "
                    f"{fn.name}() outside a fold loop — counters from "
                    "the other rings are lost (sum across all rings)"))
    return findings


def run(project: Project, targets: List[str] = None,
        send_targets: Dict[str, Set[str]] = None,
        ring_targets: List[str] = None,
        ring_drains: Set[str] = None) -> List[Finding]:
    findings: List[Finding] = []
    # surface 1: drop-exception handlers across the ingest/egress tree
    for ctx in project.files(*(targets if targets is not None
                               else drop_accounting.TARGETS)):
        flow = _Flow(ctx)
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            dropped = [n for n in drop_accounting.exc_names(node)
                       if n in drop_accounting.DROP_EXCS]
            if dropped:
                findings.extend(flow.check_handler(
                    node, f"`except {'/'.join(dropped)}` handler"))
    # surface 2: every handler in the exactly-once send/retry functions
    for rel, funcs in (send_targets if send_targets is not None
                       else ambiguous_paths.TARGETS).items():
        ctx = project.file(rel)
        if ctx is None:
            continue   # ambiguous-paths already reports the miss
        flow = _Flow(ctx)
        for fname, handler in ambiguous_paths._function_handlers(
                ctx.tree, funcs):
            findings.extend(flow.check_handler(
                handler, f"except in {fname}()"))
    # surface 3: per-ring counter drains must fold across all rings
    drains = ring_drains if ring_drains is not None else RING_DRAINS
    for ctx in project.files(*(ring_targets if ring_targets is not None
                               else RING_TARGETS)):
        findings.extend(_ring_fold_findings(ctx, drains))
    return findings
