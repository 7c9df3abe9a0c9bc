"""vtlint pass: wall-time deltas around CUDA launches must sync.

CUDA launches are async: `time.perf_counter_ns()` deltas taken around a
bare step or kernel call measure the host-side ENQUEUE cost
(microseconds), not the device work — the real cost surfaces later as a
mystery stall in whoever syncs first.

The rule: inside the warm launch files, a `t = perf_counter_ns()` /
`... perf_counter_ns() - t` pair with a launch between the two
timestamps must also have a sync between them — OR store the delta
under a name containing `dispatch`, which declares the enqueue-only
meaning explicitly (the `dispatch_dt` convention the aggregators use).

- **Launches**: the kernel wrappers (`fused_ingest`, `quantiles_rows`,
  `merge_windows_packed`), the step and flush programs that call them
  (`packed_step_core`, `sharded_ingest_packed`, `routed_ingest`, the
  `flush_live_*` / `merged_flush_live` / `range_in_packed` programs),
  and any other device-tainted call (torch_hot_path's taint walk:
  `state` roots, `torch.*` results, assignment growth).
- **Syncs**: `torch.cuda.synchronize()`, a CUDA event's `synchronize()`
  or `elapsed_time()`, observability/runtime.py `sync_and_time`, or a
  host copy of a device value (`.cpu()` / `.item()` / `.tolist()` /
  `.numpy()`).

A measurement this pass cannot see through (a callee that copies its
result to the host, which IS a sync) carries a one-line reasoned
suppression.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from veneur_tpu_torch.analysis.core import (FileContext, Finding,
                                            Project)
from veneur_tpu_torch.analysis.torch_hot_path import (KERNEL_WRAPPERS,
                                                      _is_tainted)

NAME = "timer-sync"
DOC = ("perf_counter_ns deltas spanning a CUDA launch either sync "
       "(synchronize / elapsed_time / sync_and_time / a host copy) or "
       "are named dispatch_*")

# the warm launch files: everywhere a perf_counter pair can wrap a step
# or kernel call. server.py's flush phases are out of scope — its
# compute_flush callees copy to the host (an implicit sync) and the
# phases deliberately measure mixed host+device wall time.
FILES = [
    "veneur_tpu_torch/server/native_aggregator.py",
    "veneur_tpu_torch/server/aggregator.py",
    "veneur_tpu_torch/server/sharded_aggregator.py",
    "veneur_tpu_torch/collective/tier.py",
    "veneur_tpu_torch/query/engine.py",
    "veneur_tpu_torch/watch/engine.py",
    "veneur_tpu_torch/history/writer.py",
]

# the step and flush programs: each enqueues kernels and returns at once
LAUNCHES = KERNEL_WRAPPERS + (
    "packed_step_core", "sharded_ingest_packed", "routed_ingest",
    "flush_live_in_packed", "flush_live_hist_packed", "merged_flush_live",
    "range_in_packed")

_SYNC_LEAVES = ("synchronize", "elapsed_time", "sync_and_time")
_HOST_COPIES = ("cpu", "item", "tolist", "numpy")


def _is_pcns(node: ast.AST, ctx: FileContext) -> bool:
    """Is this expression a bare time.perf_counter_ns() call?"""
    if not isinstance(node, ast.Call):
        return False
    resolved = ctx.resolve(node.func) or ""
    return resolved.rsplit(".", 1)[-1] == "perf_counter_ns"


def _target_name(node: ast.AST,
                 parents: Dict[ast.AST, ast.AST],
                 ctx: FileContext) -> Optional[str]:
    """The name the enclosing Assign/AugAssign stores into, or None
    when the delta feeds straight into a call (observe(...))."""
    cur = parents.get(node)
    while cur is not None:
        if isinstance(cur, ast.AugAssign):
            t = cur.target
            return ctx.dotted(t) if isinstance(t, ast.Attribute) \
                else getattr(t, "id", None)
        if isinstance(cur, ast.Assign):
            for t in cur.targets:
                if isinstance(t, ast.Name):
                    return t.id
                if isinstance(t, ast.Attribute):
                    return ctx.dotted(t)
            return None
        cur = parents.get(cur)
    return None


def _check_fn(ctx: FileContext, fn) -> List[Finding]:
    tainted: Set[str] = set()
    for arg in fn.args.args:
        if arg.arg == "state":
            tainted.add("state")
    parents: Dict[ast.AST, ast.AST] = {}
    for p in ast.walk(fn):
        for c in ast.iter_child_nodes(p):
            parents[c] = p

    t0s: Dict[str, int] = {}
    device_calls: List[int] = []
    syncs: List[int] = []
    deltas: List[Tuple[int, str, Optional[str]]] = []

    for node in ast.walk(fn):
        if isinstance(node, ast.Assign):
            if _is_pcns(node.value, ctx):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        t0s[t.id] = node.lineno
            elif _is_tainted(node.value, ctx, tainted):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        tainted.add(t.id)
        elif isinstance(node, ast.Call):
            fname = node.func
            resolved = ctx.resolve(fname) or ""
            leaf = resolved.rsplit(".", 1)[-1]
            if leaf in _SYNC_LEAVES or (
                    isinstance(fname, ast.Attribute)
                    and (fname.attr in _SYNC_LEAVES
                         or (fname.attr in _HOST_COPIES
                             and _is_tainted(fname.value, ctx,
                                             tainted)))):
                syncs.append(node.lineno)
            elif not _is_pcns(node, ctx) and (
                    leaf in LAUNCHES
                    or _is_tainted(node, ctx, tainted)):
                device_calls.append(node.lineno)
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Sub) \
                and _is_pcns(node.left, ctx) \
                and isinstance(node.right, ast.Name):
            deltas.append((node.lineno, node.right.id,
                           _target_name(node, parents, ctx)))

    findings: List[Finding] = []
    for lineno, t0_name, target in deltas:
        start = t0s.get(t0_name)
        if start is None or lineno <= start:
            continue
        if target is not None and "dispatch" in target:
            continue  # declared enqueue-only measurement
        spanned = [l for l in device_calls if start < l < lineno]
        if not spanned:
            continue
        if any(start < l < lineno for l in syncs):
            continue
        findings.append(Finding(
            NAME, ctx.rel, lineno,
            f"perf_counter_ns delta in {fn.name}() spans a CUDA launch "
            f"(line {spanned[0]}) with no synchronize/elapsed_time/"
            "sync_and_time/host copy before the second timestamp — "
            "this measures async enqueue cost, not device work; sync "
            "inside the range, or store it as dispatch_* if enqueue "
            "time is the point"))
    return findings


def run(project: Project, files: List[str] = None) -> List[Finding]:
    findings: List[Finding] = []
    seen: Set[Tuple[str, int]] = set()
    for rel in (files if files is not None else FILES):
        ctx = project.file(rel)
        if ctx is None:
            findings.append(Finding(
                NAME, rel, 0, "file missing — update FILES in "
                "veneur_tpu_torch/analysis/timer_sync.py"))
            continue
        for node in ast.walk(ctx.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for f in _check_fn(ctx, node):
                    key = (f.file, f.line)
                    if key not in seen:  # nested defs are walked twice
                        seen.add(key)
                        findings.append(f)
    return findings
