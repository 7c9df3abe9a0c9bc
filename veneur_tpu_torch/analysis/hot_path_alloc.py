"""vtlint pass: the per-batch pump/emit hot path stays allocation-free.

The zero-copy ingest contract: once the pipeline is warm, moving a
batch from the wire to the card performs NO per-batch Python-side
allocation — staged lanes land in pre-allocated double-buffered pinned
host buffers and every array the step touches is a view or a reused
buffer. Flagged in the hot functions: `.copy()` / `.clone()`,
`np.empty` / `np.concatenate` / `np.stack`, and the per-batch torch
allocations `torch.empty` / `torch.cat` / `torch.concatenate` /
`torch.stack` (alias-aware: `import torch as t; t.cat(...)` is caught
too). `np.zeros` is allowed (the packed-layout contract requires
zero-initialized buffers at allocation time). The pinned double-buffered
copy to the card (`_PackBuffer.to`, a non-blocking `.to(device)` out of
the reused pinned buffer) counts as reuse, not as an allocation.
"""

from __future__ import annotations

import ast
from typing import Dict, List

from veneur_tpu_torch.analysis.core import Finding, Project

NAME = "hot-path-alloc"
DOC = ("per-batch hot functions stay allocation-free (no .copy()/"
       ".clone()/np.empty/np.concatenate/np.stack/torch.empty/torch.cat/"
       "torch.stack)")

# {file: functions that run once per batch (or per datagram, per query
# batch, per ring write) when warm}
HOT_FUNCS: Dict[str, List[str]] = {
    "veneur_tpu_torch/server/native_aggregator.py": [
        "_emit_native", "feed", "pump", "_split_shards"],
    "veneur_tpu_torch/aggregation/step.py": ["pack_batch"],
    "veneur_tpu_torch/server/aggregator.py": ["_on_batch"],
    "veneur_tpu_torch/server/sharded_aggregator.py": [
        "_dispatch_row", "_on_shard_batch", "_emit_all"],
    "veneur_tpu_torch/collective/tier.py": [
        "_dispatch_row", "_dispatch_routed", "_on_stage_batch"],
    "veneur_tpu_torch/query/engine.py": ["_launch", "_launch_on_pipeline"],
    "veneur_tpu_torch/history/writer.py": [
        "begin_flush", "commit_flush", "_roll"],
}

# constructors that allocate a fresh array per call
_NP_ALLOCS = ("empty", "concatenate", "stack")
_TORCH_ALLOCS = ("empty", "cat", "concatenate", "stack")


def _violations_in(ctx, fn: ast.AST) -> List[Finding]:
    problems = []
    for node in ast.walk(fn):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)):
            continue
        attr = node.func.attr
        resolved = ctx.resolve(node.func)
        if attr in ("copy", "clone"):
            problems.append(Finding(
                NAME, ctx.rel, node.lineno,
                f"`.{attr}()` in hot-path function {fn.name}() — use "
                "the pre-allocated packed buffer"))
        elif attr in _NP_ALLOCS and resolved == f"numpy.{attr}":
            problems.append(Finding(
                NAME, ctx.rel, node.lineno,
                f"`np.{attr}` in hot-path function {fn.name}() — "
                "per-batch allocation; move it to an _alloc_* init "
                "helper"))
        elif attr in _TORCH_ALLOCS and resolved == f"torch.{attr}":
            problems.append(Finding(
                NAME, ctx.rel, node.lineno,
                f"`torch.{attr}` in hot-path function {fn.name}() — "
                "per-batch allocation; stage into a reused buffer"))
    return problems


def run(project: Project, hot_funcs: Dict[str, List[str]] = None
        ) -> List[Finding]:
    findings: List[Finding] = []
    for rel, funcs in (hot_funcs or HOT_FUNCS).items():
        ctx = project.file(rel)
        if ctx is None:
            findings.append(Finding(
                NAME, rel, 0, "file missing — update HOT_FUNCS"))
            continue
        seen = set()
        for node in ast.walk(ctx.tree):
            if (isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and node.name in funcs):
                seen.add(node.name)
                findings.extend(_violations_in(ctx, node))
        for name in funcs:
            if name not in seen:
                findings.append(Finding(
                    NAME, rel, 0,
                    f"hot-path function {name}() not found — renamed? "
                    "update HOT_FUNCS in veneur_tpu_torch/analysis/"
                    "hot_path_alloc.py"))
    return findings
