"""vtlint pass: no hidden host syncs or in-place-state hazards in the
warm per-batch/per-flush functions.

The ingest arc's perf contract: once warm, a batch crosses the host ->
device boundary exactly once (the packed h2d copy) and nothing on the
pipeline thread ever waits on the card. CUDA launches are async, so
every read of a device value back to the host is a wait for every
queued launch before it. Three regression classes this pass catches
mechanically:

1. **Implicit host syncs on device values** — `.item()` / `.tolist()` /
   `.cpu()` / `.numpy()`, `float()` / `int()` / `bool()`, and
   `np.asarray()` / `np.array()` applied to a device value block the
   caller until the card drains its queue. Host-side values are fine; a
   cheap taint walk tells them apart: device roots are `self.state` / a
   `state` parameter, any `torch.*` call result, the kernel wrappers'
   results (`fused_ingest`, `quantiles_rows`, `merge_windows_packed`),
   and locals assigned from these. A tensor's metadata (`.shape`,
   `.dtype`, `.device`, `.numel()`, ...) lives on the host and is not a
   device value. `torch.cuda.synchronize()` is a full-device drain: in a
   hot function it is a finding. Anywhere else in the package, every
   host wait on the card — `torch.cuda.synchronize` called or handed
   over as a callable, a CUDA event's or stream's `.synchronize()` —
   needs a reasoned suppression, so each wait the package makes stays a
   reviewed decision.
2. **Python branching on device values** — an `if`/`while` whose test
   touches a device value is a host sync in disguise.
3. **In-place mutators that stop being in place** — K1's wrapper and
   the history ring's writers update their state argument's tensors in
   place (the port's counterpart of the JAX package's donating jits):
   rebinding the state argument or one of its leaves, `._replace()` on
   it, or a `.clone()` of it silently turns the in-place update into a
   copy per step (and the caller's state never sees the write).
"""

from __future__ import annotations

import ast
from typing import Dict, List, Set

from veneur_tpu_torch.analysis.core import (FileContext, Finding,
                                            Project)

NAME = "torch-hot-path"
DOC = ("warm per-batch/per-flush functions contain no implicit host "
       "syncs or device-value branching; in-place mutators stay in place")

# the hot-path-alloc set, extended with the per-flush warm paths that
# run on (and block) the pipeline thread
HOT_FUNCS: Dict[str, List[str]] = {
    "veneur_tpu_torch/server/native_aggregator.py": [
        "_emit_native", "feed", "pump", "_split_shards"],
    "veneur_tpu_torch/aggregation/step.py": ["pack_batch"],
    "veneur_tpu_torch/server/aggregator.py": [
        "_on_batch", "_flush_hll_imports", "swap", "query_snapshot"],
    "veneur_tpu_torch/server/sharded_aggregator.py": [
        "_dispatch_row", "_on_shard_batch", "_emit_all",
        "_flush_hll_imports", "swap", "query_snapshot"],
    "veneur_tpu_torch/collective/tier.py": [
        "_dispatch_row", "_dispatch_routed", "_on_stage_batch",
        "absorb_raw", "swap", "query_snapshot"],
    "veneur_tpu_torch/query/engine.py": ["_launch", "_launch_on_pipeline"],
    # history ring maintenance runs inside the flush's launch window on
    # the pipeline/flush thread: a hidden sync here stalls swap()
    "veneur_tpu_torch/history/writer.py": [
        "begin_flush", "commit_flush", "_roll", "record_frame"],
}

# functions that update their first argument's tensors in place: K1's
# wrapper and the history ring's writers
INPLACE_MUTATORS: Dict[str, List[str]] = {
    "veneur_tpu_torch/ops/cuda_ingest.py": ["fused_ingest"],
    "veneur_tpu_torch/history/device.py": [
        "write_window_core", "wipe_rows", "roll_tiers"],
}

# the kernel wrappers: their results live on the card
KERNEL_WRAPPERS = ("fused_ingest", "quantiles_rows", "merge_windows_packed")

# files scanned for host waits on the card outside the hot functions
SYNC_SCAN = ["veneur_tpu_torch"]

_HOST_CONVERTERS = ("float", "int", "bool")
_NP_CONVERTERS = ("numpy.asarray", "numpy.array")
_SYNC_METHODS = ("item", "tolist", "cpu", "numpy")
# a tensor's metadata is host state: reading it never waits on the card
_HOST_ATTRS = ("shape", "dtype", "device", "ndim", "is_cuda", "layout")
_HOST_METHODS = ("size", "dim", "numel", "nelement", "element_size",
                 "data_ptr", "is_contiguous", "stride", "get_device")
# torch calls whose result is a host tensor sharing host memory
_HOST_TORCH = ("torch.from_numpy",)


def _is_tainted(node: ast.AST, ctx: FileContext,
                tainted: Set[str]) -> bool:
    """Does this expression derive from a device value?"""
    if isinstance(node, ast.Name):
        return node.id in tainted
    if isinstance(node, ast.Attribute):
        if node.attr in _HOST_ATTRS:
            return False
        # self.state (and anything hanging off it) is the device root
        if ctx.dotted(node) in ("self.state", "state"):
            return True
        return _is_tainted(node.value, ctx, tainted)
    if isinstance(node, ast.Subscript):
        return _is_tainted(node.value, ctx, tainted)
    if isinstance(node, ast.Call):
        fn = node.func
        if isinstance(fn, ast.Attribute) and fn.attr in _HOST_METHODS:
            return False
        resolved = ctx.resolve(fn) or ""
        if resolved in _HOST_TORCH:
            return False
        if resolved.startswith("torch.") \
                or resolved.rsplit(".", 1)[-1] in KERNEL_WRAPPERS:
            return True
        # method call on a tainted object stays tainted
        # (state.hll.index_put_(...), self._ingest(self.state, ...))
        if isinstance(fn, ast.Attribute) \
                and _is_tainted(fn.value, ctx, tainted):
            return True
        return any(_is_tainted(a, ctx, tainted) for a in node.args)
    if isinstance(node, ast.BinOp):
        return (_is_tainted(node.left, ctx, tainted)
                or _is_tainted(node.right, ctx, tainted))
    if isinstance(node, ast.Compare):
        return (_is_tainted(node.left, ctx, tainted)
                or any(_is_tainted(c, ctx, tainted)
                       for c in node.comparators))
    if isinstance(node, ast.BoolOp):
        return any(_is_tainted(v, ctx, tainted) for v in node.values)
    if isinstance(node, ast.UnaryOp):
        return _is_tainted(node.operand, ctx, tainted)
    if isinstance(node, (ast.Tuple, ast.List)):
        return any(_is_tainted(e, ctx, tainted) for e in node.elts)
    return False


def _assigned_names(target: ast.AST):
    """Plain names an assignment target binds (tuples unpacked)."""
    if isinstance(target, ast.Name):
        yield target.id
    elif isinstance(target, (ast.Tuple, ast.List)):
        for e in target.elts:
            yield from _assigned_names(e)


def _is_cuda_sync(node: ast.Call, ctx: FileContext) -> bool:
    return (ctx.resolve(node.func) or "") == "torch.cuda.synchronize"


def _check_hot_fn(ctx: FileContext, fn) -> List[Finding]:
    findings: List[Finding] = []
    tainted: Set[str] = set()
    # a parameter literally named `state` is device state by convention
    for arg in fn.args.args:
        if arg.arg == "state":
            tainted.add("state")

    for node in ast.walk(fn):
        # grow the taint set: locals assigned from device expressions
        if isinstance(node, ast.Assign) \
                and _is_tainted(node.value, ctx, tainted):
            for t in node.targets:
                tainted.update(_assigned_names(t))
        elif isinstance(node, (ast.If, ast.While)) \
                and _is_tainted(node.test, ctx, tainted):
            findings.append(Finding(
                NAME, ctx.rel, node.lineno,
                f"Python branch on a device value in hot function "
                f"{fn.name}() — forces a blocking device->host sync per "
                "batch; compute the predicate on host state or on the "
                "card"))
        elif isinstance(node, ast.Call):
            fname = node.func
            resolved = ctx.resolve(fname)
            if _is_cuda_sync(node, ctx):
                findings.append(Finding(
                    NAME, ctx.rel, node.lineno,
                    f"`torch.cuda.synchronize()` in hot function "
                    f"{fn.name}() — drains the whole card on the "
                    "pipeline thread"))
            elif resolved in _HOST_CONVERTERS and len(node.args) >= 1 \
                    and _is_tainted(node.args[0], ctx, tainted):
                findings.append(Finding(
                    NAME, ctx.rel, node.lineno,
                    f"`{resolved}()` on a device value in hot function "
                    f"{fn.name}() — implicit blocking transfer"))
            elif resolved in _NP_CONVERTERS and node.args \
                    and _is_tainted(node.args[0], ctx, tainted):
                findings.append(Finding(
                    NAME, ctx.rel, node.lineno,
                    f"`{resolved.replace('numpy', 'np')}` on a device "
                    f"value in hot function {fn.name}() — full "
                    "device->host materialization blocks on every "
                    "queued launch; keep the merge on the card"))
            elif isinstance(fname, ast.Attribute) \
                    and fname.attr in _SYNC_METHODS \
                    and _is_tainted(fname.value, ctx, tainted):
                findings.append(Finding(
                    NAME, ctx.rel, node.lineno,
                    f"`.{fname.attr}()` on a device value in hot "
                    f"function {fn.name}() — implicit blocking "
                    "transfer"))
    return findings


def _state_root(node: ast.AST, names: Set[str]) -> bool:
    """Does this Name/Attribute/Subscript chain hang off a state name?"""
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        node = node.value
    return isinstance(node, ast.Name) and node.id in names


def _check_mutator(ctx: FileContext, fn) -> List[Finding]:
    """An in-place mutator keeps its state argument's tensors: no
    rebinding of the argument or of a leaf, no `_replace`, no clone."""
    params = list(fn.args.posonlyargs) + list(fn.args.args)
    if not params:
        return [Finding(NAME, ctx.rel, fn.lineno,
                        f"in-place mutator {fn.name}() takes no state "
                        "argument")]
    root = params[0].arg
    names = {root}
    findings: List[Finding] = []
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign):
            # `h = hist` is a second name for the same state, not a copy
            if isinstance(node.value, ast.Name) \
                    and node.value.id in names:
                for t in node.targets:
                    names.update(_assigned_names(t))
                continue
    for node in ast.walk(fn):
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                if isinstance(t, ast.Name) and t.id == root \
                        and not isinstance(node, ast.AugAssign):
                    findings.append(Finding(
                        NAME, ctx.rel, node.lineno,
                        f"in-place mutator {fn.name}() rebinds its state "
                        f"argument `{root}` — the caller's state never "
                        "sees the update"))
                elif isinstance(t, ast.Attribute) \
                        and isinstance(t.value, ast.Name) \
                        and t.value.id in names:
                    findings.append(Finding(
                        NAME, ctx.rel, node.lineno,
                        f"in-place mutator {fn.name}() rebinds state leaf "
                        f"`{t.attr}` — write into the tensor "
                        "(`leaf[idx] = v`, `leaf.copy_(v)`), do not "
                        "replace it"))
        elif isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute):
            if node.func.attr in ("clone", "_replace") \
                    and _state_root(node.func.value, names):
                findings.append(Finding(
                    NAME, ctx.rel, node.lineno,
                    f"`.{node.func.attr}()` of the state in in-place "
                    f"mutator {fn.name}() — a copy per call where the "
                    "contract is an in-place update"))
        elif isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Name) \
                and node.func.id == "setattr" and node.args \
                and _state_root(node.args[0], names):
            findings.append(Finding(
                NAME, ctx.rel, node.lineno,
                f"setattr on the state in in-place mutator {fn.name}() "
                "— rebinds a leaf instead of writing into it"))
    return findings


def _check_mutators(project: Project,
                    mutators: Dict[str, List[str]]) -> List[Finding]:
    findings: List[Finding] = []
    for rel, names in mutators.items():
        ctx = project.file(rel)
        if ctx is None:
            findings.append(Finding(
                NAME, rel, 0, "file missing — update INPLACE_MUTATORS"))
            continue
        seen = set()
        for node in ast.walk(ctx.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and node.name in names:
                seen.add(node.name)
                findings.extend(_check_mutator(ctx, node))
        for name in names:
            if name not in seen:
                findings.append(Finding(
                    NAME, rel, 0,
                    f"in-place mutator {name}() not found — renamed? "
                    "update INPLACE_MUTATORS in veneur_tpu_torch/"
                    "analysis/torch_hot_path.py"))
    return findings


def _check_stray_syncs(ctx: FileContext, skip: Set[int]) -> List[Finding]:
    """Every host wait on the card: `torch.cuda.synchronize` (called or
    passed as a callable, e.g. a Thread target) and `<event or
    stream>.synchronize()`."""
    findings = []
    for node in ast.walk(ctx.tree):
        if getattr(node, "lineno", None) in skip:
            continue
        if isinstance(node, ast.Attribute) \
                and ctx.resolve(node) == "torch.cuda.synchronize":
            findings.append(Finding(
                NAME, ctx.rel, node.lineno,
                "torch.cuda.synchronize in production code — a "
                "deliberate full-device drain; if intended, suppress "
                "with a reason"))
        elif isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr == "synchronize" \
                and ctx.resolve(node.func) != "torch.cuda.synchronize":
            findings.append(Finding(
                NAME, ctx.rel, node.lineno,
                "`.synchronize()` of a CUDA event or stream — the host "
                "waits on the card here; if intended, suppress with a "
                "reason"))
    return findings


def run(project: Project, hot_funcs: Dict[str, List[str]] = None,
        inplace_mutators: Dict[str, List[str]] = None,
        sync_scan: List[str] = None) -> List[Finding]:
    findings: List[Finding] = []
    hot_sync_lines: Dict[str, Set[int]] = {}
    for rel, funcs in (hot_funcs if hot_funcs is not None
                       else HOT_FUNCS).items():
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
                found = _check_hot_fn(ctx, node)
                hot_sync_lines.setdefault(rel, set()).update(
                    f.line for f in found)
                findings.extend(found)
        for name in funcs:
            if name not in seen:
                findings.append(Finding(
                    NAME, rel, 0,
                    f"hot function {name}() not found — renamed? "
                    "update HOT_FUNCS in veneur_tpu_torch/analysis/"
                    "torch_hot_path.py"))
    findings.extend(_check_mutators(
        project, inplace_mutators if inplace_mutators is not None
        else INPLACE_MUTATORS))
    for ctx in project.files(*(sync_scan if sync_scan is not None
                               else SYNC_SCAN)):
        if ctx.rel.startswith("veneur_tpu_torch/analysis/"):
            continue   # the lint layer names the call in its docs
        findings.extend(_check_stray_syncs(
            ctx, hot_sync_lines.get(ctx.rel, set())))
    return findings
