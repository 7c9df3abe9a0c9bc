"""vtlint for the PyTorch/CUDA port: the package's guard on its own
invariants.

One `Project` (one AST parse per file) feeds an ordered registry of
passes over ``veneur_tpu_torch/``. Run from the command line::

    python -m veneur_tpu_torch.analysis --all            # every pass
    python -m veneur_tpu_torch.analysis lock-discipline  # one pass
    python -m veneur_tpu_torch.analysis --all --json     # machine-readable
    python -m veneur_tpu_torch.analysis --list           # pass inventory

Suppress a finding in place with a mandatory reason::

    x = dev.cpu()  # vtlint: disable=torch-hot-path -- flush boundary
"""

from __future__ import annotations

import json
import time
from typing import Dict, List

from veneur_tpu_torch.analysis import (
    accounting_flow, ambiguous_paths, bare_except, drop_accounting,
    hot_path_alloc, lock_discipline, metric_names, reshard_quiesce,
    snapshot_schema, table_grow_quiesce, timer_sync, torch_hot_path)
from veneur_tpu_torch.analysis.core import (
    REPO, Finding, Project, filter_suppressed, reasonless_suppressions)

JSON_SCHEMA_VERSION = 1

# ordered registry: name -> module (must expose NAME, DOC, run(project))
PASSES = {
    m.NAME: m for m in (
        hot_path_alloc,
        drop_accounting,
        ambiguous_paths,
        bare_except,
        metric_names,
        snapshot_schema,
        torch_hot_path,
        lock_discipline,
        accounting_flow,
        timer_sync,
        reshard_quiesce,
        table_grow_quiesce,
    )
}


def run_passes(project: Project, names: List[str]) -> Dict:
    """Run the named passes over one shared Project; returns the full
    result dict (the --json schema, minus nothing)."""
    t_all = time.monotonic()
    pass_rows = []
    findings: List[Finding] = []
    for name in names:
        mod = PASSES[name]
        t0 = time.monotonic()
        found = filter_suppressed(project, mod.run(project))
        pass_rows.append({
            "name": name,
            "doc": mod.DOC,
            "findings": len(found),
            "runtime_s": round(time.monotonic() - t0, 4),
        })
        findings.extend(found)
    findings.extend(reasonless_suppressions(project))
    return {
        "version": JSON_SCHEMA_VERSION,
        "root": str(project.root),
        "passes": pass_rows,
        "findings": [
            {"pass": f.pass_name, "file": f.file, "line": f.line,
             "message": f.message}
            for f in findings],
        "files_parsed": project.parse_count,
        "parse_count": project.parse_count,
        "runtime_s": round(time.monotonic() - t_all, 4),
        "ok": not findings,
    }


def run_cli(pass_names: List[str], root=None, as_json: bool = False) -> int:
    """Entry point of __main__: run the passes, print findings (or the
    JSON result), return the process exit code."""
    project = Project(root or REPO)
    result = run_passes(project, pass_names)
    if as_json:
        print(json.dumps(result, sort_keys=True))
    else:
        for f in result["findings"]:
            loc = f["file"] or "<project>"
            if f["line"]:
                loc += f":{f['line']}"
            print(f"{loc}: [{f['pass']}] {f['message']}")
        n = len(result["findings"])
        names = ", ".join(pass_names)
        if n:
            print(f"vtlint: {n} finding(s) from {names}")
        else:
            print(f"vtlint: OK ({names}; "
                  f"{result['files_parsed']} files, "
                  f"{result['runtime_s']}s)")
    return 1 if result["findings"] else 0
