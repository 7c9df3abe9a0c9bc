"""Faults planted under the timed path, each one a later change could
bring: the comparison must come out not correct under every one. The
CPU tests (`tests/test_bench_faults.py`) plant each in a whole run at a
test size; `readings.py` plants them on the card at the cell's own size
to read the numbers a limit is set below. The benchmark's own runs
plant none.

    with planted("unsorted_compaction"):
        harness.run_cell(...)
"""

from __future__ import annotations

import contextlib

import numpy as np


def _unchanged_step():
    """A step that returns its state unchanged."""
    from veneur_tpu_torch.aggregation import step
    return step, "ingest_core", lambda state, batch, *, spec: state


def _half_batch():
    """Half of every lane of a batch left out (dropped rows)."""
    from veneur_tpu_torch.aggregation import step
    orig = step.unpack_batch

    def half(flat, sizes):
        b = orig(flat, sizes)
        lanes = {}
        for lane in ("counter_slot", "gauge_slot", "histo_slot"):
            s = getattr(b, lane)
            if s is not None and s.numel() > 1:
                s = s.clone()
                s[s.numel() // 2:] = -1          # a dropped row
                lanes[lane] = s
        return b._replace(**lanes)
    return step, "unpack_batch", half


def _altered_answer():
    """One answer off by one where compute_flush makes it: the first
    application counter's sum, or where there is none the first
    application timer's count."""
    from veneur_tpu_torch.server.aggregator import Aggregator
    orig = Aggregator.compute_flush

    def altered(self, state, table, *a, **kw):
        out = orig(self, state, table, *a, **kw)
        res = dict(out[0])
        for kind, key in (("counter", "counter"),
                          ("histogram", "histo_count")):
            rows = [i for i, (_s, m) in enumerate(table.get_meta(kind))
                    if not m.name.startswith(("veneur.", "ssf."))]
            if rows:
                col = np.array(res[key], copy=True)
                col[rows[0]] += 1.0
                res[key] = col
                break
        return (res,) + tuple(out[1:])
    return Aggregator, "compute_flush", altered


def _unsorted_compaction():
    """Compaction that takes each row's cells as already sorted by mean
    (its per-row sort left out): every weight, min and max kept, but the
    raw cells a step appends out of order are lumped with whatever lies
    beside them."""
    from veneur_tpu_torch.aggregation import step
    td = step.td
    orig = td.compress_rows

    def unsorted(mean, weight, **kw):
        sort = td._argsort_stable
        td._argsort_stable = lambda x, dim: _columns(x)
        try:
            return orig(mean, weight, **kw)
        finally:
            td._argsort_stable = sort
    return td, "compress_rows", unsorted


def _columns(x):
    """Each row's columns in their own order."""
    import torch
    return torch.arange(x.shape[-1], device=x.device).expand(x.shape)


FAULTS = {
    "unchanged_step": _unchanged_step,
    "half_batch": _half_batch,
    "altered_answer": _altered_answer,
    "unsorted_compaction": _unsorted_compaction,
}


@contextlib.contextmanager
def planted(name: str):
    obj, attr, repl = FAULTS[name]()
    orig = getattr(obj, attr)
    setattr(obj, attr, repl)
    try:
        yield
    finally:
        setattr(obj, attr, orig)
