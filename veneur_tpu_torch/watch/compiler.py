"""Compile ALL active watches into one padded device evaluation.

The compiler is why 100k standing monitors cost one flush-program launch
per interval instead of 100k queries: every watch's selector is resolved
against the interval's sorted NameIndex (the query tier's bisect index
over the detached key table's meta prefix), the matched rows are DEDUPED
across watches into per-kind slot gathers, the union of quantile
requests becomes one quantile vector, and the whole is packed with
`pack_query_inputs` into the input layout of the flush program
(`flush_live_in_packed`), so evaluation runs the program the flush and
query tiers run, with its gather sizes padded to the same buckets.

Re-resolution cost: swap() installs a FRESH KeyTable every interval,
so selector→row resolution is interval-scoped by construction — the
plan cache keys on (table identity, per-kind meta counts, watch-set
generation) and a new interval or a register/delete naturally misses.
That re-resolve (bisect per watch) runs on the WATCH ENGINE thread
against a detached table, never on the ingest pipeline or the flush
worker.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from veneur_tpu_torch.query.nameindex import NameIndex
from veneur_tpu_torch.query.snapshot import COUNT_TABLES

# per-watch resolution cap, the query tier's bound: a wildcard that
# explodes matches is truncated (worst-of over the first N) instead of
# letting one watch blow the padded gather past a flush block
MAX_MATCHES = 1024

# watch kind -> candidate count tables (threshold/delta restricted
# further by metric_kinds at resolve time)
_KIND_TABLES = {
    "threshold": ("counter", "gauge", "status"),
    "delta": ("counter", "gauge", "status"),
    "quantile": ("histo",),
    "cardinality": ("set",),
}
_SCALAR_TABLE = {"counter": "counter", "gauge": "gauge",
                 "status": "status"}


class WatchPlan:
    """One interval's packed evaluation: device inputs + the per-watch
    row map the engine walks to extract values from the unpacked flush
    result."""

    __slots__ = ("inputs", "n_q", "buckets", "qcol", "rows",
                 "truncated", "n_rows")

    def __init__(self, inputs, n_q: int, buckets: tuple, qcol: dict,
                 rows: Dict[int, List[Tuple[str, int]]],
                 truncated: set, n_rows: int) -> None:
        self.inputs = inputs
        self.n_q = n_q
        self.buckets = buckets
        self.qcol = qcol
        self.rows = rows            # wid -> [(tname, result row), ...]
        self.truncated = truncated  # wids whose selector hit MAX_MATCHES
        self.n_rows = n_rows        # total deduped gather rows


def _tables_for(watch) -> List[str]:
    if watch.kind in ("threshold", "delta") and watch.metric_kinds:
        return [_SCALAR_TABLE[k] for k in watch.metric_kinds]
    return list(_KIND_TABLES[watch.kind])


def resolve_watch(index: NameIndex, watch) -> Tuple[list, bool]:
    """Selector -> [(tname, pos, slot, meta)] via the sorted index,
    with the query tier's kind/tag filtering. Returns (matches,
    truncated)."""
    out = []
    for tname in _tables_for(watch):
        if watch.mode == "name":
            ent = index.exact(tname, watch.arg)
        elif watch.mode == "prefix":
            ent = index.prefix(tname, watch.arg)
        else:
            ent = index.match(tname, watch.arg)
        for pos, slot, meta in ent:
            # histo rows carry both histogram and timer metas; honor a
            # quantile watch's metric_kinds restriction by actual kind
            if (tname == "histo" and watch.metric_kinds
                    and meta.kind not in watch.metric_kinds):
                continue
            if watch.tags is not None and tuple(meta.tags) != watch.tags:
                continue
            out.append((tname, pos, slot, meta))
    truncated = len(out) > MAX_MATCHES
    if truncated:
        out = out[:MAX_MATCHES]
    return out, truncated


def compile_watches(spec, index: NameIndex, watches: list
                    ) -> Optional[WatchPlan]:
    """Pack every active watch into ONE evaluation layout. Returns None
    when no selector matched anything (the engine still steps each
    watch with value=None so NO_DATA tracking advances)."""
    need: Dict[str, List[int]] = {t: [] for t in COUNT_TABLES}
    rowof: Dict[Tuple[str, int], int] = {}
    rows: Dict[int, List[Tuple[str, int]]] = {}
    truncated: set = set()
    union_qs: set = set()
    for w in watches:
        ms, trunc = resolve_watch(index, w)
        if trunc:
            truncated.add(w.wid)
        lst = []
        for tname, pos, slot, _meta in ms:
            key = (tname, pos)
            r = rowof.get(key)
            if r is None:
                r = len(need[tname])
                rowof[key] = r
                need[tname].append(slot)
            lst.append((tname, r))
        rows[w.wid] = lst
        if w.kind == "quantile" and lst:
            union_qs.add(float(w.quantile))
    n_rows = sum(len(need[t]) for t in COUNT_TABLES)
    if n_rows == 0:
        return None
    from veneur_tpu_torch.aggregation.step import pack_query_inputs
    inputs, n_q, buckets, qcol = pack_query_inputs(
        spec, [need[t] for t in COUNT_TABLES], union_qs)
    return WatchPlan(inputs, n_q, buckets, qcol, rows, truncated, n_rows)
