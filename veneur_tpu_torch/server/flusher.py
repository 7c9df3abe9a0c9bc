"""Turn device flush arrays + host slot metadata into InterMetrics.

This is the reference's generateInterMetrics (flusher.go:225-298) plus the
per-sampler Flush methods (samplers/samplers.go:147/230/319/392/511-675),
driven by the scope rules of flusher.go:61-77:

- local instance (forwarding configured): mixed histograms/timers emit
  aggregates only (percentiles=nil); global-scoped metrics and sets emit
  nothing locally (their sketch state is forwarded); local-only
  histograms/timers flush fully, with percentiles.
- global / standalone instance: everything flushes; global-scoped
  histograms emit aggregates from the digest (the reference's global=true
  Flush path), mixed ones from their local scalars.

One deliberate deviation, documented: the reference keeps separate sampler
objects for direct vs imported mixed-scope histograms' local scalars; our
device table has one (min, max, count, sum) row per key, so on a standalone
global instance that both ingests a key directly and imports it, aggregates
include the imported mass (strictly more accurate; percentiles identical).
"""

from __future__ import annotations

import dataclasses
import math
import threading
from typing import Dict, List, Optional

import numpy as np

from veneur_tpu_torch.aggregation.host import (
    KeyTable, SCOPE_GLOBAL, SCOPE_LOCAL)
from veneur_tpu_torch.samplers.intermetric import (
    COUNTER, GAUGE, SINK_ONLY_TAG_PREFIX, STATUS, InterMetric, route_info)

# aggregate name -> (flush-dict key, metric type)
AGGREGATE_FIELDS = {
    "min": ("histo_min", GAUGE),
    "max": ("histo_max", GAUGE),
    "median": ("histo_median", GAUGE),
    "avg": ("histo_avg", GAUGE),
    "count": ("histo_count", COUNTER),
    "sum": ("histo_sum", GAUGE),
    "hmean": ("histo_hmean", GAUGE),
}


def percentile_name(p: float) -> str:
    """reference samplers.go:664: `%s.%dpercentile` with int(p*100)."""
    return f"{int(p * 100)}percentile"


def unique_timeseries(table: KeyTable, is_local: bool) -> int:
    """Count of unique timeseries this interval, per the reference's
    sampling rules (worker.go:300-341 SampleTimeseries): a global instance
    counts everything; a local one counts only what it will NOT forward
    (counters/gauges unless global-scoped; histos/sets/timers only when
    local-only; status always). Exact (slot allocation is per-key), where
    the reference uses an HLL estimate over digests."""
    n = 0
    for kind in ("counter", "gauge", "set", "histogram", "status"):
        for _slot, meta in table.get_meta(kind):
            if not is_local or meta.kind == "status":
                n += 1
            elif meta.kind in ("counter", "gauge"):
                n += meta.scope != SCOPE_GLOBAL
            else:  # histogram / timer / set
                n += meta.scope == SCOPE_LOCAL
    return n


def _prep(meta, hostname):
    """Per-KEY invariants (tag list copy, sink routing, hostname) computed
    once per key per interval: a 100k-name interval emits ~6 metrics per
    key and route_info scans were ~half of generation time. The routing
    test is ONE substring scan of the parser's precomputed joined-tags
    string (the common no-routing case never touches per-tag Python)."""
    jt = meta.joined_tags
    if jt is None:
        jt = ",".join(meta.tags)
    sinks = route_info(meta.tags) if SINK_ONLY_TAG_PREFIX in jt else None
    p = meta._emit_prep = (list(meta.tags), sinks,
                          meta.hostname or hostname)
    return p


@dataclasses.dataclass
class FrameSegment:
    """One homogeneous column group: every row shares the metric type and
    (for compound histo names) the suffix already baked into `names`.
    `metas` holds the originating SlotMeta per row BY REFERENCE — tag
    lists, routing, and hostname are derived lazily, so building a
    segment allocates no per-metric Python objects."""
    names: List[str]
    values: np.ndarray       # float64, len == len(names)
    mtype: str               # COUNTER / GAUGE / STATUS
    metas: List              # SlotMeta per row
    is_status: bool = False  # carry meta.message into InterMetric


@dataclasses.dataclass
class MetricFrame:
    """Columnar flush output — the 10M-key answer to InterMetric lists.

    Materializing one Python object per metric costs ~1.8s per 1.6M
    metrics (measured floor of dataclass construction); at the 10M-key
    north star that is ~20s of host time per interval. A frame carries
    (names, values, type) columns plus SlotMeta references and defers
    everything else, the same pre-sized streaming shape the reference
    uses in Go (flusher.go:169-298). Sinks that declare
    `accepts_frames = True` get the frame; `intermetrics()` materializes
    the exact object list for everything else (order is grouped by
    segment, not interleaved per key — sinks are order-independent)."""
    timestamp: int
    hostname: str
    segments: List[FrameSegment]
    # memoized intermetrics(): several materializing consumers (plugins,
    # object-only sinks via the base-class default) may share one frame —
    # each rebuilding ~per-metric objects would multiply the exact cost
    # the frame exists to avoid. Lock-guarded lazy init: the old "benign"
    # race let N concurrent sink threads each pay the full materialization
    # (and briefly hold N copies of a 10M-object list); now exactly one
    # builds and the rest share it.
    _materialized: object = dataclasses.field(
        default=None, repr=False, compare=False)
    _mat_lock: object = dataclasses.field(
        default_factory=threading.Lock, repr=False, compare=False)

    def __len__(self):
        return sum(len(s.names) for s in self.segments)

    def rows(self):
        """Yield prepared (name, value, mtype, message, tags, sinks,
        hostname) tuples — THE consumption surface for accepts_frames
        sinks, so per-key prep (tag copy, sink routing, hostname
        fallback) stays inside this module and every sink shares one
        loop instead of reaching into SlotMeta internals."""
        hostname = self.hostname
        for seg in self.segments:
            vals = seg.values.tolist()
            mtype = seg.mtype
            metas = seg.metas
            is_status = seg.is_status
            for i, name in enumerate(seg.names):
                m = metas[i]
                p = m._emit_prep or _prep(m, hostname)
                yield (name, vals[i], mtype,
                       m.message if is_status else "", p[0], p[1], p[2])

    def intermetrics(self) -> List[InterMetric]:
        # double-checked: the unlocked read is safe (attribute store is a
        # single bytecode under the GIL) and keeps the post-build hot path
        # lock-free
        if self._materialized is None:
            with self._mat_lock:
                if self._materialized is None:
                    ts = self.timestamp
                    self._materialized = [
                        InterMetric(name, ts, value, tags, mtype, message,
                                    host, sinks)
                        for name, value, mtype, message, tags, sinks, host
                        in self.rows()]
        return self._materialized


def _simple_segment(metas, vals, mtype, is_local, *, skip_scope=None,
                    keep_scope=None,
                    is_status=False) -> Optional[FrameSegment]:
    """Segment for a scalar kind. On a LOCAL tier, `skip_scope` drops
    that scope (forwarded, not flushed) while `keep_scope` keeps only
    that scope (the sets rule: everything else is forwarded). On a
    global/standalone tier both are ignored — everything flushes."""
    if not metas:
        return None
    n = len(metas)
    vals = np.asarray(vals, np.float64)[:n]
    if is_local and (skip_scope is not None or keep_scope is not None):
        if keep_scope is not None:
            keep = [i for i in range(n)
                    if metas[i][1].scope == keep_scope]
        else:
            keep = [i for i in range(n)
                    if metas[i][1].scope != skip_scope]
        if len(keep) != n:
            mlist = [metas[i][1] for i in keep]
            return FrameSegment([m.name for m in mlist], vals[keep],
                                mtype, mlist, is_status)
    mlist = [m for _s, m in metas]
    return FrameSegment([m.name for m in mlist], vals, mtype, mlist,
                        is_status)


def generate_frame(flush: Dict[str, np.ndarray], table: KeyTable,
                   *, percentiles: List[float], aggregates: List[str],
                   is_local: bool, timestamp: int,
                   hostname: str = "") -> MetricFrame:
    """Columnar twin of generate_intermetrics: identical emission rules
    (scope routing, imported_only suppression, non-finite min/max drops),
    vectorized filters, zero per-metric object construction."""
    segs: List[FrameSegment] = []

    def add(seg):
        if seg is not None and len(seg.names):
            segs.append(seg)

    add(_simple_segment(table.get_meta("counter"), flush["counter"],
                        COUNTER, is_local, skip_scope=SCOPE_GLOBAL))
    add(_simple_segment(table.get_meta("gauge"), flush["gauge"],
                        GAUGE, is_local, skip_scope=SCOPE_GLOBAL))
    add(_simple_segment(table.get_meta("status"), flush["status"],
                        STATUS, is_local, is_status=True))
    # sets have no local part: a local tier forwards the HLL and emits
    # only local-only sets (flusher.go:277-280)
    add(_simple_segment(table.get_meta("set"), flush["set_estimate"],
                        GAUGE, is_local, keep_scope=SCOPE_LOCAL))

    metas = table.get_meta("histogram")
    if metas:
        n = len(metas)
        hcount = np.asarray(flush["histo_count"])[:n]
        mask = hcount > 0
        scopes = imported = None
        if is_local or any(m.imported_only for _s, m in metas):
            scopes = np.fromiter((m.scope for _s, m in metas), np.int8, n)
            imported = np.fromiter((m.imported_only for _s, m in metas),
                                   np.bool_, n)
        if is_local:
            mask &= scopes != SCOPE_GLOBAL
        # aggregate eligibility: imported-only MIXED histos on a global
        # tier emit percentiles only (flusher.go:61-77)
        agg_mask = mask
        if imported is not None:
            agg_mask = mask & (~imported | ((scopes == SCOPE_GLOBAL)
                                            & (not is_local)))
        perc_mask = mask
        if is_local:
            perc_mask = mask & (scopes == SCOPE_LOCAL)

        asel = np.flatnonzero(agg_mask)
        if len(asel):
            base = [metas[i][1].name for i in asel]
            mlist = [metas[i][1] for i in asel]
            for a in dict.fromkeys(aggregates):
                if a not in AGGREGATE_FIELDS:
                    continue
                col = np.asarray(flush[AGGREGATE_FIELDS[a][0]],
                                 np.float64)[asel]
                suf = "." + a
                if a in ("min", "max"):
                    fin = np.isfinite(col)
                    if not fin.all():
                        keep = np.flatnonzero(fin)
                        add(FrameSegment(
                            [base[i] + suf for i in keep], col[keep],
                            AGGREGATE_FIELDS[a][1],
                            [mlist[i] for i in keep]))
                        continue
                add(FrameSegment([b + suf for b in base], col,
                                 AGGREGATE_FIELDS[a][1], mlist))
        if percentiles:
            psel = np.flatnonzero(perc_mask)
            if len(psel):
                base = [metas[i][1].name for i in psel]
                mlist = [metas[i][1] for i in psel]
                hq = np.asarray(flush["histo_quantiles"],
                                np.float64)[psel]
                for pi, p in enumerate(percentiles):
                    suf = "." + percentile_name(p)
                    add(FrameSegment([b + suf for b in base], hq[:, pi],
                                     GAUGE, mlist))
    return MetricFrame(timestamp, hostname, segs)


def generate_intermetrics(flush: Dict[str, np.ndarray], table: KeyTable,
                          *, percentiles: List[float], aggregates: List[str],
                          is_local: bool, timestamp: int,
                          hostname: str = "") -> List[InterMetric]:
    """The emit loops are deliberately flat and allocation-light: values
    cross the numpy boundary once per kind via .tolist() (per-element
    ndarray indexing + float() was ~2x the loop), InterMetric is a slots
    dataclass built with positional args, and scope filters test plain
    ints. A 1M-live-key interval labels in ~1s of host time (the
    reference pre-sizes and streams the same pass in Go,
    flusher.go:169-298)."""
    out: List[InterMetric] = []
    perc = list(percentiles)
    ts = timestamp
    app = out.append

    # flush arrays are COMPACT: row i pairs with get_meta(kind)[i]
    # (aggregator.compute_flush gathers live rows on device)
    metas = table.get_meta("counter")
    if metas:
        vals = np.asarray(flush["counter"]).tolist()
        for i, (_slot, m) in enumerate(metas):
            if is_local and m.scope == SCOPE_GLOBAL:
                continue  # forwarded, not flushed (flusher.go:274-287)
            p = m._emit_prep or _prep(m, hostname)
            app(InterMetric(m.name, ts, vals[i], p[0], COUNTER, "",
                            p[2], p[1]))

    metas = table.get_meta("gauge")
    if metas:
        vals = np.asarray(flush["gauge"]).tolist()
        for i, (_slot, m) in enumerate(metas):
            if is_local and m.scope == SCOPE_GLOBAL:
                continue
            p = m._emit_prep or _prep(m, hostname)
            app(InterMetric(m.name, ts, vals[i], p[0], GAUGE, "",
                            p[2], p[1]))

    metas = table.get_meta("status")
    if metas:
        vals = np.asarray(flush["status"]).tolist()
        for i, (_slot, m) in enumerate(metas):
            p = m._emit_prep or _prep(m, hostname)
            app(InterMetric(m.name, ts, vals[i], p[0], STATUS, m.message,
                            p[2], p[1]))

    metas = table.get_meta("set")
    if metas:
        vals = np.asarray(flush["set_estimate"]).tolist()
        for i, (_slot, m) in enumerate(metas):
            # sets have no local part (flusher.go:277-280): local instances
            # forward the HLL and emit nothing unless the set is local-only
            if is_local and m.scope != SCOPE_LOCAL:
                continue
            p = m._emit_prep or _prep(m, hostname)
            app(InterMetric(m.name, ts, vals[i], p[0], GAUGE, "",
                            p[2], p[1]))

    metas = table.get_meta("histogram")
    if metas:
        hq = np.asarray(flush["histo_quantiles"]).tolist()
        hcount = np.asarray(flush["histo_count"]).tolist()
        # (suffix, value list, type) per aggregate, resolved once
        agg_cols = [("." + a, np.asarray(flush[AGGREGATE_FIELDS[a][0]]
                                         ).tolist(),
                     AGGREGATE_FIELDS[a][1], a in ("min", "max"))
                    for a in dict.fromkeys(aggregates)
                    if a in AGGREGATE_FIELDS]
        psuf = ["." + percentile_name(p) for p in perc]
        isfinite = math.isfinite
        for i, (_slot, m) in enumerate(metas):
            scope = m.scope
            if is_local and scope == SCOPE_GLOBAL:
                continue
            if not hcount[i] > 0:
                continue
            name = m.name
            p = m._emit_prep or _prep(m, hostname)
            tags, sinks, host = p
            # imported-only MIXED histos on a global tier emit percentiles
            # only: their aggregates already flushed on the local instances
            # (flusher.go:61-77 "avoid double counting"); global-scoped
            # ones flush aggregates from the digest (the global=true path).
            if not m.imported_only or (scope == SCOPE_GLOBAL
                                       and not is_local):
                for suf, col, mtype, needs_finite in agg_cols:
                    v = col[i]
                    if needs_finite and not isfinite(v):
                        continue
                    app(InterMetric(name + suf, ts, v, tags, mtype, "",
                                    host, sinks))
            # percentiles: only where they are globally accurate —
            # everywhere on a global/standalone instance, local-only keys
            # on a local one
            if perc and (not is_local or scope == SCOPE_LOCAL):
                row = hq[i]
                for pi, suf in enumerate(psuf):
                    app(InterMetric(name + suf, ts, row[pi], tags, GAUGE,
                                    "", host, sinks))
    return out
