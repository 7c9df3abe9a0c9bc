"""metricpb.Metric <-> aggregator state conversion.

Export mirrors reference worker.go:181 ForwardableMetrics + the samplers'
Metric() methods (samplers/samplers.go: Counter.Metric :171, Gauge.Metric
:266, Set.Metric :432, Histo.Metric :688): scope-global counters/gauges and
non-local histograms/timers/sets ship their mergeable sketch state. Import
mirrors importsrv/server.go:102 SendMetrics → worker.go:438
ImportMetricGRPC, including the scope coercion of counters/gauges to
GlobalOnly (:442-447).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from veneur_tpu_torch.aggregation.host import (
    KeyTable, SCOPE_GLOBAL, SCOPE_LOCAL)
from veneur_tpu_torch.ops import hll as hll_ops
from veneur_tpu_torch.proto import metricpb_pb2 as mpb
from veneur_tpu_torch.utils.hashing import fnv1a_32

_KIND_TO_TYPE = {
    "counter": mpb.Counter, "gauge": mpb.Gauge, "histogram": mpb.Histogram,
    "set": mpb.Set, "timer": mpb.Timer,
}
_TYPE_TO_KIND = {v: k for k, v in _KIND_TO_TYPE.items()}
_TYPE_NAMES = {mpb.Counter: "counter", mpb.Gauge: "gauge",
               mpb.Histogram: "histogram", mpb.Set: "set",
               mpb.Timer: "timer"}


def metric_digest(name: str, pb_type: int, tags) -> int:
    """Sharding digest over name+type+tags, identical to the reference's
    importsrv hash (importsrv/server.go:141-148 hashMetric: fnv1a-32 over
    name, the capitalized enum name from Type.String(), then each tag).
    Inputs are deserialized protobuf strings — always valid UTF-8 (the
    export side replaces invalid bytes at the wire boundary, _wire_str),
    so a plain encode cannot raise."""
    h = fnv1a_32(name.encode())
    h = fnv1a_32(mpb.Type.Name(pb_type).encode(), h)
    for t in tags:
        h = fnv1a_32(t.encode(), h)
    return h


def _wire_str(s: str) -> str:
    """Name/tag strings entering metricpb protobuf STRING fields. A
    metric whose name arrived as invalid UTF-8 is held host-side with
    surrogates (key identity must round-trip); protobuf rejects
    surrogates, and ONE such global-scoped key would otherwise make
    export_metrics raise EVERY interval — permanently killing the whole
    forward stream for one corrupt datagram. Replace to U+FFFD at the
    wire boundary instead: only the corrupt key's name is mangled, the
    stream lives. (The Go reference has the harsher behavior: proto3
    marshal errors on invalid UTF-8, failing the whole batch.)"""
    try:
        s.encode()
        return s
    except UnicodeEncodeError:
        return s.encode("utf-8", "surrogateescape").decode("utf-8",
                                                           "replace")


def iter_forwardable(raw: Dict[str, np.ndarray], table: KeyTable,
                     hll_precision: int):
    """Yield (kind, meta, scope, payload) for every forward-eligible
    live row of a flush — the scope filters of worker.go:181
    ForwardableMetrics with payloads in the exact form
    Aggregator.import_metric receives after an export -> wire -> import
    round-trip (scope already coerced per worker.go:442-447). BOTH
    forward paths consume this one generator: export_metrics builds
    protobuf from it for the DCN/gRPC path, and the collective tier's
    absorb_raw feeds the payloads straight into device staging (zero
    serialization), so the two paths cannot drift.

    raw arrays are COMPACT: row i pairs with get_meta(kind)[i]
    (aggregator.compute_flush want_raw gathers live rows on device).

    One deviation: set payloads carry the losslessly unpacked dense
    registers, where the wire's axiomhq nibble form saturates register
    spreads > 15 (hll_ops.serialize tailcut) — identical whenever the
    spread fits, strictly more accurate otherwise."""
    for i, (_slot, meta) in enumerate(table.get_meta("counter")):
        if meta.scope != SCOPE_GLOBAL:
            continue  # only global counters forward (worker.go:186-193)
        yield ("counter", meta, SCOPE_GLOBAL,
               {"value": int(round(float(raw["counter"][i])))})

    for i, (_slot, meta) in enumerate(table.get_meta("gauge")):
        if meta.scope != SCOPE_GLOBAL:
            continue
        yield ("gauge", meta, SCOPE_GLOBAL,
               {"value": float(raw["gauge"][i])})

    for i, (_slot, meta) in enumerate(table.get_meta("set")):
        if meta.scope == SCOPE_LOCAL:
            continue  # local-only sets flush locally, never forward
        regs = hll_ops.unpack_registers_np(
            np.asarray(raw["hll"][i], np.int32), precision=hll_precision)
        yield ("set", meta,
               SCOPE_GLOBAL if meta.scope == SCOPE_GLOBAL else 0,
               {"registers": np.asarray(regs, np.uint8)})

    for i, (_slot, meta) in enumerate(table.get_meta("histogram")):
        if meta.scope == SCOPE_LOCAL:
            continue
        w = raw["h_weight"][i]
        live = w > 0
        if not live.any():
            continue
        kind = "timer" if meta.kind == "timer" else "histogram"
        yield (kind, meta,
               SCOPE_GLOBAL if meta.scope == SCOPE_GLOBAL else 0,
               {"means": raw["h_mean"][i][live], "weights": w[live],
                "min": float(raw["h_min"][i]),
                "max": float(raw["h_max"][i]),
                "recip": float(raw["h_recip"][i])})


def export_metrics(raw: Dict[str, np.ndarray], table: KeyTable,
                   compression: float, hll_precision: int
                   ) -> List[mpb.Metric]:
    """Build the forwardable MetricList from a flush's raw state."""
    out: List[mpb.Metric] = []
    for kind, meta, _scope, payload in iter_forwardable(raw, table,
                                                        hll_precision):
        name = _wire_str(meta.name)
        tags = [_wire_str(t) for t in meta.tags]
        pb_scope = (mpb.Global if meta.scope == SCOPE_GLOBAL
                    else mpb.Mixed)
        if kind == "counter":
            m = mpb.Metric(name=name, tags=tags, type=mpb.Counter,
                           scope=mpb.Global)
            m.counter.value = payload["value"]
        elif kind == "gauge":
            m = mpb.Metric(name=name, tags=tags, type=mpb.Gauge,
                           scope=mpb.Global)
            m.gauge.value = payload["value"]
        elif kind == "set":
            m = mpb.Metric(name=name, tags=tags, type=mpb.Set,
                           scope=pb_scope)
            # serialize unpacks packed rows itself, so dense registers
            # produce the identical wire bytes
            m.set.hyper_log_log = hll_ops.serialize(payload["registers"],
                                                    hll_precision)
        else:
            mtype = mpb.Timer if kind == "timer" else mpb.Histogram
            m = mpb.Metric(name=name, tags=tags, type=mtype,
                           scope=pb_scope)
            td = m.histogram.t_digest
            td.compression = compression
            td.min = payload["min"]
            td.max = payload["max"]
            td.reciprocalSum = payload["recip"]
            for mean, wt in zip(payload["means"], payload["weights"]):
                td.main_centroids.add(mean=float(mean), weight=float(wt))
        out.append(m)

    return out


def import_into(aggregator, metric: mpb.Metric) -> None:
    """Apply one received metricpb.Metric to a global aggregator
    (worker.go:438 ImportMetricGRPC)."""
    kind = _TYPE_NAMES[metric.type]
    tags = tuple(metric.tags)
    digest = metric_digest(metric.name, metric.type, tags)
    # counters/gauges arriving via import are global by definition
    # (worker.go:442-447 scope coercion)
    scope = SCOPE_GLOBAL if kind in ("counter", "gauge") else (
        SCOPE_GLOBAL if metric.scope == mpb.Global else 0)

    which = metric.WhichOneof("value")
    if which == "counter":
        payload = {"value": metric.counter.value}
    elif which == "gauge":
        payload = {"value": metric.gauge.value}
    elif which == "set":
        _, regs = hll_ops.deserialize(metric.set.hyper_log_log)
        payload = {"registers": regs}
    elif which == "histogram":
        td = metric.histogram.t_digest
        payload = {
            "means": [c.mean for c in td.main_centroids],
            "weights": [c.weight for c in td.main_centroids],
            "min": td.min, "max": td.max, "recip": td.reciprocalSum,
        }
    else:
        # the reference ERRORS on a nil value (worker.go:441
        # ImportMetricGRPC; worker_test.go:327) so the import server
        # counts it — a silent return would hide malformed peers
        raise ValueError(
            f"metric {metric.name!r} has no value field set")
    aggregator.import_metric(kind, metric.name, tags, scope, digest,
                             payload)
