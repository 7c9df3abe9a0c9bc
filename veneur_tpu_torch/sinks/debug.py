"""Log-everything sink (reference sinks/debug/debug.go: gated on
debug_flushed_metrics / debug_ingested_spans)."""

from __future__ import annotations

import logging

from veneur_tpu_torch.sinks.base import MetricSink, SpanSink, filter_acceptable

log = logging.getLogger("veneur_tpu_torch.sinks.debug")


class DebugMetricSink(MetricSink):
    name = "debug"

    def __init__(self):
        self.flushed = []  # kept for tests/introspection, like channel sinks

    # frame flushes use the base default: materialize (memoized) — debug
    # keeps full objects for introspection by design

    def flush(self, metrics):
        metrics = filter_acceptable(metrics, self.name)
        self.flushed.extend(metrics)
        for m in metrics:
            log.info("flushed metric name=%s type=%s value=%s tags=%s",
                     m.name, m.type, m.value, ",".join(m.tags))


class DebugSpanSink(SpanSink):
    name = "debug"

    def __init__(self):
        self.spans = []

    def ingest(self, span):
        self.spans.append(span)
        log.info("ingested span service=%s name=%s trace_id=%d",
                 span.service, span.name, span.trace_id)
