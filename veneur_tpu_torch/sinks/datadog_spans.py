"""Datadog trace (span) sink — reference datadog.go:410-498 span half.

Spans buffer in a bounded ring and flush as `[[DatadogTraceSpan...]]`
grouped by trace id, POSTed to `{trace_api}/v0.3/traces` (the trace-agent
API the reference targets).
"""

from __future__ import annotations

import json
import logging
import threading
import urllib.request
from collections import deque

from veneur_tpu_torch.sinks.base import SpanSink

log = logging.getLogger("veneur_tpu_torch.sinks.datadog")


class DatadogSpanSink(SpanSink):
    name = "datadog"

    def __init__(self, trace_api_address: str, buffer_size: int = 16384):
        self.trace_api = trace_api_address.rstrip("/")
        # bounded ring: oldest spans drop when full (datadog.go ring buffer)
        self.buffer = deque(maxlen=buffer_size)
        self._lock = threading.Lock()
        self.flushed = 0

    def _dd_span(self, span) -> dict:
        duration = span.end_timestamp - span.start_timestamp
        return {
            "trace_id": span.trace_id & ((1 << 64) - 1),
            "span_id": span.id & ((1 << 64) - 1),
            "parent_id": span.parent_id & ((1 << 64) - 1),
            "start": span.start_timestamp,
            "duration": duration,
            "name": span.name,
            "resource": span.tags.get("resource", span.name),
            "service": span.service,
            "type": span.tags.get("type", "custom"),
            "error": 1 if span.error else 0,
            "meta": dict(span.tags),
        }

    def ingest(self, span) -> None:
        from veneur_tpu_torch.protocol.wire import valid_trace
        # metrics-only carrier spans (self-telemetry, emit -ssf metrics)
        # are not traces (reference datadog.go Ingest -> ValidateTrace)
        if not valid_trace(span):
            return
        with self._lock:
            self.buffer.append(self._dd_span(span))

    def flush(self) -> None:
        with self._lock:
            spans, self.buffer = list(self.buffer), deque(
                maxlen=self.buffer.maxlen)
        if not spans:
            return
        traces = {}
        for s in spans:
            traces.setdefault(s["trace_id"], []).append(s)
        body = json.dumps(list(traces.values())).encode()
        req = urllib.request.Request(
            f"{self.trace_api}/v0.3/traces", data=body, method="POST",
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=10) as resp:
                resp.read()
            self.flushed += len(spans)
        except Exception as e:
            log.error("datadog trace flush failed: %s", e)
