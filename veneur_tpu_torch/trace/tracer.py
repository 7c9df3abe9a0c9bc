"""Span construction + a minimal tracer (reference trace/trace.go span
lifecycle and trace/opentracing.go header inject/extract).

The reference exposes a full OpenTracing adapter; the API here covers the
parts Veneur itself uses: StartSpan/start_span_from_context, tags,
ClientFinish, and HTTP header propagation (trace id / span id headers,
opentracing.go textmap carrier)."""

from __future__ import annotations

import random
import time
from typing import Dict, Optional

from veneur_tpu_torch.proto import ssf_pb2

HEADER_TRACE_ID = "Trace-Id"
HEADER_SPAN_ID = "Span-Id"


def _new_id() -> int:
    return random.getrandbits(63) | 1


class Span:
    def __init__(self, name: str, service: str = "",
                 trace_id: Optional[int] = None,
                 parent_id: Optional[int] = None,
                 indicator: bool = False, tags: Optional[Dict] = None,
                 start_ns: Optional[int] = None):
        self.name = name
        self.service = service
        self.trace_id = trace_id or _new_id()
        self.id = _new_id()
        self.parent_id = parent_id or 0
        self.indicator = indicator
        self.error = False
        self.tags = dict(tags or {})
        # explicit start supports spans reconstructed after the fact (the
        # flush trace's ingest-drain phase happens on the pipeline thread
        # BEFORE the flush worker builds the span tree)
        self.start_ns = (int(start_ns) if start_ns is not None
                         else int(time.time() * 1e9))
        self.end_ns = 0
        self.samples = []
        self.log_lines = []   # LogFields/LogKV records (stored, unsent —
        #                       matching opentracing.go:312 "ignored")
        self.baggage: Dict[str, str] = {}

    def set_tag(self, k: str, v) -> "Span":
        self.tags[k] = v if isinstance(v, str) else repr(v)
        return self

    def set_operation_name(self, name: str) -> "Span":
        """OpenTracing SetOperationName -> the resource tag
        (opentracing.go:278 sets Trace.Resource)."""
        self.tags["resource"] = name
        return self

    def log_fields(self, **fields) -> None:
        self.log_lines.append(dict(fields))

    def log_kv(self, *alternating) -> None:
        self.log_fields(**{str(alternating[i]): alternating[i + 1]
                           for i in range(0, len(alternating) - 1, 2)})

    def log_event(self, event: str) -> None:
        """Deprecated OpenTracing API — interface-compat no-op, exactly
        like the reference (opentracing.go:341 LogEvent)."""

    def log_event_with_payload(self, event: str, payload) -> None:
        """Deprecated no-op (opentracing.go:346)."""

    def log(self, data) -> None:
        """Deprecated no-op (opentracing.go:351)."""

    def set_baggage_item(self, key: str, value: str) -> "Span":
        """Span-level baggage (opentracing.go:324 SetBaggageItem); the
        OpenTracing adapter that reads it is not ported yet."""
        self.baggage[key] = value
        return self

    def baggage_item(self, key: str) -> str:
        kl = key.lower()
        for k, v in self.baggage.items():
            if k.lower() == kl:
                return v
        return ""

    def finish_with_options(self, finish_time_ns: Optional[int] = None,
                            log_records=None) -> ssf_pb2.SSFSpan:
        """FinishWithOptions (opentracing.go:236): explicit finish time;
        log records are retained with the span's log lines but — like
        the reference — never transmitted (BulkLogData deprecated)."""
        if log_records:
            self.log_lines.extend(log_records)
        return self.finish(finish_time_ns)

    def add(self, *samples):
        """Attach SSF metric samples to ride along with the span
        (trace.go Span.Add)."""
        self.samples.extend(samples)

    def child(self, name: str, **kw) -> "Span":
        return Span(name, service=self.service, trace_id=self.trace_id,
                    parent_id=self.id, **kw)

    def finish(self, finish_time_ns: Optional[int] = None) -> ssf_pb2.SSFSpan:
        self.end_ns = finish_time_ns or int(time.time() * 1e9)
        return self.to_ssf()

    def to_ssf(self) -> ssf_pb2.SSFSpan:
        span = ssf_pb2.SSFSpan(
            version=0, trace_id=self.trace_id, id=self.id,
            parent_id=self.parent_id, service=self.service, name=self.name,
            indicator=self.indicator, error=self.error,
            start_timestamp=self.start_ns,
            end_timestamp=self.end_ns or int(time.time() * 1e9))
        for k, v in self.tags.items():
            span.tags[k] = v
        for s in self.samples:
            span.metrics.append(s)
        return span

    def client_finish(self, client) -> None:
        """finish + record on the trace client (trace.go ClientFinish)."""
        ssf_span = self.finish()
        if client is not None:
            client.record(ssf_span)

    # -- header propagation (opentracing.go inject/extract) -----------------
    def inject(self, headers: Dict[str, str]) -> None:
        headers[HEADER_TRACE_ID] = str(self.trace_id)
        headers[HEADER_SPAN_ID] = str(self.id)


class Tracer:
    def __init__(self, service: str = "", client=None):
        self.service = service
        self.client = client

    def start_span(self, name: str, parent: Optional[Span] = None,
                   **kw) -> Span:
        if parent is not None:
            s = parent.child(name, **kw)
        else:
            s = Span(name, service=self.service, **kw)
        return s

    def extract(self, headers: Dict[str, str],
                name: str = "request") -> Span:
        """Continue a trace from incoming HTTP headers; malformed ids fall
        back to a fresh trace (headers are caller-controlled)."""
        def _id(key):
            try:
                return int(headers.get(key, 0) or 0) or None
            except (TypeError, ValueError):
                return None

        return Span(name, service=self.service,
                    trace_id=_id(HEADER_TRACE_ID),
                    parent_id=_id(HEADER_SPAN_ID))
