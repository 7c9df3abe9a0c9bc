"""LightStep span sink (reference sinks/lightstep/lightstep.go).

The reference pools `lightstep_num_clients` opentracing clients and
round-robins spans by trace id (lightstep.go:126-204). The LightStep
tracer library is not part of this image, so the client factory is
injectable (any object with `.report(span_dict)`); without one,
construction requires the `lightstep` package and raises cleanly
otherwise — the factory only wires this sink when an access token is
configured.
"""

from __future__ import annotations

import logging
from typing import Callable, List, Optional

from veneur_tpu_torch.sinks.base import SpanSink

log = logging.getLogger("veneur_tpu_torch.sinks.lightstep")


class LightStepSpanSink(SpanSink):
    name = "lightstep"

    def __init__(self, access_token: str, collector_host: str = "",
                 num_clients: int = 1,
                 client_factory: Optional[Callable] = None):
        if client_factory is None:
            try:
                import lightstep  # type: ignore
            except ImportError:
                raise RuntimeError(
                    "lightstep sink requires the lightstep package or an "
                    "injected client_factory")

            def client_factory():
                return lightstep.Tracer(access_token=access_token,
                                        collector_host=collector_host
                                        or None)
        self.clients: List = [client_factory() for _ in range(
            max(1, num_clients))]
        self.sent = 0

    def _client_for(self, span):
        # round-robin by trace id (lightstep.go:126-204)
        return self.clients[span.trace_id % len(self.clients)]

    def ingest(self, span) -> None:
        client = self._client_for(span)
        duration_us = (span.end_timestamp - span.start_timestamp) / 1e3
        if hasattr(client, "report"):
            client.report({
                "operation_name": span.name, "service": span.service,
                "trace_id": span.trace_id, "span_id": span.id,
                "parent_id": span.parent_id,
                "start_us": span.start_timestamp / 1e3,
                "duration_us": duration_us, "error": span.error,
                "tags": dict(span.tags)})
        else:  # a real lightstep.Tracer
            ls = client.start_span(operation_name=span.name,
                                   start_time=span.start_timestamp / 1e9)
            for k, v in span.tags.items():
                ls.set_tag(k, v)
            ls.set_tag("error", span.error)
            ls.finish(finish_time=span.end_timestamp / 1e9)
        self.sent += 1

    def flush(self) -> None:
        for c in self.clients:
            if hasattr(c, "flush"):
                try:
                    c.flush()
                except Exception as e:
                    log.debug("lightstep flush: %s", e)
