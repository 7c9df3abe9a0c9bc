"""Sink interfaces (reference sinks/sinks.go:32-103) and the sinks the
server wires at startup (reference server.go:472-678)."""

from veneur_tpu_torch.sinks.base import MetricSink, SpanSink  # noqa: F401
