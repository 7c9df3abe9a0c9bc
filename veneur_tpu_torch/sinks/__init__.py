"""Sink interfaces (reference sinks/sinks.go:32-103): the debug,
blackhole and local-file sinks, and the span-to-metric extraction sink."""

from veneur_tpu_torch.sinks.base import MetricSink, SpanSink  # noqa: F401
