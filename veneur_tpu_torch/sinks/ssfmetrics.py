"""Metric-extraction span sink: re-injects span-derived metrics into the
aggregation pipeline (reference sinks/ssfmetrics/metrics.go:44
NewMetricExtractionSink — always the first span sink).

Extracts: embedded SSF samples (ConvertMetrics), indicator-span SLI timers
(ConvertIndicatorMetrics), and sampled span-name uniqueness Sets
(ConvertSpanUniquenessMetrics)."""

from __future__ import annotations

import logging
from typing import Callable

from veneur_tpu_torch.protocol.wire import valid_trace
from veneur_tpu_torch.samplers import parser
from veneur_tpu_torch.sinks.base import SpanSink

log = logging.getLogger("veneur_tpu_torch.sinks.ssfmetrics")


class MetricExtractionSink(SpanSink):
    name = "metric_extraction"

    def __init__(self, process_metrics: Callable,
                 indicator_timer_name: str = "",
                 objective_timer_name: str = "",
                 uniqueness_rate: float = 0.01):
        """process_metrics: callable taking a list of UDPMetrics (routed to
        the aggregation pipeline, metrics.go:65-69)."""
        self.process_metrics = process_metrics
        self.indicator_timer_name = indicator_timer_name
        self.objective_timer_name = objective_timer_name
        self.uniqueness_rate = uniqueness_rate
        self.invalid_samples = 0

    def _extract(self, span, out: list) -> int:
        """Returns the span's invalid-sample count instead of mutating
        state — callers fold it in only after the pipeline hand-off
        succeeds (SpanPipeline atomicity contract)."""
        metrics, invalid = parser.convert_metrics(span)
        out.extend(metrics)
        # indicator + uniqueness extraction only for valid trace spans;
        # metric-carrier-only packets stop here (metrics.go:111-114)
        if valid_trace(span):
            if self.indicator_timer_name or self.objective_timer_name:
                try:
                    out.extend(parser.convert_indicator_metrics(
                        span, self.indicator_timer_name,
                        self.objective_timer_name))
                except parser.ParseError as e:
                    log.debug("indicator conversion failed: %s", e)
            if self.uniqueness_rate > 0:
                out.extend(
                    parser.convert_span_uniqueness_metrics(
                        span, self.uniqueness_rate))
        return len(invalid)

    def ingest(self, span) -> None:
        metrics: list = []
        invalid = self._extract(span, metrics)
        if metrics:
            self.process_metrics(metrics)
        self.invalid_samples += invalid

    def ingest_many(self, spans) -> None:
        """One pipeline hand-off per worker batch instead of per span.
        Atomic per the SpanPipeline contract: nothing — not even the
        invalid-sample counter — mutates until the single
        process_metrics call has succeeded."""
        metrics: list = []
        invalid = 0
        for span in spans:
            invalid += self._extract(span, metrics)
        if metrics:
            self.process_metrics(metrics)
        self.invalid_samples += invalid
