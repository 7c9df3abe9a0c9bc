"""Sink interfaces.

reference sinks/sinks.go:32-48 MetricSink{Name, Start, Flush,
FlushOtherSamples} and :86-103 SpanSink{Name, Start, Ingest, Flush}. Tag
exclusion (SetExcludedTags) is wired from `tags_exclude` with the
`tag|sink1|sink2` per-sink syntax (reference server.go:1467-1510).
"""

from __future__ import annotations

import logging
import threading
from typing import Callable, Iterable, List, Optional

from veneur_tpu_torch.reliability.faults import FAULTS, SINK_FLUSH
from veneur_tpu_torch.reliability.policy import CircuitOpenError
from veneur_tpu_torch.samplers.intermetric import InterMetric

log = logging.getLogger("veneur_tpu_torch.sinks")


class MetricSink:
    name: str = "sink"

    # Every sink can take a columnar flusher.MetricFrame: the default
    # materializes (memoized on the frame, so N object-path sinks share
    # ONE InterMetric list); high-volume sinks override flush_frame to
    # consume frame.rows() directly and skip materialization.
    accepts_frames = True

    def start(self) -> None:
        pass

    def flush(self, metrics: List[InterMetric]) -> None:
        raise NotImplementedError

    def flush_frame(self, frame) -> None:
        self.flush(frame.intermetrics())

    def flush_other_samples(self, samples: Iterable) -> None:
        """DogStatsD events / service checks as SSF samples
        (reference sinks.go:44-47)."""

    def set_excluded_tags(self, tags: List[str]) -> None:
        self.excluded_tags = list(tags)

    def strip_excluded(self, tags: Iterable[str]) -> List[str]:
        excl = getattr(self, "excluded_tags", ())
        return [t for t in tags
                if not any(t == e or t.startswith(e + ":") for e in excl)]


class SpanSink:
    name: str = "span_sink"

    def start(self) -> None:
        pass

    def ingest(self, span) -> None:
        raise NotImplementedError

    def flush(self) -> None:
        pass


def filter_acceptable(metrics: List[InterMetric], sink_name: str):
    """reference sinks/sinks.go:51 IsAcceptableMetric applied batch-wise."""
    return [m for m in metrics if m.is_acceptable_to(sink_name)]


def dispatch_flush(sink, payload) -> None:
    """THE flush dispatch every fan-out path goes through: the `sink.flush`
    fault-injection point, then frame-vs-list routing. Keeping it here (not
    in server.py) means chaos tests hit the same seam any embedding does."""
    FAULTS.inject(SINK_FLUSH, name=sink.name)
    from veneur_tpu_torch.server.flusher import MetricFrame
    if isinstance(payload, MetricFrame):
        sink.flush_frame(payload)
    else:
        sink.flush(payload)


class ResilientSink:
    """Mixin giving egress sinks (Datadog/SignalFx/Splunk/Kafka) a shared
    retry/breaker harness around their individual network calls.

    Unconfigured (the default), resilient_post() is a bare passthrough —
    today's single-attempt behavior, byte for byte. The server wires
    configure_resilience() from the sink_retry_* / circuit_* config keys;
    retrying HERE (per POST/produce) rather than around the whole flush
    avoids re-serializing and re-sending chunks that already landed.

    When a sink handles its own retries this way, the server fan-out does
    NOT wrap its flush in a second retry loop (resilience_configured is
    the signal) — otherwise errors would multiply attempts.
    """

    retry_policy = None
    breaker = None
    retries_total = 0        # drained by server self-telemetry per interval
    posts_skipped_open = 0   # refused by an open breaker

    def configure_resilience(self, policy, breaker=None) -> None:
        self.retry_policy = policy
        self.breaker = breaker
        self._resilience_lock = threading.Lock()
        self.retries_total = 0
        self.posts_skipped_open = 0

    @property
    def resilience_configured(self) -> bool:
        return self.retry_policy is not None or self.breaker is not None

    def reliability_counters(self):
        """(retries_total, posts_skipped_open) read under the harness
        lock — the server's telemetry-registry collectors call this so
        /metrics and the self-metric flush see consistent values."""
        lock = getattr(self, "_resilience_lock", None)
        if lock is None:   # configure_resilience never ran
            return (self.retries_total, self.posts_skipped_open)
        with lock:
            return (self.retries_total, self.posts_skipped_open)

    def resilient_post(self, fn: Callable, what: str = ""):
        """Run one network call under the sink's policy/breaker. Terminal
        failure re-raises — call sites keep their existing log-and-continue
        (or raise) semantics unchanged."""
        breaker = self.breaker
        if breaker is not None and not breaker.allow():
            with self._resilience_lock:
                self.posts_skipped_open += 1
            raise CircuitOpenError(
                f"{getattr(self, 'name', 'sink')} {what}: circuit open")
        policy = self.retry_policy
        if policy is None:
            try:
                result = fn()
            except Exception:
                if breaker is not None:
                    breaker.record_failure()
                raise
            # success must reset the breaker even without a retry policy:
            # otherwise sporadic (non-consecutive) failures accumulate to
            # a spurious trip, and a successful half-open probe would
            # leave _probe_in_flight set — wedging the breaker half-open
            if breaker is not None:
                breaker.record_success()
            return result
        name = getattr(self, "name", "sink")

        def on_retry(attempt, exc, delay):
            with self._resilience_lock:
                self.retries_total += 1
            log.warning("sink %s %s attempt %d failed: %s; retrying in "
                        "%.3fs", name, what, attempt + 1, exc, delay)

        try:
            result = policy.run(fn, on_retry=on_retry)
        except Exception:
            if breaker is not None:
                breaker.record_failure()
            raise
        if breaker is not None:
            breaker.record_success()
        return result
