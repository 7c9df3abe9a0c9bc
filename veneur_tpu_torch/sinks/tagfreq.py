"""Tag-frequency span sink: count-min heavy hitters over the span firehose.

No reference counterpart: the sketch consumer BASELINE config 5 calls for
(a high-cardinality SSF span stream -> per-interval top-K tag
frequencies). A span sink (every span visits every sink) that feeds
`tag_key:value` strings into the count-min sketch on the device
(ops/countmin.py) and, at flush, reports the interval's top K as SSF
samples through the Server's own trace client: the results ride the
self-telemetry loop-back into the metric pipeline and out every metric
sink, as the veneur.* counters do.

Members are buffered and shipped to the device in batches of
`batch_size` (one update a batch). Span pipelines may run several
workers, so the buffer and the sketch update take a lock.
"""

from __future__ import annotations

import logging
import threading
from typing import Callable, List, Optional, Sequence

from veneur_tpu_torch.ops.countmin import (DEFAULT_DEPTH, DEFAULT_WIDTH,
                                           HeavyHitters)

log = logging.getLogger("veneur_tpu_torch.sinks.tagfreq")


class TagFrequencySink:
    """SpanSink tracking heavy-hitter tag values a flush interval."""

    name = "tag_frequency"

    def __init__(self, report: Optional[Callable[[List], None]] = None,
                 tag_keys: Sequence[str] = (), top_k: int = 100,
                 depth: int = DEFAULT_DEPTH, width: int = DEFAULT_WIDTH,
                 batch_size: int = 4096,
                 metric_name: str = "veneur.span.tag_frequency",
                 device=None):
        self.report = report
        self.tag_keys = set(tag_keys)
        self.top_k = top_k
        self.batch_size = batch_size
        self.metric_name = metric_name
        self.hh = HeavyHitters(top_k, depth, width, device=device)
        self._buf: List[bytes] = []
        self._lock = threading.Lock()
        self.spans_seen = 0
        self.members_seen = 0

    def start(self):
        pass

    def _span_members(self, span) -> List[bytes]:
        return [f"{k}:{v}".encode() for k, v in span.tags.items()
                if not self.tag_keys or k in self.tag_keys]

    def _ingest_members(self, members: List[bytes], n_spans: int) -> None:
        """The one buffering path of both ingest calls. Atomic, as the
        SpanPipeline's retry contract needs: the device update, which may
        raise, runs before any state changes, so a failure leaves the
        sink as it was and a redelivered span cannot count twice."""
        if not members:
            return
        with self._lock:
            merged = self._buf + members
            if len(merged) >= self.batch_size:
                self.hh.update(merged)   # may raise: nothing changed yet
                self._buf = []
            else:
                self._buf = merged
            self.spans_seen += n_spans
            self.members_seen += len(members)

    def ingest(self, span) -> None:
        members = self._span_members(span)
        self._ingest_members(members, 1 if members else 0)

    def ingest_many(self, spans) -> None:
        """The span workers' batched call: one lock round trip a batch."""
        members: List[bytes] = []
        n_spans = 0
        for span in spans:
            m = self._span_members(span)
            if m:
                n_spans += 1
                members.extend(m)
        self._ingest_members(members, n_spans)

    def flush(self) -> List:
        """Report the interval's top K and reset (flush-scoped state, as
        every other sketch in the pipeline). Returns the samples, for
        tests and callers without a report callback."""
        from veneur_tpu_torch.samplers import ssf_samples
        with self._lock:
            if self._buf:
                self.hh.update(self._buf)
                self._buf = []
            top = self.hh.top(self.top_k)
            total = self.hh.total
            self.hh.reset()
        samples = [ssf_samples.gauge(self.metric_name, float(count),
                                     {"tag": member.decode("utf-8",
                                                           "replace")})
                   for member, count in top]
        if samples:
            samples.append(ssf_samples.gauge(self.metric_name + ".total",
                                             float(total)))
        if self.report is not None and samples:
            try:
                self.report(samples)
            except Exception as e:
                log.warning("tag-frequency report failed: %s", e)
        return samples
