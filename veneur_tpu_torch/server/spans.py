"""Span pipeline: SpanChan + SpanWorker fan-out (reference worker.go:575-719
SpanWorker, server.go:991-1065 span intake).

Each span fans out to every span sink; a span that is invalid as a trace
AND carries no metrics is dropped (worker.go:627-640). Sink ingest runs
with a per-sink timeout budget enforced at flush, not per span (Python
threads can't be interrupted mid-call; the reference's 9s per-sink ingest
timeout maps to the flush deadline here)."""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Callable, List, Optional

from veneur_tpu_torch.protocol.wire import valid_trace

log = logging.getLogger("veneur_tpu_torch.server.spans")


class SpanPipeline:
    def __init__(self, span_sinks: List, capacity: int = 100,
                 num_workers: int = 1, common_tags=None,
                 report_samples: Optional[Callable] = None):
        """report_samples: callable taking a list of SSFSamples — the span
        worker reports its own per-sink telemetry at flush, exactly as the
        reference's SpanWorker.Flush does through its statsd client
        (worker.go:698-713)."""
        self.span_sinks = list(span_sinks)
        self.chan: "queue.Queue" = queue.Queue(maxsize=capacity)
        self.num_workers = max(1, num_workers)
        self.common_tags = dict(common_tags or {})
        self.report_samples = report_samples
        self.spans_received = 0
        self.spans_dropped = 0
        self.chan_cap_hits = 0
        self.sink_errors = 0
        self._threads: List[threading.Thread] = []
        self._stop = object()
        # per-sink ingest accounting since the last flush, accumulated by
        # worker threads under a lock (the reference uses per-sink atomics,
        # worker.go:617-690 cumulativeTimes)
        self._stats_lock = threading.Lock()
        self._ingest_ns: dict = {}
        self._ingested: dict = {}
        # per-(service, ssf_format) intake counters since the last drain
        # (server.go:154-157 ssfServiceSpanMetrics in a sync.Map;
        # flusher.go:463-466 swaps them out per flush): value is
        # [received, root_received]. Own lock: listener threads must not
        # contend with the span workers' per-batch stats lock.
        self._svc_lock = threading.Lock()
        self._svc_counts: dict = {}

    # -- intake (server.go:1022 handleSSF) ----------------------------------
    def handle_span(self, span, ssf_format: str = None) -> bool:
        """Enqueue; returns False when the channel is full (the reference
        blocks; we drop + count to protect the UDP readers). ssf_format
        ("packet"/"framed") is set by the WIRE listeners only: the
        reference's channel client feeds SpanChan directly
        (server.go:310), bypassing the per-service intake counters, so
        self-telemetry spans (format None) skip them too."""
        # += on an attribute is read-modify-write; concurrent listener
        # threads can interleave at bytecode boundaries and lose counts
        # (the reference uses atomics) — one short lock covers both
        # counters
        with self._svc_lock:
            self.spans_received += 1
            if ssf_format is not None:
                key = (span.service, ssf_format)
                c = self._svc_counts.get(key)
                if c is None:
                    c = self._svc_counts[key] = [0, 0]
                c[0] += 1
                if span.id == span.trace_id:
                    c[1] += 1
        try:
            self.chan.put_nowait(span)
            return True
        except queue.Full:
            with self._svc_lock:
                self.spans_dropped += 1
                self.chan_cap_hits += 1   # worker.go:717 hit_chan_cap
            return False

    def drain_service_counts(self) -> dict:
        """Swap out the per-(service, format) intake counters (the
        flusher.go:463 atomic-swap idiom)."""
        with self._svc_lock:
            counts, self._svc_counts = self._svc_counts, {}
        return counts

    # -- workers (worker.go:611 SpanWorker.Work) ----------------------------
    def start(self):
        for i in range(self.num_workers):
            t = threading.Thread(target=self._work, daemon=True,
                                 name=f"span-worker-{i}")
            t.start()
            self._threads.append(t)

    def _work(self):
        """Batch-drains the channel (one blocking get, then up to 255
        opportunistic gets): per-span queue hops were ~2/3 of the span
        firehose's host cost. Sinks exposing ingest_many get the whole
        batch in one call; others keep the per-span path. Each _stop
        sentinel still terminates exactly one worker."""
        stopping = False
        while not stopping:
            first = self.chan.get()
            if first is self._stop:
                return
            batch = [first]
            while len(batch) < 256:
                try:
                    nxt = self.chan.get_nowait()
                except queue.Empty:
                    break
                if nxt is self._stop:
                    stopping = True
                    break
                batch.append(nxt)
            spans = []
            for span in batch:
                # tag with commonTags without clobbering span tags
                # (worker.go:619-626)
                for k, v in self.common_tags.items():
                    if k not in span.tags:
                        span.tags[k] = v
                # drop spans that are invalid traces and carry no metrics
                if not valid_trace(span) and not span.metrics:
                    with self._svc_lock:
                        self.spans_dropped += 1
                    continue
                spans.append(span)
            if not spans:
                continue
            for sink in self.span_sinks:
                t0 = time.perf_counter_ns()
                many = getattr(sink, "ingest_many", None)
                delivered = False
                if many is not None:
                    try:
                        many(spans)
                        delivered = True
                    except Exception as e:
                        # fall through to per-span delivery so one bad
                        # span can't take the other 255 with it;
                        # ingest_many implementations must be atomic
                        # (no partial state on raise) for this retry to
                        # stay exactly-once
                        log.warning("span sink %s ingest_many failed, "
                                    "retrying per-span: %s", sink.name, e)
                if delivered:
                    ok_spans = len(spans)
                else:
                    ok_spans = 0
                    for span in spans:
                        try:
                            sink.ingest(span)
                            ok_spans += 1
                        except Exception as e:
                            with self._stats_lock:
                                self.sink_errors += 1
                            log.warning("span sink %s ingest failed: %s",
                                        sink.name, e)
                with self._stats_lock:
                    self._ingest_ns[sink.name] = (
                        self._ingest_ns.get(sink.name, 0)
                        + time.perf_counter_ns() - t0)
                    # only successfully-ingested spans count toward
                    # veneur.sink.spans_flushed_total — a dead sink must
                    # not look healthy on dashboards
                    self._ingested[sink.name] = (
                        self._ingested.get(sink.name, 0) + ok_spans)

    def flush(self):
        """worker.go:698 SpanWorker.Flush: flush every span sink, timing
        each, then report the per-sink conventions the reference's span
        worker emits (worker.go:706-713), veneur.-prefixed like the
        reference's central ssf.NamePrefix:
        veneur.worker.span.flush_duration_ns,
        veneur.sink.span_ingest_total_duration_ns (cumulative since last
        flush), and veneur.sink.spans_flushed_total (measured centrally
        as spans
        delivered to the sink — a sampling sink may send fewer downstream,
        which its own telemetry covers)."""
        with self._stats_lock:
            ing_ns, self._ingest_ns = self._ingest_ns, {}
            ing_n, self._ingested = self._ingested, {}
        samples = []
        for sink in self.span_sinks:
            t0 = time.perf_counter_ns()
            try:
                sink.flush()
            except Exception as e:
                log.warning("span sink %s flush failed: %s", sink.name, e)
            if self.report_samples is None:
                continue
            from veneur_tpu_torch.samplers import ssf_samples
            tags = {"sink": sink.name}
            samples.append(ssf_samples.timing(
                "veneur.worker.span.flush_duration_ns",
                (time.perf_counter_ns() - t0) / 1e9, tags))
            samples.append(ssf_samples.timing(
                "veneur.sink.span_ingest_total_duration_ns",
                ing_ns.get(sink.name, 0) / 1e9, tags))
            n = ing_n.get(sink.name, 0)
            if n:
                samples.append(ssf_samples.count(
                    "veneur.sink.spans_flushed_total", n, tags))
        if samples and self.report_samples is not None:
            try:
                self.report_samples(samples)
            except Exception as e:
                log.warning("span worker self-report failed: %s", e)

    def stop(self):
        for _ in self._threads:
            self.chan.put(self._stop)
        for t in self._threads:
            t.join(timeout=2.0)
