"""Datadog metric sink — batched JSON series posts.

reference sinks/datadog/datadog.go: `DDMetric` JSON bodies posted to
`{api}/api/v1/series?api_key=...`, chunked to `datadog_flush_max_per_body`
points per POST (:112-160), name-prefix drops and per-prefix tag exclusion
(:256+), events/service checks via FlushOtherSamples (:162). Uses urllib —
no external HTTP dependency — with zlib deflate like the reference's
compressed posts (http/http.go PostHelper).
"""

from __future__ import annotations

import json
import logging
import threading
import urllib.request
import zlib
from typing import List

from veneur_tpu_torch.samplers.intermetric import COUNTER, STATUS, InterMetric
from veneur_tpu_torch.sinks.base import (MetricSink, ResilientSink,
                                         filter_acceptable)

log = logging.getLogger("veneur_tpu_torch.sinks.datadog")


class DatadogMetricSink(ResilientSink, MetricSink):
    name = "datadog"

    def __init__(self, api_key: str, hostname: str, api_url: str,
                 interval_s: float = 10.0, flush_max_per_body: int = 25000,
                 tags: List[str] = (),
                 metric_name_prefix_drops: List[str] = (),
                 exclude_tags_prefix_by_prefix_metric: dict = None):
        self.api_key = api_key
        self.hostname = hostname
        self.api_url = api_url.rstrip("/")
        self.interval_s = interval_s
        self.flush_max_per_body = flush_max_per_body
        self.tags = list(tags)
        self.prefix_drops = list(metric_name_prefix_drops)
        self.prefix_tag_excludes = dict(
            exclude_tags_prefix_by_prefix_metric or {})

    # -- serialization ------------------------------------------------------
    def _add(self, series, checks, name, ts, value, mtype, tags, host,
             message, sink_tags):
        """The ONE serialization both flush paths share (reference
        datadog.go:256 finalizeMetrics): `host:`/`device:` magic tags
        override the metric's hostname / set device_name and are removed
        from the tag list (checked BEFORE tag exclusions, like the
        reference); STATUS metrics become Datadog service checks; counters
        become rates divided by the flush interval. One deliberate
        refinement over the reference (which only consults the sink-level
        hostname): an InterMetric-carried hostname — a proxied peer's —
        ranks between the magic tag and the sink default."""
        magic_host = device = None
        kept = []
        for t in tags:
            if t.startswith("host:"):
                magic_host = t[5:]
            elif t.startswith("device:"):
                device = t[7:]
            else:
                kept.append(t)
        kept = self.strip_excluded(kept)
        for prefix, excludes in self.prefix_tag_excludes.items():
            if name.startswith(prefix):
                kept = [t for t in kept
                        if not any(t == e or t.startswith(e + ":")
                                   for e in excludes)]
        hostname = magic_host or host or self.hostname
        all_tags = kept + sink_tags
        if mtype == STATUS:
            # a non-finite status (unvalidated f32 lane) must degrade to
            # UNKNOWN(3), not abort the whole interval's flush
            status = int(value) if value == value and abs(value) != \
                float("inf") else 3
            checks.append({
                "check": name, "status": status,
                "host_name": hostname, "timestamp": ts,
                "tags": all_tags, "message": message})
            return
        dd = {
            "metric": name,
            "type": "gauge",
            "points": [[ts, value]],
            "host": hostname,
            "tags": all_tags,
        }
        if mtype == COUNTER:
            # Datadog rates: value divided by the flush interval, with the
            # interval attached so count rollups reconstruct the original
            # (reference datadog.go:375 Interval)
            dd["type"] = "rate"
            dd["points"] = [[ts, value / self.interval_s]]
            dd["interval"] = int(self.interval_s)
        if device:
            dd["device_name"] = device
        series.append(dd)

    # -- flush --------------------------------------------------------------
    def flush(self, metrics):
        metrics = filter_acceptable(metrics, self.name)
        series, checks = [], []
        # sink-level tags pass the operator's exclusions too (the
        # reference filters dd.tags the same way) — invariant per flush
        sink_tags = self.strip_excluded(self.tags)
        for m in metrics:
            if any(m.name.startswith(p) for p in self.prefix_drops):
                continue
            self._add(series, checks, m.name, m.timestamp, m.value,
                      m.type, m.tags, m.hostname, m.message, sink_tags)
        self._post_series(series)
        self._post_checks(checks)

    def flush_frame(self, frame):
        """Columnar flush: DDMetric dicts straight from the frame's
        prepared rows — no InterMetric materialization between the
        flusher and the JSON body (the per-object detour is ~2us/metric
        at the 10M-key scale; see flusher.MetricFrame). Same emission
        rules as flush(): sink routing, prefix drops, shared _add."""
        drops = self.prefix_drops
        ts = frame.timestamp
        series, checks = [], []
        sink_tags = self.strip_excluded(self.tags)
        for name, value, mtype, msg, tags, sinks, host in frame.rows():
            if drops and any(name.startswith(p) for p in drops):
                continue
            if sinks is not None and self.name not in sinks:
                continue
            self._add(series, checks, name, ts, value, mtype, tags, host,
                      msg, sink_tags)
        self._post_series(series)
        self._post_checks(checks)

    def _post_json(self, path, payload, what):
        """The one deflate-JSON POST used by series, checks and events,
        run under the sink's retry/breaker harness (a passthrough when
        unconfigured); terminal errors are logged, never fatal."""
        url = f"{self.api_url}{path}?api_key={self.api_key}"
        req = urllib.request.Request(
            url, data=zlib.compress(json.dumps(payload).encode()),
            method="POST",
            headers={"Content-Type": "application/json",
                     "Content-Encoding": "deflate"})

        def once():
            with urllib.request.urlopen(req, timeout=10) as resp:
                resp.read()

        try:
            self.resilient_post(once, what=what)
        except Exception as e:
            log.error("datadog %s flush failed: %s", what, e)

    def _post_checks(self, checks):
        """Service checks go to the check_run API (datadog.go:122),
        chunked like series so one giant body can't be rejected whole."""
        for i in range(0, len(checks), self.flush_max_per_body):
            self._post_json("/api/v1/check_run",
                            checks[i:i + self.flush_max_per_body],
                            "check_run")

    def _post_series(self, series):
        if not series:
            return
        chunks = [series[i:i + self.flush_max_per_body]
                  for i in range(0, len(series), self.flush_max_per_body)]
        # parallel chunk posts, like the reference's per-chunk goroutines
        # (datadog.go:145-155 flushPart workers)
        threads = [threading.Thread(target=self._post_chunk, args=(c,))
                   for c in chunks[1:]]
        for t in threads:
            t.start()
        self._post_chunk(chunks[0])
        for t in threads:
            t.join()

    def _post_chunk(self, series):
        self._post_json("/api/v1/series", {"series": series}, "series")

    def flush_other_samples(self, samples):
        """DogStatsD events → Datadog events API: the vdogstatsd_* conduit
        tags map back onto event fields (reference datadog.go:162
        FlushOtherSamples / parseMetricsFromSSFSamples)."""
        events = []
        for s in samples:
            tags = dict(s.tags) if s.tags else {}
            if "vdogstatsd_ev" not in tags:
                continue
            ev = {
                "title": s.name,
                "text": s.message,
                "date_happened": s.timestamp,
                "tags": [f"{k}:{v}" for k, v in tags.items()
                         if not k.startswith("vdogstatsd")],
            }
            field_map = {"vdogstatsd_at": "alert_type",
                         "vdogstatsd_pri": "priority",
                         "vdogstatsd_hostname": "host",
                         "vdogstatsd_st": "source_type_name",
                         "vdogstatsd_ak": "aggregation_key"}
            for tag_key, ev_key in field_map.items():
                if tags.get(tag_key):
                    ev[ev_key] = tags[tag_key]
            events.append(ev)
        if events:
            self._post_json("/intake", {"events": events}, "event")
