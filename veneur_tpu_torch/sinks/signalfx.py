"""SignalFx metric sink (reference sinks/signalfx/signalfx.go).

Datapoints posted as JSON to `{endpoint}/v2/datapoint` with an X-SF-Token
header; counters as cumulative counters, everything else as gauges. The
reference's per-tag API-token fan-out (vary_key_by + per-tag token map,
signalfx.go:240-344) selects a client per metric by the value of one tag;
with dynamic fetch enabled, the tag→token map is re-fetched periodically
from the SignalFx tokens API (signalfx.go:250-344). DogStatsD events are
posted to the events API (signalfx.go:501 FlushOtherSamples →
reportEvent). No sfxclient dependency — urllib like the datadog sink.
"""

from __future__ import annotations

import json
import logging
import threading
import urllib.parse
import urllib.request
from typing import Dict, List

from veneur_tpu_torch.samplers.intermetric import (
    COUNTER, SINK_ONLY_TAG_PREFIX, InterMetric)
from veneur_tpu_torch.sinks.base import (MetricSink, ResilientSink,
                                         filter_acceptable)

# the dimension KEY the routing tag produces ("veneursinkonly:x" and the
# bare "veneursinkonly" both partition to this)
_SINK_ONLY_KEY = SINK_ONLY_TAG_PREFIX.rstrip(":")

# reference signalfx.go:27-28
EVENT_NAME_MAX_LENGTH = 256
EVENT_DESCRIPTION_MAX_LENGTH = 256
# tokens-API pagination (reference signalfx.go:273-277)
_TOKEN_PAGE_LIMIT = 200
# pagination backstop: a server that keeps returning full pages (or
# ignores offset) must not spin the token fetch forever; 500 pages =
# 100k tokens, far past any real org
_TOKEN_MAX_PAGES = 500

log = logging.getLogger("veneur_tpu_torch.sinks.signalfx")


class SignalFxMetricSink(ResilientSink, MetricSink):
    name = "signalfx"

    def __init__(self, api_key: str, endpoint: str, hostname: str,
                 hostname_tag: str = "host",
                 vary_key_by: str = "",
                 per_tag_api_keys: Dict[str, str] = None,
                 flush_max_per_body: int = 5000,
                 metric_name_prefix_drops: List[str] = (),
                 metric_tag_prefix_drops: List[str] = (),
                 tags: List[str] = (),
                 dynamic_per_tag_tokens_enable: bool = False,
                 dynamic_per_tag_tokens_refresh_s: float = 300.0,
                 api_endpoint: str = "https://api.signalfx.com"):
        self.api_key = api_key
        self.endpoint = endpoint.rstrip("/")
        self.hostname = hostname
        self.hostname_tag = hostname_tag
        self.vary_key_by = vary_key_by
        self.per_tag_api_keys = dict(per_tag_api_keys or {})
        self.flush_max_per_body = flush_max_per_body
        self.prefix_drops = list(metric_name_prefix_drops)
        self.tag_prefix_drops = list(metric_tag_prefix_drops)
        self.common_tags = list(tags)
        self.dynamic_per_tag_tokens_enable = dynamic_per_tag_tokens_enable
        # floor of 1s: a configured "0s" must degrade to a fast refresh,
        # not an unthrottled busy loop against the tokens API
        self.dynamic_per_tag_tokens_refresh_s = max(
            1.0, dynamic_per_tag_tokens_refresh_s)
        self.api_endpoint = api_endpoint.rstrip("/")
        self._refresh_stop = threading.Event()
        self._refresher = None

    def start(self):
        """Arm the periodic tag→token refresher (reference
        signalfx.go:250 clientByTagUpdater goroutine)."""
        if not self.dynamic_per_tag_tokens_enable:
            return
        self._refresher = threading.Thread(
            target=self._refresh_loop, daemon=True,
            name="signalfx-token-refresh")
        self._refresher.start()

    def stop(self):
        self._refresh_stop.set()

    def _refresh_loop(self):
        while not self._refresh_stop.wait(
                self.dynamic_per_tag_tokens_refresh_s):
            self.refresh_tokens_once()

    def refresh_tokens_once(self) -> bool:
        """One fetch of the full tag→token map from the SignalFx tokens
        API; merge on success, keep-last-good on any failure (reference
        signalfx.go:256-269: a failed fetch logs a warning and leaves
        the existing per-tag clients untouched)."""
        try:
            tokens = self._fetch_api_keys()
        except Exception as e:
            log.warning("failed to fetch new tokens from SignalFx: %s", e)
            return False
        # merge (not replace): the reference only overwrites/creates
        # clients for fetched names, never deletes existing ones.
        # Copy-on-rebind keeps _token_for lock-free on the per-datapoint
        # flush hot path (the GIL makes the rebind atomic, the same read
        # semantics as the reference's RWMutex).
        merged = dict(self.per_tag_api_keys)
        merged.update(tokens)
        self.per_tag_api_keys = merged
        log.debug("fetched %d signalfx tokens", len(tokens))
        return True

    def _fetch_api_keys(self) -> Dict[str, str]:
        """Paginated GET {api_endpoint}/v2/token until a SHORT page
        (reference signalfx.go:321-344 fetchAPIKeys): each result row
        contributes name → secret. A page under the requested limit is
        the last one — stopping only on an EMPTY page pays one wasted
        round-trip per refresh and spins forever against a server that
        ignores offset; _TOKEN_MAX_PAGES backstops even that."""
        out: Dict[str, str] = {}
        offset = 0
        for _page in range(_TOKEN_MAX_PAGES):
            q = urllib.parse.urlencode({
                "limit": _TOKEN_PAGE_LIMIT, "name": "", "offset": offset})
            req = urllib.request.Request(
                f"{self.api_endpoint}/v2/token?{q}",
                headers={"Content-Type": "application/json",
                         "X-SF-Token": self.api_key})
            with urllib.request.urlopen(req, timeout=10) as resp:
                if resp.status != 200:
                    raise RuntimeError(
                        f"signalfx api returned {resp.status}")
                body = json.loads(resp.read())
            results = body.get("results")
            if not isinstance(results, list):
                raise ValueError(
                    "unknown results structure returned from signalfx api")
            count = 0
            for row in results:
                if not isinstance(row, dict) or \
                        not isinstance(row.get("name"), str) or \
                        not isinstance(row.get("secret"), str):
                    raise ValueError(
                        "unknown result structure returned from "
                        "signalfx api")
                out[row["name"]] = row["secret"]
                count += 1
            if count < _TOKEN_PAGE_LIMIT:
                return out
            offset += _TOKEN_PAGE_LIMIT
        log.warning("signalfx token fetch stopped at the %d-page cap "
                    "with every page full; token list may be truncated",
                    _TOKEN_MAX_PAGES)
        return out

    def _datapoint_from(self, name, ts, value, tags, host):
        """The ONE datapoint serialization both flush paths share."""
        dims = {self.hostname_tag: host or self.hostname}
        for t in self.strip_excluded(tags) + self.common_tags:
            if any(t.startswith(p) for p in self.tag_prefix_drops):
                continue
            k, _, v = t.partition(":")
            if k == _SINK_ONLY_KEY:
                continue  # routing tag, never a dimension (signalfx.go:465
                #           deletes exactly this dimension key)
            dims[k] = v
        return {"metric": name, "value": value,
                "timestamp": int(ts * 1000), "dimensions": dims}

    def _datapoint(self, m: InterMetric):
        return self._datapoint_from(m.name, m.timestamp, m.value, m.tags,
                                    m.hostname)

    def _token_for(self, tags) -> str:
        """vary-by token selection (signalfx.go client fan-out)."""
        if self.vary_key_by:
            prefix = self.vary_key_by + ":"
            for t in tags:
                if t.startswith(prefix):
                    return self.per_tag_api_keys.get(t[len(prefix):],
                                                     self.api_key)
        return self.api_key

    def flush_other_samples(self, samples):
        """DogStatsD events → SignalFx events API (reference
        signalfx.go:501 FlushOtherSamples: only samples carrying the
        vdogstatsd_ev conduit tag are events; everything else is
        ignored)."""
        events = []
        for s in samples:
            tags = dict(s.tags) if s.tags else {}
            if "vdogstatsd_ev" not in tags:
                continue
            events.append(self._event_body(s, tags))
        if events:
            self._post_events(events)

    def _event_body(self, s, tags):
        """One SignalFx event (reference signalfx.go:546-591
        reportEvent): common dims + hostname + sample tags (conduit key
        dropped, excluded tags stripped), name/description truncated at
        256, Datadog markdown fences chopped out of the message."""
        dims = {}
        for t in self.common_tags:
            k, _, v = t.partition(":")
            dims[k] = v
        dims[self.hostname_tag] = self.hostname
        for k, v in tags.items():
            if k != "vdogstatsd_ev":
                dims[k] = v
        for e in getattr(self, "excluded_tags", ()):
            dims.pop(e, None)
        name = (s.name or "")[:EVENT_NAME_MAX_LENGTH]
        # reference order (signalfx.go:563-576): truncate FIRST, then
        # chop the Datadog markdown fences (first occurrence each), then
        # trim — a >256-char message loses its trailing fence to the
        # truncation before the replace could match it
        message = (s.message or "")[:EVENT_DESCRIPTION_MAX_LENGTH]
        message = message.replace("%%% \n", "", 1)
        message = message.replace("\n %%%", "", 1)
        message = message.strip()
        return {
            "eventType": name,
            "category": "USERDEFINED",
            "dimensions": dims,
            "properties": {"description": message},
            "timestamp": int(s.timestamp) * 1000,
        }

    def _post_events(self, events):
        req = urllib.request.Request(
            f"{self.endpoint}/v2/event",
            data=json.dumps(events).encode(), method="POST",
            headers={"Content-Type": "application/json",
                     "X-SF-Token": self.api_key})

        def once():
            with urllib.request.urlopen(req, timeout=10) as resp:
                resp.read()

        try:
            self.resilient_post(once, what="event")
        except Exception as e:
            log.error("signalfx event flush failed: %s", e)

    def flush(self, metrics):
        metrics = filter_acceptable(metrics, self.name)
        self._flush_rows(
            (m.name, m.timestamp, m.value, m.type, m.tags, m.hostname)
            for m in metrics)

    def flush_frame(self, frame):
        """Columnar flush via frame.rows() — identical emission rules,
        no InterMetric materialization (see flusher.MetricFrame)."""
        ts = frame.timestamp
        self._flush_rows(
            (name, ts, value, mtype, tags, host)
            for name, value, mtype, _msg, tags, sinks, host
            in frame.rows()
            if sinks is None or self.name in sinks)

    def _flush_rows(self, rows):
        by_token: Dict[str, Dict[str, list]] = {}
        for name, ts, value, mtype, tags, host in rows:
            if any(name.startswith(p) for p in self.prefix_drops):
                continue
            kind = "counter" if mtype == COUNTER else "gauge"
            body = by_token.setdefault(self._token_for(tags),
                                       {"counter": [], "gauge": []})
            body[kind].append(self._datapoint_from(name, ts, value, tags,
                                                   host))
        for token, body in by_token.items():
            # chunk across BOTH kinds so one POST never exceeds
            # flush_max_per_body total points
            points = ([("counter", p) for p in body["counter"]]
                      + [("gauge", p) for p in body["gauge"]])
            for i in range(0, len(points), self.flush_max_per_body):
                chunk = {"counter": [], "gauge": []}
                for kind, p in points[i:i + self.flush_max_per_body]:
                    chunk[kind].append(p)
                self._post(token, chunk)

    def _post(self, token, body):
        req = urllib.request.Request(
            f"{self.endpoint}/v2/datapoint",
            data=json.dumps(body).encode(), method="POST",
            headers={"Content-Type": "application/json",
                     "X-SF-Token": token})

        def once():
            with urllib.request.urlopen(req, timeout=10) as resp:
                resp.read()

        try:
            self.resilient_post(once, what="datapoint")
        except Exception as e:
            log.error("signalfx flush failed: %s", e)
