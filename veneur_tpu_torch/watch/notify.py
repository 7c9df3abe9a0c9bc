"""Transition fan-out: SSE stream hub + optional webhook sink.

Only STATE TRANSITIONS leave the watch engine — a watch holding ALERT
across a hundred intervals produces one event, not a hundred — so the
fan-out volume is bounded by alert dynamics, not by watch count.

`StreamHub` backs `GET /watch/stream`: each subscriber owns a bounded
deque; a publisher that finds it full drops the OLDEST queued event
(an SSE consumer that fell behind wants the newest state, and the
at-least-once contract is per TRANSITION STREAM, not per slow reader)
and every drop is counted under `veneur.watch.notify_dropped_total`
labeled with the dropped event's watch kind — exact accounting, one
inc per lost event, asserted by the storm tests.

`WebhookNotifier` rides the ResilientSink harness: the POST runs
under the server's shared retry policy via `resilient_post`, and a
TERMINAL failure (retries exhausted) counts every event in the batch
as dropped. Delivery is therefore at-least-once per transition up to
the configured retry budget, never silently lossy.
"""

from __future__ import annotations

import json
import logging
import threading
import urllib.request
from collections import deque
from typing import List, Optional

from veneur_tpu_torch.sinks.base import ResilientSink

log = logging.getLogger("veneur_tpu_torch.watch")

# per-subscriber queue depth: deep enough to ride a storm burst, small
# enough that an abandoned-but-open stream can't hold a storm's worth
# of event dicts per subscriber
SUBSCRIBER_QUEUE_DEPTH = 256


class Subscriber:
    """One SSE consumer's bounded event queue (drop-oldest)."""

    __slots__ = ("_dq", "_cv", "depth", "dropped")

    def __init__(self, depth: int = SUBSCRIBER_QUEUE_DEPTH) -> None:
        self._dq: deque = deque()
        self._cv = threading.Condition()
        self.depth = max(1, int(depth))
        self.dropped = 0   # this subscriber's exact drop count

    def offer(self, event: dict) -> Optional[dict]:
        """Enqueue; returns the DROPPED event when the queue was full
        (the caller accounts it), else None."""
        with self._cv:
            lost = None
            if len(self._dq) >= self.depth:
                lost = self._dq.popleft()
                self.dropped += 1
            self._dq.append(event)
            self._cv.notify()
            return lost

    def get(self, timeout: float) -> Optional[dict]:
        with self._cv:
            if not self._dq:
                self._cv.wait(timeout)
            if not self._dq:
                return None
            return self._dq.popleft()


class StreamHub:
    """Subscriber registry + transition publisher (engine thread)."""

    def __init__(self, max_subscribers: int, dropped=None,
                 depth: int = SUBSCRIBER_QUEUE_DEPTH) -> None:
        self.max_subscribers = max(1, int(max_subscribers))
        self._dropped = dropped   # veneur.watch.notify_dropped_total
        self._depth = depth
        self._lock = threading.Lock()
        self._subs: List[Subscriber] = []

    def subscribe(self) -> Optional[Subscriber]:
        """None when the subscriber cap is reached (HTTP 503)."""
        with self._lock:
            if len(self._subs) >= self.max_subscribers:
                return None
            sub = Subscriber(self._depth)
            self._subs.append(sub)
            return sub

    def unsubscribe(self, sub: Subscriber) -> None:
        with self._lock:
            try:
                self._subs.remove(sub)
            except ValueError:
                pass

    @property
    def n_subscribers(self) -> int:
        with self._lock:
            return len(self._subs)

    def publish(self, events: List[dict]) -> int:
        """Fan one interval's transitions out to every subscriber.
        Returns the total number of events dropped (all counted)."""
        with self._lock:
            subs = list(self._subs)
        n_dropped = 0
        for sub in subs:
            for ev in events:
                lost = sub.offer(ev)
                if lost is not None:
                    n_dropped += 1
                    if self._dropped is not None:
                        self._dropped.inc(
                            1, kind=lost.get("kind", "threshold"))
        return n_dropped


class WebhookNotifier(ResilientSink):
    """POST one JSON batch of transitions per evaluated interval to
    `watch_webhook_url`, under the server's shared retry/breaker
    harness. Runs on the watch engine thread — a slow webhook delays
    only subsequent WATCH intervals (which drop-oldest with exact
    accounting), never ingest or the flush deadline."""

    name = "watch_webhook"

    def __init__(self, url: str, dropped=None,
                 timeout_s: float = 10.0) -> None:
        self.url = url
        self._dropped = dropped
        self.timeout_s = timeout_s
        self.posts_total = 0
        self.post_failures = 0

    def post_events(self, events: List[dict]) -> bool:
        """True when the batch landed; on terminal failure every event
        counts as dropped (exact accounting) and delivery falls back to
        the SSE stream + the next checkpoint's persisted state."""
        if not events:
            return True
        body = json.dumps({"events": events}).encode()

        def _post():
            req = urllib.request.Request(
                self.url, data=body,
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req,
                                        timeout=self.timeout_s) as resp:
                if resp.status >= 300:
                    raise RuntimeError(f"webhook status {resp.status}")

        try:
            if self.resilience_configured:
                self.resilient_post(_post, what="watch events")
            else:
                _post()
        except Exception as e:  # noqa: BLE001 — terminal failure accounted
            self.post_failures += 1
            if self._dropped is not None:
                for ev in events:
                    self._dropped.inc(
                        1, kind=ev.get("kind", "threshold"))
            log.warning("watch webhook %s failed (%d events dropped, "
                        "counted): %s", self.url, len(events), e)
            return False
        self.posts_total += 1
        return True
