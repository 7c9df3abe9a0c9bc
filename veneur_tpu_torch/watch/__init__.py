"""Streaming watch tier: standing monitors as one fused device
evaluation per flush interval.

Clients register threshold / delta / quantile / cardinality watches
(Datadog-monitor-shaped: name/prefix/wildcard selector, predicate,
hysteresis band, `for_intervals` debounce) through `POST /watch`; a
compiler packs ALL active watches into one padded evaluation layout in
the flush program's packed-input format, the engine runs it as ONE
`flush_live_in_packed` launch on each flush's detached interval state,
per-watch OK/ALERT/NO_DATA state machines step on the unpacked rows, and
only state TRANSITIONS fan out, over `GET /watch/stream` (SSE, bounded
per-subscriber queues with exact drop accounting) and an optional
webhook. Checkpointing registrations and firing state comes with the
Server's checkpoints (ROADMAP A6).
"""

from veneur_tpu_torch.watch.compiler import (MAX_MATCHES, WatchPlan,
                                             compile_watches, resolve_watch)
from veneur_tpu_torch.watch.engine import WatchEngine
from veneur_tpu_torch.watch.model import (OPS, STATUSES, WATCH_KINDS, Watch,
                                          WatchError, WatchLimitError,
                                          parse_watch)
from veneur_tpu_torch.watch.notify import (StreamHub, Subscriber,
                                           WebhookNotifier)

__all__ = [
    "MAX_MATCHES", "OPS", "STATUSES", "WATCH_KINDS", "Watch",
    "WatchEngine", "WatchError", "WatchLimitError", "WatchPlan",
    "StreamHub", "Subscriber", "WebhookNotifier", "compile_watches",
    "parse_watch", "resolve_watch",
]
