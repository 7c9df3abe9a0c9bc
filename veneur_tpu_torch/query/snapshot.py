"""Consistent read snapshots of the live aggregation interval.

Everything that mutates live state -- ingest steps and swap() itself --
runs on the ONE pipeline thread, in packet-queue FIFO order. Query-tier
requests are more queue items, which gives the tier:

- **Read-your-writes.** A sample admitted to the packet queue before the
  query's snapshot request is processed first (FIFO, one consumer), so
  its ingest step is enqueued before the query's read. (The native ring
  path pumps rings each dispatch-loop iteration before draining the
  queue, so ring samples get the same guarantee up to one iteration.)
- **No torn reads across the swap.** swap() runs on the same thread: a
  pipeline request runs entirely before it or entirely after it. The
  engine detects a swap between its two visits by table identity (swap()
  installs a fresh key table) and retries, so a response never mixes two
  intervals.
- **Coherent name prefixes.** The key table is append-only within an
  interval, so per-kind meta COUNTS captured on the pipeline thread pin a
  prefix that stays valid for the rest of the interval: resolution
  against it runs off-thread on the captured meta list references
  (CPython list append is atomic) with no lock.

Why TWO pipeline visits instead of one captured state reference: the
ingest kernel updates the live state IN PLACE, so a tensor captured
mid-interval holds whatever later steps wrote into it by the time a read
runs. The read therefore has to be *enqueued from the pipeline thread*:
SnapshotRequest pins the name prefix, the engine resolves slots
off-thread, then a PipelineCall enqueues the flush-program gather on the
pipeline thread's CUDA stream, the stream the ingest steps use, before
any later step. Stream order then makes the gather read exactly the
state as of its visit. The gather writes fresh output tensors, which the
engine copies back on its own thread.

`set_shift` is captured from the aggregator's live degrade ladder
(`active_set_shift`), because the 2^shift set-estimate correction that
the flush applies from the latched shift has not happened yet for a live
interval; the query engine applies it itself.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, List

# canonical per-table count keys; "histo" covers histogram AND timer
# metas (they share a table; SlotMeta.kind tells them apart)
COUNT_TABLES = ("counter", "gauge", "status", "set", "histo")

# KeyTable.get_meta argument per count table
_META_KIND = {"counter": "counter", "gauge": "gauge", "status": "status",
              "set": "set", "histo": "histogram"}


@dataclass
class QuerySnapshot:
    """One coherent naming view of the live interval: the key table,
    per-kind meta list REFERENCES with the prefix lengths that were
    current on the pipeline thread, and the live set_shift. Carries no
    device state (see the module docstring for why)."""
    table: Any
    metas: Dict[str, List[tuple]]
    counts: Dict[str, int]
    set_shift: int = 0


def take_snapshot(aggregator):
    """Pipeline-thread-only: drain staging and pin the naming view;
    returns (live state, QuerySnapshot). The meta lists and counts are
    read here, on the pipeline thread, so the prefix is exactly the
    drained state's key population (on native tables get_meta also
    drains the C++ key records, which is only safe from this thread
    mid-interval)."""
    state, table, set_shift = aggregator.query_snapshot()
    metas = {t: table.get_meta(_META_KIND[t]) for t in COUNT_TABLES}
    counts = {t: len(metas[t]) for t in COUNT_TABLES}
    return state, QuerySnapshot(table=table, metas=metas, counts=counts,
                                set_shift=int(set_shift))


class PipelineRequest:
    """Base for packet-queue items the pipeline thread runs in FIFO
    order, the query tier's FlushRequest analogue. The waiter blocks on
    `done`; `finish(False, ...)` is the dispatch backstop's hook, so an
    internal error never strands an HTTP thread."""

    __slots__ = ("done", "ok", "detail")

    def __init__(self) -> None:
        self.done = threading.Event()
        self.ok = False
        self.detail = ""

    def run(self, aggregator) -> None:  # pragma: no cover - abstract
        raise NotImplementedError

    def finish(self, ok: bool, detail: str = "") -> None:
        self.ok = ok
        self.detail = detail
        self.done.set()

    def wait(self, timeout: float | None = None) -> bool:
        return self.done.wait(timeout)


class SnapshotRequest(PipelineRequest):
    """Visit #1: drain staging and pin the interval's naming view."""

    __slots__ = ("snapshot",)

    def __init__(self) -> None:
        super().__init__()
        self.snapshot: QuerySnapshot | None = None

    def run(self, aggregator) -> None:
        try:
            _state, self.snapshot = take_snapshot(aggregator)
            self.ok = True
        except Exception as e:  # noqa: BLE001 - the waiter must wake
            self.detail = f"snapshot failed: {e}"
        finally:
            self.done.set()


class PipelineCall(PipelineRequest):
    """Visit #2 (and any other pipeline-thread errand): run `fn` on the
    pipeline thread, in FIFO order with ingest and swap, and hand its
    return value back. The query engine uses it to ENQUEUE the device
    gather before any later ingest step updates the live state."""

    __slots__ = ("fn", "result", "exc")

    def __init__(self, fn: Callable[[Any], Any]) -> None:
        super().__init__()
        self.fn = fn
        self.result: Any = None
        self.exc: Exception | None = None

    def run(self, aggregator) -> None:
        try:
            self.result = self.fn(aggregator)
            self.ok = True
        except Exception as e:  # noqa: BLE001 - the waiter must wake
            self.exc = e
            self.detail = f"pipeline call failed: {e}"
        finally:
            self.done.set()
