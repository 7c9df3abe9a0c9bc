"""CollectiveGlobalTier: the global aggregation tier resident on the card.

A ShardedAggregator with a real replica axis: co-located local tiers
hand their flush's raw sketch arrays straight to `absorb_raw` (no
protobuf, no gRPC, no wire bytes). Rows are staged into per-(replica
row, source column, owner shard) buckets through the hash-routed
CollectiveKeyTable, the buckets are routed to their owner tiles
(collective/router.py) and applied there by the ordinary ingest step. At
flush time the replica rows merge with the sketch merges of
collective/ops.py.

How the grid maps onto one card. The JAX package runs this over a
(replica, shard) device mesh. Where the shard axis is physical it stages
absorbs into a [R][S_src][S_dest] Batcher grid and exchanges the buckets
with an `all_to_all` over the shard axis; on a mesh collapsed onto
fewer devices it stages every absorb into replica row 0's batchers
instead, which moves each participant's replica row, and with it the
last-write-wins winner. This package keeps the whole logical grid on
its one device and always routes as the physical mesh does: the
all_to_all over the shard axis is a transpose of [R, S_src, S_dest, B]
into [R, S_dest, S_src, B]. So it flushes what the JAX tier flushes on a
mesh with one device per tile (the 8-device test mesh at R = 2, S = 4,
for one).

The envelope/gRPC forward path stays the cross-host path: a local with
a dialed forward client keeps using it; `collective_attach` only
short-circuits the co-located case.

Participant p absorbs into replica row p % R and staging column
(p // R) % S, so N locals spread over the replica rows. Absorb payloads
are what the wire path delivers (forward/convert.py iter_forwardable is
shared with export_metrics), except that HLL rows skip the axiomhq
nibble form, whose tailcut saturates a register spread past 15: the
absorbed union is lossless there, and byte-identical where the spread
fits.

Every staging and in-place device update of the tier (direct metrics
and imports, absorbs, routed and direct steps, the HLL merges, the
swap) runs under one re-entrant lock: absorbs come from the locals'
flush threads while the tier's own pipeline thread ingests, and both
stage into batchers and update the same tensors in place.
"""

from __future__ import annotations

import threading
import time
from functools import partial
from typing import Dict, Optional


from veneur_tpu_torch.aggregation.host import Batcher, BatchSpec
from veneur_tpu_torch.aggregation.state import TableSpec
from veneur_tpu_torch.aggregation.step import packed_layout
from veneur_tpu_torch.collective.keytable import CollectiveKeyTable
from veneur_tpu_torch.collective.router import (merged_state, pack_routed,
                                                routed_ingest)
from veneur_tpu_torch.observability.registry import Timer
from veneur_tpu_torch.observability.runtime import sync_and_time
from veneur_tpu_torch.parallel.sharded import flat_view
from veneur_tpu_torch.server.sharded_aggregator import ShardedAggregator

# -- process-local tier registry -------------------------------------------
# Co-located servers in one process find each other here, by group name
# at flush time, so start order does not matter.
_REGISTRY: Dict[str, "CollectiveGlobalTier"] = {}
_REGISTRY_LOCK = threading.Lock()


def register(group: str, tier: "CollectiveGlobalTier") -> None:
    with _REGISTRY_LOCK:
        _REGISTRY[group] = tier


def lookup(group: str) -> Optional["CollectiveGlobalTier"]:
    with _REGISTRY_LOCK:
        return _REGISTRY.get(group)


def unregister(group: str, tier: "CollectiveGlobalTier") -> None:
    with _REGISTRY_LOCK:
        if _REGISTRY.get(group) is tier:
            del _REGISTRY[group]


class CollectiveGlobalTier(ShardedAggregator):
    def __init__(self, spec: TableSpec, bspec: BatchSpec = BatchSpec(),
                 n_shards: int = 2, n_replicas: int = 1, device=None,
                 compact_every: int = 8, group=None):
        self._absorb_lock = threading.RLock()
        super().__init__(spec, bspec, n_shards, device, compact_every,
                         n_replicas=n_replicas, group=group)
        self._raw_from = "merged" if self.n_replicas > 1 else "tile"
        self._stage_grid = self._make_stage_grid()
        self._routed_bufs = None
        self._next_participant = 0
        self._routed_steps = 0
        self.absorbed_rows = 0
        # always-on phase timers: a private Timer until a host Server
        # injects its registry-owned one (set_phase_timer). Phases: stage
        # (absorb_raw host staging), all_to_all_route (routed step),
        # replica_merge and flush (compute_flush)
        self._phase_timer = Timer(
            "veneur.collective.phase_duration_ns",
            help="collective tier phase wall time by phase (ns)",
            labelnames=("phase",))
        # cross-tier tracing: the last absorb's (trace_id, span_id), so
        # compute_flush's replica_merge span parents onto it
        self._last_absorb = None
        self._trace_client = None

    def _new_table(self):
        return CollectiveKeyTable(self.spec, self.n_shards)

    def set_phase_timer(self, timer) -> None:
        """Adopt a registry-owned phase-duration Timer (the host Server
        registers veneur.collective.phase_duration_ns and injects it)."""
        self._phase_timer = timer

    # -- serialized staging and device updates --------------------------------
    def process_metric(self, m) -> None:
        with self._absorb_lock:
            super().process_metric(m)

    def import_metric(self, *args, **kw) -> None:
        with self._absorb_lock:
            super().import_metric(*args, **kw)

    def _dispatch_row(self, row, force_compact: bool = False) -> None:
        with self._absorb_lock:
            super()._dispatch_row(row, force_compact)

    def _flush_hll_imports(self) -> None:
        with self._absorb_lock:
            super()._flush_hll_imports()

    # -- absorb staging ------------------------------------------------------
    def _make_stage_grid(self):
        return [[[Batcher(self.pspec, self.bspec,
                          on_batch=partial(self._on_stage_batch, r, j, d))
                  for d in range(self.n_shards)]
                 for j in range(self.n_shards)]
                for r in range(self.layout.r_local)]

    def _on_stage_batch(self, r: int, j: int, d: int, batch) -> None:
        """A stage bucket filled mid-absorb: emit the whole grid (the
        routed step is rectangular) with the filled bucket's batch in
        place and every other bucket force-emitted."""
        self._dispatch_routed(
            lambda rr, jj, dd: batch if (rr, jj, dd) == (r, j, d)
            else self._stage_grid[rr][jj][dd].force_emit())

    def _dispatch_routed(self, get) -> None:
        grid = [[[get(r, j, d) for d in range(self.n_shards)]
                 for j in range(self.n_shards)]
                for r in range(self.layout.r_local)]
        if self._routed_bufs is None:
            # an owner tile takes every source column's bucket: S times
            # each lane of a bucket
            self._routed_bufs = self._grid_buffers(packed_layout(
                tuple(n * self.n_shards for n in self._sizes))[1])
        bufs = self._routed_bufs
        buf = bufs[bufs[2]]
        bufs[2] ^= 1
        buf.ready()
        _, sizes = pack_routed(grid, out=buf.array)
        self.h2d_bytes += buf.array.nbytes
        t0 = time.perf_counter_ns()
        routed_ingest(self.state, buf.to(self.device), spec=self.pspec,
                      sizes=sizes)
        self._phase_timer.observe(time.perf_counter_ns() - t0,
                                  phase="all_to_all_route")
        self.steps_total += 1
        self._count_step(t0)
        # absorbed digest rows land in temp cells like any other ingest;
        # compact at the direct path's cadence
        self._routed_steps += 1
        if self._routed_steps % self.compact_every == 0:
            self._dispatch_row([b.force_emit() for b in self.batchers],
                               force_compact=True)

    def _staging_buffers(self) -> list:
        return super()._staging_buffers() + (self._routed_bufs or [])[:2]

    def _emit_absorbed(self) -> None:
        if not any(b.pending() for row in self._stage_grid
                   for cell in row for b in cell):
            return
        self._dispatch_routed(
            lambda r, j, d: self._stage_grid[r][j][d].force_emit())

    # -- absorb with no serialization ----------------------------------------
    def assign_participant(self) -> int:
        """Claim a stable participant id (-> replica row and staging
        column) for a co-located local tier."""
        with self._absorb_lock:
            p = self._next_participant
            self._next_participant += 1
            return p

    def absorb_raw(self, raw, table, participant: Optional[int] = None,
                   parent_span=None, trace_client=None) -> int:
        """Fold a co-located local tier's flush output (raw arrays and its
        detached key table) into the tier. Returns the rows absorbed.
        Thread-safe against other absorbs and the tier's own swap. With
        parent_span (the local's flush.forward span) it emits a
        collective.absorb child span with rows/bytes tags and remembers
        its ids, so compute_flush's replica_merge span parents onto it."""
        from veneur_tpu_torch.forward.convert import iter_forwardable
        span = None
        if parent_span is not None:
            span = parent_span.child("collective.absorb")
            span.set_tag("transport", "colocated")
        with self._absorb_lock:
            if participant is None:
                participant = self._next_participant
                self._next_participant += 1
            r = participant % self.layout.r_local
            j = (participant // self.n_replicas) % self.n_shards
            n = 0
            t0 = time.perf_counter_ns()
            for kind, meta, scope, payload in iter_forwardable(
                    raw, table, self.spec.hll_precision):
                self._absorb_one(r, j, kind, meta, scope, payload)
                n += 1
            self._phase_timer.observe(time.perf_counter_ns() - t0,
                                      phase="stage")
            self.absorbed_rows += n
            if span is not None:
                span.set_tag("rows", str(n))
                span.set_tag("bytes", str(sum(
                    a.nbytes for a in raw.values() if hasattr(a, "nbytes"))))
                self._last_absorb = (span.trace_id, span.id)
                self._trace_client = trace_client
                span.client_finish(trace_client)
            return n

    def _absorb_one(self, r: int, j: int, kind: str, meta, scope: int,
                    payload: dict) -> None:
        slot = self.table.slot_for_routed(
            kind, meta.name, meta.tags, scope, hostname=meta.hostname,
            imported=True, joined_tags=meta.joined_tags)
        if slot is None:
            self.dropped_capacity += 1
            return
        shard, local = self._local(kind, slot)
        b = self._stage_grid[r][j][shard]
        if kind == "counter":
            b.add_counter(local, float(payload["value"]), 1.0)
        elif kind == "gauge":
            b.add_gauge(local, float(payload["value"]))
        elif kind == "set":
            # register rows cannot ride the Batch member lanes; they merge
            # into replica row 0 by register max (order-free)
            self._stage_hll(slot, payload["registers"])
        elif kind in ("histogram", "timer"):
            self._stage_digest(b, local, payload)
        self.processed += 1

    # -- flush ---------------------------------------------------------------
    def swap(self):
        with self._absorb_lock:
            self._emit_absorbed()
            if self._routed_steps and not self._steps:
                # an absorb-only interval: the inherited boundary sync
                # keys off _steps, which routed steps do not count
                self.step_ns += sync_and_time(self.state)
                self.steps_synced += 1
            state, table = super().swap()
            self._stage_grid = self._make_stage_grid()
            self._routed_steps = 0
            return state, table

    # -- query tier ----------------------------------------------------------
    def query_snapshot(self):
        """Absorbed rows staged before the snapshot are part of it too:
        fold them under the absorb lock, then snapshot as the sharded
        backend does."""
        with self._absorb_lock:
            self._emit_absorbed()
            return super().query_snapshot()

    def query_flat_state(self, state):
        """R > 1: merge the replica rows first, so reads see the merged
        sketches, then flatten the shard axis."""
        if self.n_replicas == 1:
            return super().query_flat_state(state)
        merged = merged_state(state, self.pspec, self.layout)
        return flat_view(type(merged)(*[x[None] for x in merged]))

    def compute_flush(self, state, table, percentiles,
                      want_raw: bool = False, history=None):
        """The merged flush, timed as the "flush" phase, with a
        collective.replica_merge span parented onto the last co-located
        absorb (the cross-tier trace: local forward -> absorb -> merge)."""
        from veneur_tpu_torch.trace.tracer import Span
        mspan = None
        if self._last_absorb is not None:
            tid, sid = self._last_absorb
            mspan = Span("collective.replica_merge", service="veneur",
                         trace_id=tid, parent_id=sid)
            mspan.set_tag("replicas", str(self.n_replicas))
        t0 = time.perf_counter_ns()
        try:
            return super().compute_flush(state, table, percentiles,
                                         want_raw, history)
        finally:
            # the flush copies its packed result to the host, so this is
            # the flush's wall time, device work included
            self._phase_timer.observe(time.perf_counter_ns() - t0,
                                      phase="flush")
            if mspan is not None:
                mspan.client_finish(self._trace_client)
                self._last_absorb = None

    def _merge_rows(self, rows):
        """Time the replica merge of the flush's gathered rows (synced)
        as the "replica_merge" phase."""
        t0 = time.perf_counter_ns()
        merged = super()._merge_rows(rows)
        sync_and_time(merged)
        self._phase_timer.observe(time.perf_counter_ns() - t0,
                                  phase="replica_merge")
        return merged
