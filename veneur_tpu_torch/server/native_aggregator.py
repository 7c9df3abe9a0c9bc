"""Native-ingest aggregation backend: the default config's ingest path.

Wire packets are parsed, keyed and staged entirely in C++ (the port's
copy of the engine, veneur_tpu_torch/native/dogstatsd.cpp), which writes
each batch straight into a pinned host buffer in the packed layout of
aggregation/step.py; the Python side only ships full buffers to the
device and runs the ingest step. Python-originated samples (service
checks, escalated specials) share the same slot space through
vt_slot_for and stage through the ordinary Python Batcher, so both
batch streams feed the same step.

Slot metadata (SlotMeta for flush labelling) is rebuilt lazily from the
engine's new-key records; status checks keep a Python table (they never
ride the native wire path's kinds).

Documented deviations, as in the JAX package's native backend:

- Gauge last-write-wins is per stream: when one gauge key arrives both
  over the wire (native staging) and through a Python-side path in one
  interval, the native batch lands first and the Python batch second, so
  the Python-side write wins whatever the arrival order. The
  single-stream case is exactly ordered.
- An empty tag section (`|#`) and no section both join to "" in the C++
  key record, so such a key's label has no tags where the Python path
  would keep [""] when the empty section arrived first.
- A histo slot first created by the import path and later hit by wire
  samples keeps imported_only=True for the interval (the engine does not
  report which slots the wire hit), so a global tier flushes only its
  percentiles.
- A corrupt MetricList tail is a partial apply: import_pb_bytes stages
  incrementally, so the metrics decoded before the undecodable boundary
  are merged when the tail is dropped and counted, where the Python
  path's whole-request deserialize rejects all of them.

The global tier's gRPC import decodes serialized MetricLists in the
engine (`import_pb_bytes`, the engine's vi_import): counters, gauges and
digest centroids stage natively, the digests' exact min/max/reciprocal
sums drain into the Python Batcher's stats lanes, and sets, valueless
metrics and oneof/type mismatches take the Python `import_into` path.
"""

from __future__ import annotations

import logging
import time
from typing import List

import numpy as np

from veneur_tpu_torch.aggregation.host import (BatchSpec, KeyTable, SlotMeta,
                                               _KindTable)
from veneur_tpu_torch.aggregation.state import TableSpec
from veneur_tpu_torch.aggregation.step import (packed_layout,
                                               packed_rings_core,
                                               packed_step_core)
from veneur_tpu_torch.native import NativeIngest
from veneur_tpu_torch.parallel.sharded import KIND_CAPACITY
from veneur_tpu_torch.server.aggregator import Aggregator, _PackBuffer
from veneur_tpu_torch.server.sharded_aggregator import ShardedAggregator

log = logging.getLogger("veneur_tpu_torch.server.native_aggregator")

# the ten lanes the C++ engine stages, in vt_emit_packed's argument order;
# the status and histo_stat lanes between them stay Python-owned
_NATIVE_LANES = ("counter_slot", "counter_inc", "gauge_slot", "gauge_val",
                 "set_slot", "set_reg", "set_rho", "histo_slot", "histo_val",
                 "histo_wt")


class NativeKeyTable:
    """KeyTable facade over the C++ slot maps + a Python status table."""

    def __init__(self, spec: TableSpec, eng: NativeIngest, n_shards: int = 1):
        self.spec = spec
        self.eng = eng
        self.n_shards = n_shards
        self.status = _KindTable(spec.status_capacity, n_shards)
        # drained metadata: kind-table name -> [(slot, SlotMeta)]
        self.meta = {"counter": [], "gauge": [], "set": [], "histo": []}
        self.by_slot = {"counter": {}, "gauge": {}, "set": {}, "histo": {}}
        self._finalized = False

    _TABLE = staticmethod(KeyTable._table_name)

    def _drain(self):
        if self._finalized:
            return
        for kind, slot, scope, name, joined, imported in \
                self.eng.drain_new_keys():
            tname = self._TABLE(kind)
            if slot in self.by_slot[tname]:
                # registered Python-side with the exact tag tuple already
                continue
            # flush labels use the FIRST arrival's tags (the reference's
            # one sampler per MetricKey)
            m = SlotMeta(name=name,
                         tags=tuple(joined.split(",")) if joined else (),
                         scope=scope, kind=kind, joined_tags=joined,
                         imported_only=imported)
            self.meta[tname].append((slot, m))
            self.by_slot[tname][slot] = m

    def slot_for(self, kind: str, name: str, tags: tuple, scope: int,
                 digest: int, hostname: str = "", imported: bool = False,
                 joined_tags=None):
        if kind == "status":
            # joined-string identity, as host.py KeyTable and the engine
            key = (kind, name, joined_tags if joined_tags is not None
                   else ",".join(tags))
            slot = self.status.by_key.get(key)
            if slot is not None:
                return slot
            return self.status.alloc(key, digest, name, tags, scope, kind,
                                     hostname=hostname)
        joined = joined_tags if joined_tags is not None else ",".join(tags)
        slot, was_new = self.eng.slot_for(kind, name, joined, scope, digest)
        if slot is not None and was_new:
            # register the exact tuple now: tags from other sources may
            # contain commas, which a joined-string round trip would split
            tname = self._TABLE(kind)
            m = SlotMeta(name=name, tags=tags, scope=scope, kind=kind,
                         hostname=hostname, imported_only=imported,
                         joined_tags=joined)
            self.meta[tname].append((slot, m))
            self.by_slot[tname][slot] = m
        return slot

    def get_meta(self, kind: str):
        self._drain()
        if kind == "status":
            return self.status.meta
        return self.meta[self._TABLE(kind)]

    def meta_for_slot(self, kind: str, slot: int):
        if kind == "status":
            return self.status.by_slot.get(slot)
        self._drain()
        return self.by_slot[self._TABLE(kind)].get(slot)

    def dropped(self) -> int:
        return self.eng.stats()["dropped"] + self.status.dropped

    def finalize(self):
        """Detach: absorb the remaining key records and stop draining (the
        engine's maps are about to be reset for the next interval)."""
        self._drain()
        self._finalized = True


class NativeAggregator(Aggregator):
    """Aggregator whose wire ingest runs in the C++ engine. `device=None`
    means the card (and raises without one); `engine` hands over a
    running NativeIngest, whose reader threads keep feeding it."""

    def __init__(self, spec: TableSpec, bspec: BatchSpec = BatchSpec(),
                 device=None, compact_every: int = 8, engine=None):
        super().__init__(spec, bspec, device, compact_every)
        self.eng = engine if engine is not None else NativeIngest(spec, bspec)
        self.table = NativeKeyTable(spec, self.eng)
        self._alloc_packed_buffers()
        if self.eng.n_rings:
            # a handed-over engine whose rings already run: rings_start,
            # which allocates the ring arenas, will not run again
            self._alloc_ring_arenas(self.eng.n_rings)

    # -- packed buffers ------------------------------------------------------
    def _alloc_packed_buffers(self):
        """Two pinned host buffers in the packed layout that the C++ engine
        fills in place, used in turn (the engine stages batch N+1 while
        batch N's copy may still read the other). All 16 lanes are present
        at the Python Batcher's sizes; the status and histo_stat lanes
        never ride the native wire path and stay constant sentinel
        regions that C++ never touches."""
        b = self.bspec
        # lane sizes in Batch._fields order
        self._pk_sizes = (b.counter, b.counter, b.gauge, b.gauge,
                          b.status, b.status, b.set, b.set, b.set,
                          b.histo, b.histo, b.histo,
                          b.histo_stat, b.histo_stat, b.histo_stat,
                          b.histo_stat)
        layout, words = packed_layout(self._pk_sizes)
        self._pk_layout = layout
        self._pk_offs = np.asarray([layout[n][0] for n in _NATIVE_LANES],
                                   np.int32)
        self._pk_bufs = [self._new_buffer(words) for _ in range(2)]
        # per-buffer staged-row counts of that buffer's previous emit:
        # vt_emit_packed's incremental sentinel-restore bound
        self._pk_prev = [np.zeros(4, np.uint32) for _ in range(2)]
        self._pk_idx = 0

    def _alloc_ring_arenas(self, n_rings: int):
        """Two pinned (rings, words) arenas, one packed row per ring, used
        in turn like the single-ring pair: every ring's emit lands in its
        own row and the whole arena crosses to the device in one copy a
        step. Each row keeps its own previous counts."""
        words = packed_layout(self._pk_sizes)[1]
        self._rg_bufs = [self._new_buffer((n_rings, words))
                         for _ in range(2)]
        self._rg_prev = [np.zeros((n_rings, 4), np.uint32) for _ in range(2)]
        self._rg_idx = 0

    def _staging_buffers(self) -> list:
        return (super()._staging_buffers() + self._pk_bufs
                + getattr(self, "_rg_bufs", []))

    def _new_buffer(self, shape) -> _PackBuffer:
        """A pinned (on the card) packed buffer, every row filled with
        sentinels once. Afterwards it is never zeroed or reallocated:
        vt_emit_packed keeps its sentinels incrementally from the bytes
        of the buffer's previous emit."""
        buf = _PackBuffer(shape, self.device.type == "cuda")
        for row in buf.array.reshape(-1, buf.array.shape[-1]):
            self._init_packed_sentinels(row)
        return buf

    def _init_packed_sentinels(self, flat):
        """Every slot lane at its table capacity (dropped rows), weights 0,
        histo-stat min/max at +/-inf: the state Batcher.emit keeps its
        lanes in on the Python path."""
        spec = self.spec

        def lane(name, value, f32=False):
            off, n, _ = self._pk_layout[name]
            view = flat[off:off + n]
            (view.view(np.float32) if f32 else view)[:] = value

        lane("counter_slot", spec.counter_capacity)
        lane("gauge_slot", spec.gauge_capacity)
        lane("set_slot", spec.set_capacity)
        lane("histo_slot", spec.histo_capacity)
        lane("status_slot", spec.status_capacity)
        lane("histo_stat_slot", spec.histo_capacity)
        lane("histo_stat_min", np.inf, f32=True)
        lane("histo_stat_max", -np.inf, f32=True)

    def _begin_step(self, buf: _PackBuffer) -> bool:
        """Count one step whose batch `buf` holds, set its control word;
        returns the compaction flag."""
        self._steps += 1
        self.steps_total += 1
        do_compact = self._steps % self.compact_every == 0
        buf.array.reshape(-1)[0] = 1 if do_compact else 0
        self.h2d_bytes += buf.array.nbytes
        return do_compact

    # -- wire path -----------------------------------------------------------
    def feed(self, data: bytes) -> List[bytes]:
        """Parse a packet buffer natively; returns escalated event and
        service-check lines for the caller's Python parser. A lane-full
        stop resumes at the consumed offset: the buffer is never
        re-sliced."""
        full, off = self.eng.feed(data)
        while full:
            self._emit_native()
            full, off = self.eng.feed(data, off)
        return self.eng.drain_specials()

    def _emit_native(self) -> None:
        """Emit the engine's staging into the next packed buffer and run
        one ingest step on it (none when nothing was staged)."""
        idx = self._pk_idx
        buf = self._pk_bufs[idx]
        buf.ready()
        nc, ng, ns, nh = self.eng.emit_packed(buf.array, self._pk_offs,
                                              self._pk_prev[idx])
        if nc + ng + ns + nh == 0:
            return
        self._pk_idx = 1 - idx
        do_compact = self._begin_step(buf)
        t0 = time.perf_counter_ns()
        packed_step_core(self.state, buf.to(self.device), spec=self.spec,
                         sizes=self._pk_sizes, do_compact=do_compact)
        self._count_step(t0)

    def extra_parse_errors(self) -> int:
        return self.eng.stats()["parse_errors"]

    # -- native import path (global tier) ------------------------------------
    def import_pb_bytes(self, data: bytes):
        """Decode and stage a serialized forwardrpc.MetricList with the
        engine (the reference's importsrv SendMetrics). Counters, gauges
        and digests stage natively; sets, valueless metrics and oneof/type
        mismatches fall back to the Python import_into path, so error
        accounting follows the reference's per-metric rules. Returns
        (metrics, errors)."""
        from veneur_tpu_torch.forward.convert import import_into
        from veneur_tpu_torch.proto import metricpb_pb2 as mpb
        total = 0
        errors = 0
        off = 0
        while off < len(data):
            staged, new_off, spans, lane_full = \
                self.eng.import_metriclist(data, off)
            total += staged + len(spans)
            for so, sl in spans:
                try:
                    import_into(self, mpb.Metric.FromString(
                        data[so:so + sl]))
                except Exception as e:
                    errors += 1
                    log.warning("bad imported metric (native path): %s", e)
            if new_off >= len(data):
                break
            if not lane_full and new_off == off and staged == 0 \
                    and not spans:
                # undecodable at a top-level boundary, not a lane stop:
                # count one error and drop the rest (the Python
                # deserializer would reject the whole request)
                errors += 1
                log.warning("undecodable MetricList tail at offset %d "
                            "(%d bytes dropped)", off, len(data) - off)
                break
            # staging (or the fallback span buffer) filled: free the
            # lanes, then re-enter at the reported boundary
            self._emit_native()
            off = new_off
        # the digests' exact min/max/recip ride the Python stats lanes;
        # min, max and the add do not depend on the centroids' steps
        slots, mns, mxs, rcs = self.eng.drain_import_stats()
        if len(slots):
            self.batcher.add_histo_stats_bulk(slots, mns, mxs, rcs)
        return total, errors

    # -- native UDP reader group ---------------------------------------------
    def readers_start(self, fds, max_len: int = 65536,
                      ring_cap: int = 65536, n_rings: int = 1,
                      pin_cores=None, force_rings: bool = False) -> None:
        """Start the native readers. n_rings == 1 keeps the single-ring
        vr_* engine (N reader threads -> one ring -> this thread's pump);
        n_rings > 1 starts the multi-ring vrm_* engine: one ring + parser
        + arena row per reader core, fds spread round-robin (each
        SO_REUSEPORT fd owns its ring), optional core pinning per ring.
        force_rings takes even one ring through the vrm engine, where
        tenant fairness lives."""
        if n_rings <= 1 and not force_rings:
            self.eng.readers_start(fds, max_len=max_len, ring_cap=ring_cap)
            return
        # every fd must own a ring: more sockets than configured rings
        # grows the ring count rather than orphaning listeners
        n_rings = max(n_rings, len(fds) if fds else 0)
        self.rings_start(n_rings, fds=fds, max_len=max_len,
                         ring_cap=ring_cap, pin_cores=pin_cores)

    def rings_start(self, n_rings: int, fds=None, max_len: int = 65536,
                    ring_cap: int = 65536, pin_cores=None) -> None:
        """Start the multi-ring engine (fd-less rings take rings_inject
        only) and allocate its arena pair."""
        self.eng.rings_start(n_rings, fds=fds, max_len=max_len,
                             ring_cap=ring_cap, pin_cores=pin_cores)
        self._alloc_ring_arenas(n_rings)

    def _emit_rings(self) -> bool:
        """Drain every ring's staging into the current arena's rows and run
        ONE step (packed_rings_core) over the whole arena. Returns False,
        with no step, when every ring was empty. The control word rides
        row 0 only."""
        idx = self._rg_idx
        arena = self._rg_bufs[idx]
        arena.ready()
        prev = self._rg_prev[idx]
        total = 0
        for r in range(self.eng.n_rings):
            total += sum(self.eng.rings_emit(r, arena.array[r],
                                             self._pk_offs, prev[r]))
        if total == 0:
            return False
        self._rg_idx = 1 - idx
        do_compact = self._begin_step(arena)
        t0 = time.perf_counter_ns()
        packed_rings_core(self.state, arena.to(self.device), spec=self.spec,
                          sizes=self._pk_sizes, do_compact=do_compact)
        self._count_step(t0)
        return True

    def pump(self, max_wait_ms: int, max_emits: int = 8) -> List[bytes]:
        """Drain the C++ datagram ring(s) into staging (GIL released while
        idle), emitting device batches whenever a lane fills. Bounded, so
        that under sustained overload the caller's loop still gets back to
        its flush requests. Returns escalated event/service-check lines."""
        if self.eng.n_rings:
            self.eng.rings_wait(max_wait_ms)
            for _ in range(max_emits):
                if not self._emit_rings():
                    break
            return self.eng.drain_specials()
        full, _st = self.eng.pump(max_wait_ms)
        for _ in range(max_emits):
            if not full:
                break
            self._emit_native()
            full, _st = self.eng.pump(0)
        if full:
            # leave staging drained so the next call ingests at once
            self._emit_native()
        return self.eng.drain_specials()

    def reader_counters(self) -> dict:
        return self.eng.reader_counters()

    def ring_stats(self) -> dict:
        """Ring/emit telemetry: depth, high-water, pump batches/stalls,
        emit_packed call/ns totals (exact cross-ring sums with rings)."""
        return self.eng.ring_stats()

    def ring_stats_per_ring(self) -> List[dict]:
        return self.eng.ring_stats_per_ring()

    def admission_set(self, enabled: bool, state: int, rate: float,
                      burst: float, high_tags) -> None:
        """Push statsd admission knobs into the C++ reader ring(s)."""
        self.eng.admission_set(enabled, state, rate, burst, high_tags)

    def admission_drain(self) -> dict:
        """Exact per-class {admitted, shed} deltas since the last drain."""
        return self.eng.admission_drain()

    # -- tenant fairness and quarantine push-down ----------------------------
    def tenant_config(self, *a, **kw) -> None:
        """One-shot tenant-table creation; must land before rings start."""
        self.eng.tenant_config(*a, **kw)

    def tenant_params(self, base_rate: float, weights) -> None:
        self.eng.tenant_params(base_rate, weights)

    def tenant_table(self) -> dict:
        return self.eng.tenant_table()

    def tenant_restore(self, entries) -> int:
        return self.eng.tenant_restore(entries)

    def tenant_rows_drain(self) -> dict:
        return self.eng.tenant_rows_drain()

    def set_tenant(self, name: str) -> None:
        """Parse context of the feed path: later feed() calls parse as
        tenant `name` (empty: the default tenant)."""
        self.eng.set_tenant(name)

    # -- key-table growth ----------------------------------------------------
    def table_stats(self) -> dict:
        """{kind: (allocated, cumulative dropped, capacity)} of the
        engine's four key tables."""
        return self.eng.table_stats()

    def readers_stop(self) -> None:
        self.eng.readers_stop()

    # `processed` and `dropped_capacity` span both ingest paths: the C++
    # engine's counts plus the Python-side samples and drops
    def _native_stat(self, key: str) -> int:
        return self.eng.stats()[key] if hasattr(self, "eng") else 0

    @property
    def processed(self):
        return self._py_processed + self._native_stat("processed")

    @processed.setter
    def processed(self, v):
        self._py_processed = v - self._native_stat("processed")

    @property
    def dropped_capacity(self):
        return self._py_dropped + self._native_stat("dropped")

    @dropped_capacity.setter
    def dropped_capacity(self, v):
        self._py_dropped = v - self._native_stat("dropped")

    # -- flush ---------------------------------------------------------------
    def swap(self):
        rings = bool(self.eng.n_rings)
        if rings:
            # quiesce: no ring worker parses between here and resume, so
            # staged rows cannot race the table reset below; datagrams
            # parsed after the resume land in the next interval
            self.eng.rings_pause()
            self._emit_rings()
        self._emit_native()
        detached = self.table
        detached.finalize()
        state, _ = super().swap()
        # super() put a Python KeyTable in place; the engine keeps the
        # slot space, so re-wrap it after the reset
        self.eng.reset()
        self.table = NativeKeyTable(self.spec, self.eng)
        if rings:
            self.eng.rings_resume()
        return state, detached

    def query_snapshot(self):
        """Live snapshot: emit the engine's staged rows first, from the
        single reader and from every ring. The rings are not paused:
        nothing resets here, so a datagram parsed after this instant
        lands after the snapshot (the ring path's analogue of the packet
        queue's FIFO order)."""
        if self.eng.n_rings:
            self._emit_rings()
        self._emit_native()
        return super().query_snapshot()


class NativeShardedAggregator(ShardedAggregator):
    """The sharded backend fed by the C++ parse/key/stage engine.

    The engine's slot space is shard-aware (dogstatsd.cpp KindTable:
    slot = shard·per_shard + local, the host.py rule), so its emitted
    global slots split into (shard, local) with two vectorised numpy ops
    and bulk-copy into the per-shard staging batchers. With `preshard`
    the engine emits the rows already grouped by owner shard with
    shard-local slots (vt_emit_sharded), and the batchers take contiguous
    slices. Reader rings drain through the pre-sharded emit only, ring 0
    first, each ring's rows staged into the batchers in turn, as the JAX
    package's sharded backend drains them: which step a row lands in,
    and so a digest's bytes, follow that order."""

    def __init__(self, spec: TableSpec, bspec: BatchSpec = BatchSpec(),
                 n_shards: int = 2, device=None, compact_every: int = 8,
                 preshard: bool = False, engine=None):
        super().__init__(spec, bspec, n_shards, device, compact_every)
        # a handed-over engine (table growth) keeps its readers running
        self.eng = engine if engine is not None \
            else NativeIngest(spec, bspec, n_shards)
        self.table = NativeKeyTable(spec, self.eng, n_shards)
        self._py_processed = 0
        self._py_dropped = 0
        self.preshard = preshard
        self._ps_bounds = np.zeros(4 * (n_shards + 1), np.int32)
        b = bspec
        # emit targets for the ten native lanes; rows past each emit's
        # counts are never read
        self._lanes = (np.empty(b.counter, np.int32),
                       np.zeros(b.counter, np.float32),
                       np.empty(b.gauge, np.int32),
                       np.zeros(b.gauge, np.float32),
                       np.empty(b.set, np.int32), np.zeros(b.set, np.int32),
                       np.zeros(b.set, np.uint8),
                       np.empty(b.histo, np.int32),
                       np.zeros(b.histo, np.float32),
                       np.zeros(b.histo, np.float32))

    # engine-backed stats and the engine's push-downs, as NativeAggregator
    _native_stat = NativeAggregator._native_stat
    processed = NativeAggregator.processed
    dropped_capacity = NativeAggregator.dropped_capacity
    extra_parse_errors = NativeAggregator.extra_parse_errors
    feed = NativeAggregator.feed
    readers_start = NativeAggregator.readers_start
    reader_counters = NativeAggregator.reader_counters
    ring_stats = NativeAggregator.ring_stats
    ring_stats_per_ring = NativeAggregator.ring_stats_per_ring
    admission_set = NativeAggregator.admission_set
    admission_drain = NativeAggregator.admission_drain
    tenant_config = NativeAggregator.tenant_config
    tenant_params = NativeAggregator.tenant_params
    tenant_table = NativeAggregator.tenant_table
    tenant_restore = NativeAggregator.tenant_restore
    tenant_rows_drain = NativeAggregator.tenant_rows_drain
    set_tenant = NativeAggregator.set_tenant
    table_stats = NativeAggregator.table_stats
    readers_stop = NativeAggregator.readers_stop

    def _local(self, kind: str, slot: int):
        """global slot -> (shard, local): the per-shard spec's widths, the
        engine's own allocation rule (a NativeKeyTable has no .tables)."""
        per = getattr(self.pspec,
                      KIND_CAPACITY[KeyTable._table_name(kind)])
        return slot // per, slot % per

    def _split_shards(self, global_slots, per_shard):
        """One-pass shard split of a staged slot lane: a stable argsort
        groups rows by shard (keeping arrival order within a shard, which
        gauge last-write depends on) and searchsorted finds each shard's
        [start, end). Returns (order, local slots in that order, bounds)."""
        sh = global_slots // per_shard
        order = np.argsort(sh, kind="stable")
        lo = (global_slots - sh * per_shard).astype(np.int32, copy=False)
        bounds = np.searchsorted(sh, np.arange(self.n_shards + 1),
                                 sorter=order)
        return order, lo[order], bounds

    # (batcher method, lane indexes into self._lanes) per kind, in the
    # emit's counter/gauge/set/histo order
    _KIND_LANES = (("add_counters_bulk", (0, 1)),
                   ("add_gauges_bulk", (2, 3)),
                   ("add_sets_bulk", (4, 5, 6)),
                   ("add_histos_bulk", (7, 8, 9)))

    def _stage_presharded(self, counts) -> None:
        """Bulk-copy a pre-sharded emit (rows grouped by owner shard,
        slots shard-local, per-kind bounds in _ps_bounds) into the
        per-shard batchers: contiguous slices only."""
        s = self.n_shards
        for k, (n, (method, lanes)) in enumerate(zip(counts,
                                                     self._KIND_LANES)):
            if not n:
                continue
            at = self._ps_bounds[k * (s + 1):(k + 1) * (s + 1)]
            for i in range(s):
                if at[i + 1] > at[i]:
                    getattr(self.batchers[i], method)(
                        *[self._lanes[j][at[i]:at[i + 1]] for j in lanes])

    def _emit_native(self) -> None:
        if self.preshard:
            counts = self.eng.emit_sharded(self._lanes, self._ps_bounds)
            if sum(counts):
                self._stage_presharded(counts)
            return
        counts = self.eng.emit_into(self._lanes)
        p = self.pspec
        for n, cap, (method, lanes) in zip(
                counts, (p.counter_capacity, p.gauge_capacity,
                         p.set_capacity, p.histo_capacity),
                self._KIND_LANES):
            if not n:
                continue
            order, lo, at = self._split_shards(self._lanes[lanes[0]][:n],
                                               cap)
            vals = [self._lanes[j][:n][order] for j in lanes[1:]]
            for i in range(self.n_shards):
                if at[i + 1] > at[i]:
                    getattr(self.batchers[i], method)(
                        lo[at[i]:at[i + 1]],
                        *[v[at[i]:at[i + 1]] for v in vals])

    # -- multi-ring reader group ---------------------------------------------
    def rings_start(self, n_rings: int, fds=None, max_len: int = 65536,
                    ring_cap: int = 65536, pin_cores=None) -> None:
        self.eng.rings_start(n_rings, fds=fds, max_len=max_len,
                             ring_cap=ring_cap, pin_cores=pin_cores)

    def _emit_rings(self) -> bool:
        emitted = False
        for r in range(self.eng.n_rings):
            counts = self.eng.rings_emit_sharded(r, self._lanes,
                                                 self._ps_bounds)
            if sum(counts):
                self._stage_presharded(counts)
                emitted = True
        return emitted

    def pump(self, max_wait_ms: int, max_emits: int = 8) -> List[bytes]:
        """Drain the reader ring(s) into the per-shard batchers (bounded
        as NativeAggregator.pump is)."""
        if self.eng.n_rings:
            self.eng.rings_wait(max_wait_ms)
            for _ in range(max_emits):
                if not self._emit_rings():
                    break
            return self.eng.drain_specials()
        full, _st = self.eng.pump(max_wait_ms)
        for _ in range(max_emits):
            if not full:
                break
            self._emit_native()
            full, _st = self.eng.pump(0)
        if full:
            self._emit_native()
        return self.eng.drain_specials()

    def swap(self):
        rings = bool(self.eng.n_rings)
        if rings:
            self.eng.rings_pause()
            self._emit_rings()
        self._emit_native()
        detached = self.table
        detached.finalize()
        state, _ = super().swap()
        self.eng.reset()
        self.table = NativeKeyTable(self.spec, self.eng, self.n_shards)
        if rings:
            self.eng.rings_resume()
        return state, detached

    def query_snapshot(self):
        """NativeAggregator.query_snapshot's discipline over the per-shard
        staging batchers."""
        if self.eng.n_rings:
            self._emit_rings()
        self._emit_native()
        return super().query_snapshot()
