"""Sharded aggregation backend: the key table split into S shard tiles
(parallel/sharded.py) behind the Aggregator interface the Server uses.

The key space splits across `n_shards` tiles by the reference's
`Digest % numWorkers` rule (host.py assigns slot = shard·per_shard +
local, so the flattened tiles line up with the KeyTable's global slot
numbers). Each shard has its own staging Batcher; when any shard's lane
fills, every shard emits (padded), so one packed [1, S, W] buffer is one
ingest step over the whole grid (one fused-ingest launch on the card).

The flush gathers the live rows, replica-merges them (at R = 1 the
merge still re-compresses every digest row, as the JAX merged flush
does) and runs the flush math on the merged rows only: the JAX package
runs its flush over every row of every shard and gathers the live rows
after; every output is row-wise, so the results are the same.

Config: tpu_n_shards > 1 (or 0 = one shard per local card when several
are attached).
"""

from __future__ import annotations

import time
from functools import partial
from typing import List, Tuple

import numpy as np
import torch

from veneur_tpu_torch.aggregation.host import Batcher, BatchSpec, KeyTable
from veneur_tpu_torch.aggregation.state import TableSpec, resolve_device
from veneur_tpu_torch.aggregation.step import (
    FLUSH_KEY_KIND, _pack_outputs, batch_sizes, combine_flush_scalars,
    flush_live_shapes, live_slots, pack_batch, pack_bucket_chunks,
    pack_flush_inputs, pad_bucket, unpack_flush)
from veneur_tpu_torch.collective.ops import merge_replica_block
from veneur_tpu_torch.observability.runtime import sync_and_time
from veneur_tpu_torch.parallel.sharded import (
    Layout, flat_view, merged_flush_live, merged_raw_shapes, per_shard_spec,
    sharded_empty_state, sharded_ingest_packed)
from veneur_tpu_torch.server.aggregator import (Aggregator, _PackBuffer,
                                                set_member_bytes)

__all__ = ["ShardedAggregator", "per_shard_spec"]

# staged HLL rows merged per call (register max is order-free, so merging
# in chunks equals one merge at the swap)
_HLL_STAGE_ROWS = 1024

_KINDS = ("counter", "gauge", "status", "set", "histogram")
_RAW_KIND = {"raw_hll": 3, "raw_h_weight": 4, "raw_h_mean": 4,
             "raw_h_min": 4, "raw_h_max": 4, "raw_recip_hi": 4,
             "raw_recip_lo": 4}


class ShardedAggregator(Aggregator):
    # where the flush's raw sketch rows come from: "tile" reads replica
    # row 0 as ingested (the JAX sharded backend's raw gather), "merged"
    # the replica-merged rows
    _raw_from = "tile"

    def __init__(self, spec: TableSpec, bspec: BatchSpec = BatchSpec(),
                 n_shards: int = 2, device=None, compact_every: int = 8,
                 n_replicas: int = 1, group=None):
        self.device = resolve_device(device)
        self.spec = spec            # total capacities (KeyTable slot space)
        self.pspec = per_shard_spec(spec, n_shards)
        self.bspec = bspec
        self.n_shards = n_shards
        self.n_replicas = max(1, int(n_replicas))
        self.layout = Layout(self.n_replicas, n_shards, group)
        self.compact_every = compact_every
        self._sizes = batch_sizes(Batcher(self.pspec, bspec).force_emit())
        self.state = self._empty()
        self.table = self._new_table()
        self.batchers = self._make_batchers()
        self._hll_slots: List[Tuple[int, int]] = []   # (shard, local)
        self._hll_rows: List[np.ndarray] = []
        self._restore_residuals: list = []
        self._pack_bufs: dict = {}
        self._row_bufs = None
        self._steps = 0
        self.processed = 0
        self.dropped_capacity = 0
        self.h2d_bytes = 0
        self.dispatch_ns = 0
        self.step_ns = 0
        self.steps_total = 0
        self.steps_synced = 0
        self._init_degrade()

    def _empty(self):
        return sharded_empty_state(self.pspec, self.layout.r_local,
                                   self.n_shards, self.device)

    def _new_table(self):
        return KeyTable(self.spec, self.n_shards)

    # -- slot routing --------------------------------------------------------
    def _local(self, kind: str, slot: int) -> Tuple[int, int]:
        """global slot -> (shard, local slot); per-kind shard width."""
        per = self.table.tables[KeyTable._table_name(kind)].per_shard
        return slot // per, slot % per

    def process_metric(self, m) -> None:
        kind = m.type
        slot = self.table.slot_for(kind, m.name, m.tags, m.scope, m.digest,
                                   hostname=m.hostname,
                                   joined_tags=m.joined_tags)
        if slot is None:
            self.dropped_capacity += 1
            return
        if kind in ("histogram", "timer"):
            mt = self.table.meta_for_slot(kind, slot)
            if mt is not None and mt.imported_only:
                mt.imported_only = False
        shard, local = self._local(kind, slot)
        b = self.batchers[shard]
        if kind == "counter":
            b.add_counter(local, float(m.value), m.sample_rate)
        elif kind == "gauge":
            b.add_gauge(local, float(m.value))
        elif kind == "status":
            b.add_status(local, float(m.value))
            mt = self.table.meta_for_slot("status", slot)
            if mt is not None:
                mt.message = m.message
        elif kind == "set":
            member = set_member_bytes(m.value)
            if self._set_admit(member):
                b.add_set(local, member)
        elif kind in ("histogram", "timer"):
            # the server's own veneur.* timers are never degraded
            if m.name.startswith("veneur."):
                rate = m.sample_rate
            else:
                rate = self._histo_admit(m.sample_rate)
            if rate is not None:
                b.add_histo(local, float(m.value), rate)
        self.processed += 1

    def import_metric(self, kind: str, name: str, tags: tuple, scope: int,
                      digest: int, payload: dict) -> None:
        slot = self.table.slot_for(kind, name, tags, scope, digest,
                                   imported=True)
        if slot is None:
            self.dropped_capacity += 1
            return
        shard, local = self._local(kind, slot)
        b = self.batchers[shard]
        if kind == "counter":
            b.add_counter(local, float(payload["value"]), 1.0)
        elif kind == "gauge":
            b.add_gauge(local, float(payload["value"]))
        elif kind == "set":
            self._stage_hll(slot, payload["registers"])
        elif kind in ("histogram", "timer"):
            self._stage_digest(b, local, payload)
        self.processed += 1

    # -- checkpoint restore (hooks of Aggregator.restore_metric) -------------
    def _restore_lane(self, kind: str, slot: int):
        shard, local = self._local(kind, slot)
        return self.batchers[shard], local

    def _restore_emit(self) -> None:
        self._emit_all()

    def _stage_hll(self, slot: int, regs) -> None:
        """Stage imported or restored dense registers as (shard, local);
        swap, query_snapshot and restore_flush merge them."""
        regs = np.asarray(regs, np.uint8)
        if regs.shape[0] != self.pspec.registers:
            raise ValueError(
                f"HLL has {regs.shape[0]} registers, table expects "
                f"{self.pspec.registers}")
        self._hll_slots.append(self._local("set", slot))
        self._hll_rows.append(regs)
        if len(self._hll_slots) >= _HLL_STAGE_ROWS:
            self._flush_hll_imports()

    def _flush_hll_imports(self) -> None:
        """Register-max every staged row into replica row 0's packed table,
        in place, touching only the addressed rows. Duplicate (shard,
        local) targets are folded on the host first (np.maximum.at:
        register max is order-free), so the store's targets are unique."""
        if not self._hll_slots:
            return
        from veneur_tpu_torch.ops.hll import merge_rows_packed_
        per = self.pspec.set_capacity
        key = np.asarray([s * per + l for s, l in self._hll_slots],
                         np.int64)
        rows = np.stack(self._hll_rows).astype(np.uint8)
        uniq, inv = np.unique(key, return_inverse=True)
        folded = np.zeros((len(uniq), rows.shape[1]), np.uint8)
        np.maximum.at(folded, inv.reshape(-1), rows)
        hll = self.state.hll[0].view(-1, self.pspec.hll_words)
        merge_rows_packed_(hll, torch.from_numpy(uniq).to(self.device),
                           torch.from_numpy(folded).to(self.device),
                           precision=self.pspec.hll_precision)
        self._hll_slots, self._hll_rows = [], []

    # -- device steps --------------------------------------------------------
    def _make_batchers(self):
        """One staging Batcher per shard; when any shard's lane fills,
        every shard emits (padded), so each step is one rectangular
        [R, S] packed buffer."""
        return [Batcher(self.pspec, self.bspec,
                        on_batch=partial(self._on_shard_batch, i))
                for i in range(self.n_shards)]

    def _grid_buffers(self, words: int) -> list:
        """[buffer, buffer, next index]: two pinned (on the card)
        [r_local, S, words] buffers used in turn."""
        pinned = self.device.type == "cuda"
        return [_PackBuffer((self.layout.r_local, self.n_shards, words),
                            pinned) for _ in range(2)] + [0]

    def _staging_buffers(self) -> list:
        return super()._staging_buffers() + (self._row_bufs or [])[:2]

    def _dispatch_row(self, row, force_compact: bool = False) -> None:
        """Pack each shard's batch into its tile of replica row 0 of the
        next [r_local, S, W] buffer and run one sharded step; compaction
        rides the in-band control word every `compact_every` steps."""
        self._steps += 1
        self.steps_total += 1
        dc = force_compact or self._steps % self.compact_every == 0
        if self._row_bufs is None:
            # every tile holds an all-padding batch once; replica rows
            # past 0 keep it (direct traffic rides row 0)
            pad = pack_batch(Batcher(self.pspec, self.bspec).force_emit())
            self._row_bufs = self._grid_buffers(len(pad))
            for b in self._row_bufs[:2]:
                b.array[:] = pad
        bufs = self._row_bufs
        buf = bufs[bufs[2]]
        bufs[2] ^= 1
        buf.ready()
        buf.array[..., 0] = 1 if dc else 0
        for i, b in enumerate(row):
            pack_batch(b, dc, out=buf.array[0, i])
        self.h2d_bytes += buf.array.nbytes
        t0 = time.perf_counter_ns()
        sharded_ingest_packed(self.state, buf.to(self.device),
                              spec=self.pspec, sizes=self._sizes,
                              do_compact=dc)
        self._count_step(t0)

    def _on_shard_batch(self, shard: int, batch) -> None:
        self._dispatch_row([batch if i == shard else b.force_emit()
                            for i, b in enumerate(self.batchers)])

    def _emit_all(self) -> None:
        if not any(b.pending() for b in self.batchers):
            return
        self._dispatch_row([b.force_emit() for b in self.batchers])

    # -- flush ---------------------------------------------------------------
    def swap(self):
        self._emit_all()
        self._flush_hll_imports()
        if self._steps:
            self.step_ns += sync_and_time(self.state)
            self.steps_synced += 1
        state, table = self.state, self.table
        self.state = self._empty()
        self.table = self._new_table()
        if self._pressure is not None:
            self._pressure.attach(self.table)
        self.batchers = self._make_batchers()
        self._steps = 0
        self._latch_degrade()
        return state, table

    # -- query tier ----------------------------------------------------------
    def query_snapshot(self):
        """Pipeline-thread-only live snapshot (Aggregator.query_snapshot):
        drain every shard's staging batcher and the staged HLL rows, then
        hand out the live state."""
        self._emit_all()
        self._flush_hll_imports()
        return self.state, self.table, self.active_set_shift

    def query_flat_state(self, state):
        """[1, S, K, ...] -> [S·K, ...] views: the KeyTable's global slot
        numbers are flat indices into the shard-major layout."""
        return flat_view(state)

    def _merge_rows(self, rows):
        """The replica merge of the flush's gathered live rows."""
        return merge_replica_block(rows, self.pspec, self.layout.group)

    def compute_flush(self, state, table, percentiles: List[float],
                      want_raw: bool = False, history=None):
        """Flush math on a detached interval: the live rows gathered,
        replica-merged and flushed in one program (K2 once over the
        histogram rows), one packed f32 copy back. Output arrays are
        compact, row i paired with table.get_meta(kind)[i]. With
        want_raw (or `history`, fed from the host as the JAX sharded
        backend feeds it), the live rows' raw sketch state too."""
        perc = percentiles or [0.5]
        spec = self.spec
        caps = (spec.counter_capacity, spec.gauge_capacity,
                spec.status_capacity, spec.set_capacity,
                spec.histo_capacity)
        slots = [live_slots(table, k) for k in _KINDS]
        lens = [len(s) for s in slots]
        buckets = tuple(pad_bucket(n, cap) for n, cap in zip(lens, caps))
        flat = torch.from_numpy(pack_flush_inputs(
            perc, pack_bucket_chunks(slots, buckets, 0))).to(self.device)
        n_q = len(perc)
        qs = flat[:n_q].view(torch.float32)
        idx, off = [], n_q
        for n in buckets:
            idx.append(flat[off:off + n])
            off += n
        need_raw = want_raw or history is not None
        out = merged_flush_live(state, qs, idx, spec=self.pspec,
                                merge=self._merge_rows,
                                raw=self._raw_from if need_raw else None)
        shapes = flush_live_shapes(self.pspec, *buckets, n_q)
        if need_raw:
            shapes.update(merged_raw_shapes(self.pspec, buckets[3],
                                            buckets[4]))
        got = unpack_flush(_pack_outputs(out).cpu().numpy(), shapes)
        got = {k: v[:lens[FLUSH_KEY_KIND.get(k, _RAW_KIND.get(k))]]
               for k, v in got.items()}
        result = combine_flush_scalars(
            {k: v for k, v in got.items() if not k.startswith("raw_")})
        if not need_raw:
            return result, table
        raw = {
            "counter": result["counter"],
            "gauge": result["gauge"],
            "hll": got["raw_hll"],
            "h_mean": got["raw_h_mean"],
            "h_weight": got["raw_h_weight"],
            "h_min": got["raw_h_min"],
            "h_max": got["raw_h_max"],
            "h_recip": (got["raw_recip_hi"].astype(np.float64)
                        + got["raw_recip_lo"]),
        }
        if history is not None:
            # host-fed ring write, as the JAX sharded backend feeds it: the
            # frame the forwarder and archive see
            history.record_frame(table, result, raw)
        if want_raw:
            return result, table, raw
        return result, table
