"""Single-device aggregation backend: key table + batcher + device state.

The glue between parsed UDPMetrics and the ingest step, in the role of the
reference's worker goroutines. Every full batch is packed into one i32
buffer, copied to the device once and applied by the ingest step
(aggregation/step.py packed_step_core), which re-compresses the digests
every `compact_every` steps. `swap` detaches the interval's state and key
table and starts fresh ones; `compute_flush` turns a detached interval
into per-key numpy values.

The global tier's import path (`import_metric`) and checkpoint restore
(`restore_metric` + `restore_flush`) stage through the same lanes as
live samples: counters and gauges in their lanes, an imported digest's
centroids as weighted samples in the histogram lane with its exact
min/max/reciprocal sum in the histo_stat lanes, so every one of them is
applied by the ingest step (K1 on the card). Imported HLL sketches are
register-maxed into the packed table (ops/hll.py merge_rows_packed_),
drained at `swap` and `query_snapshot`.
"""

from __future__ import annotations

import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from veneur_tpu_torch.aggregation.host import Batcher, BatchSpec, KeyTable
from veneur_tpu_torch.aggregation.state import (TableSpec, empty_state,
                                                resolve_device)
from veneur_tpu_torch.aggregation.step import (
    FLUSH_BLOCK_ROWS, FLUSH_KEY_KIND, batch_sizes, combine_flush_scalars,
    flush_live_hist_packed, flush_live_in_packed, flush_live_shapes,
    live_slots, pack_batch, pack_bucket_chunks, pack_flush_inputs,
    packed_layout, packed_step_core, pad_bucket, unpack_flush)
from veneur_tpu_torch.history.writer import SENTINEL
from veneur_tpu_torch.observability.runtime import sync_and_time
from veneur_tpu_torch.samplers.parser import UDPMetric
from veneur_tpu_torch.utils.hashing import fnv1a_64, splitmix64

# every _SYNC_EVERY-th ingest step waits for the card, so step_ns holds
# synced step times while the other steps pay only their enqueue
_SYNC_EVERY = 64

# staged HLL import/restore rows merged into the packed table per call
_HLL_MERGE_ROWS = 128


def set_member_bytes(value) -> bytes:
    """A set member's wire bytes: surrogateescape restores non-UTF-8
    member bytes exactly as the parser decoded them (a plain encode()
    would raise on them)."""
    return value if isinstance(value, bytes) else str(value).encode(
        "utf-8", "surrogateescape")


class _PackBuffer:
    """One host staging buffer for packed batches (i32[words], or one row
    per reader ring). On the card it is pinned, and `copied` is the event
    recorded after the non-blocking copy out of it: the buffer is not
    written again before that event completes (`ready`), or the copy
    could read a half-rewritten batch."""

    def __init__(self, shape, pinned: bool):
        self.host = torch.zeros(shape, dtype=torch.int32, pin_memory=pinned)
        self.array = self.host.numpy()
        self.copied = None

    def ready(self) -> None:
        """Wait until the last copy out of this buffer has read it."""
        if self.copied is not None:
            # vtlint: disable=torch-hot-path -- double-buffer reuse: waits only for the copy out of this pinned buffer two batches back (backpressure on a backlogged card, not a drain)
            self.copied.synchronize()

    def to(self, device: torch.device) -> torch.Tensor:
        """The buffer on `device`: a non-blocking copy from pinned memory
        on the card (recording `copied`), the buffer itself on the CPU."""
        if device.type != "cuda":
            return self.host.to(device)
        flat = self.host.to(device, non_blocking=True)
        self.copied = torch.cuda.Event()
        self.copied.record()
        return flat


class Aggregator:
    # optional tables.pressure.TablePressure shared across intervals (the
    # Python key tables only: the C++ engine keeps exact counted drops)
    _pressure = None

    def __init__(self, spec: TableSpec, bspec: BatchSpec = BatchSpec(),
                 device=None, compact_every: int = 8):
        self.device = resolve_device(device)
        self.spec = spec
        self.bspec = bspec
        self.compact_every = compact_every
        self.table = KeyTable(spec)
        self.batcher = Batcher(spec, bspec, on_batch=self._on_batch)
        self.state = empty_state(spec, self.device)
        self._steps = 0
        self.processed = 0
        self.dropped_capacity = 0
        self.h2d_bytes = 0       # packed ingest bytes shipped to the device
        self.steps_total = 0     # monotonic; _steps restarts every swap
        # dispatch_ns: host time enqueueing steps (not device time);
        # step_ns: dispatch plus the wait for the card, on the sampled
        # steps and at each swap that ingested; steps_synced: samples in it
        self.dispatch_ns = 0
        self.step_ns = 0
        self.steps_synced = 0
        # two staging buffers per lane-size signature, used in turn: batch
        # N+1 packs into one while batch N's copy may still read the other
        self._pack_bufs: dict = {}
        # staged HLL import/restore rows (slot, dense u8 registers)
        self._hll_slots: list = []
        self._hll_rows: list = []
        # checkpoint-restore counter residuals (batcher, slot, lo), staged
        # in a second ingest step by restore_flush
        self._restore_residuals: list = []
        self._init_degrade()

    def _init_degrade(self) -> None:
        """Degraded aggregation knobs (pushed by an overload controller);
        the defaults are no-ops. Every backend's __init__ calls this."""
        self.degraded_timer_rate = 1.0
        self._degrade_seq = 0
        self.pending_set_shift = 0
        self.active_set_shift = 0
        self.last_set_shift = 0
        self.degraded_timer_skipped = 0
        self.degraded_set_skipped = 0

    def set_pressure(self, pressure) -> None:
        """Install a tables.pressure.TablePressure: the live table and
        every later interval's fresh KeyTable (swap) get it attached."""
        self._pressure = pressure
        if pressure is not None:
            pressure.attach(self.table)

    def _staging_buffers(self) -> list:
        return [b for bufs in self._pack_bufs.values() for b in bufs[:2]]

    def wait_copies(self) -> None:
        """Wait until every copy out of this backend's pinned staging
        buffers has read them (a grow retires the backend while its last
        step's copy may still be in flight)."""
        for buf in self._staging_buffers():
            buf.ready()

    # -- degraded aggregation ------------------------------------------------
    def _histo_admit(self, sample_rate: float):
        """Effective sample rate of one timer/histogram sample under
        degradation, or None when it is skipped: a fraction p is admitted
        by a deterministic splitmix64 roll and carries rate·p, so the
        flushed weights stay unbiased."""
        p = self.degraded_timer_rate
        if p >= 1.0:
            return sample_rate
        self._degrade_seq += 1
        if (splitmix64(self._degrade_seq) >> 11) * (1.0 / (1 << 53)) >= p:
            self.degraded_timer_skipped += 1
            return None
        return sample_rate * p

    def _set_admit(self, member: bytes) -> bool:
        """Hash-prefix member subsample at rate 2^-active_set_shift."""
        k = self.active_set_shift
        if k <= 0:
            return True
        if fnv1a_64(member) & ((1 << k) - 1):
            self.degraded_set_skipped += 1
            return False
        return True

    def _latch_degrade(self) -> None:
        """Interval boundary: the pending set shift takes effect, and the
        one that governed the detached interval is kept for its flush."""
        self.last_set_shift = self.active_set_shift
        self.active_set_shift = self.pending_set_shift

    # -- ingest --------------------------------------------------------------
    def _on_batch(self, batch) -> None:
        self._steps += 1
        self.steps_total += 1
        sizes = batch_sizes(batch)
        bufs = self._pack_bufs.get(sizes)
        if bufs is None:
            words = packed_layout(sizes)[1]
            pinned = self.device.type == "cuda"
            bufs = self._pack_bufs[sizes] = [_PackBuffer(words, pinned),
                                             _PackBuffer(words, pinned), 0]
        buf = bufs[bufs[2]]
        bufs[2] ^= 1
        buf.ready()
        do_compact = self._steps % self.compact_every == 0
        pack_batch(batch, do_compact, out=buf.array)
        self.h2d_bytes += buf.array.nbytes
        t0 = time.perf_counter_ns()
        packed_step_core(self.state, buf.to(self.device), spec=self.spec,
                         sizes=sizes, do_compact=do_compact)
        self._count_step(t0)

    def _count_step(self, t0: int) -> None:
        """Account one ingest step enqueued since perf_counter_ns `t0`."""
        dt = time.perf_counter_ns() - t0
        self.dispatch_ns += dt
        if self.steps_total % _SYNC_EVERY == 0:
            self.step_ns += dt + sync_and_time(self.state)
            self.steps_synced += 1

    def process_metric(self, m: UDPMetric) -> None:
        """Key the sample to its slot and stage it in its lane."""
        kind = m.type
        slot = self.table.slot_for(kind, m.name, m.tags, m.scope, m.digest,
                                   hostname=m.hostname,
                                   joined_tags=m.joined_tags)
        if slot is None:
            self.dropped_capacity += 1
            return
        if kind in ("histogram", "timer"):
            # a directly sampled histo is no longer import-only
            mt = self.table.meta_for_slot(kind, slot)
            if mt is not None and mt.imported_only:
                mt.imported_only = False
        if kind == "counter":
            self.batcher.add_counter(slot, float(m.value), m.sample_rate)
        elif kind == "gauge":
            self.batcher.add_gauge(slot, float(m.value))
        elif kind == "status":
            self.batcher.add_status(slot, float(m.value))
            # the slot keeps the latest message
            mt = self.table.meta_for_slot("status", slot)
            if mt is not None:
                mt.message = m.message
        elif kind == "set":
            member = set_member_bytes(m.value)
            if self._set_admit(member):
                self.batcher.add_set(slot, member)
        elif kind in ("histogram", "timer"):
            # the server's own veneur.* timers are never degraded
            if m.name.startswith("veneur."):
                rate = m.sample_rate
            else:
                rate = self._histo_admit(m.sample_rate)
            if rate is not None:
                self.batcher.add_histo(slot, float(m.value), rate)
        self.processed += 1

    # -- import path (global tier) -------------------------------------------
    def _stage_digest(self, b: Batcher, slot: int, payload: dict,
                      restore: bool = False) -> None:
        """Stage one digest's live centroids as weighted samples, and its
        exact min/max/reciprocal sum in the stats lanes: the lane carries
        the payload's reciprocal sum less what the centroid re-add adds.
        An import of a digest with no live centroid carries its whole
        reciprocal sum; a restored one carries none (the JAX package's
        two rules)."""
        means = np.asarray(payload["means"], np.float32)
        weights = np.asarray(payload["weights"], np.float32)
        live = weights > 0
        means, weights = means[live], weights[live]
        b.add_histos_bulk(np.full(len(means), slot, np.int32), means,
                          weights)
        mn = float(payload.get("min", np.inf))
        mx = float(payload.get("max", -np.inf))
        recip = payload.get("recip")
        recip_corr = 0.0
        if recip is not None and (len(means) or not restore) \
                and np.all(means != 0.0):
            recip_corr = float(recip) - float(np.sum(weights / means))
        b.add_histo_stats(slot, mn, mx, recip_corr)

    def _stage_hll(self, slot: int, regs) -> None:
        """Stage dense u8 registers for the packed-table register max."""
        regs = np.asarray(regs, np.uint8)
        if regs.shape[0] != self.spec.registers:
            # sketch registers do not interoperate across precisions
            raise ValueError(
                f"HLL has {regs.shape[0]} registers, table expects "
                f"{self.spec.registers}")
        self._hll_slots.append(slot)
        self._hll_rows.append(regs)
        if len(self._hll_slots) >= _HLL_MERGE_ROWS:
            self._flush_hll_imports()

    def import_metric(self, kind: str, name: str, tags: tuple, scope: int,
                      digest: int, payload: dict) -> None:
        """Merge one forwarded metric's sketch state (the reference's
        Worker.ImportMetricGRPC). payload keys by kind: counter/gauge
        'value'; set 'registers' (u8[R]); histogram/timer 'means',
        'weights' (+ optional 'min', 'max', 'recip')."""
        slot = self.table.slot_for(kind, name, tags, scope, digest,
                                   imported=True)
        if slot is None:
            self.dropped_capacity += 1
            return
        if kind == "counter":
            self.batcher.add_counter(slot, float(payload["value"]), 1.0)
        elif kind == "gauge":
            self.batcher.add_gauge(slot, float(payload["value"]))
        elif kind == "set":
            self._stage_hll(slot, payload["registers"])
        elif kind in ("histogram", "timer"):
            self._stage_digest(self.batcher, slot, payload)
        self.processed += 1

    # -- checkpoint restore (persistence/restore.py) -------------------------
    def _restore_lane(self, kind: str, slot: int):
        """(batcher, staging slot) for a restored key."""
        return self.batcher, slot

    def _restore_emit(self) -> None:
        self.batcher.emit()

    def restore_metric(self, kind: str, name: str, tags: tuple, scope: int,
                       digest: int, payload: dict, hostname: str = "",
                       message: str = "", imported_only: bool = False,
                       joined_tags=None) -> None:
        """Fold one checkpointed key back in through the merge lanes,
        never by overwriting state: counter add, gauge/status last write,
        HLL register max, digest centroid re-add, plus the host metadata
        a snapshot keeps. Callers finish with restore_flush()."""
        slot = self.table.slot_for(kind, name, tags, scope, digest,
                                   hostname=hostname,
                                   imported=imported_only,
                                   joined_tags=joined_tags)
        if slot is None:
            self.dropped_capacity += 1
            return
        b, local = self._restore_lane(kind, slot)
        if kind == "counter":
            # two-float split: the lane is f32 and the checkpointed count
            # an f64. hi is staged now and lo in restore_flush's second
            # step: one step's scatter-add would round hi + lo to f32
            # and lose exactly the bits the split carries
            value = float(payload["value"])
            hi = float(np.float32(value))
            b.add_counter(local, hi, 1.0)
            lo = value - hi
            if lo != 0.0:
                self._restore_residuals.append((b, local, lo))
        elif kind == "gauge":
            b.add_gauge(local, float(payload["value"]))
        elif kind == "status":
            b.add_status(local, float(payload["value"]))
            mt = self.table.meta_for_slot("status", slot)
            if mt is not None:
                mt.message = message
        elif kind == "set":
            self._stage_hll(slot, payload["registers"])
        elif kind in ("histogram", "timer"):
            self._stage_digest(b, local, payload, restore=True)
        self.processed += 1

    def restore_flush(self) -> None:
        """Apply a fold_snapshot pass: the staged batch (counter hi
        parts) in one step, then the counter lo residuals in a second,
        then the staged HLL rows."""
        self._restore_emit()
        if self._restore_residuals:
            for b, local, lo in self._restore_residuals:
                b.add_counter(local, lo, 1.0)
            self._restore_residuals = []
            self._restore_emit()
        while self._hll_slots:
            self._flush_hll_imports()

    def _flush_hll_imports(self) -> None:
        """Register-max up to _HLL_MERGE_ROWS staged rows into the live
        packed table, in place."""
        if not self._hll_slots:
            return
        from veneur_tpu_torch.ops.hll import merge_rows_packed_
        n = min(len(self._hll_slots), _HLL_MERGE_ROWS)
        slots = torch.from_numpy(np.asarray(self._hll_slots[:n], np.int64))
        rows = torch.from_numpy(np.stack(self._hll_rows[:n]))
        merge_rows_packed_(self.state.hll, slots.to(self.device),
                           rows.to(self.device),
                           precision=self.spec.hll_precision)
        self._hll_slots = self._hll_slots[n:]
        self._hll_rows = self._hll_rows[n:]

    def extra_parse_errors(self) -> int:
        """Parse errors counted below the Python layer: none here, where
        the server's Python parser counts every line it refuses (the
        native backend adds its engine's)."""
        return 0

    # -- flush ---------------------------------------------------------------
    def swap(self):
        """Detach the live state and key table and start fresh ones."""
        self.batcher.emit()
        while self._hll_slots:
            self._flush_hll_imports()
        if self._steps:
            # interval boundary: step_ns is never 0 after an interval
            # that ingested, even when no sampled step fell in it
            self.step_ns += sync_and_time(self.state)
            self.steps_synced += 1
        state, table = self.state, self.table
        self.state = empty_state(self.spec, self.device)
        self.table = KeyTable(self.spec)
        if self._pressure is not None:
            self._pressure.attach(self.table)
        self._steps = 0
        self._latch_degrade()
        return state, table

    # -- query tier ----------------------------------------------------------
    def query_snapshot(self):
        """Pipeline-thread-only read view of the LIVE interval for the
        query tier: swap()'s staging drain without the detach, so every
        sample admitted before this call has its ingest step enqueued.
        The state is the live one, which later steps update in place: a
        read of it must be enqueued on this thread, on the stream the
        steps use, before the next step (veneur_tpu_torch/query/).
        Returns (state, table, active_set_shift): the live shift, whose
        2^shift correction the flush has not applied yet."""
        self.batcher.emit()
        while self._hll_slots:
            self._flush_hll_imports()
        return self.state, self.table, self.active_set_shift

    def query_flat_state(self, state):
        """The state with flat [rows, ...] leading dims, as the query and
        watch tiers gather from it; the single-device layout is one."""
        return state

    def compute_flush(self, state, table, percentiles: List[float],
                      want_raw: bool = False, history=None):
        """Flush math on a detached interval. Output arrays are compact:
        row i pairs with table.get_meta(kind)[i]. Each block of at most
        FLUSH_BLOCK_ROWS rows per kind is one packed input copy, one flush
        and one packed output copy. With want_raw, the live rows'
        mergeable sketch state comes back too.

        With `history` (a history.HistoryWriter on this aggregator's
        device), each block runs the flush with the ring write fused in
        (step.flush_live_hist_packed): the interval's values land in
        their ring column from the flush's own tensors, with the same
        packed outputs. The writer's plan is committed after the last
        block, or aborted if any block raises."""
        perc = percentiles or [0.5]
        spec = self.spec
        caps = [spec.counter_capacity, spec.gauge_capacity,
                spec.status_capacity, spec.set_capacity,
                spec.histo_capacity]
        slots = [live_slots(table, k) for k in
                 ("counter", "gauge", "status", "set", "histogram")]
        lens = [len(s) for s in slots]
        n_blocks = max(1, max(
            -(-n // min(pad_bucket(n, cap), FLUSH_BLOCK_ROWS))
            for n, cap in zip(lens, caps)))
        # each kind's rows spread evenly over the blocks
        buckets = tuple(min(pad_bucket(-(-n // n_blocks), cap),
                            FLUSH_BLOCK_ROWS)
                        for n, cap in zip(lens, caps))
        shapes = flush_live_shapes(spec, *buckets, len(perc),
                                   want_raw=want_raw)
        def flat_of(i):
            return torch.from_numpy(pack_flush_inputs(
                perc, pack_bucket_chunks(slots, buckets, i))).to(self.device)

        if history is not None:
            if history.device != self.device:
                raise ValueError(f"history ring on {history.device}, "
                                 f"aggregator on {self.device}")
            plan = history.plan_flush(table)
            hist = history.begin_flush(plan)
            try:
                packs = []
                for i in range(n_blocks):
                    p, hist = flush_live_hist_packed(
                        state, flat_of(i), hist,
                        pack_bucket_chunks(plan.dests, buckets, i,
                                           fill=SENTINEL),
                        plan.col, spec=spec, hspec=history.spec,
                        n_q=len(perc), buckets=buckets, want_raw=want_raw,
                        clear=(i == 0))
                    packs.append(p)
            except BaseException:
                history.abort_flush()
                raise
            history.commit_flush(plan, hist)
        else:
            packs = [flush_live_in_packed(state, flat_of(i), spec=spec,
                                          n_q=len(perc), buckets=buckets,
                                          want_raw=want_raw)
                     for i in range(n_blocks)]
        pieces = [unpack_flush(p.cpu().numpy(), shapes) for p in packs]
        out = {}
        for key, kind_i in ((k, FLUSH_KEY_KIND[k]) for k in pieces[0]):
            b, n = buckets[kind_i], lens[kind_i]
            rows = [p[key][:min(b, n - i * b)]
                    for i, p in enumerate(pieces) if n - i * b > 0]
            out[key] = (np.concatenate(rows) if rows
                        else pieces[0][key][:0])
        result = combine_flush_scalars(out)
        if want_raw:
            raw = {
                "counter": result["counter"],
                "gauge": result["gauge"],
                "hll": result.pop("raw_hll"),
                "h_mean": result.pop("raw_h_mean"),
                "h_weight": result.pop("raw_h_weight"),
                "h_min": result["histo_min"],
                "h_max": result["histo_max"],
                "h_recip": np.asarray(out["histo_recip_hi"], np.float64)
                + np.asarray(out["histo_recip_lo"], np.float64),
            }
            return result, table, raw
        return result, table

    def flush(self, percentiles: List[float], want_raw: bool = False
              ) -> Tuple[Dict[str, np.ndarray], KeyTable]:
        """swap + compute_flush in one call."""
        state, table = self.swap()
        return self.compute_flush(state, table, percentiles, want_raw)
