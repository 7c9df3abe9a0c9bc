"""Single-device aggregation backend: key table + batcher + device state.

The glue between parsed UDPMetrics and the ingest step, in the role of the
reference's worker goroutines. Every full batch is packed into one i32
buffer, copied to the device once and applied by the ingest step
(aggregation/step.py packed_step_core), which re-compresses the digests
every `compact_every` steps. `swap` detaches the interval's state and key
table and starts fresh ones; `compute_flush` turns a detached interval
into per-key numpy values.
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
        # degraded aggregation knobs (pushed by an overload controller);
        # the defaults are no-ops
        self.degraded_timer_rate = 1.0
        self._degrade_seq = 0
        self.pending_set_shift = 0
        self.active_set_shift = 0
        self.last_set_shift = 0
        self.degraded_timer_skipped = 0
        self.degraded_set_skipped = 0

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

    def extra_parse_errors(self) -> int:
        """Parse errors counted below the Python layer: none here, where
        the server's Python parser counts every line it refuses (the
        native backend adds its engine's)."""
        return 0

    # -- flush ---------------------------------------------------------------
    def swap(self):
        """Detach the live state and key table and start fresh ones."""
        self.batcher.emit()
        if self._steps:
            # interval boundary: step_ns is never 0 after an interval
            # that ingested, even when no sampled step fell in it
            self.step_ns += sync_and_time(self.state)
            self.steps_synced += 1
        state, table = self.state, self.table
        self.state = empty_state(self.spec, self.device)
        self.table = KeyTable(self.spec)
        self._steps = 0
        self._latch_degrade()
        return state, table

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
