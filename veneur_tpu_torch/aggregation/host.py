"""Host-side key dictionary and batch staging.

The host resolves (kind, name, joined tags) to a dense slot index into the
device tensors; the device never sees strings. Slot metadata (name, tags,
scope, hostname, status message) stays here for flush labelling. Slots are
assigned shard-aware, slot = shard * per_shard + local index with
shard = digest % n_shards (the reference routes by Digest % numWorkers the
same way); one shard is the single-device case.

The Batcher stages parsed samples into fixed-size numpy lanes and emits a
padded Batch whenever a lane fills (padding rows carry slot == capacity).
Its histo_stat lanes carry imported digests' exact min/max/reciprocal
sums (the global tier's import and checkpoint restore paths); padding
rows there hold +inf/-inf/0, the identities of the lanes' operations.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

from veneur_tpu_torch.aggregation.state import TableSpec
from veneur_tpu_torch.aggregation.step import Batch
from veneur_tpu_torch.utils.hashing import hll_reg_rho

# scopes (the reference's MetricScope)
SCOPE_MIXED = 0
SCOPE_LOCAL = 1
SCOPE_GLOBAL = 2


@dataclasses.dataclass
class SlotMeta:
    name: str
    tags: tuple
    scope: int
    kind: str
    hostname: str = ""
    message: str = ""  # status checks only
    # True while a histo slot has only been fed by an import path; the
    # flusher then emits its percentiles only
    imported_only: bool = False
    # the parser's precomputed joined tags, when the allocation site had it
    joined_tags: Optional[str] = None
    # flusher.generate_intermetrics cache: (tags list, sink route,
    # hostname), computed once per key per interval and shared by every
    # InterMetric of the key (sinks derive new lists, never mutate)
    _emit_prep: Optional[tuple] = dataclasses.field(
        default=None, repr=False, compare=False)


class _KindTable:
    __slots__ = ("capacity", "n_shards", "per_shard", "by_key", "meta",
                 "by_slot", "next_free", "dropped")

    def __init__(self, capacity: int, n_shards: int):
        self.capacity = capacity
        self.n_shards = n_shards
        self.per_shard = capacity // n_shards
        self.by_key: dict = {}
        self.meta: list = []          # (slot, SlotMeta) in allocation order
        self.by_slot: dict = {}       # slot -> SlotMeta
        self.next_free = [0] * n_shards
        self.dropped = 0

    def alloc(self, key, digest: int, name: str, tags: tuple, scope: int,
              kind: str, hostname: str = "", imported: bool = False,
              joined_tags=None) -> Optional[int]:
        """Allocate a slot for a new key, or count a drop when its shard
        is full (the capacity check runs before any construction)."""
        shard = digest % self.n_shards
        nxt = self.next_free[shard]
        if nxt >= self.per_shard:
            self.dropped += 1
            return None
        meta = SlotMeta(name=name, tags=tags, scope=scope, kind=kind,
                        hostname=hostname, imported_only=imported,
                        joined_tags=joined_tags)
        self.next_free[shard] = nxt + 1
        slot = shard * self.per_shard + nxt
        self.by_key[key] = slot
        self.meta.append((slot, meta))
        self.by_slot[slot] = meta
        return slot


class KeyTable:
    """(kind, name, joined tags) -> slot for one flush interval. Timers and
    histograms share the histo table but are distinct key namespaces."""

    # optional tables.pressure.TablePressure, attached by the backend's
    # swap() when table growth is on; stays None (one branch on the miss
    # path only) otherwise
    pressure = None

    def __init__(self, spec: TableSpec, n_shards: int = 1):
        self.spec = spec
        self.n_shards = n_shards
        self.tables = {
            "counter": _KindTable(spec.counter_capacity, n_shards),
            "gauge": _KindTable(spec.gauge_capacity, n_shards),
            "status": _KindTable(spec.status_capacity, n_shards),
            "set": _KindTable(spec.set_capacity, n_shards),
            "histo": _KindTable(spec.histo_capacity, n_shards),
        }

    @staticmethod
    def _table_name(kind: str) -> str:
        return "histo" if kind in ("histogram", "timer") else kind

    def slot_for(self, kind: str, name: str, tags: tuple, scope: int,
                 digest: int, hostname: str = "",
                 imported: bool = False,
                 joined_tags: Optional[str] = None) -> Optional[int]:
        t = self.tables[self._table_name(kind)]
        # key identity is the joined tag string (an empty tag section
        # joins to "" and shares the no-tags key)
        if joined_tags is None:
            joined_tags = ",".join(tags)
        key = (kind, name, joined_tags)
        slot = t.by_key.get(key)
        if slot is not None:
            return slot
        if self.pressure is not None:
            # miss path only: the pressure ladder (tables/pressure.py) may
            # redirect the key to a rollup or merge slot, or admit it
            return self.pressure.admit(t, key, digest, name, tags, scope,
                                       kind, hostname, imported, joined_tags)
        return t.alloc(key, digest, name, tags, scope, kind,
                       hostname=hostname, imported=imported,
                       joined_tags=joined_tags)

    def get_meta(self, kind: str):
        """[(slot, SlotMeta)] in allocation order for flush labelling."""
        return self.tables[self._table_name(kind)].meta

    def meta_for_slot(self, kind: str, slot: int) -> Optional[SlotMeta]:
        return self.tables[self._table_name(kind)].by_slot.get(slot)

    def dropped(self) -> int:
        return sum(t.dropped for t in self.tables.values())


@dataclasses.dataclass(frozen=True)
class BatchSpec:
    """Fixed staging sizes per lane."""
    counter: int = 8192
    gauge: int = 2048
    status: int = 256
    set: int = 4096
    histo: int = 8192
    histo_stat: int = 256


class Batcher:
    """Stages parsed samples into numpy lanes and emits padded Batches to
    `on_batch` whenever a lane fills (and on `emit()`)."""

    def __init__(self, spec: TableSpec, bspec: BatchSpec = BatchSpec(),
                 on_batch: Optional[Callable[[Batch], None]] = None):
        self.spec = spec
        self.bspec = bspec
        self.on_batch = on_batch
        b = bspec
        self.c_slot = np.full(b.counter, spec.counter_capacity, np.int32)
        self.c_inc = np.zeros(b.counter, np.float32)
        self.g_slot = np.full(b.gauge, spec.gauge_capacity, np.int32)
        self.g_val = np.zeros(b.gauge, np.float32)
        self.st_slot = np.full(b.status, spec.status_capacity, np.int32)
        self.st_val = np.zeros(b.status, np.float32)
        self.s_slot = np.full(b.set, spec.set_capacity, np.int32)
        self.s_reg = np.zeros(b.set, np.int32)
        self.s_rho = np.zeros(b.set, np.uint8)
        self.h_slot = np.full(b.histo, spec.histo_capacity, np.int32)
        self.h_val = np.zeros(b.histo, np.float32)
        self.h_wt = np.zeros(b.histo, np.float32)
        self.hs_slot = np.full(b.histo_stat, spec.histo_capacity, np.int32)
        self.hs_min = np.full(b.histo_stat, np.inf, np.float32)
        self.hs_max = np.full(b.histo_stat, -np.inf, np.float32)
        self.hs_recip = np.zeros(b.histo_stat, np.float32)
        self.nc = self.ng = self.nst = self.ns = self.nh = self.nhs = 0

    def add_counter(self, slot: int, value: float, rate: float):
        self.c_slot[self.nc] = slot
        self.c_inc[self.nc] = value * (1.0 / rate)
        self.nc += 1
        if self.nc >= self.bspec.counter:
            self.emit()

    def add_gauge(self, slot: int, value: float):
        self.g_slot[self.ng] = slot
        self.g_val[self.ng] = value
        self.ng += 1
        if self.ng >= self.bspec.gauge:
            self.emit()

    def add_status(self, slot: int, value: float):
        self.st_slot[self.nst] = slot
        self.st_val[self.nst] = value
        self.nst += 1
        if self.nst >= self.bspec.status:
            self.emit()

    def add_set(self, slot: int, member: bytes):
        reg, rho = hll_reg_rho(member, self.spec.hll_precision)
        self.s_slot[self.ns] = slot
        self.s_reg[self.ns] = reg
        self.s_rho[self.ns] = rho
        self.ns += 1
        if self.ns >= self.bspec.set:
            self.emit()

    def add_histo(self, slot: int, value: float, rate: float):
        self.h_slot[self.nh] = slot
        self.h_val[self.nh] = value
        self.h_wt[self.nh] = 1.0 / rate
        self.nh += 1
        if self.nh >= self.bspec.histo:
            self.emit()

    def add_histo_stats(self, slot: int, mn: float, mx: float,
                        recip: float):
        """An imported digest's exact min/max and the reciprocal-sum
        correction its centroid re-add leaves over."""
        self.hs_slot[self.nhs] = slot
        self.hs_min[self.nhs] = mn
        self.hs_max[self.nhs] = mx
        self.hs_recip[self.nhs] = recip
        self.nhs += 1
        if self.nhs >= self.bspec.histo_stat:
            self.emit()

    # -- bulk staging: slices, not per-sample Python calls -----------------
    def _bulk(self, dsts, srcs, n_attr: str, cap: int):
        n = len(srcs[0])
        i = 0
        while i < n:
            cur = getattr(self, n_attr)
            take = min(cap - cur, n - i)
            for dst, src in zip(dsts, srcs):
                dst[cur:cur + take] = src[i:i + take]
            setattr(self, n_attr, cur + take)
            i += take
            if getattr(self, n_attr) >= cap:
                self.emit()

    def add_counters_bulk(self, slots, incs):
        """incs already rate-weighted."""
        self._bulk((self.c_slot, self.c_inc), (slots, incs), "nc",
                   self.bspec.counter)

    def add_gauges_bulk(self, slots, vals):
        self._bulk((self.g_slot, self.g_val), (slots, vals), "ng",
                   self.bspec.gauge)

    def add_sets_bulk(self, slots, regs, rhos):
        """(reg, rho) pre-split from the member hashes."""
        self._bulk((self.s_slot, self.s_reg, self.s_rho),
                   (slots, regs, rhos), "ns", self.bspec.set)

    def add_histos_bulk(self, slots, vals, wts):
        self._bulk((self.h_slot, self.h_val, self.h_wt),
                   (slots, vals, wts), "nh", self.bspec.histo)

    def add_histo_stats_bulk(self, slots, mns, mxs, recips):
        """add_histo_stats in slices (the native import decoder drains
        these per request)."""
        self._bulk((self.hs_slot, self.hs_min, self.hs_max, self.hs_recip),
                   (slots, mns, mxs, recips), "nhs", self.bspec.histo_stat)

    def pending(self) -> int:
        return self.nc + self.ng + self.nst + self.ns + self.nh + self.nhs

    def _staged(self) -> Batch:
        return Batch(
            counter_slot=self.c_slot.copy(), counter_inc=self.c_inc.copy(),
            gauge_slot=self.g_slot.copy(), gauge_val=self.g_val.copy(),
            status_slot=self.st_slot.copy(), status_val=self.st_val.copy(),
            set_slot=self.s_slot.copy(), set_reg=self.s_reg.copy(),
            set_rho=self.s_rho.copy(),
            histo_slot=self.h_slot.copy(), histo_val=self.h_val.copy(),
            histo_wt=self.h_wt.copy(),
            histo_stat_slot=self.hs_slot.copy(),
            histo_stat_min=self.hs_min.copy(),
            histo_stat_max=self.hs_max.copy(),
            histo_stat_recip=self.hs_recip.copy(),
        )

    def force_emit(self) -> Batch:
        """Emit unconditionally (all padding when nothing is staged)
        without calling on_batch: for callers that stack several
        batchers' batches themselves (the sharded backends)."""
        b = self.emit(notify=False)
        return self._staged() if b is None else b

    def emit(self, notify: bool = True) -> Optional[Batch]:
        """Build a padded Batch from staged samples, reset staging, pass it
        to on_batch (unless `notify` is False). Returns the Batch (None
        if nothing was staged)."""
        if self.pending() == 0:
            return None
        batch = self._staged()
        # reset padding sentinels for the next batch
        self.c_slot[:self.nc] = self.spec.counter_capacity
        self.g_slot[:self.ng] = self.spec.gauge_capacity
        self.st_slot[:self.nst] = self.spec.status_capacity
        self.s_slot[:self.ns] = self.spec.set_capacity
        self.h_slot[:self.nh] = self.spec.histo_capacity
        self.hs_slot[:self.nhs] = self.spec.histo_capacity
        self.hs_min[:self.nhs] = np.inf
        self.hs_max[:self.nhs] = -np.inf
        self.hs_recip[:self.nhs] = 0.0
        self.c_inc[:self.nc] = 0.0
        self.h_wt[:self.nh] = 0.0
        self.nc = self.ng = self.nst = self.ns = self.nh = self.nhs = 0
        if notify and self.on_batch is not None:
            self.on_batch(batch)
        return batch
