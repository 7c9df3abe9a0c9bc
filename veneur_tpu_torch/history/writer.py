"""Host orchestration for the history ring: key admission, window
metadata, decimation scheduling, and every device dispatch that touches
the ring.

The writer lives at server scope, not interval scope: its key index --
(kind, name, joined_tags) -> ring row, per kind -- persists across
interval KeyTable swaps, because a key's ring row has nothing to do with
its current table slot. Windows are addressed by key identity.

Two write paths share one device function (device.write_window_core):

  - the FUSED path: Aggregator.compute_flush runs the write inside the
    flush (aggregation/step.py flush_live_hist_packed), on the flush's
    own device tensors, with no extra host traffic;
  - the HOST-FED path: `record_frame` writes an archived flush frame
    (numpy result + raw) through the same function -- the replay oracle.

Both store bit-identical bytes for the same frame, which is what makes
"range answers byte-exact vs re-merging the archived flush frames" hold.

Locking: `_dlock` serialises ring dispatches and guards the ring
reference (the device functions update the ring in place; see
device.py); readers (range queries, lookbacks) dispatch under the same
lock and may materialise outside it, since their gathers are enqueued on
the same stream before any later write. `_dlock` is an RLock so
begin/commit can hold it across a tiled multi-block flush.
"""

from __future__ import annotations

import threading
import time
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from veneur_tpu_torch import convert
from veneur_tpu_torch.aggregation.state import resolve_device
from veneur_tpu_torch.history import device as hdev
from veneur_tpu_torch.history.spec import HistorySpec
from veneur_tpu_torch.observability.runtime import SampledSync

# Ring kind order, identical to step.FLUSH_KEY_KIND's numbering.
KINDS = ("counter", "gauge", "status", "set", "histogram")
# Out-of-range row sentinel: the ring writes drop these rows.
SENTINEL = np.int32(1 << 30)
_SYNC_EVERY = 64


def _pad_pow2(vals, fill, floor: int = 4):
    b = floor
    while b < len(vals):
        b <<= 1
    arr = np.full(b, fill, np.int32)
    arr[:len(vals)] = vals
    return arr


class HistoryPlan(NamedTuple):
    """One interval's admission decisions (host only)."""
    dests: tuple      # per kind: i32[len(get_meta(kind))] ring rows
    resets: tuple     # per kind: list of reassigned rows to wipe
    col: int          # tier-0 ring column for this window
    seq: int
    ts: float


class RangeStep(NamedTuple):
    seq_lo: int
    seq_hi: int
    ts_lo: float
    ts_hi: float
    complete: bool    # False when part of the span fell off retention


class RangePlan(NamedTuple):
    sel: np.ndarray   # f32[S, W] column-selection mask per step
    rank: np.ndarray  # f32[W] recency rank (end_seq + 1; 0 = unset)
    steps: List[RangeStep]


class _ColMeta(NamedTuple):
    tier: int
    start: int        # first tier-0 seq covered (inclusive)
    end: int          # last tier-0 seq covered (inclusive)
    ts: float         # wall time of the newest covered window


class HistoryWriter:
    def __init__(self, hspec: HistorySpec, *, interval_s: float = 10.0,
                 device=None, c_writes=None, c_evictions=None,
                 c_range=None, g_hbm=None):
        self.spec = hspec
        self.interval_s = float(interval_s)
        self.device = resolve_device(device)
        self._dlock = threading.RLock()
        self._mlock = threading.RLock()
        self._hist: Optional[hdev.HistoryState] = None
        self._rows = [dict() for _ in KINDS]        # key -> row
        self._row_key = [dict() for _ in KINDS]     # row -> key
        self._free = [list(range(hspec.rows_for(k) - 1, -1, -1))
                      for k in range(len(KINDS))]
        self._last_seen = [np.full(hspec.rows_for(k), -1, np.int64)
                           for k in range(len(KINDS))]
        self._seq = 0
        self._cols: List[Optional[_ColMeta]] = [None] * hspec.total_cols
        self._c_writes = c_writes
        self._c_evictions = c_evictions
        self._c_range = c_range
        self._g_hbm = g_hbm
        self._sync = SampledSync(_SYNC_EVERY)
        if g_hbm is not None:
            g_hbm.set(float(hspec.hbm_bytes()))

    # -- key index -----------------------------------------------------------
    @staticmethod
    def _key(meta):
        return (meta.kind, meta.name, meta.joined_tags)

    def _col_of(self, tier: int, slot: int) -> int:
        return tier * self.spec.windows + (slot % self.spec.windows)

    def _assign_kind(self, k: int, metas, seq: int):
        """Ring rows for one kind's get_meta list, in order. Admission is
        sticky (a known key keeps its row); overflow evicts the
        least-recently-flushed row not used by THIS interval; when every
        row is in current use the incoming key is turned away (counted as
        an eviction of the write -- the ring is a bounded cache, not the
        source of truth)."""
        rows, rkey = self._rows[k], self._row_key[k]
        free, seen = self._free[k], self._last_seen[k]
        dest = np.full(len(metas), SENTINEL, np.int32)
        resets = []
        evict_order = None
        evict_pos = 0
        evictions = 0
        for i, (_slot, m) in enumerate(metas):
            key = self._key(m)
            row = rows.get(key)
            if row is None:
                if free:
                    row = free.pop()
                else:
                    if evict_order is None:
                        evict_order = np.argsort(seen, kind="stable")
                    row = None
                    while evict_pos < len(evict_order):
                        cand = int(evict_order[evict_pos])
                        evict_pos += 1
                        if seen[cand] < seq:     # not used this interval
                            row = cand
                            break
                    if row is None:
                        evictions += 1           # turned away at capacity
                        continue
                    old = rkey.pop(row, None)
                    if old is not None:
                        del rows[old]
                    resets.append(row)
                    evictions += 1
                rows[key] = row
                rkey[row] = key
            dest[i] = row
            seen[row] = seq
        return dest, resets, evictions

    def plan_flush(self, table, ts: Optional[float] = None) -> HistoryPlan:
        ts = time.time() if ts is None else ts
        with self._mlock:
            seq = self._seq
            dests, resets, ev = [], [], 0
            for k, kind in enumerate(KINDS):
                d, r, e = self._assign_kind(k, table.get_meta(kind), seq)
                dests.append(d)
                resets.append(r)
                ev += e
            if ev and self._c_evictions is not None:
                self._c_evictions.inc(ev)
            return HistoryPlan(tuple(dests), tuple(resets),
                               self._col_of(0, seq), seq, ts)

    # -- fused-flush protocol ------------------------------------------------
    def begin_flush(self, plan: HistoryPlan) -> hdev.HistoryState:
        """Enter the write critical section: wipe reassigned rows and hand
        the ring to the flush. MUST be paired with commit_flush or
        abort_flush."""
        self._dlock.acquire()
        try:
            hist = self._ensure_hist()
            if any(plan.resets):
                hdev.wipe_rows(hist, plan.resets, hspec=self.spec)
            return hist
        except BaseException:
            self._dlock.release()
            raise

    def commit_flush(self, plan: HistoryPlan, hist) -> None:
        try:
            self._hist = hist
            with self._mlock:
                self._cols[plan.col] = _ColMeta(0, plan.seq, plan.seq,
                                                plan.ts)
                self._roll(plan)
                self._seq = plan.seq + 1
            if self._c_writes is not None:
                n = sum(int((d != SENTINEL).sum()) for d in plan.dests)
                self._c_writes.inc(n)
        finally:
            self._dlock.release()

    def abort_flush(self) -> None:
        self._dlock.release()

    def _ensure_hist(self) -> hdev.HistoryState:
        if self._hist is None:
            self._hist = hdev.empty_history(self.spec, self.device)
        return self._hist

    def _roll(self, plan: HistoryPlan) -> None:
        """Dispatch this window's due decimation merges (2x per tier):
        after window seq, tier t rolls when seq+1 is a multiple of 2^t."""
        s = plan.seq
        for t in range(1, self.spec.tiers + 1):
            if (s + 1) % (1 << t):
                break
            m = (s + 1) // (1 << t) - 1
            lo = 2 * m
            src0 = self._col_of(t - 1, lo)
            src1 = self._col_of(t - 1, lo + 1)
            dst = self._col_of(t, m)
            m0, m1 = self._cols[src0], self._cols[src1]
            step = 1 << (t - 1)
            if (m0 is None or m1 is None or m0.tier != t - 1
                    or m1.tier != t - 1 or m0.start != lo * step
                    or m1.start != (lo + 1) * step):
                continue      # partial ring (fresh start / old restore)
            hdev.roll_tiers(self._hist, src0, src1, dst, hspec=self.spec)
            self._cols[dst] = _ColMeta(t, m * (1 << t),
                                       (m + 1) * (1 << t) - 1, m1.ts)

    # -- host-fed path (replay oracle) ---------------------------------------
    def record_frame(self, table, result: dict, raw: dict,
                     ts: Optional[float] = None) -> None:
        """Write one archived flush frame (result+raw in get_meta order,
        as compute_flush(want_raw=True) returns them) into the ring."""
        plan = self.plan_flush(table, ts)
        hist = self.begin_flush(plan)
        try:
            vals, dests = self._frame_vals(plan, result, raw)
            vals = {k: torch.from_numpy(np.ascontiguousarray(v)).to(
                self.device) for k, v in vals.items()}
            hdev.write_window(hist, vals, dests, plan.col, hspec=self.spec,
                              clear=True)
        except BaseException:
            self.abort_flush()
            raise
        self.commit_flush(plan, hist)

    @staticmethod
    def _split_pair(v):
        """f64 -> normalised (hi, lo) f32 pair; the exact inverse of the
        host-side hi+lo combine for pairs the device normalised."""
        hi = np.asarray(v, np.float64).astype(np.float32)
        lo = (np.asarray(v, np.float64) - hi.astype(np.float64)).astype(
            np.float32)
        return hi, lo

    def _frame_vals(self, plan: HistoryPlan, result: dict, raw: dict):
        def bucket(arr, dest, fill=0.0):
            arr = np.asarray(arr)
            b = len(_pad_pow2(dest, SENTINEL, floor=64))
            out = np.full((b,) + arr.shape[1:], fill, arr.dtype)
            out[:len(arr)] = arr
            return out

        dc, dg, dst_, ds, dh = plan.dests
        chi, clo = self._split_pair(result["counter"])
        hct_hi, hct_lo = self._split_pair(result["histo_count"])
        hs_hi, hs_lo = self._split_pair(result["histo_sum"])
        vals = {
            "counter_hi": bucket(chi, dc),
            "counter_lo": bucket(clo, dc),
            "gauge": bucket(np.asarray(raw["gauge"], np.float32), dg),
            "status": bucket(np.asarray(result["status"], np.float32),
                             dst_),
            "hll": bucket(np.asarray(raw["hll"], np.int32), ds),
            "h_mean": bucket(np.asarray(raw["h_mean"], np.float32), dh),
            "h_weight": bucket(np.asarray(raw["h_weight"], np.float32),
                               dh),
            "h_min": bucket(np.asarray(raw["h_min"], np.float32), dh),
            "h_max": bucket(np.asarray(raw["h_max"], np.float32), dh),
            "h_count_hi": bucket(hct_hi, dh),
            "h_count_lo": bucket(hct_lo, dh),
            "h_sum_hi": bucket(hs_hi, dh),
            "h_sum_lo": bucket(hs_lo, dh),
        }
        dests = tuple(_pad_pow2(d, SENTINEL, floor=64)
                      for d in plan.dests)
        return vals, dests

    # -- reads ---------------------------------------------------------------
    @property
    def armed(self) -> bool:
        return self._hist is not None

    @property
    def seq(self) -> int:
        return self._seq

    def acquire_read(self) -> hdev.HistoryState:
        """Enter the dispatch critical section and return the ring. Pair
        with release_read() AFTER dispatching the read (not after
        materialising it: later writes are enqueued behind it on the same
        stream)."""
        self._dlock.acquire()
        return self._ensure_hist()

    def release_read(self) -> None:
        self._dlock.release()

    def tick_sync(self, token) -> None:
        self._sync.tick(token)

    def iter_keys(self):
        """[(kind_idx, (kind, name, joined_tags), row)] snapshot of the
        admission index."""
        with self._mlock:
            return [(k, key, row) for k in range(len(KINDS))
                    for key, row in self._rows[k].items()]

    def rows_for_keys(self, k: int, keys):
        with self._mlock:
            return [self._rows[k].get(key) for key in keys]

    def read_values(self, seq: int, items):
        """Scalar-kind lookback for the watch tier: items is a list of
        (kind_idx, row) with kind_idx in {0 counter, 1 gauge, 2 status};
        returns f64[len(items)], NaN where window `seq` is not resident at
        tier 0 or the row is unset."""
        out = np.full(len(items), np.nan, np.float64)
        if not items:
            return out
        with self._mlock:
            col = self._col_of(0, seq)
            meta = self._cols[col]
            if (meta is None or meta.tier != 0 or meta.start != seq
                    or not self.armed):
                return out
        by_kind = [[], [], []]
        backrefs = [[], [], []]
        for i, (k, row) in enumerate(items):
            if k <= 2 and row is not None:
                by_kind[k].append(row)
                backrefs[k].append(i)
        idx = [torch.from_numpy(_pad_pow2(b, 0)).to(self.device)
               for b in by_kind]
        with self._dlock:
            hist = self._ensure_hist()
            chi, clo, g, st = hdev.read_column(
                hist, col, idx[0], idx[1], idx[2], hspec=self.spec)
            self._sync.tick(st)
        chi = chi.cpu().numpy().astype(np.float64)
        clo = clo.cpu().numpy().astype(np.float64)
        g = g.cpu().numpy()
        st = st.cpu().numpy()
        for j, i in enumerate(backrefs[0]):
            out[i] = chi[j] + clo[j]
        for j, i in enumerate(backrefs[1]):
            out[i] = g[j]
        for j, i in enumerate(backrefs[2]):
            out[i] = st[j]
        return out

    # -- range planning ------------------------------------------------------
    def plan_range(self, range_s: float, window_s: Optional[float],
                   step_s: Optional[float],
                   max_steps: int) -> RangePlan:
        """Translate a [now - range_s, now] request into per-step column
        cover sets. Times quantise to flush intervals; each step's cover
        is the binary decomposition of its seq span over the decimation
        tiers (largest resident tier first), so a step touches
        O(tiers + log windows) columns instead of one per interval."""
        if self._c_range is not None:
            self._c_range.inc()
        iv = max(self.interval_s, 1e-9)
        with self._mlock:
            last = self._seq - 1
            n_back = max(1, int(round(range_s / iv)))
            step_w = max(1, int(round((step_s or range_s) / iv)))
            win_w = max(1, int(round((window_s or step_s or range_s)
                                     / iv)))
            w = self.spec.total_cols
            sel_rows, steps = [], []
            j = 0
            while j * step_w < n_back and len(steps) < max_steps:
                hi = last - j * step_w
                lo = hi - win_w + 1
                j += 1
                if hi < 0:
                    break
                row = np.zeros(w, np.float32)
                complete = self._cover(row, max(lo, 0), hi)
                if lo < 0:
                    complete = False
                sel_rows.append(row)
                steps.append(RangeStep(
                    max(lo, 0), hi,
                    self._ts_of(max(lo, 0), first=True),
                    self._ts_of(hi, first=False), complete))
            if not steps:
                sel_rows = [np.zeros(w, np.float32)]
                steps = [RangeStep(0, -1, 0.0, 0.0, False)]
            rank = np.zeros(w, np.float32)
            for c, m in enumerate(self._cols):
                if m is not None:
                    rank[c] = float(m.end + 1)
            return RangePlan(np.stack(sel_rows), rank, steps)

    def _cover(self, row: np.ndarray, lo: int, hi: int) -> bool:
        """Mark the minimal resident cover of tier columns for the
        inclusive seq span [lo, hi] in `row`; returns True iff the whole
        span was resident."""
        complete = True
        cur = hi
        while cur >= lo:
            placed = False
            # largest tier whose aligned block ends at `cur` and fits
            for t in range(self.spec.tiers, -1, -1):
                size = 1 << t
                if (cur + 1) % size or cur - size + 1 < lo:
                    continue
                m = (cur + 1) // size - 1
                col = self._col_of(t, m)
                meta = self._cols[col]
                if (meta is not None and meta.tier == t
                        and meta.start == m * size):
                    row[col] = 1.0
                    cur -= size
                    placed = True
                    break
            if not placed:
                complete = False
                cur -= 1
        return complete

    def _ts_of(self, seq: int, *, first: bool) -> float:
        col = self._col_of(0, seq)
        m = self._cols[col]
        if m is not None and m.tier == 0 and m.start == seq:
            return m.ts - (self.interval_s if first else 0.0)
        return 0.0

    # -- persistence ---------------------------------------------------------
    def snapshot(self) -> dict:
        """Checkpoint payload: host metadata + the ring arrays as numpy
        (byte-exact round trip), in the JAX package's layout."""
        with self._dlock, self._mlock:
            arrays = convert.history_to_numpy(self._ensure_hist())
            meta = {
                "spec": self.spec.to_dict(),
                "seq": self._seq,
                "interval_s": self.interval_s,
                "cols": [list(m) if m is not None else None
                         for m in self._cols],
                "keys": [[[row, list(key)]
                          for key, row in self._rows[k].items()]
                         for k in range(len(KINDS))],
                "last_seen": [self._last_seen[k].tolist()
                              for k in range(len(KINDS))],
            }
        return {"meta": meta, "arrays": arrays}

    def restore(self, data: dict) -> None:
        """Adopt a checkpointed ring, built on this writer's device. A
        spec mismatch (different shape parameters on the restoring
        server) keeps the fresh empty ring -- history is a cache;
        correctness never depends on it."""
        meta = data.get("meta") or {}
        if HistorySpec.from_dict(meta.get("spec") or {}) != self.spec:
            return
        arrays = data.get("arrays") or {}
        if sorted(arrays) != sorted(hdev.HISTORY_FIELDS):
            return
        with self._dlock, self._mlock:
            self._hist = convert.history_from_numpy(arrays, self.device)
            self._seq = int(meta["seq"])
            self._cols = [(_ColMeta(*m) if m is not None else None)
                          for m in meta["cols"]]
            self._rows = [dict() for _ in KINDS]
            self._row_key = [dict() for _ in KINDS]
            for k in range(len(KINDS)):
                for row, key in meta["keys"][k]:
                    key = tuple(key)
                    self._rows[k][key] = int(row)
                    self._row_key[k][int(row)] = key
                self._last_seen[k] = np.asarray(meta["last_seen"][k],
                                                np.int64)
                used = set(self._row_key[k])
                self._free[k] = [r for r in
                                 range(self.spec.rows_for(k) - 1, -1, -1)
                                 if r not in used]
