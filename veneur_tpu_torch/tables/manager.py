"""Key-table growth planning, idle-eviction census, and accounting.

The TableManager owns the policy half of table growth: WHEN to grow (or
shrink) which kind's table, and the exact accounting that makes every
non-admitted row visible. The mechanism half (executing a capacity
change at the swap boundary) lives in growth.py, the one grow site.

Key tables are flush-scoped (a fresh table per interval), so "idle
eviction" is not a table operation at all: a key that stops arriving
simply occupies nothing next interval. What the census adds is exact
OBSERVABILITY of that reclamation — `(kind, key) -> last_seen`, swept
against `table_idle_ttl_s`, each expiry counted once in
`evicted_total` — plus the demand signal that lets capacity shrink
back after an explosion subsides. The census is bounded at CENSUS_MAX
entries; past that it disarms (eviction accounting reads 0, growth
still works) rather than competing with the flush for host time.
"""

from __future__ import annotations

import logging
from collections import deque
from typing import Dict, Optional, Tuple

from veneur_tpu_torch.tables.growth import spec_capacities

log = logging.getLogger("veneur_tpu_torch.tables")

KINDS = ("counter", "gauge", "set", "histo", "status")


class TableManager:
    # census hard bound: beyond this the census costs more than the
    # observability is worth; growth/pressure keep running without it
    CENSUS_MAX = 1 << 20

    def __init__(self, baseline_spec, n_shards: int = 1,
                 max_capacity: int = 1 << 24, idle_ttl_s: float = 300.0,
                 high_water: float = 0.85, shrink_window: int = 8):
        self.baseline = spec_capacities(baseline_spec)
        self.n_shards = max(1, int(n_shards))
        self.max_capacity = int(max_capacity)
        self.idle_ttl_s = float(idle_ttl_s)
        self.high_water = float(high_water)
        # exact accounting, by kind (registry families read these)
        self.grows: Dict[str, int] = {}
        self.evicted: Dict[str, int] = {}
        self.grow_events = 0            # grow swaps executed (any kind)
        self.last_grow_swap_ns = 0      # pause cost of the last grow
        # occupancy history for the conservative shrink rule
        self._occ = {k: deque(maxlen=max(2, int(shrink_window)))
                     for k in KINDS}
        # native `dropped` is lifetime-cumulative; per-interval deltas
        self._prev_native_dropped: Dict[str, int] = {}
        # idle census
        self._census: Dict[Tuple[str, object], float] = {}
        self._census_on = True
        self._last_sweep = 0.0
        self.pressure = None            # set by the server when enabled
        self._forced: Optional[Dict[str, int]] = None

    # -- occupancy -----------------------------------------------------------
    def occupancy(self, agg) -> Dict[str, Tuple[int, int, int]]:
        """Per kind (used, dropped_this_interval, capacity) of the LIVE
        interval. Pipeline-thread only (the native stats call must not
        interleave with feed, and Python table reads race staging
        otherwise)."""
        out: Dict[str, Tuple[int, int, int]] = {}
        eng = getattr(agg, "eng", None)
        if eng is not None and hasattr(eng, "table_stats"):
            for k, (used, dropped_cum, cap) in eng.table_stats().items():
                prev = self._prev_native_dropped.get(k, 0)
                self._prev_native_dropped[k] = dropped_cum
                out[k] = (int(used), max(0, dropped_cum - prev), int(cap))
            st = getattr(agg.table, "status", None)
            if st is not None:
                out["status"] = (sum(st.next_free), st.dropped, st.capacity)
        else:
            for k, t in agg.table.tables.items():
                out[k] = (sum(t.next_free), t.dropped, t.capacity)
        return out

    # -- grow / shrink planning ----------------------------------------------
    def plan(self, agg) -> Optional[Dict[str, int]]:
        """Per-kind capacity targets for a grow swap at THIS flush
        boundary, or None. Pipeline-thread only. Growth doubles until
        demand (admitted + dropped rows, i.e. what WANTED a slot) fits
        under the high-water mark; shrink halves only after a full
        window of intervals at < 1/4 occupancy and never below the
        config baseline. Both directions preserve n_shards
        divisibility — doubling/halving keeps it, and the max-capacity
        clamp rounds down to a multiple."""
        if self._forced is not None:
            forced, self._forced = self._forced, None
            for kind in forced:
                self._occ[kind].clear()
            return forced
        targets: Dict[str, int] = {}
        for kind, (used, dropped, cap) in self.occupancy(agg).items():
            hist = self._occ.get(kind)
            if hist is not None:
                hist.append(used)
            demand = used + dropped
            if demand >= self.high_water * cap:
                target = cap
                while (demand >= self.high_water * target
                       and target < self.max_capacity):
                    target *= 2
                clamp = self.max_capacity - (self.max_capacity
                                             % self.n_shards)
                target = min(target, max(cap, clamp))
                if target > cap:
                    targets[kind] = target
                continue
            base = self.baseline.get(kind, cap)
            if (hist is not None and len(hist) == hist.maxlen
                    and cap > base and max(hist) < cap // 4):
                half = cap // 2
                if half >= base and half % self.n_shards == 0:
                    targets[kind] = half
        if not targets:
            return None
        for kind in targets:
            self._occ[kind].clear()
        return targets

    def force(self, targets: Dict[str, int]) -> None:
        """Stage an operator-requested capacity change for the next
        flush boundary (Server.trigger_table_grow). Validated here so
        the pipeline thread never sees an unexecutable plan."""
        bad = {k: v for k, v in targets.items()
               if k not in KINDS or int(v) <= 0
               or int(v) % self.n_shards}
        if bad or not targets:
            raise ValueError(
                f"invalid grow targets {bad or targets}: kinds must be "
                f"in {KINDS} with positive capacities divisible by "
                f"n_shards={self.n_shards}")
        self._forced = {k: int(v) for k, v in targets.items()}

    def note_grow(self, targets: Dict[str, int], swap_ns: int) -> None:
        """Account an executed grow swap (growth.grow_swap ran)."""
        self.grow_events += 1
        self.last_grow_swap_ns = int(swap_ns)
        for kind in targets:
            self.grows[kind] = self.grows.get(kind, 0) + 1

    # -- idle census ---------------------------------------------------------
    @staticmethod
    def _iter_meta(table):
        """(table_kind, [(slot, SlotMeta)]) pairs of a DETACHED table,
        Python KeyTable or finalized NativeKeyTable alike."""
        tables = getattr(table, "tables", None)
        if tables is not None:
            return [(k, t.meta) for k, t in tables.items()]
        out = [(k, m) for k, m in table.meta.items()]
        out.append(("status", table.status.meta))
        return out

    def census_flush(self, table, now: float) -> None:
        """Flush-worker side: mark the detached interval's keys live and
        expire idle ones (exact `evicted_total`). Runs OFF the pipeline
        thread against an immutable finalized table."""
        if not self._census_on:
            return
        census = self._census
        for kind, meta in self._iter_meta(table):
            for _slot, m in meta:
                jt = m.joined_tags if m.joined_tags is not None \
                    else ",".join(m.tags)
                census[(kind, (m.kind, m.name, jt))] = now
        if len(census) > self.CENSUS_MAX:
            self._census_on = False
            self._census = {}
            log.warning("table census disarmed at %d live keys "
                        "(> %d); evicted_total accounting paused",
                        len(census), self.CENSUS_MAX)
            return
        # amortized sweep: at most ~4 walks per TTL period
        if now - self._last_sweep < max(self.idle_ttl_s / 4.0, 1.0):
            return
        self._last_sweep = now
        expired = [k for k, seen in census.items()
                   if now - seen > self.idle_ttl_s]
        for k in expired:
            del census[k]
            kind = k[0]
            self.evicted[kind] = self.evicted.get(kind, 0) + 1

    # -- registry snapshots --------------------------------------------------
    def grows_snapshot(self):
        return [((k,), v) for k, v in sorted(self.grows.items())]

    def evicted_snapshot(self):
        return [((k,), v) for k, v in sorted(self.evicted.items())]

    @staticmethod
    def capacity_snapshot(spec):
        return [((k,), v) for k, v in sorted(spec_capacities(spec).items())]

    # -- checkpoint sidecar ("keytables" chunk) ------------------------------
    def snapshot_state(self, spec) -> dict:
        """Sidecar payload: the LIVE per-kind capacities (so restore
        re-grows before folding) plus the cumulative accounting. The
        capacities live here, NOT in schema_hash — cross-capacity
        restore stays legal (codec.py covers field NAMES only)."""
        out = {"capacities": spec_capacities(spec),
               "grows": dict(self.grows),
               "evicted": dict(self.evicted),
               "grow_events": self.grow_events}
        if self.pressure is not None:
            out["merged"] = dict(self.pressure.merged)
            out["demoted"] = dict(self.pressure.demoted)
        return out

    def restore_state(self, d: dict) -> None:
        """Adopt a sidecar's cumulative accounting (capacities are
        adopted separately by growth.adopt_capacities, before fold)."""
        for key, target in (("grows", self.grows),
                            ("evicted", self.evicted)):
            for k, v in dict(d.get(key) or {}).items():
                if k in KINDS:
                    target[k] = int(v)
        self.grow_events = int(d.get("grow_events", self.grow_events))
        if self.pressure is not None:
            for key, target in (("merged", self.pressure.merged),
                                ("demoted", self.pressure.demoted)):
                for k, v in dict(d.get(key) or {}).items():
                    if k in KINDS:
                        target[k] = int(v)
