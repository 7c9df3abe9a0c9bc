"""Pressure ladder below hard key-table capacity.

Attached to every flush interval's fresh Python KeyTable by the
backend's swap() (Aggregator.set_pressure); the native C++ engine keeps
its exact counted drops instead — those are absorbed by the next grow,
which is the native path's pressure valve.

The ladder runs on the slot-allocation MISS path only (the hit path
stays one dict probe — host.py KeyTable.slot_for), in order:

1. demotion  — a key family (table kind, metric name) whose tag-variant
   allocation rate tripped the explosion detector sends every NEW
   variant to one aggregate-only rollup row tagged
   `veneur_rollup:true`; the exact count of collapsed variants is
   `demoted_rows_total`. This is the per-tenant quarantine
   (reliability/tenancy.py) generalized to per-key-family
   (arXiv:2004.10332's bucketed aggregation under cardinality pressure).
2. admission — room in the key's shard: normal allocation. The shard
   check runs BEFORE t.alloc so a ladder fall-through never
   double-counts `dropped`.
3. merging   — counters only: a full shard redirects the key to one of
   the SALSA merge cells pre-allocated at attach (arXiv:2102.12531's
   self-adjusting cell merge: neighbors share a cell, value mass is
   conserved). Counted once per distinct merged key per interval as
   `merged_cells_total`. Error bound: a merge cell's value is the EXACT
   sum of its members' increments, so any single member's value is
   over-reported by at most the cell total minus its own contribution
   (additive, pinned by tests/test_torch_tables.py).
4. drop      — exact counted drop (`t.dropped`).

Redirects install a by_key alias, so every later sample of a demoted or
merged key takes the one-probe hit path — the ladder itself is paid
once per distinct key per interval.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

# counter name that owns the SALSA merge cells; the reserved tag marks
# rollup rows so downstream consumers can tell exact rows from
# aggregate-only ones
MERGE_CELL_NAME = "veneur.table.overflow"
ROLLUP_TAG = "veneur_rollup:true"


class TablePressure:
    """Cross-interval pressure state shared by successive KeyTables.

    Counters (`merged`, `demoted`) are cumulative across intervals and
    keyed by table kind — the registry's labeled-by-kind families read
    them directly. Variant-rate estimators decay at each attach (one
    attach per flush interval), the same windowed-decay detector as
    reliability/tenancy.py's quarantine.
    """

    def __init__(self, salsa_enabled: bool = False, salsa_cells: int = 64,
                 demote_threshold: int = 4096, demote_decay: float = 0.5):
        self.salsa_enabled = bool(salsa_enabled)
        self.salsa_cells = int(salsa_cells)
        self.demote_threshold = int(demote_threshold)
        self.demote_decay = float(demote_decay)
        # cumulative, by table kind ("counter"/"gauge"/"set"/"histo"/
        # "status") — exact accounting for the registry families
        self.merged: Dict[str, int] = {}
        self.demoted: Dict[str, int] = {}
        # tag-explosion detector: (kind, name) -> decayed variant-rate
        # estimate; window counts NEW variant allocations this interval
        self._est: Dict[Tuple[str, str], float] = {}
        self._window: Dict[Tuple[str, str], int] = {}
        self._demoted_families: set = set()
        # per-attach state
        self._kind_of: Dict[int, str] = {}       # id(_KindTable) -> kind
        self._cells: list = []                   # counter merge cell slots
        self._merged_keys: set = set()           # interval dedup for merged

    # -- interval boundary ---------------------------------------------------
    def attach(self, table) -> None:
        """Install on a fresh KeyTable (swap boundary, pipeline thread).
        Rolls the variant-rate window into the decayed estimate and
        pre-allocates the SALSA merge cells in the new counter table."""
        table.pressure = self
        self._kind_of = {id(t): k for k, t in table.tables.items()}
        # decay + roll the detector windows; prune quiet families so the
        # estimator map stays bounded by the active-family set
        if self._est or self._window:
            est = {}
            for fam in set(self._est) | set(self._window):
                v = (self._est.get(fam, 0.0) * self.demote_decay
                     + self._window.get(fam, 0))
                if v >= 1.0 or fam in self._demoted_families:
                    est[fam] = v
                if v >= self.demote_threshold:
                    self._demoted_families.add(fam)
            self._est = est
            self._window = {}
        self._merged_keys = set()
        self._cells = []
        if self.salsa_enabled:
            t = table.tables["counter"]
            for i in range(self.salsa_cells):
                key = ("counter", MERGE_CELL_NAME, f"cell:{i}")
                slot = t.by_key.get(key)
                if slot is None:
                    slot = t.alloc(key, i, MERGE_CELL_NAME, (f"cell:{i}",),
                                   0, "counter", joined_tags=f"cell:{i}")
                if slot is None:
                    break  # table smaller than the cell block: stop early
                self._cells.append(slot)

    # -- miss-path ladder ----------------------------------------------------
    def admit(self, t, key, digest: int, name: str, tags: tuple, scope: int,
              kind: str, hostname: str, imported: bool,
              joined_tags) -> Optional[int]:
        tkind = self._kind_of.get(id(t), kind)
        fam = (tkind, name)
        # 1. demoted family: collapse the variant onto the rollup row
        if fam in self._demoted_families and joined_tags != ROLLUP_TAG:
            rollup_key = (kind, name, ROLLUP_TAG)
            slot = t.by_key.get(rollup_key)
            if slot is None:
                slot = t.alloc(rollup_key, digest, name, (ROLLUP_TAG,),
                               scope, kind, hostname=hostname,
                               joined_tags=ROLLUP_TAG)
            if slot is not None:
                t.by_key[key] = slot  # alias: next sample hits fast path
                self.demoted[tkind] = self.demoted.get(tkind, 0) + 1
                return slot
            # rollup row itself unallocatable: fall through the ladder
        # 2. room in the key's shard: normal allocation (+ detector)
        shard = digest % t.n_shards
        if t.next_free[shard] < t.per_shard:
            w = self._window.get(fam, 0) + 1
            self._window[fam] = w
            if w + self._est.get(fam, 0.0) >= self.demote_threshold:
                self._demoted_families.add(fam)
            return t.alloc(key, digest, name, tags, scope, kind,
                           hostname=hostname, imported=imported,
                           joined_tags=joined_tags)
        # 3. SALSA merge cell (counters only): conserve the value mass
        if self._cells and tkind == "counter":
            slot = self._cells[digest % len(self._cells)]
            t.by_key[key] = slot
            if key not in self._merged_keys:
                self._merged_keys.add(key)
                self.merged[tkind] = self.merged.get(tkind, 0) + 1
            return slot
        # 4. exact counted drop
        t.dropped += 1
        return None

    # -- registry snapshots --------------------------------------------------
    def merged_snapshot(self):
        return [((k,), v) for k, v in sorted(self.merged.items())]

    def demoted_snapshot(self):
        return [((k,), v) for k, v in sorted(self.demoted.items())]
