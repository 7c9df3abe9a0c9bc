"""Reshard planning: the moved-key residue math and the partitioner that
turns one drained interval's snapshot into per-destination-shard
migration units.

Shard routing is `route_digest(kind, name, joined_tags) % n_shards`
(collective/keytable.py, persistence/restore.py and the engine's
KindTable share the recipe), so whether a key moves under a resize is a
function of its digest and the two shard counts alone.

A migration unit is a mini-snapshot in the persistence/snapshot.py
schema, restricted to the rows one destination shard owns under the new
map. Units are numbered by destination shard, which makes the
exactly-once envelope seq deterministic: a crashed transfer replays the
same (epoch, seq) per unit, and the receiver's DedupWindow suppresses
every unit that already folded (coordinator.py).
"""

from __future__ import annotations

import dataclasses
from math import gcd
from typing import Dict, List

import numpy as np

from veneur_tpu_torch.collective.keytable import route_digest

# snapshot table name -> the array keys paired with it
# (persistence/snapshot.py)
_KIND_ARRAYS = {"counter": ("counter",), "gauge": ("gauge",),
                "status": ("status",), "set": ("hll",),
                "histo": ("h_mean", "h_weight", "h_min", "h_max",
                          "h_recip")}


def key_moved(digest: int, old_n: int, new_n: int) -> bool:
    """True iff a key with this routing digest changes owner shard when
    the shard count goes old_n -> new_n."""
    return (digest % old_n) != (digest % new_n)


def moved_fraction(old_n: int, new_n: int) -> float:
    """The fraction of the digest space that changes owner, over one
    period of the joint residue cycle lcm(old_n, new_n) (the u32 digest
    space's partial last cycle is ~lcm/2^32 of it)."""
    if old_n == new_n:
        return 0.0
    period = old_n * new_n // gcd(old_n, new_n)
    moved = sum(1 for r in range(period) if r % old_n != r % new_n)
    return moved / period


@dataclasses.dataclass(frozen=True)
class ReshardPlan:
    """One resize: old_n -> new_n. `signature` names it in logs and
    summaries."""
    old_n: int
    new_n: int

    def __post_init__(self):
        if self.old_n < 1 or self.new_n < 1:
            raise ValueError(f"shard counts must be >= 1 "
                             f"({self.old_n} -> {self.new_n})")

    @property
    def signature(self) -> str:
        return f"{self.old_n}->{self.new_n}"

    def dest_shard(self, digest: int) -> int:
        return digest % self.new_n

    def moved(self, digest: int) -> bool:
        return key_moved(digest, self.old_n, self.new_n)


def _row_digest(entry) -> int:
    """Digest of one snapshot table row (the schema's 8-field entry).
    `actual_kind` tells histogram from timer: they share a table but are
    distinct keys."""
    name, tags, _scope, _host, _msg, _imp, actual_kind, joined = entry
    if joined is None:
        joined = ",".join(tags)
    return route_digest(actual_kind, name, joined)


def partition_units(snap: dict, plan: ReshardPlan) -> List[dict]:
    """Split a drained interval's snapshot into per-destination-shard
    migration units, in destination order (a shard with no rows gets no
    unit; a unit's seq is its `dest_shard` either way).

    Every live row re-enters the new mesh, which starts empty, but rows
    whose owner is unchanged are counted apart from moved ones
    (`rows_moved`, what veneur.reshard.rows_moved_total reports: the
    cross-owner traffic a fleet would put on the wire)."""
    arrays = snap["arrays"]
    tables = snap["tables"]
    by_dest: Dict[int, Dict[str, List[int]]] = {}
    moved_rows: Dict[int, int] = {}
    for kind, entries in tables.items():
        for i, entry in enumerate(entries):
            d = _row_digest(entry)
            dest = plan.dest_shard(d)
            by_dest.setdefault(dest, {}).setdefault(kind, []).append(i)
            if plan.moved(d):
                moved_rows[dest] = moved_rows.get(dest, 0) + 1
    units: List[dict] = []
    for dest in sorted(by_dest):
        sel = by_dest[dest]
        u_tables = {kind: [tables[kind][i] for i in sel.get(kind, ())]
                    for kind in tables}
        u_arrays = {}
        for kind, arr_keys in _KIND_ARRAYS.items():
            idx = np.asarray(sel.get(kind, ()), np.int64)
            for ak in arr_keys:
                src = np.asarray(arrays[ak])
                u_arrays[ak] = src[idx] if len(idx) else src[:0]
        units.append({
            "agg_kind": snap.get("agg_kind", "single"),
            "n_shards": int(snap.get("n_shards", plan.old_n)),
            "spec": snap["spec"],
            "interval_ts": snap.get("interval_ts", 0),
            "created_at": snap.get("created_at", 0),
            "hostname": snap.get("hostname", ""),
            "tables": u_tables,
            "arrays": u_arrays,
            "spill": b"",
            "spill_entries": 0,
            "forward": None,
            # unit bookkeeping, not part of the persisted schema
            "dest_shard": dest,
            "rows": sum(len(v) for v in u_tables.values()),
            "rows_moved": moved_rows.get(dest, 0),
        })
    return units
