"""Build the in-memory checkpoint snapshot from a flush's outputs.

The async writer's zero-extra-transfer contract lives here: a checkpoint
is assembled ONLY from what the flush already moved device→host —
`compute_flush`'s compact result arrays and (with want_raw) the live
rows' mergeable sketch state. No additional device reads, no
full-capacity DeviceState copies; the snapshot is O(live keys).

Snapshot layout (the dict codec.encode_to_dir serializes):

  agg_kind     "single" | "sharded"
  n_shards     shard count the tables were laid out for
  spec         TableSpec fields as a plain dict
  interval_ts  the swap timestamp of the captured interval
  created_at   wall clock at build time
  hostname     reporting hostname
  tables       {kind: [[name, tags, scope, hostname, message,
                        imported_only, actual_kind, joined_tags], ...]}
               in ALLOCATION ORDER — entry i pairs with row i of the
               kind's arrays (the compute_flush pairing contract)
  arrays       counter f64[nc]; gauge f32[ng]; status f32[nst];
               hll u8[ns, R]; h_mean/h_weight f32[nh, C+T];
               h_min/h_max f32[nh]; h_recip f64[nh]
  spill        ForwardSpillBuffer.to_bytes() wire bytes (b"" if none)
  forward      exactly-once forwarding identity + receiver dedup state
               ({"source_id", "epoch", "next_seq", "dedup"}; absent when
               forward_dedup_window is 0) — see forward/envelope.py
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import numpy as np

from veneur_tpu_torch.aggregation.host import KeyTable


def _table_rows(table: KeyTable, kind: str) -> list:
    rows = []
    for _slot, meta in table.get_meta(kind):
        rows.append([meta.name, list(meta.tags), int(meta.scope),
                     meta.hostname, meta.message, bool(meta.imported_only),
                     meta.kind, meta.joined_tags])
    return rows


def spec_dict(spec) -> Dict[str, object]:
    return {f.name: getattr(spec, f.name)
            for f in dataclasses.fields(spec)}


def build_snapshot(spec, table: KeyTable, result: Dict[str, np.ndarray],
                   raw: Dict[str, np.ndarray], *, agg_kind: str,
                   n_shards: int, interval_ts: float, hostname: str = "",
                   spill: Optional[bytes] = None,
                   spill_entries: int = 0,
                   forward_meta: Optional[dict] = None,
                   watches: Optional[dict] = None,
                   history: Optional[dict] = None,
                   tenants: Optional[dict] = None,
                   keytables: Optional[dict] = None) -> dict:
    """`result`/`raw` are compute_flush's outputs for the interval being
    checkpointed (want_raw=True — both backends emit identical raw keys).
    `table` is the interval's detached KeyTable."""
    arrays = {
        # counter is already the f64 hi+lo fold — exact for any count a
        # double holds, restored via the two-float split in restore.py
        "counter": np.asarray(raw["counter"], np.float64),
        "gauge": np.asarray(raw["gauge"], np.float32),
        # raw has no status lane (status never forwards); the compact
        # flush result carries the same per-live-row values
        "status": np.asarray(result["status"], np.float32),
        # v2: 6-bit packed i32 words straight off the flush raw gather
        # (restore folds dense-u8 v1 rows through the same merge path)
        "hll": np.asarray(raw["hll"], np.int32),
        "h_mean": np.asarray(raw["h_mean"], np.float32),
        "h_weight": np.asarray(raw["h_weight"], np.float32),
        "h_min": np.asarray(raw["h_min"], np.float32),
        "h_max": np.asarray(raw["h_max"], np.float32),
        "h_recip": np.asarray(raw["h_recip"], np.float64),
    }
    tables = {kind: _table_rows(table, kind)
              for kind in ("counter", "gauge", "status", "set")}
    # histogram + timer share the histo device table; the per-row
    # actual_kind field (meta.kind) disambiguates on restore
    tables["histo"] = _table_rows(table, "histogram")
    # the sharded backend's live-slot gather pads index arrays to a
    # bucket size (live_indices), so its rows carry a zero tail past the
    # meta count; pad sits after the live rows (get_meta order), so
    # trimming to n_meta restores the pairing contract
    _kind_arrays = {"counter": ("counter",), "gauge": ("gauge",),
                    "status": ("status",), "set": ("hll",),
                    "histo": ("h_mean", "h_weight", "h_min", "h_max",
                              "h_recip")}
    for kind, arr_keys in _kind_arrays.items():
        n_meta = len(tables[kind])
        for arr_key in arr_keys:
            n_rows = len(arrays[arr_key])
            if n_rows < n_meta:
                raise ValueError(
                    f"snapshot pairing broken for {kind}: {n_meta} table "
                    f"entries vs {n_rows} array rows")
            if n_rows > n_meta:
                arrays[arr_key] = arrays[arr_key][:n_meta]
    return {
        "agg_kind": agg_kind,
        "n_shards": int(n_shards),
        "spec": spec_dict(spec),
        "interval_ts": int(interval_ts),
        "created_at": time.time(),
        "hostname": hostname,
        "tables": tables,
        "arrays": arrays,
        "spill": spill or b"",
        "spill_entries": int(spill_entries),
        # exactly-once forwarding state; None/absent = feature off
        "forward": forward_meta,
        # streaming watch tier registrations + firing state
        # (veneur_tpu/watch/); None/absent = tier off or no watches
        "watches": watches,
        # history ring sidecar (veneur_tpu/history/): key index + raw
        # window arrays, restored byte-exact; None/absent = tier off
        "history": history,
        # tenant quarantine table + exact demoted-row totals
        # (veneur_tpu/reliability/tenancy.py); None/absent = tier off
        "tenants": tenants,
        # self-adjusting key tables (veneur_tpu/tables/): LIVE per-kind
        # capacities + growth accounting. Deliberately OUTSIDE
        # schema_hash (which covers spec field NAMES only) so
        # cross-capacity restore keeps working both directions;
        # None/absent = growth off
        "keytables": keytables,
    }
