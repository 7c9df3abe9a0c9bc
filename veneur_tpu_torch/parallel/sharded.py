"""The key table sharded into [R, S] tiles, and the replica merge.

The JAX package lays its state over a 2-D device mesh: a "shard" axis
(key-space parallelism, the reference's `Digest % numWorkers` routing)
and a "replica" axis (one local tier's worth of state each, merged at
flush time by collectives). Every state leaf carries leading [R, S]
dims. With fewer devices than tiles the JAX mesh collapses and every
tile lives on one device under those leading dims.

This package keeps that layout on one card: a `DeviceState` whose
tensors have leading [R, S] dims, all on one device, carved out of ONE
allocation of the table R·S times the per-shard spec (`flat_spec`). A
tile's leaves are contiguous slices of that table, so the whole grid is
also the single-device table of the flattened spec, row (r·S + s)·K +
local, which is the layout `query_flat_state` reads.

Ingest runs as one step over the flattened table: tiles' slot ranges
are disjoint and every write is row-wise, so one fused-ingest launch
(one `build_streams` prologue, one `compact_core` when due) over the
flattened view equals R·S per-tile steps. Each tile's local slots are
offset by its base row; a tile's padding sentinel (its per-shard
capacity) would become row 0 of the next tile once offset, so every slot
outside [0, per-shard capacity) is remapped to the flattened table's
own sentinel first, in every slot lane.

`Layout` stands where the JAX mesh stood: R and S, and the
`torch.distributed` process group the replica rows are spread over
(None in one process). With a group, each process holds `r_local`
replica rows and the replica merge gathers the others' rows over it
(collective/ops.py).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from veneur_tpu_torch.aggregation.state import (DeviceState, TableSpec,
                                                empty_state)
from veneur_tpu_torch.aggregation.step import (
    _F32_LANES, _U8_LANES, Batch, batch_sizes, compact_core, ingest_core,
    pack_batch, packed_layout)

# slot lane -> the TableSpec capacity it indexes
SLOT_LANES = {"counter_slot": "counter_capacity",
              "gauge_slot": "gauge_capacity",
              "status_slot": "status_capacity",
              "set_slot": "set_capacity",
              "histo_slot": "histo_capacity",
              "histo_stat_slot": "histo_capacity"}

# table kind -> the TableSpec capacity it sizes (each divides by S)
KIND_CAPACITY = {"counter": "counter_capacity", "gauge": "gauge_capacity",
                 "status": "status_capacity", "set": "set_capacity",
                 "histo": "histo_capacity"}
_CAPACITIES = tuple(KIND_CAPACITY.values())


@dataclasses.dataclass(frozen=True)
class Layout:
    """The [R, S] grid and the process group its replica rows spread
    over (None: every row in this process)."""
    n_replicas: int
    n_shards: int
    group: Optional[object] = None

    @property
    def world(self) -> int:
        if self.group is None:
            return 1
        import torch.distributed as dist
        return dist.get_world_size(self.group)

    @property
    def rank(self) -> int:
        if self.group is None:
            return 0
        import torch.distributed as dist
        return dist.get_rank(self.group)

    @property
    def r_local(self) -> int:
        """Replica rows held by this process."""
        if self.n_replicas % self.world:
            raise ValueError(f"{self.n_replicas} replicas do not divide "
                             f"over {self.world} processes")
        return self.n_replicas // self.world


def divides(spec: TableSpec, n_shards: int) -> bool:
    """Whether n_shards divides every capacity of `spec`."""
    return not any(getattr(spec, f) % n_shards for f in _CAPACITIES)


def per_shard_spec(spec: TableSpec, n_shards: int) -> TableSpec:
    """The spec of one shard tile: every capacity divided by n_shards,
    which must divide each of them."""
    for field in _CAPACITIES:
        cap = getattr(spec, field)
        if cap % n_shards or cap < n_shards:
            raise ValueError(
                f"tpu_{field} ({cap}) must be a positive multiple of "
                f"tpu_n_shards ({n_shards})")
    return dataclasses.replace(spec, **{
        f: getattr(spec, f) // n_shards for f in _CAPACITIES})


@functools.lru_cache(maxsize=None)
def flat_spec(pspec: TableSpec, tiles: int) -> TableSpec:
    """The single-device spec of `tiles` tiles of `pspec` laid end to
    end (the flattened view of the [R, S] grid)."""
    return dataclasses.replace(pspec, **{
        f: getattr(pspec, f) * tiles for f in _CAPACITIES})


def sharded_empty_state(spec: TableSpec, n_replicas: int, n_shards: int,
                        device) -> DeviceState:
    """A zeroed state whose leaves have leading [R, S] dims on `device`,
    all views of one flattened table. `spec` capacities are PER SHARD."""
    flat = empty_state(flat_spec(spec, n_replicas * n_shards), device)
    return DeviceState(*[
        x.view((n_replicas, n_shards, x.shape[0] // (n_replicas * n_shards))
               + tuple(x.shape[1:])) for x in flat])


def flat_view(state: DeviceState) -> DeviceState:
    """[R, S, K, ...] leaves -> [R·S·K, ...] views (no copy)."""
    return DeviceState(*[x.view((-1,) + tuple(x.shape[3:])) for x in state])


def stack_batches(batches, n_replicas: int, n_shards: int) -> Batch:
    """Stack a [R][S] nested list of per-shard Batches into one numpy
    Batch with leading [R, S] dims. Optional lanes that every tile lacks
    stay None; every tile must agree on which lanes are present."""
    cols = list(zip(*[list(zip(*[batches[r][s] for s in range(n_shards)]))
                      for r in range(n_replicas)]))

    def stack(col):
        flat = [x for row in col for x in row]
        if all(x is None for x in flat):
            return None
        if any(x is None for x in flat):
            raise ValueError(
                "stack_batches: every tile must agree on which optional "
                "Batch lanes are present")
        return np.stack([np.stack(row) for row in col])

    return Batch(*[stack(col) for col in cols])


def pack_tiles(batch: Batch, do_compact: bool = False, out=None):
    """Host: a stacked [R, S, ...] Batch -> i32[R, S, W], each tile's
    batch in the packed layout (aggregation/step.py pack_batch)."""
    lead = next(a for a in batch if a is not None).shape[:2]
    tiles = [Batch(*[None if a is None else a[r, s] for a in batch])
             for r in range(lead[0]) for s in range(lead[1])]
    if out is None:
        words = packed_layout(batch_sizes(tiles[0]))[1]
        out = np.zeros(lead + (words,), np.int32)
    for i, t in enumerate(tiles):
        pack_batch(t, do_compact, out=out[i // lead[1], i % lead[1]])
    return out


def unpack_tiles(flat: torch.Tensor, sizes: tuple,
                 pspec: TableSpec) -> Batch:
    """Device: i32[T, W] packed tile batches -> one Batch over the
    flattened table of T tiles. Tile t's slots in [0, capacity) move to
    t·capacity + slot; every other slot (the tile's padding sentinel
    included) goes to the flattened table's sentinel T·capacity."""
    t = flat.shape[0]
    body = flat[:, 1:]
    tile = torch.arange(t, dtype=torch.int32, device=flat.device)[:, None]
    lanes = []
    off = 0
    for name, n in zip(Batch._fields, sizes):
        if n == 0:
            lanes.append(None)
            continue
        if name in _U8_LANES:
            words = (n + 3) // 4
            a = body[:, off:off + words].contiguous().view(
                torch.uint8)[:, :n]
            off += words
        else:
            a = body[:, off:off + n]
            off += n
            if name in _F32_LANES:
                a = a.view(torch.float32)
            elif name in SLOT_LANES:
                cap = getattr(pspec, SLOT_LANES[name])
                a = torch.where((a >= 0) & (a < cap), a + tile * cap,
                                t * cap)
        lanes.append(a.reshape(-1))
    return Batch(*lanes)


def sharded_ingest_packed(state: DeviceState, flat: torch.Tensor, *,
                          spec: TableSpec, sizes: tuple,
                          do_compact: bool) -> DeviceState:
    """The sharded step: i32[R, S, W] packed tile batches (each in the
    JAX packed layout, control word in-band) applied to the [R, S]
    state in place as ONE ingest step over the flattened table, then
    the digest re-compression when `do_compact`. `spec` is per shard."""
    if tuple(flat.shape[:2]) != tuple(state.counter_acc.shape[:2]):
        raise ValueError(f"batch tiles {tuple(flat.shape[:2])}, state "
                         f"holds {tuple(state.counter_acc.shape[:2])}")
    tiles = flat.shape[0] * flat.shape[1]
    fspec = flat_spec(spec, tiles)
    fstate = flat_view(state)
    ingest_core(fstate, unpack_tiles(flat.reshape(tiles, -1), sizes, spec),
                spec=fspec)
    if do_compact:
        compact_core(fstate, spec=fspec)
    return state


def sharded_ingest(state: DeviceState, batch: Batch, *,
                   spec: TableSpec) -> DeviceState:
    """`sharded_ingest_packed` for a stacked numpy [R, S, ...] Batch."""
    flat = pack_tiles(batch)
    sizes = tuple(0 if a is None else int(a[0, 0].size) for a in batch)
    dev = state.counter_acc.device
    return sharded_ingest_packed(state, torch.from_numpy(flat).to(dev),
                                 spec=spec, sizes=sizes, do_compact=False)


# -- the merged flush --------------------------------------------------------

# which live-row index each state leaf is gathered by (0 counter, 1 gauge,
# 2 status, 3 set, 4 histogram)
_LEAF_KIND = {"counter_acc": 0, "counter_hi": 0, "counter_lo": 0,
              "gauge": 1, "gauge_stamp": 1, "status": 2, "status_stamp": 2,
              "hll": 3}


def gather_rows(state: DeviceState, idx) -> DeviceState:
    """Rows `idx[kind]` (flat indices over the S·K shard rows) of every
    replica row: [r, S, K, ...] leaves -> [r, n_kind, ...] (indices
    clamped, as the flush's gathers clamp them)."""
    out = []
    for name, x in zip(DeviceState._fields, state):
        i = idx[_LEAF_KIND.get(name, 4)]
        rows = x.reshape((x.shape[0], -1) + tuple(x.shape[3:]))
        out.append(rows[:, torch.clamp(i.long(), 0, rows.shape[1] - 1)])
    return DeviceState(*out)


def merged_flush_live(state: DeviceState, qs: torch.Tensor, idx, *,
                      spec: TableSpec, merge,
                      raw: Optional[str] = None) -> dict:
    """The merged flush of the live rows: gather each kind's live rows of
    every replica row, merge them over the replica axis
    (collective/ops.py merge_replica_block, which re-compresses every
    digest row even at R = 1), then the flush math on the merged rows
    (aggregation/step.py flush_live_core: K2 once over the histogram
    rows). Every output is row-wise, so this equals the JAX package's
    dense merged flush followed by its live-row gather.

    `raw` adds the raw sketch rows (`raw_*` keys): "merged" from the
    merged rows, "tile" from replica row 0 as ingested (the JAX sharded
    backend's raw gather reads the unmerged state). `merge(rows)` is the
    replica merge (merge_replica_block over the layout's group)."""
    from veneur_tpu_torch.aggregation.step import flush_live_core
    rows = gather_rows(state, idx)
    merged = merge(rows)
    ar = [torch.arange(len(i), dtype=torch.int32, device=qs.device)
          for i in idx]
    out = flush_live_core(merged, qs, *ar, spec=spec)
    if raw is not None:
        src = merged if raw == "merged" else DeviceState(
            *[x[0] for x in rows])
        w = src.h_w
        out.update({
            "raw_hll": src.hll, "raw_h_weight": w,
            "raw_h_mean": src.h_wm / torch.clamp(w, min=1e-30),
            "raw_h_min": src.h_min, "raw_h_max": src.h_max,
            "raw_recip_hi": src.h_recip_hi,
            "raw_recip_lo": src.h_recip_lo + src.h_recip_acc})
    return out


def merged_raw_shapes(spec: TableSpec, n_set: int, n_h: int) -> dict:
    """unpack_flush shapes of the `raw_*` keys of merged_flush_live."""
    cells = spec.total_cells
    f32 = "float32"
    return {"raw_hll": ((n_set, spec.hll_words), "int32"),
            "raw_h_weight": ((n_h, cells), f32),
            "raw_h_mean": ((n_h, cells), f32),
            "raw_h_min": ((n_h,), f32), "raw_h_max": ((n_h,), f32),
            "raw_recip_hi": ((n_h,), f32), "raw_recip_lo": ((n_h,), f32)}


def merged_flush(state: DeviceState, qs, *, spec: TableSpec,
                 layout: Layout) -> dict:
    """The dense merged flush (the JAX make_merged_flush): every row of
    every shard, outputs with a leading [S] dim, as host numpy with the
    two-float pairs left uncollapsed (finish with
    aggregation/step.py combine_flush_scalars)."""
    s = state.counter_acc.shape[1]
    dev = state.counter_acc.device
    caps = [spec.counter_capacity, spec.gauge_capacity,
            spec.status_capacity, spec.set_capacity, spec.histo_capacity]
    idx = [torch.arange(s * k, dtype=torch.int32, device=dev)
           for k in caps]
    qs = torch.as_tensor(np.asarray(qs, np.float32), device=dev)
    from veneur_tpu_torch.collective.ops import merge_replica_block
    merge = functools.partial(merge_replica_block, spec=spec,
                              group=layout.group)
    out = merged_flush_live(state, qs, idx, spec=spec, merge=merge)
    return {k: v.reshape((s, -1) + tuple(v.shape[1:])).cpu().numpy()
            for k, v in out.items()}
