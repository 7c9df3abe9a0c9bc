"""The routed ingest and the replica-merged state of the collective tier.

`routed_ingest` is the co-located delivery path. A local tier's flush
rows are staged on the host into per-(replica row, source column, owner
shard) buckets, and each owner tile applies the buckets routed to it
with the ordinary ingest step. The JAX package exchanges the buckets
with a `lax.all_to_all` over the shard axis inside shard_map: each tile
sends bucket d to shard d and concatenates what arrives in source
order. Here the whole [R, S] grid lives on one device, so that exchange
is a transpose of [R, S_src, S_dest, B] into [R, S_dest, S_src, B]: owner
tile (r, d) ingests the buckets of every source column j in order j =
0..S-1, exactly the rows the JAX physical mesh delivers to it.

`merged_state` runs the replica merge alone (no flush math): one merged
[S, ...] state, the raw-gather twin of the merged flush.
"""

from __future__ import annotations

import numpy as np
import torch

from veneur_tpu_torch.aggregation.state import DeviceState, TableSpec
from veneur_tpu_torch.aggregation.step import Batch, pack_batch
from veneur_tpu_torch.collective.ops import merge_replica_block
from veneur_tpu_torch.parallel.sharded import (Layout,
                                               sharded_ingest_packed)


def route_batches(grid) -> list:
    """[R][S_src][S_dest] nested Batches -> [R][S_dest] Batches, each the
    concatenation over source columns in order (the all_to_all)."""
    n_r, n_s = len(grid), len(grid[0])
    out = []
    for r in range(n_r):
        row = []
        for d in range(n_s):
            parts = [grid[r][j][d] for j in range(n_s)]
            row.append(Batch(*[
                None if all(p[i] is None for p in parts)
                else np.concatenate([p[i] for p in parts])
                for i in range(len(Batch._fields))]))
        out.append(row)
    return out


def pack_routed(grid, out=None):
    """Host: the routed grid packed as i32[R, S, W'], tile (r, d) holding
    the buckets routed to owner shard d (every lane S times a bucket's
    length). Returns (buffer, lane sizes)."""
    from veneur_tpu_torch.aggregation.step import batch_sizes, packed_layout
    routed = route_batches(grid)
    sizes = batch_sizes(routed[0][0])
    if out is None:
        out = np.zeros((len(routed), len(routed[0]),
                        packed_layout(sizes)[1]), np.int32)
    for r, row in enumerate(routed):
        for d, b in enumerate(row):
            pack_batch(b, False, out=out[r, d])
    return out, sizes


def routed_ingest(state: DeviceState, flat: torch.Tensor, *,
                  spec: TableSpec, sizes: tuple) -> DeviceState:
    """Apply a packed routed grid (`pack_routed`, on the state's device)
    in place: one ingest step over the flattened tiles, no compaction
    (the tier compacts on its direct path's cadence)."""
    return sharded_ingest_packed(state, flat, spec=spec, sizes=sizes,
                                 do_compact=False)


def merged_state(state: DeviceState, spec: TableSpec,
                 layout: Layout) -> DeviceState:
    """[R, S, K, ...] -> the replica-merged [S, K, ...] state."""
    s = state.counter_acc.shape[1]
    merged = merge_replica_block(
        DeviceState(*[x.reshape((x.shape[0], -1) + tuple(x.shape[3:]))
                      for x in state]), spec, layout.group)
    return DeviceState(*[x.reshape((s, -1) + tuple(x.shape[1:]))
                         for x in merged])
