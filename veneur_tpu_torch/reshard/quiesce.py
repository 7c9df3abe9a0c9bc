"""The swap-boundary helper for shard-map changes.

Changing the shard map while packets are in flight is safe only at a
buffer-swap boundary: the engine's staged rows were keyed under the old
map (slot = shard·per_shard + local at parse time), so they must be
emitted and the interval detached before the map changes, and no packed
batch may straddle two maps. `shard_map_swap` is the one place that
sequence lives, and the only caller of the engine's `shard_map_set`:

1. stage the new shard count on the engine (`shard_map_set` marks it;
   parsing continues under the old map);
2. run the aggregator's `swap()`, which pauses the reader rings, emits
   every staged row under the old map, detaches the interval and calls
   the engine's `reset()`, which applies the staged map while the
   tables are empty; the rings then resume under the new map.

A Python backend has no engine: the swap alone is the boundary, and the
new aggregator object carries the new layout.
"""

from __future__ import annotations


def shard_map_swap(aggregator, new_n_shards: int):
    """Detach the current interval at a flush boundary and re-learn the
    shard map without restarting the pipeline. Returns the detached
    (state, table) pair, as `aggregator.swap()` does. A swap that raises
    unstages the map (the old count again), so the engine keeps keying
    under the map its serving aggregator was built for."""
    eng = getattr(aggregator, "eng", None)
    if eng is None:
        return aggregator.swap()
    eng.shard_map_set(int(new_n_shards))
    try:
        return aggregator.swap()
    except BaseException:
        eng.shard_map_set(int(getattr(aggregator, "n_shards", 1)))
        raise
