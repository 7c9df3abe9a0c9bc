"""The one key-table grow site.

New per-kind capacities are staged on the C++ engine under its key mutex
(`capacity_set` -> pending_caps), then applied by the `vt_reset` that runs
inside the very next swap's quiesce, while the engine's tables are empty
and the ring workers are paused. Key tables are flush-scoped (every swap
builds a fresh table from the spec on both the Python and the C++ path),
so a grow needs no mid-interval rehash: the grow pause is the swap pause.

On the card the new aggregator's device state (the 14 leaves K1 updates
in place) is allocated at the grown widths before anything is staged or
swapped. An allocation the card cannot hold therefore raises with the
server unchanged: the swap fails, the flush is reported failed, and the
interval keeps accumulating in the old state, as a deferred flush does.
The old aggregator rides the interval's flush job, so its detached state
flushes against the old spec while the new state fills.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, Tuple

log = logging.getLogger("veneur_tpu_torch.tables")

# table kind -> TableSpec field, in the native capacity_set argument
# order for the first four (status is Python-side on every backend)
KIND_FIELDS = (("counter", "counter_capacity"),
               ("gauge", "gauge_capacity"),
               ("set", "set_capacity"),
               ("histo", "histo_capacity"),
               ("status", "status_capacity"))


def spec_capacities(spec) -> Dict[str, int]:
    """Per-kind capacities of a TableSpec, by table kind."""
    return {k: int(getattr(spec, f)) for k, f in KIND_FIELDS}


def grown_spec(spec, targets: Dict[str, int]):
    """A new TableSpec with the given per-kind capacities applied.
    Only capacity fields change — sketch geometry (compression, HLL
    precision, ...) is identity-relevant and never grows live."""
    fields = dict(KIND_FIELDS)
    changes = {fields[k]: int(v) for k, v in targets.items()
               if k in fields and int(v) != getattr(spec, fields[k])}
    return dataclasses.replace(spec, **changes) if changes else spec


class GrowConflict(RuntimeError):
    """A grow refused because a live reshard owns the swap boundary;
    .status 409 for admin surfaces."""

    status = 409


def grow_swap(server, new_spec) -> Tuple[object, object, object]:
    """Execute a per-kind capacity change at the swap boundary.

    Must run on the pipeline thread (it is the interval flush swap).
    Returns (state, table, old_aggregator): the detached interval, which
    the caller enqueues as this interval's flush job exactly like a plain
    swap; the flush math runs against the old aggregator's spec.

    Sequence: build the new backend around the same engine at the new
    spec (its device state allocated first, so a failed allocation
    changes nothing) -> stage capacities on the engine -> swap (the
    quiesce's reset applies them while the tables are empty) -> carry the
    lifetime counters over -> install. Ingest never restarts; readers
    keep feeding the same C++ handle throughout.
    """
    old = server.aggregator
    eng = getattr(old, "eng", None)
    new_agg, native = server._make_aggregator(
        getattr(old, "n_shards", 1), engine=eng, spec=new_spec)
    if eng is not None:
        caps = spec_capacities(new_spec)
        eng.capacity_set(caps["counter"], caps["gauge"], caps["set"],
                         caps["histo"])
    try:
        state, table = old.swap()
    except BaseException:
        if eng is not None:
            # unstage: the old backend keeps serving at its own spec
            caps = spec_capacities(old.spec)
            eng.capacity_set(caps["counter"], caps["gauge"], caps["set"],
                             caps["histo"])
        raise
    # lifetime-counter continuity
    new_agg.processed = old.processed
    new_agg.dropped_capacity = old.dropped_capacity
    new_agg.h2d_bytes = getattr(old, "h2d_bytes", 0)
    new_agg.steps_total = getattr(old, "steps_total", 0)
    new_agg.step_ns = getattr(old, "step_ns", 0)
    new_agg.dispatch_ns = getattr(old, "dispatch_ns", 0)
    new_agg.steps_synced = getattr(old, "steps_synced", 0)
    new_agg.last_set_shift = getattr(old, "last_set_shift", 0)
    new_agg.degraded_timer_skipped = getattr(old, "degraded_timer_skipped",
                                             0)
    new_agg.degraded_set_skipped = getattr(old, "degraded_set_skipped", 0)
    if getattr(old, "_pressure", None) is not None:
        new_agg.set_pressure(old._pressure)
    server.aggregator = new_agg
    server._native = native
    log.info("key tables grown: %s -> %s",
             spec_capacities(old.spec), spec_capacities(new_spec))
    return state, table, old


def adopt_capacities(server, caps: Dict[str, int]) -> bool:
    """Restore-time re-grow: adopt a checkpoint sidecar's per-kind
    capacities BEFORE folding rows. Startup only — the pipeline is not
    running yet, so the swap boundary is trivially quiescent and the
    discarded empty interval costs nothing. Returns True if the spec
    changed. fold_snapshot is capacity-independent (restore.py digest
    routing), so folding works either way; adopting first means the
    restored process starts with the table headroom it had when the
    checkpoint was taken instead of re-walking the grow ladder."""
    spec = server.aggregator.spec
    new_spec = grown_spec(spec, caps)
    if new_spec is spec:
        return False
    n_shards = getattr(server.aggregator, "n_shards", 1)
    bad = [k for k, v in spec_capacities(new_spec).items()
           if v <= 0 or v % n_shards]
    if bad:
        log.warning("checkpoint capacities %s not adoptable at "
                    "n_shards=%d; restoring at config capacities",
                    caps, n_shards)
        return False
    grow_swap(server, new_spec)
    return True
