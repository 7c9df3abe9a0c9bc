"""Warm restart: load the newest valid checkpoint and FOLD it into the
live aggregator through the same sketch-merge ops the forward/import
path uses.

Restore never overwrites device state. Every snapshot row re-enters
through Aggregator.restore_metric — counter add (two-float split so f64
counts survive the f32 staging lane), HLL register max-merge, t-digest
centroid re-add with the exact min/max/reciprocalSum stats lane, gauge/
status last-write-wins — so a restore composes with concurrent ingest
exactly like an imported interval does: restored state merges, and any
later live sample for the same key wins the LWW lanes because restore
runs before the listeners start.

Corrupt snapshots are rejected and QUARANTINED (moved under
<checkpoint_dir>/quarantine/), and restore falls back to the next-newest
checkpoint, then to a cold start — a bad disk must never crash or wedge
startup.
"""

from __future__ import annotations

import logging
from typing import Optional, Tuple

import numpy as np

from veneur_tpu_torch.persistence import codec
from veneur_tpu_torch.utils.hashing import fnv1a_32

log = logging.getLogger("veneur_tpu_torch.persistence.restore")


def _digest(kind: str, name: str, joined_tags: str) -> int:
    """Deterministic shard-routing digest for restored keys, the
    parser's recipe (samplers/parser.py _key_info). The original ingest
    digest is not persisted; any stable hash works — the KeyTable's
    by_key dict guarantees later live samples land on the same slot
    regardless of which digest allocated it."""
    h = fnv1a_32(name.encode("utf-8", "surrogateescape"))
    h = fnv1a_32(kind.encode(), h)
    return fnv1a_32(joined_tags.encode("utf-8", "surrogateescape"), h)


def restore_latest(root: str, on_corrupt=None
                   ) -> Optional[Tuple[dict, str]]:
    """Newest-first scan: load the first checkpoint that validates,
    quarantining every rejected one along the way. Multi-host assemblies
    (persistence/assembly.py) rank alongside single-process checkpoints
    by sequence number, assemblies first on a tie (an assembly at seq N
    supersedes any stray single part at N). Returns (snapshot, path) or
    None for a cold start."""
    from veneur_tpu_torch.persistence import assembly
    candidates = sorted(
        [(seq, 0, path) for seq, path in codec.list_checkpoints(root)]
        + [(seq, 1, path) for seq, path in assembly.list_assemblies(root)])
    for seq, is_asm, path in reversed(candidates):
        try:
            snap = (assembly.load_assembly(path) if is_asm
                    else codec.load_dir(path))
        except codec.CorruptSnapshot as e:
            log.warning("rejecting checkpoint %s: %s", path, e)
            try:
                codec.quarantine(root, path)
            except OSError as qe:
                log.warning("could not quarantine %s: %s", path, qe)
            if on_corrupt is not None:
                on_corrupt()
            continue
        return snap, path
    return None


def fold_snapshot(aggregator, snap: dict, skip_forwarded: bool = False) -> int:
    """Merge every snapshot row into `aggregator` via restore_metric;
    returns the number of rows folded. Capacity overflow in a smaller
    target table is counted in the aggregator's dropped_capacity, same
    as live ingest.

    With `skip_forwarded` (a local restoring under exactly-once
    forwarding), rows a local's flush would export forward-ONLY — global
    counters/gauges/histos, non-local sets (the exact complement of
    flusher.py's local-flush masks) — are NOT folded back: their
    payloads were staged into the spill (under their original envelopes)
    BEFORE this snapshot was written, so the spill replay delivers them
    and re-folding here would re-export the same data under a fresh seq
    the receiver cannot dedup. Mixed-scope histograms flush both tiers
    and must stay."""
    from veneur_tpu_torch.aggregation.host import SCOPE_GLOBAL, SCOPE_LOCAL
    arrays = snap["arrays"]
    n = 0

    def rows(kind):
        for i, entry in enumerate(snap["tables"][kind]):
            name, tags, scope, hostname, message, imported_only, \
                actual_kind, joined_tags = entry
            if joined_tags is None:
                joined_tags = ",".join(tags)
            scope = int(scope)
            if skip_forwarded:
                if kind in ("counter", "gauge", "histo"):
                    if scope == SCOPE_GLOBAL:
                        continue
                elif kind == "set":
                    if scope != SCOPE_LOCAL:
                        continue
            yield (i, actual_kind, name, tuple(tags), scope,
                   hostname, message, bool(imported_only), joined_tags)

    for i, kind, name, tags, scope, host, _msg, imp, joined in \
            rows("counter"):
        aggregator.restore_metric(
            kind, name, tags, scope, _digest(kind, name, joined),
            {"value": float(arrays["counter"][i])},
            hostname=host, imported_only=imp, joined_tags=joined)
        n += 1
    for i, kind, name, tags, scope, host, _msg, imp, joined in \
            rows("gauge"):
        aggregator.restore_metric(
            kind, name, tags, scope, _digest(kind, name, joined),
            {"value": float(arrays["gauge"][i])},
            hostname=host, imported_only=imp, joined_tags=joined)
        n += 1
    for i, kind, name, tags, scope, host, msg, imp, joined in \
            rows("status"):
        aggregator.restore_metric(
            kind, name, tags, scope, _digest(kind, name, joined),
            {"value": float(arrays["status"][i])},
            hostname=host, message=msg, imported_only=imp,
            joined_tags=joined)
        n += 1
    # v2 snapshots hold 6-bit packed i32 word rows, v1 dense u8 register
    # rows; either way the aggregator's restore interface takes dense u8
    # "registers" (they fold through the normal merge path, so a v1
    # snapshot restores byte-exact into the packed table)
    hll_rows = np.asarray(arrays["hll"])
    if hll_rows.dtype != np.uint8:
        from veneur_tpu_torch.ops.hll import unpack_registers_np
        hll_rows = unpack_registers_np(
            hll_rows.astype(np.int32),
            precision=int(snap["spec"]["hll_precision"]))
    for i, kind, name, tags, scope, host, _msg, imp, joined in \
            rows("set"):
        aggregator.restore_metric(
            kind, name, tags, scope, _digest(kind, name, joined),
            {"registers": np.asarray(hll_rows[i], np.uint8)},
            hostname=host, imported_only=imp, joined_tags=joined)
        n += 1
    for i, kind, name, tags, scope, host, _msg, imp, joined in \
            rows("histo"):
        aggregator.restore_metric(
            kind, name, tags, scope, _digest(kind, name, joined),
            {"means": arrays["h_mean"][i],
             "weights": arrays["h_weight"][i],
             "min": float(arrays["h_min"][i]),
             "max": float(arrays["h_max"][i]),
             "recip": float(arrays["h_recip"][i])},
            hostname=host, imported_only=imp, joined_tags=joined)
        n += 1
    aggregator.restore_flush()
    return n


def restore_spill(spill_buffer, spill_bytes: bytes) -> int:
    """Re-seed a configured ForwardSpillBuffer from snapshot bytes,
    preserving original spill stamps. Entries already past max_age_s
    re-enter and are counted into dropped_age at the next drain — drop
    accounting survives the restart, nothing vanishes silently."""
    if not spill_bytes or spill_buffer is None:
        return 0
    from veneur_tpu_torch.reliability.spill import parse_spill_bytes
    # with_envelope keeps each staged unit's (epoch, seq) attached so the
    # post-restart replay re-sends the ORIGINAL seqs the receiver's dedup
    # window knows how to suppress (exactly-once across a crash)
    entries, _caps = parse_spill_bytes(spill_bytes, with_envelope=True)
    spill_buffer.restore_entries(entries)
    return len(entries)
