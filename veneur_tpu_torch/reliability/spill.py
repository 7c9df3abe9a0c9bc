"""Forward spill buffer: the forward path's durable send queue.

Two operating modes share one bounded buffer:

LEGACY (dedup off — merge-on-retry): the Go reference drops a failed
forward's payload — one gRPC error loses an interval of sketch state.
Our forward payloads are MERGEABLE (metricpb.Metric: t-digest centroids
merge, HLL registers fold with max, counters add — PAPERS.md, Dunning
t-digests), so a failed forward is held via add() and merged into the
NEXT interval's forward batch. Lossless only if every payload folds
exactly once; an ambiguous failure (the receiver DID fold before the
deadline fired) re-sends a re-merged copy and double-counts the
additive kinds.

ACK-GATED (exactly-once, forward_dedup_window > 0): every forwarded
interval is staged as an immutable UNIT under its (epoch, seq) envelope
BEFORE the send — so the payload is inside any checkpoint taken that
interval — and evicted only by ack(epoch, seq) after the receiving tier
acknowledged the seq. A failed or ambiguous send leaves the unit in
place; the retry re-sends the SAME bytes under the SAME seq and the
receiver's dedup window suppresses the potential duplicate. See
forward/envelope.py and README §Exactly-once forwarding.

Either way the buffer is bounded by bytes and by age; when a cap is hit
the OLDEST payloads drop first and every drop is counted — degradation
is observable, never silent (veneur.forward.spill_bytes /
veneur.forward.spill.dropped_total in self-telemetry).
"""

from __future__ import annotations

import logging
import struct
import threading
import time
from collections import deque
from typing import Callable, List, NamedTuple, Optional, Tuple

log = logging.getLogger("veneur_tpu_torch.reliability.spill")

# wire format (persistence checkpoints): magic, then the caps + entry
# count, then per entry the ORIGINAL spill stamp and the metricpb blob —
# stamps survive a restart so max_age_s keeps bounding total staleness.
# VSPL2 adds the envelope's (epoch, seq) per entry; -1/-1 marks a legacy
# (unenveloped) entry. VSPL1 checkpoints are still readable.
_SPILL_MAGIC_V1 = b"VSPL1"
_SPILL_MAGIC = b"VSPL2"
_SPILL_HEADER = struct.Struct("<qdI")     # max_bytes, max_age_s, count
_SPILL_ENTRY_V1 = struct.Struct("<dI")    # spilled_at, blob length
_SPILL_ENTRY = struct.Struct("<dqqI")     # spilled_at, epoch, seq, blob len

_NO_ENVELOPE = -1


class SpillUnit(NamedTuple):
    """One staged forward payload: the metrics exported for an interval,
    frozen under the (epoch, seq) they were first stamped with."""
    epoch: int
    seq: int
    staged_at: float
    metrics: List


def parse_spill_bytes(data: bytes, with_envelope: bool = False
                      ) -> Tuple[List, Tuple[int, float]]:
    """-> ([(spilled_at, metricpb.Metric), ...], (max_bytes, max_age_s)),
    or 4-tuples (spilled_at, metric, epoch, seq) with `with_envelope`
    (epoch/seq are -1 for entries spilled without one). Accepts both the
    VSPL1 and VSPL2 wire formats. Raises ValueError on malformed bytes
    (checkpoint CRCs catch rot; this catches format drift)."""
    from veneur_tpu_torch.proto import metricpb_pb2 as mpb
    magic = data[:len(_SPILL_MAGIC)]
    if magic == _SPILL_MAGIC:
        entry_struct = _SPILL_ENTRY
    elif magic == _SPILL_MAGIC_V1:
        entry_struct = _SPILL_ENTRY_V1
    else:
        raise ValueError("bad spill magic")
    off = len(magic)
    try:
        max_bytes, max_age_s, count = _SPILL_HEADER.unpack_from(data, off)
        off += _SPILL_HEADER.size
        entries = []
        for _ in range(count):
            if entry_struct is _SPILL_ENTRY:
                spilled_at, epoch, seq, blob_len = entry_struct.unpack_from(
                    data, off)
            else:
                spilled_at, blob_len = entry_struct.unpack_from(data, off)
                epoch = seq = _NO_ENVELOPE
            off += entry_struct.size
            blob = data[off:off + blob_len]
            if len(blob) != blob_len:
                raise ValueError("truncated spill entry")
            off += blob_len
            m = mpb.Metric.FromString(blob)
            entries.append((spilled_at, m, epoch, seq) if with_envelope
                           else (spilled_at, m))
    except struct.error as e:
        raise ValueError(f"truncated spill buffer: {e}")
    return entries, (max_bytes, max_age_s)


class ForwardSpillBuffer:
    """Holds forwardable metricpb.Metric payloads across failed intervals.

    Thread-safe: forwards run on fire-and-forget aux threads and a slow
    failing forward can overlap the next interval's.
    """

    def __init__(self, max_bytes: int, max_age_s: float = 60.0,
                 clock: Callable[[], float] = time.time):
        if max_bytes <= 0:
            raise ValueError("max_bytes must be > 0")
        self.max_bytes = int(max_bytes)
        self.max_age_s = float(max_age_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._entries: deque = deque()   # legacy: (spilled_at, metric, nbytes)
        # ack-gated: [epoch, seq, staged_at, [(spilled_at, m, nb)...], nbytes]
        # oldest (lowest seq) first — retries replay in stamping order
        self._units: deque = deque()
        self._bytes = 0
        self.spilled_total = 0       # metrics ever spilled/staged
        self.dropped_capacity = 0    # metrics evicted by the byte cap
        self.dropped_age = 0         # metrics expired by max_age_s

    @property
    def bytes(self) -> int:
        with self._lock:
            return self._bytes

    @property
    def dropped_total(self) -> int:
        with self._lock:
            return self.dropped_capacity + self.dropped_age

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries) + sum(len(u[3]) for u in self._units)

    # -- legacy merge-on-retry path (dedup off) ------------------------------
    def add(self, metrics: List, now: float = None) -> None:
        """Spill a failed forward's payload, stamped with the CURRENT
        clock. Evicts oldest-first when the byte cap is exceeded (a
        single over-cap payload evicts itself — the cap is a hard bound,
        not a suggestion)."""
        if not metrics:
            return
        now = self._clock() if now is None else now
        with self._lock:
            self.spilled_total += len(metrics)
            evicted = self._extend_locked(
                (now, m, m.ByteSize()) for m in metrics)
        if evicted:
            log.warning("forward spill over %d bytes: dropped %d oldest "
                        "payloads", self.max_bytes, evicted)

    def readd(self, entries: List) -> None:
        """Return previously drained (spilled_at, metric) entries after a
        re-failed send, keeping their ORIGINAL spill timestamps — so
        max_age_s bounds total staleness since the first failure, not
        time since the last retry. Re-adds are not re-counted in
        spilled_total. 4-tuple (spilled_at, metric, epoch, seq) entries
        are accepted and land as legacy entries (envelope dropped —
        re-adding is the merge-on-retry path).

        Entries land at the LEFT of the deque: drained entries are older
        than anything add() appended while the retry was in flight, and
        the deque must stay oldest-first or the byte-cap eviction (and a
        later drain()'s pair ordering) would drop fresh payloads while
        keeping stale ones."""
        if not entries:
            return
        with self._lock:
            for entry in reversed(entries):
                ts, m = entry[0], entry[1]
                nb = m.ByteSize()
                self._entries.appendleft((ts, m, nb))
                self._bytes += nb
            evicted = self._evict_locked()
        if evicted:
            log.warning("forward spill over %d bytes: dropped %d oldest "
                        "payloads", self.max_bytes, evicted)

    def _extend_locked(self, triples) -> int:
        """Append (spilled_at, metric, nbytes) triples and enforce the
        byte cap; returns the evicted count. Caller holds the lock and
        must keep appends time-ordered (newest at the right)."""
        for t in triples:
            self._entries.append(t)
            self._bytes += t[2]
        return self._evict_locked()

    def _evict_locked(self) -> int:
        """Enforce the byte cap, oldest first: legacy entries (which are
        never older than an ack-gated unit in the same buffer only by
        accident — both queues evict from their own left), then whole
        units. A unit evicts atomically: re-sending a subset under its
        original seq could lose the rest to the receiver's window."""
        evicted = 0
        while self._bytes > self.max_bytes and self._entries:
            _, _, nb = self._entries.popleft()
            self._bytes -= nb
            self.dropped_capacity += 1
            evicted += 1
        while self._bytes > self.max_bytes and self._units:
            unit = self._units.popleft()
            self._bytes -= unit[4]
            self.dropped_capacity += len(unit[3])
            evicted += len(unit[3])
        return evicted

    def drain(self, now: float = None) -> List:
        """Take everything still fresh as (spilled_at, metric) pairs for
        merging into the next forward batch; expired payloads are dropped
        and counted. The buffer is emptied either way — a re-failed send
        returns the pairs via readd(), preserving their timestamps.
        Staged units are drained too (their envelopes discarded): this
        only happens when a dedup-off server restores a checkpoint
        written by a dedup-on one, where merge-on-retry is the best the
        configuration can do."""
        now = self._clock() if now is None else now
        with self._lock:
            out, expired = [], 0
            for spilled_at, m, _nb in self._entries:
                if now - spilled_at > self.max_age_s:
                    expired += 1
                else:
                    out.append((spilled_at, m))
            for unit in self._units:
                for spilled_at, m, _nb in unit[3]:
                    if now - spilled_at > self.max_age_s:
                        expired += 1
                    else:
                        out.append((spilled_at, m))
            self._entries.clear()
            self._units.clear()
            self._bytes = 0
            self.dropped_age += expired
        if expired:
            log.warning("forward spill: dropped %d payloads older than "
                        "%.0fs", expired, self.max_age_s)
        return out

    # -- ack-gated exactly-once path (forward_dedup_window > 0) --------------
    def take_legacy(self, now: float = None) -> List:
        """Remove and return the fresh LEGACY (unenveloped) entries as
        (spilled_at, metric) pairs; expired ones are dropped and counted.
        The exactly-once sender folds these — restored from a
        pre-upgrade checkpoint, or left by a dedup-off run — into its
        next stamped unit so they forward under an envelope."""
        now = self._clock() if now is None else now
        with self._lock:
            out, expired = [], 0
            for spilled_at, m, nb in self._entries:
                self._bytes -= nb
                if now - spilled_at > self.max_age_s:
                    expired += 1
                else:
                    out.append((spilled_at, m))
            self._entries.clear()
            self.dropped_age += expired
        if expired:
            log.warning("forward spill: dropped %d payloads older than "
                        "%.0fs", expired, self.max_age_s)
        return out

    def add_unit(self, metrics: List, epoch: int, seq: int,
                 now: float = None) -> None:
        """Stage an interval's export as an immutable unit under its
        envelope BEFORE the send attempt. The unit leaves the buffer
        only via ack(), the byte cap, or max_age_s expiry — never
        because a send merely returned."""
        if not metrics:
            return
        now = self._clock() if now is None else now
        entries = [(now, m, m.ByteSize()) for m in metrics]
        nbytes = sum(nb for _, _, nb in entries)
        with self._lock:
            self.spilled_total += len(entries)
            self._units.append([int(epoch), int(seq), now, entries, nbytes])
            self._bytes += nbytes
            evicted = self._evict_locked()
        if evicted:
            log.warning("forward spill over %d bytes: dropped %d oldest "
                        "payloads", self.max_bytes, evicted)

    def pending_units(self, now: float = None) -> List[SpillUnit]:
        """Snapshot (NOT drain) the staged units oldest-first for a send
        pass; units older than max_age_s are dropped and counted first.
        Metrics lists are shared, not copied — callers must not mutate."""
        now = self._clock() if now is None else now
        with self._lock:
            expired = 0
            while self._units and now - self._units[0][2] > self.max_age_s:
                unit = self._units.popleft()
                self._bytes -= unit[4]
                self.dropped_age += len(unit[3])
                expired += len(unit[3])
            out = [SpillUnit(u[0], u[1], u[2], [m for _, m, _ in u[3]])
                   for u in self._units]
        if expired:
            log.warning("forward spill: dropped %d payloads older than "
                        "%.0fs", expired, self.max_age_s)
        return out

    def ack(self, epoch: int, seq: int) -> bool:
        """The receiving tier acknowledged (epoch, seq): evict the unit.
        Idempotent — a duplicate ack (or an ack for an already-expired
        unit) is a no-op returning False."""
        with self._lock:
            for i, unit in enumerate(self._units):
                if unit[0] == epoch and unit[1] == seq:
                    del self._units[i]
                    self._bytes -= unit[4]
                    return True
        return False

    # -- persistence (checkpoints; README §Durability) ----------------------
    def to_bytes(self) -> bytes:
        """Serialize contents + caps, preserving every entry's original
        spill stamp and (for staged units) envelope. Point-in-time
        consistent (one lock hold)."""
        with self._lock:
            rows = [(ts, m, _NO_ENVELOPE, _NO_ENVELOPE)
                    for ts, m, _nb in self._entries]
            for epoch, seq, _staged, entries, _nb in self._units:
                rows.extend((ts, m, epoch, seq) for ts, m, _ in entries)
        parts = [_SPILL_MAGIC,
                 _SPILL_HEADER.pack(self.max_bytes, self.max_age_s,
                                    len(rows))]
        for spilled_at, m, epoch, seq in rows:
            blob = m.SerializeToString()
            parts.append(_SPILL_ENTRY.pack(spilled_at, epoch, seq,
                                           len(blob)))
            parts.append(blob)
        return b"".join(parts)

    def restore_entries(self, entries: List) -> None:
        """Re-enter parse_spill_bytes(with_envelope=True) 4-tuples after
        a restart: enveloped rows regroup into their original units
        (original stamps AND seqs — the replay is what the receiver's
        dedup window suppresses), unenveloped rows land as legacy
        entries. Not re-counted in spilled_total."""
        legacy = [e for e in entries if len(e) < 4 or e[2] == _NO_ENVELOPE]
        enveloped = [e for e in entries if len(e) >= 4 and e[2] != _NO_ENVELOPE]
        if enveloped:
            groups: "dict[tuple, list]" = {}
            for ts, m, epoch, seq in enveloped:
                groups.setdefault((epoch, seq), []).append((ts, m, m.ByteSize()))
            with self._lock:
                for (epoch, seq), rows in sorted(groups.items()):
                    nbytes = sum(nb for _, _, nb in rows)
                    staged_at = min(ts for ts, _, _ in rows)
                    self._units.append([epoch, seq, staged_at, rows, nbytes])
                    self._bytes += nbytes
                evicted = self._evict_locked()
            if evicted:
                log.warning("forward spill over %d bytes: dropped %d oldest "
                            "payloads on restore", self.max_bytes, evicted)
        if legacy:
            self.readd(legacy)

    @classmethod
    def from_bytes(cls, data: bytes,
                   clock: Callable[[], float] = time.time
                   ) -> "ForwardSpillBuffer":
        """Rebuild a buffer with the SERIALIZED caps and stamps. Entries
        already past max_age_s still re-enter; the next drain() (or
        pending_units()) expires them into dropped_age, so the drop
        accounting that would have happened without the restart still
        happens."""
        entries, (max_bytes, max_age_s) = parse_spill_bytes(
            data, with_envelope=True)
        buf = cls(max_bytes, max_age_s, clock=clock)
        buf.restore_entries(entries)
        return buf
