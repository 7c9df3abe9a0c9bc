"""Exactly-once forwarding envelope and the receiver-side dedup window.

The local→proxy→global forward path is at-least-once by construction:
ambiguous gRPC timeouts re-send, the spill buffer replays across
restarts, and a crash-restore re-forwards the last checkpointed
interval. HLL register folds and LWW gauges absorb duplicates, but
counter accumulators and t-digest centroid weights are ADDITIVE — every
duplicate fold inflates global counts and quantile weights. The
transport therefore carries an idempotency key:

    (source_id, epoch, seq)

  source_id  128-bit hex id minted once per local server and persisted
             in the checkpoint manifest, so a restart keeps its stream.
  epoch      bumped on EVERY restore/restart. Seqs minted after the
             last checkpoint are lost with the process; reusing them
             would make the receiver falsely suppress fresh data, so a
             restarted sender opens a new epoch instead.
  seq        monotone per (source_id, epoch), one per forward unit (an
             interval's exported payload). Retries — ambiguous timeout,
             spill replay, proxy re-attempt — re-send the SAME seq.

The envelope travels as gRPC metadata / HTTP headers (and optionally a
wrapped JSON import body), so it survives proxy re-routing: a re-routed
duplicate is suppressed at whichever global instance folds it.

Receivers keep one DedupWindow per (source_id, epoch) stream: a
high-water mark plus a bitmap of the last `window` seqs. Semantics:

  seq unseen and within the window        -> fresh (fold it)
  seq already marked                      -> duplicate (suppress + ACK)
  seq below high-water - window (stale)   -> conservatively suppressed;
     the window size bounds how stale a replay can be and still be
     distinguished — see README §Exactly-once forwarding
  seq jumping more than max_skip ahead    -> EnvelopeError (rejected;
     a corrupt or hostile envelope must not wipe the whole bitmap)

Suppressed duplicates are still ACKED (success to the sender) so the
sender evicts the unit from its spill — a NACK would replay forever.
"""

from __future__ import annotations

import dataclasses
import os
import re
import threading
from collections import OrderedDict
from typing import Mapping, Optional

SOURCE_ID_LEN = 32          # hex chars (128 bits)
_SOURCE_ID_RE = re.compile(r"^[0-9a-f]{%d}$" % SOURCE_ID_LEN)

# one key set for both transports: gRPC metadata keys must be lowercase,
# and http.server's header mapping is case-insensitive, so the lowercase
# spelling works verbatim on either side of the wire
META_SOURCE_ID = "veneur-source-id"
META_EPOCH = "veneur-epoch"
META_SEQ = "veneur-seq"
_META_KEYS = (META_SOURCE_ID, META_EPOCH, META_SEQ)

# optional trace context (cross-tier flush tracing): the local tier's
# flush.forward span rides the envelope so the global tier's
# import/absorb spans parent onto it. Both-or-none: absent = legacy /
# untraced peer, exactly one present = corruption (same contract as the
# partial-envelope rule). Zero is not a valid id (tracer ids are
# `getrandbits(63) | 1`), so "zero keys" cannot masquerade as a trace.
META_TRACE_ID = "veneur-trace-id"
META_PARENT_SPAN_ID = "veneur-parent-span-id"
_TRACE_KEYS = (META_TRACE_ID, META_PARENT_SPAN_ID)

FRESH = "fresh"
DUPLICATE = "duplicate"
STALE = "stale"


class EnvelopeError(ValueError):
    """A malformed or unacceptable envelope: partial metadata, bad
    source_id, negative/non-integer epoch or seq, or a seq skip past the
    dedup window's bound. Receivers REJECT (4xx / INVALID_ARGUMENT) and
    account in veneur.forward.envelope_rejected_total — never fold."""


def mint_source_id() -> str:
    return os.urandom(SOURCE_ID_LEN // 2).hex()


@dataclasses.dataclass(frozen=True)
class Envelope:
    source_id: str
    epoch: int
    seq: int
    # cross-tier trace context; None/None = untraced (legacy-compatible)
    trace_id: Optional[int] = None
    parent_span_id: Optional[int] = None

    def validate(self) -> "Envelope":
        if not _SOURCE_ID_RE.match(self.source_id or ""):
            raise EnvelopeError(
                f"bad source_id {self.source_id!r}: want {SOURCE_ID_LEN} "
                "lowercase hex chars")
        if self.epoch < 0 or self.seq < 0:
            raise EnvelopeError(
                f"negative epoch/seq ({self.epoch}, {self.seq})")
        if (self.trace_id is None) != (self.parent_span_id is None):
            raise EnvelopeError(
                "partial trace context: trace_id and parent_span_id "
                "travel together")
        if self.trace_id is not None \
                and (self.trace_id <= 0 or self.parent_span_id <= 0):
            raise EnvelopeError(
                f"non-positive trace context ({self.trace_id}, "
                f"{self.parent_span_id})")
        return self

    # -- wire codecs --------------------------------------------------------
    def to_metadata(self) -> tuple:
        """gRPC invocation metadata / HTTP header pairs; trace-context
        keys ride only when present, so untraced senders stay
        byte-identical to pre-trace peers."""
        meta = ((META_SOURCE_ID, self.source_id),
                (META_EPOCH, str(self.epoch)),
                (META_SEQ, str(self.seq)))
        if self.trace_id is not None:
            meta += ((META_TRACE_ID, str(self.trace_id)),
                     (META_PARENT_SPAN_ID, str(self.parent_span_id)))
        return meta

    def to_json(self) -> dict:
        d = {"source_id": self.source_id, "epoch": self.epoch,
             "seq": self.seq}
        if self.trace_id is not None:
            d["trace_id"] = self.trace_id
            d["parent_span_id"] = self.parent_span_id
        return d

    @staticmethod
    def _parse_trace(get_trace, get_parent) -> tuple:
        """Shared trace-context parse for both codecs: both absent ->
        (None, None); exactly one present or non-integer -> reject."""
        tid_s, psid_s = get_trace, get_parent
        if tid_s is None and psid_s is None:
            return None, None
        if tid_s is None or psid_s is None:
            missing = (META_TRACE_ID if tid_s is None
                       else META_PARENT_SPAN_ID)
            raise EnvelopeError(
                f"partial trace context: missing {missing}")
        try:
            return int(tid_s), int(psid_s)
        except (TypeError, ValueError):
            raise EnvelopeError(
                f"non-integer trace context ({tid_s!r}, {psid_s!r})")

    @classmethod
    def from_mapping(cls, meta: Mapping) -> Optional["Envelope"]:
        """Parse from a metadata/header mapping (anything with .get —
        dict(grpc invocation_metadata) or an email.message.Message).
        Returns None when NO envelope keys are present (legacy sender);
        raises EnvelopeError when the envelope is partial or malformed —
        a half-present envelope is corruption, not a legacy peer. The
        trace-context pair follows the same rule independently: absent
        = untraced, half-present = rejected."""
        vals = [meta.get(k) for k in _META_KEYS]
        if all(v is None for v in vals):
            return None
        if any(v is None for v in vals):
            missing = [k for k, v in zip(_META_KEYS, vals) if v is None]
            raise EnvelopeError(f"partial envelope: missing {missing}")
        sid, epoch_s, seq_s = vals
        try:
            epoch, seq = int(epoch_s), int(seq_s)
        except (TypeError, ValueError):
            raise EnvelopeError(
                f"non-integer epoch/seq ({epoch_s!r}, {seq_s!r})")
        tid, psid = cls._parse_trace(meta.get(META_TRACE_ID),
                                     meta.get(META_PARENT_SPAN_ID))
        return cls(str(sid), epoch, seq, tid, psid).validate()

    @classmethod
    def from_json(cls, d: object) -> Optional["Envelope"]:
        """Parse the wrapped-JSON-body form ({"envelope": {...}})."""
        if d is None:
            return None
        if not isinstance(d, dict):
            raise EnvelopeError(f"envelope must be an object, got "
                                f"{type(d).__name__}")
        try:
            epoch, seq = int(d.get("epoch")), int(d.get("seq"))
        except (TypeError, ValueError):
            raise EnvelopeError("non-integer epoch/seq in JSON envelope")
        tid, psid = cls._parse_trace(d.get("trace_id"),
                                     d.get("parent_span_id"))
        return cls(str(d.get("source_id") or ""), epoch, seq,
                   tid, psid).validate()


class DedupWindow:
    """Bounded per-stream duplicate suppression: for each
    (source_id, epoch) a high-water mark plus a `window`-bit bitmap of
    recently seen seqs. Streams are LRU-bounded at `max_sources`; an
    evicted stream's re-appearance re-opens at its next seq (its old
    seqs would then read fresh — evictions are counted in
    veneur.dedup.window_evictions_total so the bound is observable).

    Thread-safe; the import paths call observe() from gRPC worker and
    HTTP handler threads concurrently."""

    def __init__(self, window: int, max_sources: int = 1024,
                 max_skip: Optional[int] = None):
        if window <= 0:
            raise ValueError("window must be > 0")
        self.window = int(window)
        self.max_sources = max(1, int(max_sources))
        # the acceptance bound on forward jumps: a hostile/corrupt seq
        # must not be able to slide the high-water mark arbitrarily far
        # (wiping the bitmap's memory of everything actually folded)
        self.max_skip = (int(max_skip) if max_skip is not None
                         else self.window * 64)
        self._lock = threading.Lock()
        # (source_id, epoch) -> [high_water, bitmap]; bit k of the
        # bitmap marks seq (high_water - k), k in [0, window)
        self._streams: "OrderedDict[tuple, list]" = OrderedDict()
        self.evictions = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._streams)

    def _verdict_locked(self, env: Envelope, mark: bool) -> str:
        key = (env.source_id, env.epoch)
        st = self._streams.get(key)
        if st is None:
            if env.seq > self.max_skip:
                raise EnvelopeError(
                    f"seq {env.seq} opens a stream past max skip "
                    f"{self.max_skip}")
            if mark:
                while len(self._streams) >= self.max_sources:
                    self._streams.popitem(last=False)
                    self.evictions += 1
                self._streams[key] = [env.seq, 1]
            return FRESH
        self._streams.move_to_end(key)
        high, bits = st
        if env.seq > high:
            skip = env.seq - high
            if skip > self.max_skip:
                raise EnvelopeError(
                    f"seq {env.seq} skips {skip} past high-water {high} "
                    f"(max {self.max_skip})")
            if mark:
                st[0] = env.seq
                st[1] = ((bits << skip) | 1) & ((1 << self.window) - 1)
            return FRESH
        k = high - env.seq
        if k >= self.window:
            # below the window: indistinguishable from an already-folded
            # seq whose bit scrolled off — suppress conservatively (the
            # documented staleness bound: a replay older than `window`
            # seqs behind the stream head is dropped, never double-folded)
            return STALE
        if bits & (1 << k):
            return DUPLICATE
        if mark:
            st[1] = bits | (1 << k)
        return FRESH

    def observe(self, env: Envelope) -> str:
        """Check-and-mark: FRESH (and now marked), DUPLICATE, or STALE.
        Raises EnvelopeError on an over-bound seq skip."""
        with self._lock:
            return self._verdict_locked(env, mark=True)

    def peek(self, env: Envelope) -> str:
        """Check without marking (the proxy's two-phase use: mark only
        after every destination delivered)."""
        with self._lock:
            return self._verdict_locked(env, mark=False)

    def mark(self, env: Envelope) -> None:
        with self._lock:
            self._verdict_locked(env, mark=True)

    # -- checkpoint persistence (persistence/snapshot.py "forward") ---------
    def snapshot(self) -> dict:
        """JSON-able state, LRU order preserved (oldest first)."""
        with self._lock:
            return {"window": self.window,
                    "streams": [[sid, epoch, high, format(bits, "x")]
                                for (sid, epoch), (high, bits)
                                in self._streams.items()]}

    def restore(self, snap: dict) -> int:
        """Fold a snapshot()'s streams back in, re-masking bitmaps to
        THIS window's width (a restore into a smaller window keeps the
        newest seqs, the conservative end). Returns streams restored."""
        streams = (snap or {}).get("streams") or []
        n = 0
        with self._lock:
            for entry in streams:
                try:
                    sid, epoch, high, bits_hex = entry
                    high = int(high)
                    bits = int(str(bits_hex), 16)
                except (TypeError, ValueError):
                    continue   # one bad row must not void the rest
                while len(self._streams) >= self.max_sources:
                    self._streams.popitem(last=False)
                    self.evictions += 1
                self._streams[(str(sid), int(epoch))] = [
                    high, bits & ((1 << self.window) - 1)]
                n += 1
        return n
