"""The exactly-once forwarding envelope: its parse half.

A forward unit carries an idempotency key, (source_id, epoch, seq), as
gRPC metadata, HTTP headers or a wrapped JSON import body:

  source_id  128-bit hex id of the sending local server.
  epoch      bumped on every restore/restart of the sender.
  seq        monotone per (source_id, epoch), one per forward unit.

A receiver parses it here and rejects a malformed one (partial keys, a
bad source_id, a negative or non-integer epoch/seq, a half-present trace
context) with EnvelopeError: HTTP 400 / gRPC INVALID_ARGUMENT, counted
in veneur.forward.envelope_rejected_total, never folded. Zero keys mean
a legacy sender. The receiver's duplicate window and the sender's
source-id minting are not ported yet (ROADMAP A6f), so a well-formed
envelope is parsed, validated and otherwise ignored.
"""

from __future__ import annotations

import dataclasses
import re
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


class EnvelopeError(ValueError):
    """A malformed envelope: partial metadata, bad source_id, or a
    negative/non-integer epoch or seq. Receivers REJECT (4xx /
    INVALID_ARGUMENT) and account in
    veneur.forward.envelope_rejected_total — never fold."""


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
