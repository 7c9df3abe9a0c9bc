"""SSF wire protocol: framing and packet parsing.

reference protocol/wire.go: frame = [1B version=0][4B big-endian length]
[protobuf SSFSpan], 16MB cap (:44); framing errors are fatal per connection
(IsFramingError); ParseSSF (:137) normalizes the legacy name tag and zero
sample rates.
"""

from __future__ import annotations

import struct
from typing import Optional

from veneur_tpu_torch.proto import ssf_pb2

MAX_SSF_PACKET_LENGTH = 16 * 1024 * 1024
VERSION_0 = 0


class FramingError(Exception):
    """The stream is unrecoverably broken (reference IsFramingError)."""


def parse_ssf(packet: bytes) -> ssf_pb2.SSFSpan:
    """Parse + normalize one SSF protobuf packet (wire.go:137 ParseSSF)."""
    span = ssf_pb2.SSFSpan()
    span.ParseFromString(packet)
    if not span.name:
        # legacy name-tag promotion (wire.go:155-163)
        if "name" in span.tags:
            span.name = span.tags["name"]
        span.tags.pop("name", None)
    for sample in span.metrics:
        if sample.sample_rate == 0:
            sample.sample_rate = 1.0
    return span


def valid_trace(span: ssf_pb2.SSFSpan) -> bool:
    """wire.go:81 ValidTrace."""
    return (span.id != 0 and span.trace_id != 0
            and span.start_timestamp != 0 and span.end_timestamp != 0
            and bool(span.name))


def read_ssf(stream) -> Optional[ssf_pb2.SSFSpan]:
    """Read one framed span from a file-like stream (wire.go:108 ReadSSF).
    Returns None on clean EOF at a message boundary; raises FramingError on
    mid-frame EOF, bad version, or oversized length."""
    head = stream.read(1)
    if head == b"":
        return None
    version = head[0]
    if version != VERSION_0:
        raise FramingError(f"unknown SSF frame version {version}")
    raw_len = stream.read(4)
    if len(raw_len) < 4:
        raise FramingError("truncated SSF frame length")
    (length,) = struct.unpack(">I", raw_len)
    if length > MAX_SSF_PACKET_LENGTH:
        raise FramingError(f"SSF frame of {length} bytes exceeds cap")
    body = b""
    while len(body) < length:
        chunk = stream.read(length - len(body))
        if not chunk:
            raise FramingError("truncated SSF frame body")
        body += chunk
    return parse_ssf(body)


def write_ssf(stream, span: ssf_pb2.SSFSpan) -> int:
    """Write one framed span (wire.go:182 WriteSSF)."""
    body = span.SerializeToString()
    stream.write(struct.pack(">BI", VERSION_0, len(body)))
    stream.write(body)
    return len(body)
