"""AWS X-Ray span sink (reference sinks/xray/xray.go).

UDP JSON segment documents to the X-Ray daemon, each datagram prefixed
with `{"format": "json", "version": 1}\\n` (xray.go:22 segmentHeader).
Trace ids use the X-Ray `1-<epoch hex>-<24 hex>` format; %-based sampling
on trace id; annotations from an allowlisted tag set (xray.go
xray_annotation_tags).
"""

from __future__ import annotations

import json
import logging
import socket
import zlib
from typing import List

from veneur_tpu_torch.sinks.base import SpanSink

log = logging.getLogger("veneur_tpu_torch.sinks.xray")

SEGMENT_HEADER = b'{"format": "json", "version": 1}\n'


class XRaySpanSink(SpanSink):
    name = "xray"

    def __init__(self, daemon_address: str = "127.0.0.1:2000",
                 sample_percentage: float = 100.0,
                 annotation_tags: List[str] = ()):
        host, _, port = daemon_address.partition(":")
        self.addr = (host or "127.0.0.1", int(port or 2000))
        self.sample_percentage = sample_percentage
        self.annotation_tags = list(annotation_tags)
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sent = 0
        self.skipped = 0

    @staticmethod
    def trace_id(span) -> str:
        """xray.go:262 CalculateTraceID. X-Ray only assembles segments
        sharing one trace id, so the epoch half comes from the trace's
        ROOT start when the client sent it, else from the span start
        bucketed to ~4.3 min (low byte cleared) so siblings within the
        window agree. Same best-effort contract as the reference: traces
        whose clients mix sending/omitting root_start, or whose spans
        straddle a bucket boundary, can still shear — root_start from
        every client is the reliable path."""
        epoch = getattr(span, "root_start_timestamp", 0) // int(1e9)
        if epoch == 0:
            epoch = (span.start_timestamp // int(1e9)) & 0xFFFFFFFFFFFF00
        return (f"1-{epoch & 0xFFFFFFFF:08x}-"
                f"{span.trace_id & ((1 << 96) - 1):024x}")

    def ingest(self, span) -> None:
        # the sample decision hashes the DECIMAL trace id with CRC32
        # against pct-of-maxuint32 (xray.go:155-160): every veneur
        # instance keeps the SAME traces, so distributed traces stay
        # complete — a plain modulo would shear them apart
        hash_key = zlib.crc32(str(span.trace_id).encode()) & 0xFFFFFFFF
        if hash_key > int(self.sample_percentage * 0xFFFFFFFF / 100):
            self.skipped += 1
            return
        annotations = {k: v for k, v in span.tags.items()
                       if k in self.annotation_tags}
        segment = {
            "name": (span.service or "unknown")[:200],
            "id": f"{span.id & ((1 << 64) - 1):016x}",
            "trace_id": self.trace_id(span),
            "start_time": span.start_timestamp / 1e9,
            "end_time": span.end_timestamp / 1e9,
            "namespace": "remote",
            "error": bool(span.error),
            "annotations": annotations,
            "metadata": {"name": span.name},
        }
        if span.parent_id:
            segment["parent_id"] = f"{span.parent_id & ((1 << 64) - 1):016x}"
        try:
            self.sock.sendto(SEGMENT_HEADER + json.dumps(segment).encode(),
                             self.addr)
            self.sent += 1
        except OSError as e:
            log.error("xray send failed: %s", e)
