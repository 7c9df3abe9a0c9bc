"""SSF trace/metrics client (reference trace/client.go + backend.go).

A Client owns a bounded record queue (the `records` channel front-end with
backpressure, client.go:85-119) drained by one worker thread into a
backend:

- PacketBackend: one SSF protobuf per UDP/unixgram datagram
  (backend.go packetBackend).
- StreamBackend: framed spans over a stream socket, reconnecting with
  linear backoff (backend.go:18-31 DefaultBackoff 20ms → max 1s, connect
  timeout 10s; poison spans are dropped).
- ChannelBackend: feeds a server's own span pipeline directly — the
  self-telemetry loop (trace.NewChannelClient, server.go:309-313).
"""

from __future__ import annotations

import logging
import queue
import socket
import threading
import time
from typing import Optional

from veneur_tpu_torch.protocol.wire import write_ssf

log = logging.getLogger("veneur_tpu_torch.trace")

DEFAULT_CAPACITY = 1024
DEFAULT_BACKOFF = 0.020
MAX_BACKOFF = 1.0
CONNECT_TIMEOUT = 10.0


class PacketBackend:
    def __init__(self, address):
        self.address = address
        if isinstance(address, str):  # unixgram path
            self.sock = socket.socket(socket.AF_UNIX, socket.SOCK_DGRAM)
        else:
            self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.connect(address)

    def send(self, span) -> None:
        self.sock.send(span.SerializeToString())

    def close(self):
        self.sock.close()


class StreamBackend:
    def __init__(self, address, backoff: float = DEFAULT_BACKOFF,
                 max_backoff: float = MAX_BACKOFF):
        self.address = address
        self.backoff = backoff
        self.max_backoff = max_backoff
        self.sock: Optional[socket.socket] = None
        self._closing = threading.Event()

    def prepare_close(self):
        """Unblocks a worker stuck in the reconnect loop so Client.close
        can join it."""
        self._closing.set()

    def _connect(self):
        delay = self.backoff
        while self.sock is None and not self._closing.is_set():
            try:
                if isinstance(self.address, str):
                    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                else:
                    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
                s.settimeout(CONNECT_TIMEOUT)
                s.connect(self.address)
                s.settimeout(None)
                self.sock = s
            except OSError:
                time.sleep(delay)
                delay = min(delay + self.backoff, self.max_backoff)

    def send(self, span) -> None:
        if self.sock is None:
            self._connect()
        if self.sock is None:  # closing while disconnected
            raise OSError("backend closing")
        try:
            f = self.sock.makefile("wb")
            write_ssf(f, span)
            f.flush()
        except OSError:
            # drop the poison span, reconnect for the next one
            # (backend.go stream semantics)
            try:
                self.sock.close()
            except OSError:
                pass
            self.sock = None
            raise

    def close(self):
        if self.sock is not None:
            self.sock.close()


class ChannelBackend:
    """Direct hand-off into a SpanPipeline (self-telemetry loop-back)."""

    def __init__(self, span_pipeline):
        self.span_pipeline = span_pipeline

    def send(self, span) -> None:
        self.span_pipeline.handle_span(span)

    def close(self):
        pass


class Client:
    def __init__(self, backend, capacity: int = DEFAULT_CAPACITY):
        self.backend = backend
        self.records: "queue.Queue" = queue.Queue(maxsize=capacity)
        self.sent = 0
        self.dropped = 0
        self.errors = 0
        self._stop = object()
        self._thread = threading.Thread(target=self._work, daemon=True,
                                        name="trace-client")
        self._thread.start()

    def record(self, span) -> bool:
        """Non-blocking enqueue; full buffer drops (client.go backpressure
        semantics for the non-blocking path)."""
        try:
            self.records.put_nowait(span)
            return True
        except queue.Full:
            self.dropped += 1
            return False

    def _work(self):
        while True:
            item = self.records.get()
            try:
                if item is self._stop:
                    return
                try:
                    self.backend.send(item)
                    self.sent += 1
                except Exception:
                    self.errors += 1
            finally:
                self.records.task_done()

    def flush(self, timeout: float = 5.0):
        """Wait until every enqueued record has been fully sent (not just
        dequeued — task_done fires after backend.send returns)."""
        deadline = time.time() + timeout
        while self.records.unfinished_tasks and time.time() < deadline:
            time.sleep(0.01)

    def close(self):
        prepare = getattr(self.backend, "prepare_close", None)
        if prepare is not None:
            prepare()
        self.records.put(self._stop)
        self._thread.join(timeout=2.0)
        self.backend.close()


def report_one(client: Client, sample) -> bool:
    """Ship one SSF metric sample inside a metrics-only span (reference
    trace/metrics/client.go:21 ReportOne)."""
    return report_batch(client, [sample])


def report_batch(client: Client, samples) -> bool:
    """trace/metrics/client.go:50 ReportBatch: a span carrying only
    metrics (no trace fields) — the carrier-packet pattern."""
    from veneur_tpu_torch.proto import ssf_pb2
    span = ssf_pb2.SSFSpan()
    for s in samples:
        span.metrics.append(s)
    return client.record(span)
