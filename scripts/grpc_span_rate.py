#!/usr/bin/env python3
"""Span-per-call rate of the port's gRPC span sink against its collector.

    python3 scripts/grpc_span_rate.py [N]

`GRPCSpanSink.ingest` makes one unary SendSpan call a span (the Falconer
sink is the same class). This sends N spans (2,000 by default) of
chip_smoke.py's phase 15b firehose to `serve_span_sink` answered in this
process and then in a child process, each from 1 and from 8 threads,
and prints one JSON line of calls a second with the host's name. It
needs no card. chip_smoke.py phase 16 runs its collectors in a child
process, off the Server's interpreter lock.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

_CHILD = r"""
import sys
from veneur_tpu_torch.sinks.grpsink import serve_span_sink
server, port = serve_span_sink(lambda span: None)
print(port, flush=True)
sys.stdin.readline()
server.stop(grace=1)
"""


def _rate(port: int, spans, threads: int) -> float:
    from veneur_tpu_torch.sinks.grpsink import GRPCSpanSink
    sink = GRPCSpanSink(f"127.0.0.1:{port}")
    try:
        sink.ingest(spans[0])                    # the channel connects
        t0 = time.perf_counter()
        workers = [threading.Thread(
            target=lambda part: [sink.ingest(s) for s in part],
            args=(spans[i::threads],)) for i in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join()
        dt = time.perf_counter() - t0
        if sink.errors:
            raise SystemExit(f"{sink.errors} calls failed")
        return len(spans) / dt
    finally:
        sink.close()


def main() -> int:
    import chip_smoke
    from veneur_tpu_torch.protocol.wire import parse_ssf
    from veneur_tpu_torch.sinks.grpsink import serve_span_sink
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 2000
    payloads, _true = chip_smoke._firehose()
    spans = [parse_ssf(p) for p in payloads[:n]]
    out = {"host": socket.gethostname(), "spans": n}
    server, port = serve_span_sink(lambda span: None)
    try:
        for threads in (1, 8):
            out[f"same_process_{threads}_threads"] = _rate(port, spans,
                                                           threads)
    finally:
        server.stop(grace=1)
    child = subprocess.Popen([sys.executable, "-c", _CHILD],
                             stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                             text=True)
    try:
        port = int(child.stdout.readline())
        for threads in (1, 8):
            out[f"child_process_{threads}_threads"] = _rate(port, spans,
                                                            threads)
    finally:
        child.stdin.write("\n")
        child.stdin.flush()
        child.wait(timeout=30)
    print(json.dumps({k: (round(v, 1) if isinstance(v, float) else v)
                      for k, v in out.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
