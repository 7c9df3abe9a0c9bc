"""Plain-DogStatsD UDP emission shared by the server's stats_address
mirror and the proxy's runtime-metrics ticker (reference: statsd.New
clients at server.go:297 and proxy.go:213 — one shared client library
there, one shared helper here, so line format / chunking / addressing
can't drift between the two daemons)."""

from __future__ import annotations

import socket
from typing import List, Tuple

# the reference's datadog statsd client batches messages per payload;
# 25 short lines stays far under any sane MTU the way the server's
# mirror always has
LINES_PER_DATAGRAM = 25


def parse_addr(stats_address: str) -> Tuple[str, int]:
    """host:port with the host defaulting to loopback (`:8125` and
    `8125` both mean 127.0.0.1:8125, matching the server mirror)."""
    host, _, port = stats_address.rpartition(":")
    return (host or "127.0.0.1", int(port))


def format_line(name: str, value: float, type_char: str,
                tags: str = "") -> bytes:
    """One DogStatsD line; values use repr(float) like the server
    mirror (full round-trip precision, no scientific surprises for
    the magnitudes self-metrics carry)."""
    line = b"%s:%s|%s" % (name.encode(), repr(float(value)).encode(),
                          type_char.encode())
    if tags:
        line += b"|#" + tags.encode()
    return line


def send_lines(sock: socket.socket, dest: Tuple[str, int],
               lines: List[bytes]) -> None:
    for i in range(0, len(lines), LINES_PER_DATAGRAM):
        sock.sendto(b"\n".join(lines[i:i + LINES_PER_DATAGRAM]), dest)


def current_rss_bytes() -> float:
    """Resident set size, CURRENT not peak: /proc/self/statm page count
    on Linux; getrusage peak (KiB on Linux, bytes on macOS) as the
    fallback where /proc is absent."""
    try:
        with open("/proc/self/statm", "rb") as f:
            pages = int(f.read().split()[1])
        import os
        return float(pages * os.sysconf("SC_PAGE_SIZE"))
    except (OSError, ValueError, IndexError):
        import resource
        import sys
        ru = resource.getrusage(resource.RUSAGE_SELF)
        scale = 1 if sys.platform == "darwin" else 1024
        return float(ru.ru_maxrss * scale)


def runtime_gauges() -> tuple:
    """(rss_bytes, total_gc_collections) — the ONE place the "CPython
    equivalent of Go's HeapAlloc/NumGC" mapping lives (reference
    flusher.go:36-43 and proxy.go:656 both report these; Go's
    PauseTotalNs has no CPython counterpart — collections are not
    stop-the-world-timed — and is deliberately not faked)."""
    import gc
    return (current_rss_bytes(),
            float(sum(s["collections"] for s in gc.get_stats())))
