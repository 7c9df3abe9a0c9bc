"""HTTP API (reference http.go:21-59 Handler + handlers_global.go).

Endpoints: GET /healthcheck, GET /healthz (liveness), GET /readyz
(readiness — see server/health.py), GET /healthcheck/tracing, GET
/version, GET /builddate, GET /stats, GET /metrics (gated on
prometheus_metrics_enabled), GET /debug/pprof/threads and
/debug/pprof/profile (host stacks and a sampled host profile), GET
/debug/profile?seconds=N (gated on profile_capture_enabled: a
torch.profiler trace with CUDA activity), and POST/GET /quitquitquit
(gated on http_quit, server.go:80).

Routes of tiers this package has not ported yet answer 501 and name the
ROADMAP item that brings them (`NOT_PORTED_ROUTES`): POST /import, POST
/query, POST /reshard, and the /watch family.
"""

from __future__ import annotations

import http.server
import json
import logging
import math
import threading
from urllib.parse import parse_qs, urlparse

from veneur_tpu_torch import __version__ as VERSION

log = logging.getLogger("veneur_tpu_torch.server.http")

BUILD_DATE = "dev"

# (method, path or path prefix ending in "/") -> the ROADMAP item that
# ports the route's tier
NOT_PORTED_ROUTES = {
    ("POST", "/import"): "A6",
    ("POST", "/query"): "A5b",
    ("POST", "/reshard"): "A8",
    ("POST", "/watch"): "A5b",
    ("GET", "/watch"): "A5b",
    ("GET", "/watch/stream"): "A5b",
    ("DELETE", "/watch/"): "A5b",
}


def _not_ported_item(method: str, path: str):
    item = NOT_PORTED_ROUTES.get((method, path))
    if item is None and method == "DELETE" and path.startswith("/watch/"):
        item = NOT_PORTED_ROUTES[("DELETE", "/watch/")]
    return item


def _thread_dump() -> bytes:
    """Stacks of every live thread (the operational half of the
    reference's always-mounted pprof endpoints, http.go:51-56)."""
    import sys
    import traceback
    names = {t.ident: t.name for t in threading.enumerate()}
    out = []
    for ident, frame in sys._current_frames().items():
        out.append(f"--- thread {names.get(ident, '?')} ({ident}) ---")
        out.extend(line.rstrip()
                   for line in traceback.format_stack(frame))
    return ("\n".join(out) + "\n").encode()


def _sample_profile(seconds: float, hz: float = 97.0) -> bytes:
    """Statistical CPU profile: sample every thread's innermost frames at
    ~hz for `seconds`, report hottest (function, file:line) sites — the
    Python analogue of `GET /debug/pprof/profile?seconds=N`."""
    import sys
    import time as _time
    from collections import Counter
    counts: Counter = Counter()
    samples = 0
    deadline = _time.monotonic() + seconds
    period = 1.0 / hz
    me = threading.get_ident()
    while _time.monotonic() < deadline:
        for ident, frame in sys._current_frames().items():
            if ident == me:
                continue
            co = frame.f_code
            counts[(co.co_name, f"{co.co_filename}:{frame.f_lineno}")] += 1
        samples += 1
        _time.sleep(period)
    lines = [f"{samples} samples over {seconds:.1f}s "
             f"({hz:.0f}Hz, innermost frame per thread)"]
    for (fn, loc), n in counts.most_common(40):
        lines.append(f"{n / max(samples, 1) * 100:6.1f}%  {fn}  {loc}")
    return ("\n".join(lines) + "\n").encode()


def _seconds_arg(query: str) -> float:
    """The ?seconds= argument (default 5); NaN when malformed."""
    q = parse_qs(query)
    try:
        return float(q.get("seconds", ["5"])[0])
    except ValueError:
        return float("nan")


def start_http_server(server, address) -> "http.server.ThreadingHTTPServer":
    """Mount the API for a veneur_tpu_torch Server; returns the running
    ThreadingHTTPServer (its .server_address has the bound port)."""

    class Handler(http.server.BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            log.debug(fmt, *args)

        def _reply(self, code, body=b"", ctype="text/plain"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _shutdown_gate(self) -> bool:
            """The ONE shutdown gate for every stateful endpoint
            (/stats, /healthz, /readyz, /debug/profile): a tearing-down
            server must answer 503, not hang — these handlers read
            aggregator/device state that shutdown is concurrently
            draining. Returns True when it replied."""
            if server._shutdown.is_set():
                self._reply(503, b"shutting down")
                return True
            return False

        def _not_ported(self, method: str) -> bool:
            """501 for a route whose tier is not ported yet, naming the
            ROADMAP item that brings it. Returns True when it replied."""
            item = _not_ported_item(method, self.path)
            if item is None:
                return False
            length = int(self.headers.get("Content-Length", "0") or 0)
            if length:
                self.rfile.read(length)
            self._reply(501, f"{method} {self.path}: not ported to "
                             f"veneur_tpu_torch yet (ROADMAP {item})"
                        .encode())
            return True

        def do_GET(self):
            if self._not_ported("GET"):
                return
            if self.path == "/healthcheck":
                self._reply(200, b"ok")
            elif self.path == "/healthz":
                # liveness: restart-worthy failures only (README
                # §Overload & health)
                if self._shutdown_gate():
                    return
                from veneur_tpu_torch.server.health import check_live
                ok, detail = check_live(server)
                self._reply(200 if ok else 503,
                            json.dumps(detail).encode(),
                            "application/json")
            elif self.path == "/readyz":
                # readiness: should peers send NEW traffic here?
                if self._shutdown_gate():
                    return
                from veneur_tpu_torch.server.health import check_ready
                ok, detail = check_ready(server)
                self._reply(200 if ok else 503,
                            json.dumps(detail).encode(),
                            "application/json")
            elif self.path == "/healthcheck/tracing":
                # tracing is always on (reference http.go:44 keeps the
                # endpoint for fleet compatibility)
                self._reply(200, b"ok")
            elif self.path == "/version":
                self._reply(200, VERSION.encode())
            elif self.path == "/builddate":
                self._reply(200, BUILD_DATE.encode())
            elif self.path == "/stats":
                if self._shutdown_gate():
                    return
                body = json.dumps({
                    "packets_received": server.packets_received,
                    "parse_errors": server.parse_errors
                    + server.aggregator.extra_parse_errors(),
                    "processed": server.aggregator.processed,
                    "flush_count": server.flush_count,
                    "spans_received": server.span_pipeline.spans_received,
                    "spans_dropped": server.span_pipeline.spans_dropped,
                    # the full registry, flattened — every counter/gauge
                    # plus timer count/sum, labeled series keyed
                    # name{k=v,...}
                    "telemetry": server.metrics.flat_values(),
                }).encode()
                self._reply(200, body, "application/json")
            elif self.path == "/metrics":
                # Prometheus text exposition of the telemetry registry.
                # Off by default: the endpoint 404s unless configured, so
                # an unaware deployment exposes nothing new.
                if not server.cfg.prometheus_metrics_enabled:
                    self._reply(404, b"prometheus_metrics_enabled is off")
                    return
                from veneur_tpu_torch.observability import render_prometheus
                server._c_metrics_scrapes.inc()
                self._reply(200, render_prometheus(server.metrics).encode(),
                            "text/plain; version=0.0.4")
            elif self.path == "/debug/pprof/threads":
                self._reply(200, _thread_dump(), "text/plain")
            elif self.path.startswith("/debug/pprof/profile"):
                parsed = urlparse(self.path)
                if parsed.path != "/debug/pprof/profile":
                    self._reply(404, b"not found")
                    return
                seconds = _seconds_arg(parsed.query)
                if not math.isfinite(seconds) or seconds <= 0:
                    self._reply(400, b"bad seconds")
                    return
                self._reply(200, _sample_profile(min(seconds, 60.0)),
                            "text/plain")
            elif self.path.startswith("/debug/profile"):
                self._debug_profile()
            elif self.path == "/quitquitquit" and server.cfg.http_quit:
                self._quit()
            else:
                self._reply(404, b"not found")

        def _debug_profile(self):
            """On-demand device trace (torch.profiler with CUDA activity).
            Ordering: shutdown guard first (a capture during teardown
            would trace a dying runtime), then the config gate (an
            unaware deployment exposes nothing), then parsing."""
            parsed = urlparse(self.path)
            if parsed.path != "/debug/profile":
                self._reply(404, b"not found")
                return
            if self._shutdown_gate():
                return
            if not server.cfg.profile_capture_enabled:
                self._reply(404, b"profile_capture_enabled is off")
                return
            seconds = _seconds_arg(parsed.query)
            if not math.isfinite(seconds) or seconds <= 0:
                self._reply(400, b"bad seconds")
                return
            from veneur_tpu_torch.observability import runtime
            try:
                trace_dir = runtime.capture_profile(min(seconds, 60.0))
            except RuntimeError as e:
                # single-flight: one capture at a time
                self._reply(409, str(e).encode())
                return
            except Exception as e:
                log.warning("profile capture failed: %s", e)
                self._reply(500, b"profile capture failed")
                return
            self._reply(200, json.dumps(
                {"trace_dir": trace_dir,
                 "seconds": min(seconds, 60.0)}).encode(),
                "application/json")

        def do_POST(self):
            if self._not_ported("POST"):
                return
            if self.path == "/quitquitquit" and server.cfg.http_quit:
                self._quit()
            else:
                self._reply(404, b"not found")

        def do_DELETE(self):
            if not self._not_ported("DELETE"):
                self._reply(404, b"not found")

        def _quit(self):
            self._reply(200, b"bye")

            def stop():
                server.shutdown()
                if getattr(server, "exit_on_quit", False):
                    import os
                    os._exit(0)  # graceful-exit endpoint ends the process

            threading.Thread(target=stop, daemon=True).start()

    httpd = http.server.ThreadingHTTPServer(address, Handler)
    httpd.daemon_threads = True
    t = threading.Thread(target=httpd.serve_forever, daemon=True,
                         name="http-api")
    t.start()
    return httpd
