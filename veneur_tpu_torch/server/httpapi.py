"""HTTP API (reference http.go:21-59 Handler + handlers_global.go).

Endpoints: GET /healthcheck, GET /healthz (liveness), GET /readyz
(readiness — see server/health.py), GET /healthcheck/tracing, GET
/version, GET /builddate, GET /stats, GET /metrics (gated on
prometheus_metrics_enabled), GET /debug/pprof/threads and
/debug/pprof/profile (host stacks and a sampled host profile), GET
/debug/profile?seconds=N (gated on profile_capture_enabled: a
torch.profiler trace with CUDA activity), POST/GET /quitquitquit (gated
on http_quit, server.go:80), POST /import (the global tier's import:
JSONMetric arrays or a protobuf MetricList, optionally deflated), POST
/query (gated on query_enabled; range
queries also on history_enabled), POST /reshard (gated on
reshard_enabled), and, gated on watch_enabled, POST /watch, GET /watch,
DELETE /watch/<id> and GET /watch/stream (SSE).

Routes of tiers this package has not ported yet would answer 501 and
name the ROADMAP item that brings them (`NOT_PORTED_ROUTES`); every
route of the JAX package's API is served.
"""

from __future__ import annotations

import http.server
import json
import logging
import math
import threading
import zlib
from urllib.parse import parse_qs, urlparse

from veneur_tpu_torch import __version__ as VERSION
from veneur_tpu_torch.reliability.overload import CRITICAL

log = logging.getLogger("veneur_tpu_torch.server.http")

BUILD_DATE = "dev"

# (method, path) -> the ROADMAP item that ports the route's tier
NOT_PORTED_ROUTES: dict = {}


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
            (/stats, /healthz, /readyz, /query, /watch, /debug/profile):
            a tearing-down
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
            item = NOT_PORTED_ROUTES.get((method, self.path))
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
            elif self.path == "/watch":
                self._handle_watch_list()
            elif self.path == "/watch/stream":
                self._handle_watch_stream()
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
            if self.path == "/import":
                # continue the forwarder's trace as a child span
                # (handlers_global.go:126 ExtractRequestChild; a fresh
                # span when no trace headers arrive)
                from veneur_tpu_torch.trace.opentracing import GLOBAL_TRACER
                from veneur_tpu_torch.trace.tracer import Span
                req_span = GLOBAL_TRACER.extract_request_child(
                    "/import", dict(self.headers.items()),
                    "veneur.opentracing.import")
                if req_span is None:
                    req_span = Span("veneur.opentracing.import",
                                    service="veneur")
                try:
                    self._handle_import()
                finally:
                    req_span.client_finish(server.trace_client)
            elif self.path == "/query":
                self._handle_query()
            elif self.path == "/reshard":
                self._handle_reshard()
            elif self.path == "/watch":
                self._handle_watch_register()
            elif self.path == "/quitquitquit" and server.cfg.http_quit:
                self._quit()
            else:
                self._reply(404, b"not found")

        def do_DELETE(self):
            if self.path.startswith("/watch/"):
                self._handle_watch_delete()
            else:
                self._reply(404, b"not found")

        def _json_body(self, route: str):
            """The request's JSON body, or None after a 400 reply (empty
            body or bad JSON)."""
            length = int(self.headers.get("Content-Length", "0"))
            body = self.rfile.read(length)
            if not body.strip():
                self._reply(400, f"Received empty {route} request".encode())
                return None
            try:
                return json.loads(body)
            except ValueError:
                self._reply(400, b"bad JSON body")
                return None

        def _handle_reshard(self):
            """POST /reshard {"n_shards": N, "timeout_s": T?}: a live mesh
            resize, answered with its summary. The gates in /query's
            order: shutdown first, then the config gate (404 when off).
            409 while a move runs: the coordinator takes one at a time,
            so a second operator gets a clean conflict, not a queued
            surprise."""
            if self._shutdown_gate():
                return
            if server.reshard is None:
                self._reply(404, b"reshard_enabled is off")
                return
            length = int(self.headers.get("Content-Length", "0"))
            body = self.rfile.read(length)
            try:
                req = json.loads(body)
                n = int(req["n_shards"])
                timeout = req.get("timeout_s")
                if timeout is not None:
                    timeout = float(timeout)
            except (ValueError, KeyError, TypeError):
                self._reply(400, b'want JSON body {"n_shards": N}')
                return
            from veneur_tpu_torch.reshard import ReshardError
            if server.reshard.active:
                self._reply(409, b"a reshard is already in progress")
                return
            try:
                out = server.trigger_reshard(n, timeout=timeout)
            except ReshardError as e:
                self._reply(400, str(e).encode())
                return
            self._reply(200, json.dumps(out).encode(), "application/json")

        def _handle_query(self):
            """Batched read API: answer quantile / cardinality / counter
            reads from the resident device state, and range reads from
            the history ring. Shutdown gate first, then the config gate
            (an unaware deployment exposes nothing), then the CRITICAL
            shed: reads are the first load to drop when the flush path
            is fighting for the device."""
            if self._shutdown_gate():
                return
            engine = server.query_engine
            if engine is None:
                self._reply(404, b"query_enabled is off")
                return
            if server._overload is not None \
                    and server._overload.state >= CRITICAL:
                # exact drop accounting: one inc per refused request
                server._c_query_shed.inc()
                self._reply(503, b"overloaded: query shed")
                return
            req = self._json_body("/query")
            if req is None:
                return
            from veneur_tpu_torch.query import QueryError
            try:
                out = engine.submit(req)
            except QueryError as e:
                self._reply(400, str(e).encode())
                return
            except (TimeoutError, RuntimeError) as e:
                # batcher backlogged / pipeline wedged: tell the
                # dashboard to back off (exact drop accounting)
                server._c_query_shed.inc()
                self._reply(503, str(e).encode())
                return
            self._reply(200, json.dumps(out).encode(), "application/json")

        def _watch_gate(self):
            """The gate chain of every /watch endpoint, /query's order:
            shutdown gate first, then the config gate. Returns the
            engine, or None when a reply was already sent."""
            if self._shutdown_gate():
                return None
            engine = server.watch_engine
            if engine is None:
                self._reply(404, b"watch_enabled is off")
                return None
            return engine

        def _handle_watch_register(self):
            """POST /watch: register one standing monitor (a host-side
            registry insert)."""
            engine = self._watch_gate()
            if engine is None:
                return
            req = self._json_body("/watch")
            if req is None:
                return
            from veneur_tpu_torch.watch import WatchError, WatchLimitError
            try:
                out = engine.register(req)
            except WatchLimitError as e:
                self._reply(429, str(e).encode())
                return
            except WatchError as e:
                self._reply(400, str(e).encode())
                return
            self._reply(201, json.dumps(out).encode(), "application/json")

        def _handle_watch_list(self):
            engine = self._watch_gate()
            if engine is None:
                return
            watches = engine.list_watches()
            self._reply(200, json.dumps(
                {"watches": watches, "active": len(watches)}).encode(),
                "application/json")

        def _handle_watch_delete(self):
            engine = self._watch_gate()
            if engine is None:
                return
            try:
                wid = int(self.path[len("/watch/"):])
            except ValueError:
                self._reply(400, b"want DELETE /watch/<integer id>")
                return
            if engine.delete(wid):
                self._reply(200, json.dumps({"deleted": wid}).encode(),
                            "application/json")
            else:
                self._reply(404, b"no such watch")

        def _handle_watch_stream(self):
            """GET /watch/stream: SSE tail of state transitions. One
            bounded queue per subscriber (drop-oldest, drops counted);
            503 at the subscriber cap and, through the shutdown gate,
            during shutdown. The loop re-checks the shutdown flag each
            second, so a draining server sheds open streams promptly."""
            engine = self._watch_gate()
            if engine is None:
                return
            sub = engine.hub.subscribe()
            if sub is None:
                self._reply(503, b"watch_stream_max_subscribers reached")
                return
            try:
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.end_headers()
                self.wfile.write(b": watch stream open\n\n")
                self.wfile.flush()
                while not server._shutdown.is_set():
                    ev = sub.get(timeout=1.0)
                    if ev is None:
                        # keepalive comment: a dead client surfaces as
                        # BrokenPipeError instead of a leaked thread
                        self.wfile.write(b": keepalive\n\n")
                    else:
                        self.wfile.write(
                            b"data: " + json.dumps(ev).encode() + b"\n\n")
                    self.wfile.flush()
            except (BrokenPipeError, ConnectionResetError, OSError):
                pass   # the client went away; unsubscribe below
            finally:
                engine.hub.unsubscribe(sub)

        def _import_error(self, cause: str) -> None:
            """README §Monitoring: veneur.import.request_error_total
            with the reference's cause tags (handlers_global.go:96,146,
            154,163), through the self-telemetry loop."""
            from veneur_tpu_torch.samplers import ssf_samples
            from veneur_tpu_torch.trace.client import report_one
            report_one(server.trace_client, ssf_samples.count(
                "veneur.import.request_error_total", 1, {"cause": cause}))

        def _import_timing(self, t0_ns: int, part: str) -> None:
            """veneur.import.response_duration_ns tagged part:request/
            merge (handlers_global.go:190, http.go:78)."""
            import time as _time

            from veneur_tpu_torch.samplers import ssf_samples
            from veneur_tpu_torch.trace.client import report_one
            report_one(server.trace_client, ssf_samples.timing(
                "veneur.import.response_duration_ns",
                (_time.perf_counter_ns() - t0_ns) / 1e9, {"part": part}))

        def _handle_import(self):
            import time as _time
            self._import_t0 = _time.perf_counter_ns()
            length = int(self.headers.get("Content-Length", "0"))
            body = self.rfile.read(length)
            encoding = self.headers.get("Content-Encoding", "")
            if encoding == "deflate":
                try:
                    body = zlib.decompress(body)
                except zlib.error:
                    self._import_error("deflate")
                    self._reply(400, b"bad deflate body")
                    return
            elif encoding not in ("", "identity"):
                # reference: unknown encodings are 415
                # (handlers_global.go:150-156)
                self._import_error("unknown_content_encoding")
                self._reply(415, encoding.encode())
                return
            if not body.strip():
                self._reply(400, b"Received empty /import request")
                return
            # route on the declared Content-Type; fall back to a body
            # sniff (json.NewDecoder skips leading whitespace,
            # handlers_global.go:160 — and a protobuf body can
            # legitimately begin 0x0a 0x5b, which lstrip+'[' would
            # misread as JSON)
            ctype = self.headers.get("Content-Type", "")
            if "json" in ctype:
                self._import_json(body)
            elif "protobuf" in ctype:
                self._import_protobuf(body)
            elif body.lstrip()[:1] == b"[":
                self._import_json(body)
            else:
                self._import_protobuf(body)

        def _extract_envelope(self, body_env=None):
            """Exactly-once envelope for this import: the wrapped-body
            form wins, else the veneur-source-id/-epoch/-seq headers;
            None when neither is present (legacy sender). Raises
            EnvelopeError on a partial or malformed envelope."""
            from veneur_tpu_torch.forward.envelope import Envelope
            if body_env is not None:
                return Envelope.from_json(body_env)
            return Envelope.from_mapping(self.headers)

        def _reject_envelope(self, e) -> None:
            # every rejection is accounted
            server._c_envelope_rejected.inc()
            self._import_error("envelope")
            self._reply(400, str(e).encode())

        def _import_json(self, body: bytes) -> None:
            """Reference JSONMetric array (handlers_global.go:115), or
            the exactly-once wrapped form {"envelope": {...},
            "metrics": [...]} the enveloped proxy/forward path POSTs."""
            from veneur_tpu_torch.forward.envelope import EnvelopeError
            from veneur_tpu_torch.forward.jsonmetric import from_json_metric
            try:
                jms = json.loads(body)
            except ValueError:
                self._import_error("json")
                self._reply(400, b"bad JSON body")
                return
            body_env = None
            if isinstance(jms, dict):
                body_env = jms.get("envelope")
                jms = jms.get("metrics")
            try:
                envelope = self._extract_envelope(body_env)
            except EnvelopeError as e:
                self._reject_envelope(e)
                return
            if not isinstance(jms, list) or not jms:
                self._reply(400, b"Received empty /import request")
                return
            metrics = []
            for jm in jms:
                try:
                    metrics.append(from_json_metric(jm))
                except Exception as e:
                    # registry counter: atomic under concurrent HTTP
                    # import threads (import_errors is a read-only view)
                    server._c_import_errors.inc()
                    log.warning("bad JSONMetric %s: %s",
                                jm.get("name") if isinstance(jm, dict)
                                else jm, e)
            if not metrics:
                # all-empty/improper: the reference 400s
                # (handlers_global.go:176-186 nonEmpty)
                self._reply(400, b"Received empty or improperly-formed "
                                 b"metrics")
                return
            try:
                ok = server.import_metrics(metrics, envelope=envelope)
            except EnvelopeError as e:
                # the dedup window's skip bound (counted by the server)
                self._import_error("envelope")
                self._reply(400, str(e).encode())
                return
            if not ok:
                # CRITICAL overload sheds imports: 503 tells the sending
                # tier to retry elsewhere or later instead of a 202 for
                # data that was discarded. A suppressed duplicate is not
                # a shed: import_metrics acks it True.
                self._reply(503, b"overloaded: import shed")
                return
            self._import_timing(self._import_t0, "request")
            self._reply(202, b"imported")

        def _import_protobuf(self, body: bytes) -> None:
            from veneur_tpu_torch.forward.envelope import EnvelopeError
            from veneur_tpu_torch.proto import forwardrpc_pb2 as fpb
            try:
                envelope = self._extract_envelope()
            except EnvelopeError as e:
                self._reject_envelope(e)
                return
            try:
                mlist = fpb.MetricList.FromString(body)
            except Exception:
                self._import_error("protobuf")
                self._reply(400, b"bad MetricList protobuf")
                return
            try:
                ok = server.import_metrics(list(mlist.metrics),
                                           envelope=envelope)
            except EnvelopeError as e:
                self._import_error("envelope")
                self._reply(400, str(e).encode())
                return
            if not ok:
                self._reply(503, b"overloaded: import shed")
                return
            self._import_timing(self._import_t0, "request")
            self._reply(202, b"imported")

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
