"""The consistent-hash routing tier: veneur-proxy.

reference proxysrv/server.go: a Forward gRPC server that consistent-hashes
each metric's key to one global destination and forwards per-destination
batches; the ring refreshes from discovery on an interval (proxy.go:321-347)
and keeps the last good set when discovery returns empty (proxy.go:498-508);
connections are cached per destination (client_conn_map.go).
"""

from __future__ import annotations

import bisect
import logging
import socket
import threading
from collections import OrderedDict
from typing import Dict, List, Optional

from veneur_tpu_torch.forward.envelope import (FRESH, DedupWindow, Envelope,
                                         EnvelopeError)
from veneur_tpu_torch.forward.rpc import ForwardClient, serve
from veneur_tpu_torch.observability.registry import TelemetryRegistry
from veneur_tpu_torch.reliability.faults import FAULTS, PROXY_FORWARD
from veneur_tpu_torch.reliability.policy import OPEN, CircuitBreaker
from veneur_tpu_torch.utils.hashing import fnv1a_64, splitmix64


def _point(data: bytes) -> int:
    """Ring placement hash: fnv1a-64 finalized through splitmix64 — raw fnv
    clusters badly on short, similar strings (node#i)."""
    return splitmix64(fnv1a_64(data))

log = logging.getLogger("veneur_tpu_torch.forward.proxysrv")


class HashRing:
    """Consistent-hash ring with virtual nodes (the role of the reference's
    stathat.com/c/consistent ring, proxy.go:603; our node hash is fnv1a-64
    — routing placement is an internal choice, not a wire format)."""

    def __init__(self, destinations: List[str], replicas: int = 128):
        self.replicas = replicas
        self.destinations = sorted(set(destinations))
        self._points: List[int] = []
        self._owners: List[str] = []
        for dest in self.destinations:
            for i in range(replicas):
                h = _point(f"{dest}#{i}".encode())
                self._points.append(h)
                self._owners.append(dest)
        order = sorted(range(len(self._points)),
                       key=lambda i: self._points[i])
        self._points = [self._points[i] for i in order]
        self._owners = [self._owners[i] for i in order]

    def get(self, key: bytes) -> Optional[str]:
        if not self._points:
            return None
        h = _point(key)
        i = bisect.bisect(self._points, h) % len(self._points)
        return self._owners[i]


class ProxyServer:
    """Forward-service server that re-forwards by MetricKey hash
    (proxysrv/server.go:273 destForMetric keyed on MetricKey.String())."""

    def __init__(self, discoverer, service: str = "veneur-global",
                 refresh_interval: float = 0.0, replicas: int = 128,
                 failure_threshold: int = 0, cooldown_s: float = 30.0,
                 readyz_port: int = 0, readyz_opener=None,
                 dedup_window: int = 0):
        self.discoverer = discoverer
        self.service = service
        self.refresh_interval = refresh_interval
        self.replicas = replicas
        # per-destination breakers (failure_threshold=0 disables): a dead
        # global otherwise eats a full send timeout per batch per interval
        # while its ring partition backs up behind it
        self.failure_threshold = failure_threshold
        self.cooldown_s = cooldown_s
        self._breakers: Dict[str, CircuitBreaker] = {}
        self.rejected_open = 0
        # exactly-once relay (dedup_window > 0): the proxy is NOT a dedup
        # endpoint — it passes the sender's envelope through to each
        # destination — but it must survive its OWN retry hazard: a ring
        # change between a partial failure and the sender's retry would
        # re-route already-delivered keys to a different global, which
        # would fold them as fresh. So the first attempt at a
        # (source_id, epoch, seq) STORES its per-destination grouping,
        # retries re-attempt only the still-undelivered sub-batches, and
        # _done marks the seq only once every destination has it.
        self._done = (DedupWindow(dedup_window) if dedup_window > 0
                      else None)
        self._inflight: "OrderedDict[tuple, dict]" = OrderedDict()
        self._inflight_cap = 4096
        self._inflight_lock = threading.Lock()
        # plain ints, emitted under the lint-exempt veneur_proxy.*
        # statsd namespace (emit_stats_once) — the veneur.* spellings
        # belong to the server's registry
        self.dup_suppressed = 0
        self.envelope_rejected = 0
        self._ring = HashRing([], replicas)
        # overload-aware routing: peers answering /readyz non-200 (the
        # server's overload state machine) and OPEN-breaker destinations
        # are ejected from a derived routing ring so their keyspace
        # rehashes to survivors instead of queueing behind a sick peer.
        # readyz_port=0 disables probing (destinations' gRPC port is not
        # their HTTP port, so it must be configured explicitly).
        self.readyz_port = readyz_port
        self._readyz_open = readyz_opener  # injectable for tests
        self._not_ready: frozenset = frozenset()
        self._routing_cache = None  # ((id(base), excluded), derived ring)
        # registry: the proxy's own veneur.* instruments (the statsd
        # emitter's veneur_proxy.* lines are a separate, lint-exempt
        # namespace). The proxy holds no tensors: its registry has
        # callbacks only, on the CPU.
        self.metrics = TelemetryRegistry(device="cpu")
        self.metrics.callback(
            "veneur.discovery.stale",
            lambda: float(getattr(self.discoverer, "stale", 0) or 0),
            kind="gauge",
            help="1 while discovery serves last-known-good destinations")
        self._conns: Dict[str, ForwardClient] = {}
        self._lock = threading.Lock()
        self._shutdown = threading.Event()
        self._grpc = None
        self._http = None
        self.port = None
        self.http_port = None
        self.forwarded = 0
        self.errors = 0
        # counter lock: handle()/_deliver_enveloped() run on gRPC/HTTP
        # worker threads concurrently with each other and with the stats
        # emitter; bare `+=` on these ints loses increments. _bump() is
        # the single mutation path. Narrower than self._lock so counter
        # bumps never contend with ring rebuilds or connection setup.
        self._stats_lock = threading.Lock()
        # per-(destination, protocol) forwarded-metric counts — the
        # reference's metrics_by_destination self-metric
        # (proxysrv/server.go:299-301 grpc, proxy.go:651-653 http). The
        # reference samples these at 10%; exact counts are strictly
        # better and cost one dict add per batch.
        self.metrics_by_destination: Dict[tuple, int] = {}
        self._stats_thread = None
        self._stats_sock = None
        self._stats_last: Dict[tuple, int] = {}
        # ring rebuilds actually performed by refresh() — membership
        # changes only, not polls (the regression guard for the
        # rebuild-every-poll bug: a stable fleet must not churn the ring
        # object, which would also invalidate the derived routing-ring
        # cache keyed by id(base))
        self.ring_rebuilds = 0
        self.refresh()

    # -- ring maintenance ---------------------------------------------------
    def refresh(self):
        """proxy.go:321 RefreshDestinations, incl. keep-last-good-on-empty
        (proxy.go:498-508) and connection cache pruning
        (proxysrv/server.go:148-176)."""
        try:
            dests = self.discoverer.get_destinations_for_service(self.service)
        except Exception as e:
            log.warning("discovery failed: %s", e)
            self._probe_ready()
            return
        if not dests:
            log.warning("discovery returned no hosts; keeping last ring")
            self._probe_ready()
            return
        with self._lock:
            # rebuild only on a membership change: HashRing stores
            # sorted(set(...)), so comparing against that canonical form
            # is the membership signature. A stable fleet keeps the SAME
            # ring object across polls — which also keeps the derived
            # routing-ring cache (keyed by id(base)) warm.
            if sorted(set(dests)) != list(self._ring.destinations):
                self._ring = HashRing(dests, self.replicas)
                self.ring_rebuilds += 1
                for dest in list(self._conns):
                    if dest not in self._ring.destinations:
                        self._conns.pop(dest).close()
                for dest in list(self._breakers):
                    if dest not in self._ring.destinations:
                        del self._breakers[dest]
        self._probe_ready()

    def _probe_ready(self) -> None:
        """Consult each destination's GET /readyz (server/health.py) and
        record the non-ready set for _routing_ring. Fail-open per peer: a
        probe that errors (connection refused, no HTTP listener) admits
        the destination — actually-dead peers are the breakers' job, and
        a proxy must not de-route its whole ring because probing broke."""
        if self.readyz_port <= 0:
            return
        import urllib.request
        opener = self._readyz_open or urllib.request.urlopen
        with self._lock:
            dests = list(self._ring.destinations)
        not_ready = set()
        for dest in dests:
            host = dest.rsplit(":", 1)[0]
            url = f"http://{host}:{self.readyz_port}/readyz"
            try:
                with opener(url, timeout=2) as resp:
                    code = getattr(resp, "status", None) or resp.getcode()
                if code != 200:
                    not_ready.add(dest)
            except Exception as e:
                log.debug("readyz probe of %s failed (admitting): %s",
                          dest, e)
        if not_ready != self._not_ready:
            log.info("readyz: not-ready destinations now %s",
                     sorted(not_ready) or "(none)")
        self._not_ready = frozenset(not_ready)

    def _routing_ring(self) -> HashRing:
        """The ring handle()/handle_json route over: the discovery ring
        minus OPEN-breaker and not-ready destinations, rebuilt (and
        cached) only when that exclusion set changes so the hot path
        normally costs two dict scans. A breaker whose cooldown elapsed
        reads HALF_OPEN, so its destination re-enters here and the
        per-batch allow() gate claims the single probe — success closes
        the breaker and the destination stays admitted. Fail-static:
        with every destination excluded, route over the full ring."""
        with self._lock:
            base = self._ring
            excluded = set(self._not_ready)
            for dest, b in self._breakers.items():
                if b.state == OPEN:
                    excluded.add(dest)
            excluded &= set(base.destinations)
            if not excluded or len(excluded) == len(base.destinations):
                return base
            key = (id(base), frozenset(excluded))
            cached = self._routing_cache
            if cached is not None and cached[0] == key:
                return cached[1]
            ring = HashRing(
                [d for d in base.destinations if d not in excluded],
                self.replicas)
            self._routing_cache = (key, ring)
            return ring

    def _conn(self, dest: str) -> ForwardClient:
        with self._lock:
            if dest not in self._conns:
                self._conns[dest] = ForwardClient(dest)
            return self._conns[dest]

    def _breaker(self, dest: str) -> Optional[CircuitBreaker]:
        if self.failure_threshold <= 0:
            return None
        with self._lock:
            if dest not in self._breakers:
                self._breakers[dest] = CircuitBreaker(
                    self.failure_threshold, self.cooldown_s)
            return self._breakers[dest]

    # -- forwarding ---------------------------------------------------------
    def handle(self, metrics: List, envelope: Envelope = None):
        """Group by ring destination, then one SendMetrics per destination
        (proxysrv/server.go:180-188, :286). With an envelope (exactly-once
        sender, dedup_window > 0) delivery is all-or-error: partial
        failure raises so the sender retries the SAME seq, and the retry
        re-attempts only the stored undelivered sub-batches."""
        if envelope is not None and self._done is not None:
            return self._deliver_enveloped(
                metrics, envelope, "grpc",
                lambda m: f"{m.name}{m.type}{','.join(m.tags)}".encode(),
                lambda dest, batch: self._conn(dest).send_metrics(
                    batch, envelope=envelope))
        by_dest: Dict[str, List] = {}
        ring = self._routing_ring()  # rings are immutable once built
        for m in metrics:
            key = f"{m.name}{m.type}{','.join(m.tags)}".encode()
            dest = ring.get(key)
            if dest is None:
                self._bump("errors")
                continue
            by_dest.setdefault(dest, []).append(m)
        for dest, batch in by_dest.items():
            breaker = self._breaker(dest)
            if breaker is not None and not breaker.allow():
                self._bump("errors", len(batch))
                self._bump("rejected_open", len(batch))
                continue
            try:
                FAULTS.inject(PROXY_FORWARD, name=dest)
                self._conn(dest).send_metrics(batch)
                self._bump("forwarded", len(batch))
                self._count_dest(dest, "grpc", len(batch))
                if breaker is not None:
                    breaker.record_success()
            except Exception as e:
                self._bump("errors", len(batch))
                if breaker is not None:
                    breaker.record_failure()
                log.warning("proxy forward to %s failed: %s", dest, e)

    def _deliver_enveloped(self, items: List, envelope: Envelope,
                           protocol: str, keyfn, sendfn) -> bool:
        """Exactly-once relay of one (source_id, epoch, seq) unit: peek
        the done-window (suppressed units were already fully delivered —
        ack without re-sending), pin the per-destination grouping on
        first attempt, deliver undelivered sub-batches with the SENDER'S
        envelope attached (each destination's own dedup window absorbs
        ambiguous re-sends), and mark done only when none remain."""
        try:
            verdict = self._done.peek(envelope)
        except EnvelopeError:
            self._bump("envelope_rejected")
            raise
        if verdict != FRESH:
            self._bump("dup_suppressed")
            return True
        key = (protocol, envelope.source_id, envelope.epoch, envelope.seq)
        # _routing_ring acquires self._lock internally: call it before
        # taking any proxy lock of our own
        ring = self._routing_ring()
        with self._inflight_lock:
            stored = self._inflight.get(key)
            if stored is None:
                stored = {}
                for it in items:
                    dest = ring.get(keyfn(it))
                    if dest is None:
                        self._bump("errors")
                        continue
                    stored.setdefault(dest, []).append(it)
                self._inflight[key] = stored
                while len(self._inflight) > self._inflight_cap:
                    # dropping a pinned grouping degrades that unit's
                    # retry to re-hash-on-current-ring; bounded memory
                    # wins over a pathological backlog of dead seqs
                    self._inflight.popitem(last=False)
            pending = list(stored.items())
        failed = 0
        for dest, batch in pending:
            breaker = self._breaker(dest)
            if breaker is not None and not breaker.allow():
                self._bump("errors", len(batch))
                self._bump("rejected_open", len(batch))
                failed += 1
                continue
            try:
                FAULTS.inject(PROXY_FORWARD, name=dest)
                sendfn(dest, batch)
                self._bump("forwarded", len(batch))
                self._count_dest(dest, protocol, len(batch))
                if breaker is not None:
                    breaker.record_success()
                with self._inflight_lock:
                    stored.pop(dest, None)
            except Exception as e:
                failed += 1
                self._bump("errors", len(batch))
                if breaker is not None:
                    breaker.record_failure()
                log.warning("proxy forward to %s failed: %s", dest, e)
        if failed:
            raise RuntimeError(
                f"delivered {len(pending) - failed}/{len(pending)} "
                f"destinations for seq {envelope.seq}; sender must "
                "retry the same seq")
        self._done.mark(envelope)
        with self._inflight_lock:
            self._inflight.pop(key, None)
        return True

    def _bump(self, attr: str, n: int = 1) -> None:
        """Increment one of the plain-int stat counters under
        _stats_lock — `self._bump("errors")` from two worker threads is a
        read-modify-write that loses increments."""
        with self._stats_lock:
            setattr(self, attr, getattr(self, attr) + n)

    def _count_dest(self, dest: str, protocol: str, n: int) -> None:
        with self._lock:
            key = (dest, protocol)
            self.metrics_by_destination[key] = \
                self.metrics_by_destination.get(key, 0) + n

    # -- HTTP-era (v1) routing ----------------------------------------------
    def handle_json(self, json_metrics: List[dict]) -> Dict[str, List[dict]]:
        """Split a JSONMetric array by MetricKey over the ring
        (proxy.go:580 ProxyMetrics: key = Name+Type+JoinedTags). Returns
        the per-destination batches; callers POST each to <dest>/import."""
        by_dest: Dict[str, List[dict]] = {}
        ring = self._routing_ring()
        for jm in json_metrics:
            key = (f"{jm.get('name', '')}{jm.get('type', '')}"
                   f"{jm.get('tagstring', '')}").encode()
            dest = ring.get(key)
            if dest is None:
                self._bump("errors")
                continue
            by_dest.setdefault(dest, []).append(jm)
        return by_dest

    def _post_import(self, dest: str, batch: List[dict],
                     envelope: Envelope = None) -> None:
        """POST one batch to <dest>/import as deflate-compressed JSON
        (the reference's vhttp.PostHelper with compress=true,
        proxy.go:622 doPost). HTTPForwardClient owns scheme handling."""
        from veneur_tpu_torch.forward.rpc import HTTPForwardClient
        HTTPForwardClient(dest).send_json(batch, envelope=envelope)

    def proxy_json_metrics(self, json_metrics: List[dict],
                           envelope: Envelope = None) -> None:
        """ProxyMetrics (proxy.go:580): hash-split, then one POST per
        destination, counting errors per batch like the gRPC path.
        With an envelope, the all-or-error exactly-once relay applies
        (see _deliver_enveloped)."""
        if envelope is not None and self._done is not None:
            self._deliver_enveloped(
                json_metrics, envelope, "http",
                lambda jm: (f"{jm.get('name', '')}{jm.get('type', '')}"
                            f"{jm.get('tagstring', '')}").encode(),
                lambda dest, batch: self._post_import(
                    dest, batch, envelope=envelope))
            return
        for dest, batch in self.handle_json(json_metrics).items():
            breaker = self._breaker(dest)
            if breaker is not None and not breaker.allow():
                self._bump("errors", len(batch))
                self._bump("rejected_open", len(batch))
                continue
            try:
                FAULTS.inject(PROXY_FORWARD, name=dest)
                self._post_import(dest, batch)
                self._bump("forwarded", len(batch))
                self._count_dest(dest, "http", len(batch))
                if breaker is not None:
                    breaker.record_success()
            except Exception as e:
                self._bump("errors", len(batch))
                if breaker is not None:
                    breaker.record_failure()
                log.warning("proxy POST to %s failed: %s", dest, e)

    def start_http(self, address: str = "127.0.0.1:0") -> int:
        """The v1 proxy surface (proxy.go:518 mux): POST /import routes a
        JSONMetric array across the ring; GET /healthcheck. Returns the
        bound port. The 202 is sent BEFORE forwarding, matching the
        reference ("the response has already been returned at this
        point", proxy.go:607)."""
        import http.server
        import json as _json
        import zlib
        srv = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def _reply(self, code, body=b""):
                self.send_response(code)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthcheck":
                    self._reply(200, b"ok")
                else:
                    self._reply(404)

            def do_POST(self):
                if self.path != "/import":
                    self._reply(404)
                    return
                body = self.rfile.read(
                    int(self.headers.get("Content-Length", "0")))
                if self.headers.get("Content-Encoding", "") == "deflate":
                    try:
                        body = zlib.decompress(body)
                    except zlib.error:
                        self._reply(400, b"bad deflate body")
                        return
                try:
                    jms = _json.loads(body)
                except ValueError:
                    self._reply(400, b"bad JSON body")
                    return
                body_env = None
                if isinstance(jms, dict):
                    # exactly-once wrapped form: {"envelope": ...,
                    # "metrics": [...]} (forward/rpc.py send_metrics)
                    body_env = jms.get("envelope")
                    jms = jms.get("metrics")
                if not isinstance(jms, list) or not all(
                        isinstance(jm, dict) for jm in jms):
                    self._reply(400, b"bad JSONMetric array")
                    return
                envelope = None
                if srv._done is not None:
                    try:
                        envelope = (Envelope.from_json(body_env)
                                    if body_env is not None else
                                    Envelope.from_mapping(self.headers))
                    except EnvelopeError:
                        srv.envelope_rejected += 1
                        self._reply(400, b"bad envelope")
                        return
                if envelope is not None:
                    # the 202 IS the ack: send it only once every
                    # destination has the batch, else the sender evicts
                    # a unit the ring never fully delivered
                    try:
                        srv.proxy_json_metrics(jms, envelope=envelope)
                    except EnvelopeError:
                        self._reply(400, b"bad envelope")
                        return
                    except Exception:
                        self._reply(503, b"partial delivery; retry")
                        return
                    self._reply(202, b"accepted")
                    return
                # an empty array is a valid no-op, not an error
                self._reply(202, b"accepted")
                if jms:
                    srv.proxy_json_metrics(jms)

        # accept the same spellings the server's http_address does:
        # optional tcp:// (or http://) scheme and bracketed IPv6 literals
        if "://" in address:
            address = address.partition("://")[2]
        if address.startswith("["):
            host, _, rest = address[1:].partition("]")
            port = rest.lstrip(":")
        else:
            host, _, port = address.rpartition(":")
            if not host:
                host, port = port, ""

        class _Server(http.server.ThreadingHTTPServer):
            address_family = (socket.AF_INET6 if ":" in host
                              else socket.AF_INET)

        httpd = _Server((host, int(port or 0)), Handler)
        self._http = httpd
        self.http_port = httpd.server_address[1]
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        return self.http_port

    # -- self-telemetry -----------------------------------------------------
    def runtime_metrics(self) -> List[tuple]:
        """Process runtime gauges, the role of proxy.go:656
        ReportRuntimeMetrics. The Go fields map to their CPython
        equivalents: HeapAlloc -> current resident set size (the
        live-memory measure a CPython process has), NumGC -> total
        collections across gc generations. Go's PauseTotalNs has no
        CPython counterpart (collections are not stop-the-world-timed)
        and is deliberately not faked; gc.alloc_heap_bytes mirrors
        mem.heap_alloc_bytes exactly as the reference emits HeapAlloc
        under both names. Returns (name, value, type_char) tuples."""
        from veneur_tpu_torch.utils.statsd_emit import runtime_gauges
        rss, ngc = runtime_gauges()
        return [("mem.heap_alloc_bytes", rss, "g"),
                ("gc.number", ngc, "g"),
                ("gc.alloc_heap_bytes", rss, "g")]

    def start_stats(self, stats_address: str, interval: float = 10.0):
        """Emit veneur_proxy.-namespaced self-metrics to a statsd daemon
        on a ticker (proxy.go:213-217 statsd.New + Namespace, :354-365
        runtime ticker): runtime gauges each tick, plus
        metrics_by_destination / forward.error_total deltas."""
        from veneur_tpu_torch.utils.statsd_emit import parse_addr
        self._stats_dest = parse_addr(stats_address)
        self._stats_sock = socket.socket(socket.AF_INET,
                                         socket.SOCK_DGRAM)
        self._stats_interval = interval
        self._stats_thread = threading.Thread(target=self._stats_loop,
                                              daemon=True)
        self._stats_thread.start()

    def _stats_loop(self):
        while not self._shutdown.wait(self._stats_interval):
            try:
                self.emit_stats_once()
            except OSError as e:
                log.warning("proxy stats emit failed: %s", e)

    def emit_stats_once(self):
        from veneur_tpu_torch.utils.statsd_emit import format_line, send_lines
        lines = [format_line("veneur_proxy." + n, v, t)
                 for n, v, t in self.runtime_metrics()]
        with self._lock:
            counts = dict(self.metrics_by_destination)
        with self._stats_lock:
            counts[("", "error")] = self.errors
            counts[("", "dup")] = self.dup_suppressed
            counts[("", "rej")] = self.envelope_rejected
        for key, total in counts.items():
            delta = total - self._stats_last.get(key, 0)
            self._stats_last[key] = total
            if delta <= 0:
                continue
            dest, proto = key
            if proto == "error":
                lines.append(format_line(
                    "veneur_proxy.forward.error_total", delta, "c"))
            elif proto == "dup":
                lines.append(format_line(
                    "veneur_proxy.forward.dup_suppressed_total",
                    delta, "c"))
            elif proto == "rej":
                lines.append(format_line(
                    "veneur_proxy.forward.envelope_rejected_total",
                    delta, "c"))
            else:
                lines.append(format_line(
                    "veneur_proxy.metrics_by_destination", delta, "c",
                    tags=f"destination:{dest},protocol:{proto}"))
        send_lines(self._stats_sock, self._stats_dest, lines)

    # -- lifecycle ----------------------------------------------------------
    def start(self, address: str = "127.0.0.1:0"):
        def _count_reject():
            self._bump("envelope_rejected")
        self._grpc, self.port = serve(
            self.handle, address, with_metadata=self._done is not None,
            on_reject=_count_reject)
        if self.refresh_interval > 0:
            t = threading.Thread(target=self._refresh_loop, daemon=True)
            t.start()

    def _refresh_loop(self):
        while not self._shutdown.wait(self.refresh_interval):
            self.refresh()

    def stop(self):
        self._shutdown.set()
        if self._stats_sock is not None:
            self._stats_sock.close()
        if self._grpc is not None:
            self._grpc.stop(grace=1.0)
        if self._http is not None:
            self._http.shutdown()
            self._http.server_close()   # release the listening fd now
        with self._lock:
            for c in self._conns.values():
                c.close()
            self._conns.clear()
