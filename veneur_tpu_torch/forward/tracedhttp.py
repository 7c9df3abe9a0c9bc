"""Outbound HTTP POST with per-connection-event trace spans.

Reference behavioral contract: http/http.go:55-129 — PostHelper wraps
its transport in a TraceRoundTripper whose httptrace hooks emit a CHAIN
of consecutive child spans, each covering one phase of the connection:

    http.resolvingDNS      DNS start            -> connect start
    http.connecting        connect start        -> connection obtained
    http.gotConnection.*   connection obtained  -> headers written
    http.finishedHeaders   headers written      -> body written
    http.finishedWrite     body written         -> first response byte
    http.gotFirstByte      first response byte  -> request done

`gotConnection.{new,reused}` also carries a `was_idle` tag and a
`<action>.connections_used_total` count sample (http.go:73-81). Python's
urllib exposes no httptrace equivalent, so this module drives the
request through raw socket + http.client and marks the phases itself;
with no connection pool every connection is `new`. The roundtrip parent
span is tagged `action` like the reference (http.go:130 RoundTrip).

Used by the HTTP forward client (forward/rpc.py); sink POSTs keep plain
urllib — their flushes are already individually span-wrapped by the
server's sink fan-out (server.py _flush_sink), which covers the same
observability need the reference meets via PostHelper's action spans.
"""

from __future__ import annotations

import http.client
import socket
import ssl
from typing import Dict, Optional, Tuple
from urllib.parse import urlparse

from veneur_tpu_torch.reliability.faults import FAULTS, HTTP_POST
from veneur_tpu_torch.samplers import ssf_samples


class _SpanChain:
    """The rolling span of http.go:61 startSpan: starting a phase
    finishes the previous one, so the chain tiles the request timeline
    with no gaps."""

    def __init__(self, parent, client):
        self.parent = parent
        self.client = client
        self.cur = None

    def start(self, name: str):
        if self.cur is not None:
            self.cur.client_finish(self.client)
            self.cur = None
        if self.parent is not None:
            self.cur = self.parent.child(name)
        return self.cur

    def finish(self):
        if self.cur is not None:
            self.cur.client_finish(self.client)
            self.cur = None


def traced_post(url: str, body: bytes, headers: Dict[str, str],
                timeout: float = 10.0, parent_span=None,
                trace_client=None, action: str = "forward",
                retry_policy=None) -> Tuple[int, bytes]:
    """POST `body` to `url`, emitting the reference's connection-event
    span chain as children of a roundtrip span under `parent_span`
    (no-ops when parent_span/trace_client are None). Returns
    (status, response body); raises on connection errors and on any
    non-2xx status — redirects are never followed (a followed 301
    would silently drop the forward body).

    `retry_policy` (reliability.policy.RetryPolicy) reruns the whole
    attempt — DNS, connect, send, status check — with its backoff; each
    attempt emits its own span chain, so retried forwards are visible as
    repeated http.post spans rather than one long mystery gap."""
    if retry_policy is None:
        return _traced_post_once(url, body, headers, timeout, parent_span,
                                 trace_client, action)
    return retry_policy.run(
        lambda: _traced_post_once(url, body, headers, timeout, parent_span,
                                  trace_client, action))


def _traced_post_once(url: str, body: bytes, headers: Dict[str, str],
                      timeout: float, parent_span, trace_client,
                      action: str) -> Tuple[int, bytes]:
    # inside the retry loop so an armed `times=N` fault exhausts after N
    # attempts — the recover-after-retries chaos scenario
    FAULTS.inject(HTTP_POST, name=url)
    u = urlparse(url)
    host = u.hostname or ""
    tls = u.scheme == "https"
    port = u.port or (443 if tls else 80)
    path = u.path or "/"
    if u.query:
        path += "?" + u.query

    rt = parent_span.child("http.post") if parent_span is not None else None
    if rt is not None:
        rt.set_tag("action", action)
        # README §Monitoring: veneur.<action>.content_length_bytes — the
        # POST body size PostHelper reports (http/http.go:202, a count
        # sample carrying the byte length)
        rt.add(ssf_samples.count(
            "veneur." + action + ".content_length_bytes", len(body)))

    import urllib.request
    proxies = urllib.request.getproxies()
    if u.scheme in proxies and not urllib.request.proxy_bypass(host):
        # an egress proxy owns the connection lifecycle — the event
        # chain would describe the proxy hop, not the destination.
        # Route through urllib (which applies the proxy) under the
        # roundtrip span alone.
        try:
            req = urllib.request.Request(url, data=body, method="POST",
                                         headers=headers)
            # refuse redirects: urllib's default handler would reissue
            # a 301 as a bodyless GET and report success — the same
            # silent forward drop the direct path's non-2xx guard
            # prevents. Returning None makes 3xx raise HTTPError.
            class _NoRedirect(urllib.request.HTTPRedirectHandler):
                def redirect_request(self, *a, **k):
                    return None

            opener = urllib.request.build_opener(
                urllib.request.ProxyHandler(proxies), _NoRedirect())
            # non-2xx (3xx included, via _NoRedirect) raises HTTPError
            # from opener.open — no status check needed here
            with opener.open(req, timeout=timeout) as resp:
                return resp.status, resp.read()
        except Exception:
            if rt is not None:
                rt.error = True
            raise
        finally:
            if rt is not None:
                rt.client_finish(trace_client)

    chain = _SpanChain(rt, trace_client)
    sock = None
    conn: Optional[http.client.HTTPConnection] = None
    try:
        chain.start("http.resolvingDNS")
        infos = socket.getaddrinfo(host, port, type=socket.SOCK_STREAM)

        chain.start("http.connecting")
        err = None
        for af, stype, proto, _cn, sa in infos:
            # urllib/create_connection semantics: try each resolved
            # address (a dual-stack host with no v6 route must still
            # reach the v4 address)
            try:
                sock = socket.socket(af, stype, proto)
                sock.settimeout(timeout)
                sock.connect(sa)
                err = None
                break
            except OSError as e:
                err = e
                if sock is not None:
                    sock.close()
                    sock = None
        if err is not None:
            raise err
        if tls:
            ctx = ssl.create_default_context()
            sock = ctx.wrap_socket(sock, server_hostname=host)

        sp = chain.start("http.gotConnection.new")
        if sp is not None:
            sp.set_tag("was_idle", "false")
            sp.add(ssf_samples.count(
                "veneur." + action + ".connections_used_total", 1,
                {"state": "new"}))

        # HTTPSConnection for its default_port=443, so the Host header
        # omits the port exactly as a stock client would (strict virtual
        # hosts reject 'Host: example.com:443')
        conn_cls = (http.client.HTTPSConnection if tls
                    else http.client.HTTPConnection)
        conn = conn_cls(host, port, timeout=timeout)
        conn.sock = sock
        sock = None   # conn owns it now
        conn.putrequest("POST", path, skip_host=False,
                        skip_accept_encoding=True)
        for k, v in headers.items():
            conn.putheader(k, v)
        conn.putheader("Content-Length", str(len(body)))
        conn.endheaders()

        chain.start("http.finishedHeaders")
        conn.send(body)

        chain.start("http.finishedWrite")
        resp = conn.getresponse()

        chain.start("http.gotFirstByte")
        data = resp.read()
        if resp.status >= 300:
            # redirects are NOT followed — a 301 that urllib would chase
            # must surface as an error, never as a silently-dropped
            # forward (the reference's PostHelper accepts 2xx only)
            raise RuntimeError(
                f"POST {url} -> {resp.status}: {data[:200]!r}")
        return resp.status, data
    except Exception:
        if rt is not None:
            rt.error = True
        raise
    finally:
        chain.finish()
        if conn is not None:
            conn.close()
        if sock is not None:
            sock.close()
        if rt is not None:
            rt.client_finish(trace_client)
