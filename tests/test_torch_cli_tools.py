"""The port's operator CLIs (ROADMAP A13): veneur-emit,
veneur-prometheus and the telemetry dump, against the JAX package's on
the CPU, and against the port Server's own GET /metrics.

- emit: the packet builders byte-equal on seeded inputs; `main` sends
  the same bytes over UDP, TCP, unix and unixgram sockets (metrics,
  events, service checks, -replay, -command, SSF spans) and refuses the
  same flag mixes.
- prometheus: `parse_exposition`, `Translator` (the counter delta
  cache, prefix and ignore filters), the mTLS and unix-socket fetchers,
  `scrape_once` and `main -once` equal to the JAX ones.
- telemetry: `dump_once` text and JSON, with its ring, watch, tenant and
  key-table tables, equal to the JAX dump on the same exposition.
"""

import http.server
import importlib
import io
import json
import os
import socket
import socketserver
import ssl
import subprocess
import sys
import threading

import numpy as np
import pytest

from tests.test_torch_server import SMALL, _wait

ROOTS = ("veneur_tpu", "veneur_tpu_torch")


def _mod(root, name):
    return importlib.import_module(f"{root}.{name}")


# -- veneur-emit -------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_packet_builders_are_byte_equal(seed):
    rng = np.random.default_rng(seed)
    for _ in range(40):
        name = f"svc.m{int(rng.integers(100))}"
        tags = [f"k{i}:v{int(rng.integers(9))}"
                for i in range(int(rng.integers(0, 4)))]
        mtype = ("c", "g", "ms", "s", "h")[int(rng.integers(5))]
        value = f"{rng.normal() * 100:.3f}"
        rate = (1.0, 0.5, 0.125)[int(rng.integers(3))]
        fields = {k: (f"f{int(rng.integers(5))}" if rng.random() < 0.5
                      else "") for k in "dhkpst"}
        title = "deploy é" * int(rng.integers(1, 3))
        status = int(rng.integers(4))
        got = []
        for root in ROOTS:
            emit = _mod(root, "cli.emit")
            got.append((
                emit.build_metric_packet(name, value, mtype, rate, tags),
                emit.build_event_packet(title, "text\\nx", tags, **fields),
                emit.build_service_check_packet(
                    name, status, tags,
                    message="m: x", timestamp=fields["d"],
                    hostname=fields["h"])))
        assert got[0] == got[1]


class _Receiver:
    """A local socket of one transport kind that keeps what it gets."""

    def __init__(self, kind, tmp_path):
        self.kind = kind
        self.got = []
        fam = socket.AF_INET if kind in ("udp", "tcp") else socket.AF_UNIX
        typ = (socket.SOCK_DGRAM if kind in ("udp", "unixgram")
               else socket.SOCK_STREAM)
        self.sock = socket.socket(fam, typ)
        if fam == socket.AF_INET:
            self.sock.bind(("127.0.0.1", 0))
            self.hostport = f"{kind}://127.0.0.1:{self.sock.getsockname()[1]}"
        else:
            path = str(tmp_path / f"{kind}-{len(os.listdir(tmp_path))}.sock")
            self.sock.bind(path)
            self.hostport = f"{kind}://{path}"
        self.sock.settimeout(10)
        if typ == socket.SOCK_STREAM:
            self.sock.listen(4)
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _run(self):
        try:
            if self.kind in ("udp", "unixgram"):
                while True:
                    self.got.append(self.sock.recv(65536))
            conn, _ = self.sock.accept()
            conn.settimeout(10)
            buf = b""
            while True:
                chunk = conn.recv(65536)
                if not chunk:
                    break
                buf += chunk
            conn.close()
            self.got.append(buf)
        except (socket.timeout, OSError):
            pass

    def wait(self, n):
        _wait(lambda: len(self.got) >= n, "datagrams", timeout=10)
        return self.got


def _emit_both(kind, args, tmp_path, n=1, expect_rc=0):
    out = []
    for root in ROOTS:
        recv = _Receiver(kind, tmp_path)
        rc = _mod(root, "cli.emit").main(["-hostport", recv.hostport]
                                         + args)
        assert rc == expect_rc
        out.append(recv.wait(n) if rc == 0 else [])
        recv.sock.close()
    return out


_METRIC_ARGS = ["-name", "a.b", "-count", "3", "-gauge", "2.5", "-timing",
                "12ms", "-set", "u1", "-tag", "env:prod,team:x",
                "-sample_rate", "0.5"]
_EVENT_ARGS = ["-e_title", "deploy", "-e_text", "v2 shipped",
               "-e_time", "1700000000", "-e_hostname", "web1",
               "-e_aggr_key", "deploys", "-e_priority", "low",
               "-e_source_type", "ci", "-e_alert_type", "info",
               "-e_event_tags", "env:prod", "-tag", "team:infra"]
_CHECK_ARGS = ["-sc_name", "db.up", "-sc_status", "1", "-sc_msg",
               "degraded", "-sc_time", "1700000000", "-sc_hostname", "db1",
               "-sc_tags", "shard:3"]


@pytest.mark.parametrize("kind", ["udp", "tcp", "unix", "unixgram"])
@pytest.mark.parametrize("what", ["metrics", "event", "check", "legacy"])
def test_emit_sends_the_same_bytes(tmp_path, kind, what):
    args = {"metrics": _METRIC_ARGS, "event": _EVENT_ARGS,
            "check": _CHECK_ARGS,
            "legacy": ["-event_title", "t", "-event_text", "x",
                       "-mode", "event"]}[what]
    n = 4 if what == "metrics" and kind in ("udp", "unixgram") else 1
    j, t = _emit_both(kind, args, tmp_path, n=n)
    assert j == t
    body = b"".join(t)
    if what == "metrics":
        assert b"a.b:3.0|c|@0.5|#env:prod,team:x" in body
        assert b"a.b:12.000|ms|@0.5|#env:prod,team:x" in body
    # the port's own parser takes what its emit sends
    from veneur_tpu_torch.samplers import parser
    for pkt in body.split(b"\n") if kind in ("tcp", "unix") else t:
        if not pkt:
            continue
        if pkt.startswith(b"_e"):
            ev = parser.parse_event(pkt)
            assert ev.name in ("deploy", "t")
        elif pkt.startswith(b"_sc"):
            m = parser.parse_service_check(pkt)
            assert (m.name, m.value, m.message) == ("db.up", 1.0,
                                                    "degraded")
        else:
            assert parser.parse_metric(pkt).name == "a.b"


def test_emit_replay_sends_the_same_stream(tmp_path, capsys):
    j, t = _emit_both("tcp", ["-replay", "500", "-replay_names", "40"],
                      tmp_path)
    assert j == t
    lines = t[0].split(b"\n")
    assert lines[-1] == b"" and len(lines) == 501
    assert all(x.startswith(b"replay.counter.") and x.endswith(b":1|c")
               for x in lines[:-1])
    assert capsys.readouterr().out.count("sent 500 packets") == 2


def test_emit_command_times_the_child(tmp_path):
    j, t = _emit_both("udp", ["-name", "job", "-tag", "a:b", "-command",
                              sys.executable, "-c", "raise SystemExit(3)"],
                      tmp_path)
    shape = [[p.split(b":", 1)[0], p.split(b"|", 1)[1]] for p in j + t]
    assert shape[0] == shape[1] == [b"job", b"ms|#a:b,exit_status:3"]


def _ssf(root, raw, kind):
    wire = _mod(root, "protocol.wire")
    return (wire.read_ssf(io.BytesIO(raw)) if kind == "tcp"
            else wire.parse_ssf(raw))


@pytest.mark.parametrize("kind", ["udp", "tcp"])
def test_emit_ssf_spans_match(tmp_path, kind):
    args = ["-ssf", "-trace_id", "42", "-parent_span_id", "7",
            "-span_service", "svc-x", "-name", "op", "-error",
            "-span_starttime", "1700000000", "-span_endtime", "1700000001",
            "-count", "1", "-gauge", "2", "-timing", "5ms", "-set", "u",
            "-tag", "a:b,c"]
    j, t = _emit_both(kind, args, tmp_path)
    spans = [_ssf(r, raw[0], kind) for r, raw in zip(ROOTS, (j, t))]
    for sp in spans:
        assert sp.id != 0
        sp.id = 0               # a fresh random id in each
        for m in sp.metrics:
            m.timestamp = 0     # stamped at the send
    assert spans[0].SerializeToString(deterministic=True) == \
        spans[1].SerializeToString(deterministic=True)
    sp = spans[1]
    assert (sp.trace_id, sp.parent_id, sp.service, sp.error) == (
        42, 7, "svc-x", True)
    assert sp.end_timestamp - sp.start_timestamp == int(1e9)
    assert [m.name for m in sp.metrics] == ["op"] * 4


@pytest.mark.parametrize("env,flag,rc,want", [
    ({"VENEUR_EMIT_TRACE_ID": "77", "VENEUR_EMIT_PARENT_SPAN_ID": "55"},
     [], 0, (77, 55)),
    ({"VENEUR_EMIT_TRACE_ID": "99"}, ["-trace_id", "11"], 0, (11, 0)),
    ({"VENEUR_EMIT_TRACE_ID": "farts"}, ["-trace_id", "11"], 0, (11, 0)),
    ({"VENEUR_EMIT_TRACE_ID": "farts"}, [], 2, None),
    ({"VENEUR_EMIT_TRACE_ID": "1_0"}, [], 2, None)])
def test_emit_infers_trace_identity_from_the_env(tmp_path, monkeypatch, env,
                                                 flag, rc, want):
    for k in ("VENEUR_EMIT_TRACE_ID", "VENEUR_EMIT_PARENT_SPAN_ID"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    j, t = _emit_both("udp", ["-ssf", "-name", "env.span", "-gauge", "1"]
                      + flag, tmp_path, expect_rc=rc)
    if want is not None:
        got = [(s.trace_id, s.parent_id) for s in
               (_ssf(r, raw[0], "udp") for r, raw in zip(ROOTS, (j, t)))]
        assert got == [want, want]


@pytest.mark.parametrize("args", [
    ["-ssf", "-replay", "5"], ["-mode", "sc"], ["-e_title", "only"],
    ["-name", "x", "-timing", "soon"]])
def test_emit_refuses_the_same_flag_mixes(tmp_path, args, capsys):
    _emit_both("udp", args, tmp_path, expect_rc=2)
    err = capsys.readouterr().err.splitlines()
    assert len(err) == 2 and err[0] == err[1]


# -- veneur-prometheus -------------------------------------------------------

EXPO = """# HELP req_total requests
# TYPE req_total counter
req_total{az="a",secret_label="x"} 7
req_total{az="b",path="/q\\"x"} 12 1700000000000
# TYPE temp gauge
temp 3.5
# TYPE noisy_debug gauge
noisy_debug 1
# TYPE lat histogram
lat_bucket{le="0.1"} 40
lat_bucket{le="+Inf"} 50
lat_sum 12.5
lat_count 50
# TYPE rpc summary
rpc{quantile="0.5"} 0.2
rpc{quantile="0.99"} NaN
rpc_sum 31
rpc_count 90
bare_untyped 4e3
not a sample line
"""


def _bump(text):
    return (text.replace("} 7\n", "} 10\n").replace("} 40\n", "} 44\n")
            .replace("lat_count 50", "lat_count 54")
            .replace("rpc_count 90", "rpc_count 95")
            .replace("temp 3.5", "temp 4.25"))


@pytest.mark.parametrize("opts", [
    dict(), dict(added_tags=["svc:web"]),
    dict(prefix="svc.", ignored_labels=["^secret_"],
         ignored_metrics=["^noisy_"])], ids=["plain", "tags", "filters"])
def test_parse_and_translate_match_jax(opts):
    got = []
    for root in ROOTS:
        prom = _mod(root, "cli.prometheus")
        tr = prom.Translator(**opts)
        polls = [prom.parse_exposition(EXPO),
                 prom.parse_exposition(_bump(EXPO))]
        got.append((polls, [tr.translate(*p) for p in polls]))
    assert repr(got[0]) == repr(got[1])     # repr: NaN equals itself
    (_types, samples), _ = got[1][0]
    assert ("temp", {}, 3.5) in samples
    first, second = got[1][1]
    pre = opts.get("prefix", "")
    assert not any(p.startswith(f"{pre}req_total".encode()) for p in first)
    assert f"{pre}req_total:3|c".encode() in b"\n".join(second)
    assert any(p.startswith(f"{pre}lat_bucket:4|c".encode())
               for p in second)


class _Expo(http.server.BaseHTTPRequestHandler):
    bodies = [EXPO]

    def do_GET(self):
        body = type(self).bodies[0].encode()
        if len(type(self).bodies) > 1:
            type(self).bodies = type(self).bodies[1:]
        self.send_response(200)
        self.send_header("Content-Type", "text/plain")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a):
        pass


@pytest.fixture(scope="module")
def certs(tmp_path_factory):
    d = tmp_path_factory.mktemp("promtls")

    def run(*args):
        subprocess.run(args, check=True, capture_output=True, cwd=d)

    run("openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
        "-keyout", "ca.key", "-out", "ca.crt", "-days", "1",
        "-subj", "/CN=test-ca")
    for name in ("server", "client"):
        run("openssl", "req", "-newkey", "rsa:2048", "-nodes",
            "-keyout", f"{name}.key", "-out", f"{name}.csr",
            "-subj", f"/CN={name}", "-addext",
            "subjectAltName=IP:127.0.0.1")
        run("openssl", "x509", "-req", "-in", f"{name}.csr",
            "-CA", "ca.crt", "-CAkey", "ca.key", "-CAcreateserial",
            "-out", f"{name}.crt", "-days", "1",
            "-copy_extensions", "copyall")
    return d


def test_mtls_fetchers_match_jax(certs):
    httpd = http.server.HTTPServer(("127.0.0.1", 0), _Expo)
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(certs / "server.crt", certs / "server.key")
    ctx.load_verify_locations(certs / "ca.crt")
    ctx.verify_mode = ssl.CERT_REQUIRED
    httpd.socket = ctx.wrap_socket(httpd.socket, server_side=True)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        url = f"https://127.0.0.1:{httpd.server_address[1]}/metrics"
        got = []
        for root in ROOTS:
            prom = _mod(root, "cli.prometheus")
            fetch = prom.make_fetcher(url, cert=str(certs / "client.crt"),
                                      key=str(certs / "client.key"),
                                      cacert=str(certs / "ca.crt"))
            got.append(fetch())
            # without a client certificate the handshake fails
            with pytest.raises(Exception):
                prom.make_fetcher(url, cacert=str(certs / "ca.crt"))()
        assert got[0] == got[1] == EXPO
    finally:
        httpd.shutdown()


def test_unix_socket_fetchers_match_jax(tmp_path):
    sock_path = str(tmp_path / "prom.sock")

    class _UnixHTTPServer(socketserver.UnixStreamServer):
        def get_request(self):
            req, _ = super().get_request()
            return req, ("127.0.0.1", 0)

    httpd = _UnixHTTPServer(sock_path, _Expo)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        got = [_mod(r, "cli.prometheus").make_fetcher(
            "http://prom.internal/metrics", socket_path=sock_path)()
            for r in ROOTS]
        assert got[0] == got[1] == EXPO
    finally:
        httpd.shutdown()


def test_prometheus_main_once_sends_the_same_packets():
    got = []
    for root in ROOTS:
        handler = type("E", (_Expo,), {"bodies": [EXPO, _bump(EXPO)]})
        httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        recv = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        recv.bind(("127.0.0.1", 0))
        recv.settimeout(0.5)
        try:
            rc = _mod(root, "cli.prometheus").main([
                "-p", f"http://127.0.0.1:{httpd.server_address[1]}/m",
                "-h2", f"127.0.0.1:{recv.getsockname()[1]}", "-i", "10ms",
                "-a", "src:prom", "-once"])
            assert rc == 0
            pkts = []
            try:
                while True:
                    pkts.append(recv.recv(65536))
            except socket.timeout:
                pass
            got.append(pkts)
        finally:
            recv.close()
            httpd.shutdown()
    assert got[0] == got[1]
    assert b"req_total:3|c|#az:a,secret_label:x,src:prom" in got[1]


# -- the telemetry dump ------------------------------------------------------

TELEMETRY = EXPO + """# TYPE veneur_ring_per_ring_packets gauge
veneur_ring_per_ring_packets{ring="0"} 10
veneur_ring_per_ring_packets{ring="10"} 3
veneur_ring_per_ring_drops{ring="0"} 0
# TYPE veneur_watch_fired_total counter
veneur_watch_fired_total{kind="threshold"} 2
veneur_watch_suppressed_total{kind="threshold"} 1
veneur_watch_fired_total{kind="absence"} 0
# TYPE veneur_tenant_admitted_total counter
veneur_tenant_admitted_total{tenant="acme"} 100
veneur_tenant_shed_total{tenant="acme"} 4
veneur_tenant_quarantined{tenant="zed"} 1
# TYPE veneur_table_capacity gauge
veneur_table_capacity{kind="counter"} 512
veneur_table_grows_total{kind="counter"} 1
veneur_table_capacity{kind="set"} 16
"""


@pytest.mark.parametrize("as_json", [False, True], ids=["text", "json"])
@pytest.mark.parametrize("text", [TELEMETRY, ""], ids=["full", "empty"])
def test_dump_once_matches_jax(as_json, text):
    got = []
    for root in ROOTS:
        out = io.StringIO()
        rc = _mod(root, "cli.telemetry").dump_once(lambda: text, as_json,
                                                   out=out)
        got.append((rc, out.getvalue()))
    assert got[0] == got[1]
    rc, dump = got[1]
    assert rc == 0
    if as_json:
        rows = json.loads(dump)
        assert len(rows) == (0 if not text else len(
            _mod("veneur_tpu_torch", "cli.prometheus")
            .parse_exposition(text)[1]))
    elif text:
        for table in ("native ingest rings:", "standing watches:",
                      "tenants:", "key tables:"):
            assert table in dump
    else:
        assert "empty exposition" in dump


def test_dump_once_reports_a_failed_fetch(capsys):
    def fail():
        raise OSError("connection refused")
    for root in ROOTS:
        assert _mod(root, "cli.telemetry").dump_once(fail, False) == 1
    err = capsys.readouterr().err.splitlines()
    assert err == ["scrape failed: connection refused"] * 2


# -- against the port Server's own GET /metrics -------------------------------

def test_the_clis_read_the_port_servers_metrics(tmp_path):
    """The port's prometheus CLI scrapes the port Server twice and sends
    the deltas back into it; the telemetry dump lists the per-sink flush
    durations; the JAX parser reads the same exposition alike."""
    from veneur_tpu_torch import config as tconfig
    from veneur_tpu_torch.cli import prometheus as tprom
    from veneur_tpu_torch.cli import telemetry as ttele
    from veneur_tpu_torch.server.factory import new_from_config
    from veneur_tpu.cli import prometheus as jprom
    from veneur_tpu.cli import telemetry as jtele

    flush_file = tmp_path / "flush.tsv"
    srv = new_from_config(tconfig.Config(**dict(
        SMALL, interval="3600s", debug_flushed_metrics=True,
        flush_file=str(flush_file))), device="cpu")
    srv.start()
    try:
        host, port = srv.local_addr()
        tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        tx.sendto(b"cli.hits:5|c\ncli.lat:3|ms", (host, port))
        _wait(lambda: srv.aggregator.processed >= 2, "lines")
        assert srv.trigger_flush(timeout=60)
        url = f"http://127.0.0.1:{srv.http_port}/metrics"
        texts = []
        fetch = tprom.make_fetcher(url)

        def recorded():
            texts.append(fetch())
            return texts[-1]
        tr = tprom.Translator(added_tags=["via:prom"])
        assert tprom.scrape_once(recorded, tr) == [
            p for p in tprom.Translator(added_tags=["via:prom"]).translate(
                *tprom.parse_exposition(texts[0]))]
        tx.sendto(b"cli.hits:1|c", (host, port))
        _wait(lambda: srv.aggregator.processed >= 3, "lines")
        second = tprom.scrape_once(recorded, tr)
        assert jprom.parse_exposition(texts[1]) == \
            tprom.parse_exposition(texts[1])
        # the second poll's counter deltas: the lines and the flush
        # between the polls moved the Server's own counters
        assert any(b"|c|#" in p for p in second)
        # counted from here: the first flush's self-metrics re-entered
        # the pipeline and moved `processed` past the three lines above
        base = srv.aggregator.processed
        for p in second:
            tx.sendto(p, (host, port))
        sink = srv.metric_sinks[0]
        sink.flushed.clear()
        _wait(lambda: srv.aggregator.processed >= base + len(second),
              "translated lines")
        assert srv.trigger_flush(timeout=60)
        flushed = {(m.name, tuple(m.tags)): m.value for m in sink.flushed}
        for p in second:
            name, rest = p.decode().split(":", 1)
            value, mtype = rest.split("|")[:2]
            tags = tuple(rest.split("|#", 1)[1].split(",")) if "|#" in rest \
                else ()
            if mtype == "c":
                assert flushed[(name, tags)] == float(value)
        outs = []
        for tele in (jtele, ttele):
            out = io.StringIO()
            assert tele.dump_once(lambda: texts[1], False, out=out) == 0
            outs.append(out.getvalue())
        assert outs[0] == outs[1]
        assert 'veneur_sink_flush_duration_ns' in outs[1] or \
            "veneur.sink.flush_duration_ns" in outs[1]
    finally:
        srv.shutdown()
