"""Every listener of the port's Server, on the CPU (`device="cpu"`), as
tests/test_listeners.py and test_tls_crash.py hold the JAX Server's:

- statsd over UDP (the C++ readers and the Python readers), a UDP reader
  group on one SO_REUSEPORT port, TCP, TLS with client-certificate
  auth, unixgram (a path, world-writable, and the abstract namespace)
  and unix stream; each line's counter flushes exactly;
- a datagram over metric_max_length is dropped whole and counted on both
  UDP routes;
- SSF spans over unixgram and framed unix stream reach the span sinks,
  and an SSF span's samples over UDP become metrics;
- a unix socket's lock file keeps a second server off its path, and
  shutdown releases it.

Nothing here imports JAX, so the file also runs on a machine with a card
(`python -m pytest --noconftest tests/test_torch_listeners.py`), which
checks the socket options and socket kinds its kernel allows.
"""

import io
import os
import shutil
import socket
import ssl
import subprocess
import time

import pytest

from veneur_tpu_torch.config import Config
from veneur_tpu_torch.proto import ssf_pb2
from veneur_tpu_torch.protocol.wire import write_ssf
from veneur_tpu_torch.server.server import Server
from veneur_tpu_torch.sinks.debug import DebugMetricSink, DebugSpanSink

SMALL = dict(
    interval="3600s", hostname="testbox", metric_max_length=4096,
    read_buffer_size_bytes=2097152, percentiles=[0.5],
    aggregates=["count"], statsd_listen_addresses=[],
    tpu_counter_capacity=64, tpu_gauge_capacity=16, tpu_status_capacity=16,
    tpu_set_capacity=16, tpu_histo_capacity=16, tpu_batch_counter=128,
    tpu_batch_gauge=64, tpu_batch_status=16, tpu_batch_set=64,
    tpu_batch_histo=128)


def _server(span_sinks=(), **kw):
    sink = DebugMetricSink()
    srv = Server(Config(**dict(SMALL, **kw)), metric_sinks=[sink],
                 span_sinks=list(span_sinks), device="cpu")
    srv.start()
    return srv, sink


def _wait(cond, what, timeout=30.0):
    t0 = time.time()
    while not cond():
        assert time.time() - t0 < timeout, f"{what} after {timeout} s"
        time.sleep(0.02)


def _flushed_counters(srv, sink, n):
    """Wait until `n` lines are processed, flush, and return the app
    counters by name."""
    _wait(lambda: srv.aggregator.processed >= n, f"{n} lines processed")
    assert srv.trigger_flush(timeout=60)
    return {m.name: m.value for m in sink.flushed
            if m.type == "counter" and not m.name.startswith("veneur.")}


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_statsd_udp(native):
    srv, sink = _server(statsd_listen_addresses=["udp://127.0.0.1:0"],
                        native_ingest=native)
    try:
        assert srv._native_readers_active == native
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.sendto(b"u.count:3|c\nu.count:4|c", srv.local_addr())
        s.close()
        assert _flushed_counters(srv, sink, 2) == {"u.count": 7.0}
        assert srv.packets_received == 1
    finally:
        srv.shutdown()


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_udp_reader_group_shares_one_reuseport_port(native):
    srv, sink = _server(statsd_listen_addresses=["udp://127.0.0.1:0"],
                        num_readers=4, native_ingest=native)
    try:
        udp = [s for s in srv._sockets if s.type == socket.SOCK_DGRAM]
        assert len(udp) == 4
        assert len({s.getsockname() for s in udp}) == 1
        tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        for i in range(40):
            tx.sendto(b"g.count:1|c", srv.local_addr())
        tx.close()
        assert _flushed_counters(srv, sink, 40) == {"g.count": 40.0}
        assert srv.packets_received == 40
    finally:
        srv.shutdown()


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_udp_toolong_datagram_dropped_and_counted(native):
    srv, sink = _server(statsd_listen_addresses=["udp://127.0.0.1:0"],
                        metric_max_length=31, native_ingest=native)
    try:
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        over = b"foo.baz:1|c|#aa:" + b"b" * 16      # limit + 1 bytes
        at = b"at.limit:1|c|#aaaaaa:" + b"b" * 10   # exactly the limit
        assert (len(over), len(at)) == (32, 31)
        for d in (over, at, b"ok:1|c"):
            s.sendto(d, srv.local_addr())
        s.close()
        _wait(lambda: srv.packets_toolong >= 1, "the toolong drop")
        _wait(lambda: srv.aggregator.processed >= 2, "2 lines processed")
        time.sleep(0.2)     # the long datagram must not land late either
        # read before the flush, whose self-metrics re-enter the pipeline
        assert srv.packets_toolong == 1 and srv.aggregator.processed == 2
        assert _flushed_counters(srv, sink, 2) == {"at.limit": 1.0,
                                                   "ok": 1.0}
    finally:
        srv.shutdown()


def test_statsd_tcp():
    srv, sink = _server(statsd_listen_addresses=["tcp://127.0.0.1:0"])
    try:
        c = socket.create_connection(srv.local_addr(), timeout=5)
        c.sendall(b"t.count:5|c\nt.count:2|c\n")
        c.close()
        assert _flushed_counters(srv, sink, 2) == {"t.count": 7.0}
    finally:
        srv.shutdown()


@pytest.fixture(scope="module")
def certs(tmp_path_factory):
    """A CA, a server and a client certificate signed by it, and a rogue
    self-signed client certificate, made with openssl."""
    if shutil.which("openssl") is None:
        pytest.skip("needs the openssl command to make certificates")
    d = tmp_path_factory.mktemp("tls")

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
        run("openssl", "x509", "-req", "-in", f"{name}.csr", "-CA",
            "ca.crt", "-CAkey", "ca.key", "-CAcreateserial", "-out",
            f"{name}.crt", "-days", "1", "-copy_extensions", "copyall")
    run("openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
        "-keyout", "rogue.key", "-out", "rogue.crt", "-days", "1",
        "-subj", "/CN=rogue")
    return d


def _tls_connect(addr, certs, cert=None):
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    ctx.check_hostname = False
    ctx.verify_mode = ssl.CERT_NONE
    if cert:
        ctx.load_cert_chain(str(certs / f"{cert}.crt"),
                            str(certs / f"{cert}.key"))
    return ctx.wrap_socket(socket.create_connection(addr, timeout=5))


def test_statsd_tls_requires_the_ca_signed_client_cert(certs):
    srv, sink = _server(
        statsd_listen_addresses=["tcp://127.0.0.1:0"],
        tls_key=(certs / "server.key").read_text(),
        tls_certificate=(certs / "server.crt").read_text(),
        tls_authority_certificate=(certs / "ca.crt").read_text())
    try:
        assert srv.cfg.tls_key == "REDACTED"
        for cert in (None, "rogue"):
            with pytest.raises((ssl.SSLError, OSError)):
                s = _tls_connect(srv.local_addr(), certs, cert)
                s.sendall(b"tls.bad:1|c\n")
                s.recv(1)       # the server's alert surfaces here
        s = _tls_connect(srv.local_addr(), certs, "client")
        s.sendall(b"tls.count:8|c\n")
        s.close()
        assert _flushed_counters(srv, sink, 1) == {"tls.count": 8.0}
    finally:
        srv.shutdown()


def test_statsd_unixgram_path_and_abstract(tmp_path):
    path = str(tmp_path / "statsd.sock")
    name = f"@veneur-torch-test-{os.getpid()}"
    srv, sink = _server(statsd_listen_addresses=[f"unixgram://{path}",
                                                 f"unixgram://{name}"])
    try:
        assert os.stat(path).st_mode & 0o777 == 0o666
        s = socket.socket(socket.AF_UNIX, socket.SOCK_DGRAM)
        s.sendto(b"ug.count:4|c", path)
        s.sendto(b"ab.count:2|c", "\0" + name[1:])
        s.close()
        assert _flushed_counters(srv, sink, 2) == {"ug.count": 4.0,
                                                   "ab.count": 2.0}
    finally:
        srv.shutdown()
    assert not os.path.exists(path)


def test_statsd_unix_stream(tmp_path):
    path = str(tmp_path / "stream.sock")
    srv, sink = _server(statsd_listen_addresses=[f"unix://{path}"])
    try:
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.connect(path)
        s.sendall(b"us.count:6|c\nus.count:1|c\n")
        s.close()
        assert _flushed_counters(srv, sink, 2) == {"us.count": 7.0}
    finally:
        srv.shutdown()


def test_unix_socket_lock_is_exclusive_until_shutdown(tmp_path):
    path = str(tmp_path / "locked.sock")
    srv, _sink = _server(statsd_listen_addresses=[f"unixgram://{path}"])
    try:
        with pytest.raises(RuntimeError, match="held by another process"):
            _server(statsd_listen_addresses=[f"unixgram://{path}"])
    finally:
        srv.shutdown()
    srv2, sink2 = _server(statsd_listen_addresses=[f"unixgram://{path}"])
    try:
        s = socket.socket(socket.AF_UNIX, socket.SOCK_DGRAM)
        s.sendto(b"relock.count:2|c", path)
        s.close()
        assert _flushed_counters(srv2, sink2, 1) == {"relock.count": 2.0}
    finally:
        srv2.shutdown()


def _span(i, pb=ssf_pb2):
    return pb.SSFSpan(version=0, trace_id=i, id=i + 1, service="svc",
                      name=f"op{i}", start_timestamp=1, end_timestamp=2)


def test_ssf_unixgram_and_framed_stream(tmp_path):
    gram = str(tmp_path / "ssf.gram")
    stream = str(tmp_path / "ssf.stream")
    spans = DebugSpanSink()
    srv, _sink = _server(span_sinks=[spans], ssf_listen_addresses=[
        f"unixgram://{gram}", f"unix://{stream}"])
    try:
        s = socket.socket(socket.AF_UNIX, socket.SOCK_DGRAM)
        s.sendto(_span(1).SerializeToString(), gram)
        s.close()
        buf = io.BytesIO()
        write_ssf(buf, _span(2))
        write_ssf(buf, _span(3))
        c = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        c.connect(stream)
        c.sendall(buf.getvalue())
        c.close()
        _wait(lambda: {x.name for x in spans.spans} >= {"op1", "op2",
                                                         "op3"},
              "the three spans")
    finally:
        srv.shutdown()


def test_ssf_udp_span_samples_become_metrics():
    srv, sink = _server(ssf_listen_addresses=["udp://127.0.0.1:0"])
    try:
        S = ssf_pb2.SSFSample
        span = ssf_pb2.SSFSpan(trace_id=0, id=5, name="carrier")
        span.metrics.extend([S(metric=S.COUNTER, name="ssf.count", value=9),
                             S(metric=S.COUNTER, name="ssf.count", value=1)])
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.sendto(span.SerializeToString(), srv.local_addr())
        s.close()
        assert _flushed_counters(srv, sink, 2) == {"ssf.count": 10.0}
    finally:
        srv.shutdown()
