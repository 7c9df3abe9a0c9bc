"""The port's proxy tier against the JAX package, on the CPU.

- (a) `HashRing.get` places every key on the destination the JAX ring
  picks, over 1-5 destinations and after a membership change, so a mixed
  fleet (a JAX proxy beside a port proxy) routes each key to one global;
- (b) `ProxyServer` routing, envelope passthrough, bad-envelope
  accounting and the stored grouping across a ring change mid-retry
  (tests/test_exactly_once.py, tests/test_forward.py), each proxy over
  the same fake connections, delivering the same batches;
- (c) the discoverers (static, Consul with the reference's recorded
  responses, Kubernetes, keep-last-good) and the proxy's HTTP /import
  surface answer as the JAX package's do;
- (d) `example_proxy.yaml` reads to the same ProxyConfig in both
  packages, and the proxy CLI serves and exits 0 on SIGTERM;
- (e) the slice's new modules import neither jax nor veneur_tpu.

Nothing here dials a network: every destination is a fake or a loopback
port.
"""

import io
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
import zlib

import numpy as np
import pytest

from veneur_tpu import config_proxy as jconfig_proxy
from veneur_tpu.forward import discovery as jdiscovery
from veneur_tpu.forward import envelope as jenvelope
from veneur_tpu.forward import proxysrv as jproxysrv
from veneur_tpu_torch import config_proxy as tconfig_proxy
from veneur_tpu_torch.forward import discovery as tdiscovery
from veneur_tpu_torch.forward import envelope as tenvelope
from veneur_tpu_torch.forward import proxysrv as tproxysrv
from veneur_tpu_torch.proto import metricpb_pb2 as mpb
from veneur_tpu_torch.reliability.faults import FAULTS, PROXY_FORWARD

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTDATA = os.path.join(REPO, "tests", "testdata")
SID = "0123456789abcdef0123456789abcdef"
PKGS = {"jax": (jproxysrv, jenvelope, jdiscovery),
        "torch": (tproxysrv, tenvelope, tdiscovery)}


@pytest.fixture(autouse=True)
def _clean_faults():
    FAULTS.reset()
    yield
    FAULTS.reset()


# -- (a) ring placement ---------------------------------------------------------

def _dests(n):
    return [f"10.0.{i}.{7 * i + 1}:8128" for i in range(n)]


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
def test_hash_ring_places_every_key_as_jax(n):
    rng = np.random.default_rng(n)
    keys = [f"app.m{int(rng.integers(0, 10**9))}counter"
            f"{'' if i % 3 else 'env:prod'}".encode()
            for i in range(10_000)]
    for dests in (_dests(n), _dests(n + 1)[1:]):   # then a membership change
        t, j = tproxysrv.HashRing(dests), jproxysrv.HashRing(dests)
        assert t.destinations == j.destinations
        assert [t.get(k) for k in keys] == [j.get(k) for k in keys]
    assert tproxysrv.HashRing([]).get(b"k") is None


# -- (b) routing over fake connections ---------------------------------------------

class _Disc:
    def __init__(self, dests):
        self.dests = list(dests)
        self.stale = 0

    def get_destinations_for_service(self, service):
        return list(self.dests)


class _FakeConn:
    def __init__(self, dest, delivered):
        self.dest = dest
        self.fail = False
        self.delivered = delivered

    def send_metrics(self, batch, envelope=None, **kw):
        if self.fail:
            raise OSError("injected destination failure")
        self.delivered.setdefault(self.dest, []).extend(
            (m.name, None if envelope is None else (envelope.epoch,
                                                     envelope.seq))
            for m in batch)

    def close(self):
        pass


def _proxy(pkg, dests, **kw):
    """(proxy, delivered, conns) with every destination a fake."""
    proxysrv = PKGS[pkg][0]
    disc = _Disc(dests)
    p = proxysrv.ProxyServer(disc, **kw)
    delivered, conns = {}, {}
    p._conn = lambda dest: conns.setdefault(dest, _FakeConn(dest,
                                                            delivered))
    return p, disc, delivered, conns


def _metrics(n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        m = mpb.Metric(name=f"r.m{int(rng.integers(0, 10**6))}",
                       type=[mpb.Counter, mpb.Gauge, mpb.Set,
                             mpb.Histogram][i % 4],
                       tags=[f"t:{i % 5}"] if i % 2 else [])
        out.append(m)
    return out


@pytest.mark.parametrize("enveloped", [False, True])
def test_proxy_routes_as_jax(enveloped):
    dests = _dests(3)
    got = {}
    for pkg in ("jax", "torch"):
        p, _disc, delivered, _ = _proxy(
            pkg, dests, dedup_window=16 if enveloped else 0)
        env = (PKGS[pkg][1].Envelope(SID, 4, 9) if enveloped else None)
        p.handle(_metrics(300), envelope=env)
        got[pkg] = (delivered, p.forwarded, p.errors,
                    dict(p.metrics_by_destination))
        p.stop()
    assert got["torch"] == got["jax"]
    delivered = got["torch"][0]
    assert len(delivered) == 3 and got["torch"][1] == 300
    # each destination receives the sender's (epoch, seq) unchanged
    for rows in delivered.values():
        assert all(e == ((4, 9) if enveloped else None) for _, e in rows)


def test_proxy_reroute_mid_retry_does_not_double_deliver():
    """A destination fails mid-unit, the ring changes, the sender retries
    the same seq: the stored undelivered sub-batch goes to its original
    destination, nothing re-routes, nothing re-sends, and the sender's
    own duplicate retry is suppressed; the same in both packages."""
    out = {}
    for pkg in ("jax", "torch"):
        p, disc, delivered, _ = _proxy(pkg, ["a:1", "b:1"],
                                       dedup_window=16)
        env = PKGS[pkg][1].Envelope(SID, 0, 0)
        metrics = _metrics(16, seed=3)
        p._conn("b:1").fail = True
        with pytest.raises(RuntimeError):
            p.handle(metrics, envelope=env)
        got_a = len(delivered.get("a:1", []))
        assert 0 < got_a < 16 and len(p._inflight) == 1
        disc.dests = ["a:1", "c:1"]
        p.refresh()
        p._conn("b:1").fail = False
        assert p.handle(metrics, envelope=env) is True
        assert "c:1" not in delivered
        assert len(delivered["a:1"]) == got_a
        assert p.handle(metrics, envelope=env) is True
        out[pkg] = (delivered, p.dup_suppressed, p.errors, p.forwarded,
                    len(p._inflight))
        p.stop()
    assert out["torch"] == out["jax"]
    assert out["torch"][1] == 1 and out["torch"][3] == 16


def test_proxy_rejects_bad_envelope_with_accounting():
    for pkg in ("jax", "torch"):
        p, _d, delivered, _ = _proxy(pkg, ["a:1"], dedup_window=4)
        envelope = PKGS[pkg][1]
        with pytest.raises(envelope.EnvelopeError):
            p.handle(_metrics(1), envelope=envelope.Envelope(SID, 0, 10**9))
        assert p.envelope_rejected == 1 and not delivered
        p.stop()


def test_proxy_fault_at_one_destination_fails_only_its_batch():
    """PROXY_FORWARD with a destination's name fails that destination's
    sub-batch; the others deliver, and the retry sends only the failed
    one (the card's forward phase drives the same fault)."""
    p, _d, delivered, _ = _proxy("torch", ["a:1", "b:1"], dedup_window=16)
    env = tenvelope.Envelope(SID, 0, 5)
    metrics = _metrics(40, seed=4)
    FAULTS.arm(PROXY_FORWARD, error=True, match="b:1")
    with pytest.raises(RuntimeError):
        p.handle(metrics, envelope=env)
    assert "b:1" not in delivered and delivered["a:1"]
    n_a = len(delivered["a:1"])
    FAULTS.reset()
    assert p.handle(metrics, envelope=env) is True
    assert len(delivered["a:1"]) == n_a
    assert n_a + len(delivered["b:1"]) == 40
    p.stop()


def test_proxy_empty_and_unreachable_destinations_counted():
    empty = tproxysrv.ProxyServer(_Disc([]), service="s")
    empty.handle(_metrics(10))
    assert empty.errors == 10 and empty.forwarded == 0
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    dead = f"127.0.0.1:{s.getsockname()[1]}"
    s.close()
    unreach = tproxysrv.ProxyServer(_Disc([dead]), service="s")
    unreach.handle(_metrics(10))
    assert unreach.errors == 10 and unreach.forwarded == 0
    unreach.stop()


def test_proxy_ejects_open_breaker_and_readmits():
    from veneur_tpu_torch.reliability.policy import CircuitBreaker

    class Clock:
        t = 0.0

        def __call__(self):
            return self.t

    clk = Clock()
    dests = ["h1:1", "h2:1", "h3:1"]
    p = tproxysrv.ProxyServer(tdiscovery.StaticDiscoverer(dests),
                              failure_threshold=1, cooldown_s=30.0)
    b = CircuitBreaker(1, 30.0, clock=clk)
    b.record_failure()
    with p._lock:
        p._breakers["h2:1"] = b
    ring = p._routing_ring()
    assert ring.destinations == ["h1:1", "h3:1"]
    assert all(ring.get(b"key-%d" % i) != "h2:1" for i in range(200))
    assert p._routing_ring() is ring
    clk.t = 31.0
    assert p._routing_ring().destinations == dests
    p.stop()


def test_proxy_consults_peer_readyz():
    ready = {"h1": 200, "h2": 503}

    class Resp:
        def __init__(self, status):
            self.status = status

        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

    def opener(url, timeout=0):
        return Resp(ready[url.split("//")[1].split(":")[0]])

    p = tproxysrv.ProxyServer(tdiscovery.StaticDiscoverer(["h1:1", "h2:1"]),
                              readyz_port=8127, readyz_opener=opener)
    assert p._routing_ring().destinations == ["h1:1"]
    ready["h2"] = 200
    p.refresh()
    assert p._routing_ring().destinations == ["h1:1", "h2:1"]
    p.stop()


def test_proxy_counter_bumps_are_thread_safe():
    p = tproxysrv.ProxyServer(_Disc(["a:1"]))

    def bump():
        for _ in range(2000):
            p._bump("errors")
            p._bump("forwarded", 2)

    threads = [threading.Thread(target=bump) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert p.errors == 16000 and p.forwarded == 32000
    p.stop()


def test_proxy_runtime_and_stats_emission():
    p = tproxysrv.ProxyServer(tdiscovery.StaticDiscoverer(["127.0.0.1:1"]))
    try:
        rt = {n: (v, t) for n, v, t in p.runtime_metrics()}
        assert set(rt) == {"mem.heap_alloc_bytes", "gc.number",
                           "gc.alloc_heap_bytes"}
        rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        rx.bind(("127.0.0.1", 0))
        rx.settimeout(5.0)
        p._count_dest("127.0.0.1:1", "grpc", 7)
        p._count_dest("127.0.0.1:1", "http", 3)
        p.errors = 2
        p.start_stats("127.0.0.1:%d" % rx.getsockname()[1], interval=3600)
        p.emit_stats_once()
        lines = rx.recv(65536).split(b"\n")
        assert any(b"veneur_proxy.metrics_by_destination:7.0|c|"
                   b"#destination:127.0.0.1:1,protocol:grpc" in ln
                   for ln in lines)
        assert b"veneur_proxy.forward.error_total:2.0|c" in lines
        p.emit_stats_once()
        assert not any(b"metrics_by_destination" in ln
                       for ln in rx.recv(65536).split(b"\n"))
        rx.close()
        flat = {m.name: m for m in p.metrics.collect()}
        assert [v for _lv, v in
                flat["veneur.discovery.stale"].samples()] == [0.0]
    finally:
        p.stop()


# -- (c) discovery and the HTTP surface ---------------------------------------------

class _Resp(io.BytesIO):
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


def test_consul_discoverer_reference_fixtures_as_jax():
    """The reference's recorded Consul health responses parse to the same
    destinations in both packages; the zero-instance answer keeps the
    proxy's last good ring."""
    here = os.path.join(TESTDATA, "consul")
    nxt = {}

    def opener(url, timeout=0):
        assert "health/service/veneur-global?passing" in url
        with open(os.path.join(here, nxt["f"] + ".json"), "rb") as f:
            return _Resp(f.read())

    for pkg in ("jax", "torch"):
        proxysrv, _env, disc_mod = PKGS[pkg]
        d = disc_mod.ConsulDiscoverer("http://consul:8500", opener=opener)
        seen = []
        for f in ("health_service_one", "health_service_two",
                  "health_service_zero"):
            nxt["f"] = f
            seen.append(d.get_destinations_for_service("veneur-global"))
        assert seen == [["10.1.10.12:8000"],
                        ["10.1.10.12:8000", "10.1.10.13:8000"], []]
        nxt["f"] = "health_service_two"
        p = proxysrv.ProxyServer(d)
        nxt["f"] = "health_service_zero"
        p.refresh()
        assert p._ring.destinations == ["10.1.10.12:8000",
                                        "10.1.10.13:8000"]
        p.stop()


def test_discoverers_keep_last_good_and_flag_stale():
    state = {"fail": False}
    payload = json.dumps([
        {"Service": {"Address": "10.0.0.1", "Port": 8128}, "Node": {}},
        {"Service": {"Port": 8128}, "Node": {"Address": "10.0.0.2"}},
    ]).encode()

    def opener(url, timeout=0, **kw):
        if state["fail"]:
            raise OSError("discovery down")
        return _Resp(payload)

    for pkg in ("jax", "torch"):
        disc = PKGS[pkg][2]
        state["fail"] = False
        d = disc.ConsulDiscoverer(opener=opener)
        got = d.get_destinations_for_service("veneur-global")
        assert got == ["10.0.0.1:8128", "10.0.0.2:8128"] and d.stale == 0
        state["fail"] = True
        assert d.get_destinations_for_service("veneur-global") == got
        assert d.stale == 1
        with pytest.raises(OSError):
            disc.ConsulDiscoverer(opener=opener) \
                .get_destinations_for_service("veneur-global")
        # outside a cluster (no service-account token) the Kubernetes
        # discoverer answers no destination, in both packages
        k = disc.KubernetesDiscoverer(opener=opener)
        assert k.get_destinations_for_service("veneur-global") == []
        assert disc.StaticDiscoverer(["a:1"]) \
            .get_destinations_for_service("x") == ["a:1"]


def _post(port, body, headers=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/import",
                                 data=body, method="POST",
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status
    except urllib.error.HTTPError as e:
        return e.code


def test_proxy_http_import_answers_and_routes_as_jax():
    jms = [{"name": f"h.m{i}", "type": "counter", "tagstring": f"t:{i % 3}",
            "tags": [f"t:{i % 3}"], "value": "AQ=="} for i in range(60)]
    env = {"source_id": SID, "epoch": 0, "seq": 3}
    cases = [
        ("bare", json.dumps(jms).encode(), {}),
        ("deflate", zlib.compress(json.dumps(jms).encode()),
         {"Content-Encoding": "deflate"}),
        ("bad-deflate", b"xx", {"Content-Encoding": "deflate"}),
        ("bad-json", b"[{", {}),
        ("not-array", b'{"metrics": 3}', {}),
        ("empty", b"[]", {}),
        ("wrapped", json.dumps({"envelope": env, "metrics": jms}).encode(),
         {}),
        ("wrapped-again", json.dumps({"envelope": env,
                                      "metrics": jms}).encode(), {}),
        ("bad-envelope", json.dumps({"envelope": dict(env, seq=-1),
                                     "metrics": jms}).encode(), {}),
    ]
    out = {}
    for pkg in ("jax", "torch"):
        p, _d, _delivered, _ = _proxy(pkg, _dests(2), dedup_window=8)
        posted = {}
        p._post_import = lambda dest, batch, envelope=None: posted \
            .setdefault(dest, []).extend(
                (jm["name"], -1 if envelope is None else envelope.seq)
                for jm in batch)
        port = p.start_http("127.0.0.1:0")
        codes = [(name, _post(port, body, hdr)) for name, body, hdr in cases]
        time.sleep(0.2)     # the bare 202 is sent before the forward
        out[pkg] = (codes, {d: sorted(v) for d, v in posted.items()},
                    p.envelope_rejected, p.dup_suppressed,
                    p.handle_json(jms))
        p.stop()
    assert out["torch"] == out["jax"]
    assert dict(out["torch"][0]) == {
        "bare": 202, "deflate": 202, "bad-deflate": 400, "bad-json": 400,
        "not-array": 400, "empty": 202, "wrapped": 202,
        "wrapped-again": 202, "bad-envelope": 400}


# -- (d) config and the CLI ------------------------------------------------------

def test_example_proxy_yaml_reads_as_jax():
    path = os.path.join(REPO, "example_proxy.yaml")
    t = tconfig_proxy.read_proxy_config(path, env={})
    j = jconfig_proxy.read_proxy_config(path, env={})
    assert vars(t) == vars(j) and not t.unknown_keys
    env = {"VENEUR_PROXY_GRPCFORWARDADDRESS": "10.0.0.9:8128",
           "VENEUR_PROXY_FORWARD_DEDUP_WINDOW": "64",
           "VENEUR_PROXY_DEBUG": "true"}
    t = tconfig_proxy.read_proxy_config(path, env=env)
    assert vars(t) == vars(jconfig_proxy.read_proxy_config(path, env=env))
    assert (t.grpc_forward_address, t.forward_dedup_window, t.debug) == (
        "10.0.0.9:8128", 64, True)
    odd = io.StringIO("grpc_address: x:1\nbogus_key: 3\nhttp_address:\n")
    t = tconfig_proxy.read_proxy_config(odd, env={})
    odd.seek(0)
    assert vars(t) == vars(jconfig_proxy.read_proxy_config(odd, env={}))
    assert t.unknown_keys == ["bogus_key"]


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_proxy_cli_serves_example_yaml_and_exits_0_on_sigterm(tmp_path):
    port = _free_port()
    env = dict(os.environ, VENEUR_PROXY_GRPCADDRESS=f"127.0.0.1:{port}",
               VENEUR_PROXY_GRPCFORWARDADDRESS="127.0.0.1:1")
    log_path = tmp_path / "proxy.log"
    with open(log_path, "w") as log:
        p = subprocess.Popen(
            [sys.executable, "-m", "veneur_tpu_torch.cli.proxy", "-f",
             os.path.join(REPO, "example_proxy.yaml")], cwd=REPO,
            stdout=log, stderr=subprocess.STDOUT, env=env)
        try:
            deadline = time.time() + 60
            while time.time() < deadline:
                assert p.poll() is None, log_path.read_text()
                try:
                    socket.create_connection(("127.0.0.1", port),
                                             timeout=1).close()
                    break
                except OSError:
                    time.sleep(0.1)
            else:
                raise AssertionError("proxy never listened: "
                                     + log_path.read_text())
            p.send_signal(signal.SIGTERM)
            assert p.wait(timeout=30) == 0, log_path.read_text()
        finally:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    assert "listening on port" in log_path.read_text()
    # no destination configured: both CLIs refuse with exit 1
    res = subprocess.run(
        [sys.executable, "-m", "veneur_tpu_torch.cli.proxy", "-f",
         os.path.join(REPO, "example_proxy.yaml")], cwd=REPO,
        capture_output=True, text=True, timeout=60)
    assert res.returncode == 1 and "static forward address" in res.stderr


# -- (e) no JAX in the slice ---------------------------------------------------

def test_forward_tier_modules_import_no_jax_and_no_reference_package():
    code = (
        "import importlib, sys\n"
        "for m in ('forward.envelope', 'forward.discovery',\n"
        "          'forward.proxysrv', 'reliability.spill',\n"
        "          'config_proxy', 'cli.proxy', 'persistence',\n"
        "          'server.server'):\n"
        "    importlib.import_module('veneur_tpu_torch.' + m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'veneur_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.startswith("ok"), \
        res.stdout + res.stderr
