"""The port's query tier against the JAX package, on the CPU.

- (a) `parse_request` on valid and malformed /query bodies: the same
  parsed queries, or a QueryError with the same text;
- (b) `NameIndex` exact, prefix and wildcard resolution over a seeded
  key population: the same (position, slot, name) rows in the same order;
- (c) `pack_query_inputs`: byte-exact buffers and the same (n_q,
  buckets, qcol), and the same refusal past one flush block;
- (d) the slice as a whole: the same datagrams into the port's Server
  and the JAX Server (built through the test-side subclass whose
  aggregators wait for each JAX step, ROADMAP C-watch 4), both with the
  history, query and watch tiers on. Over three intervals the instant
  answers to one batch of queries (every kind, prefix, wildcard, tag
  filters, quantiles) agree: counters, gauges and status values exact,
  set estimates within rtol 1e-6 (the HLL estimator sums in another
  order than XLA), digest quantiles within rtol/atol 2e-5 (C-watch 3).
  The port's instant answers are value-exact against its own next
  flush. Then range answers over the ring agree the same way, and the
  port's range counters are the exact sums of what it flushed, its
  gauges the last value flushed;
- (e) inside the port's Server: read-your-writes, a fresh interval after
  the swap, no torn reads while flushes race the reads, an instant batch
  whose swap lands between its two pipeline visits and a range batch
  whose ring write lands between its plan and its launch (both retried
  and answered right), 404 with the tier off, 400 on bad bodies, 503
  behind the shutdown gate and when the pipeline is gone, the query
  self-metrics, and the `cli/query.py` round trip.
"""

import json
import socket
import threading
import time
import urllib.error
import urllib.request
from collections import namedtuple

import numpy as np
import pytest

from tests.test_torch_server import SMALL, _SyncedJServer
from veneur_tpu import config as jconfig
from veneur_tpu.aggregation import state as jstate
from veneur_tpu.aggregation import step as jstep
from veneur_tpu.query import engine as jengine
from veneur_tpu.query import nameindex as jnameindex
from veneur_tpu.sinks.debug import DebugMetricSink as JDebugMetricSink
from veneur_tpu_torch import config as tconfig
from veneur_tpu_torch.aggregation import state as tstate
from veneur_tpu_torch.aggregation import step as tstep
from veneur_tpu_torch.cli import query as cli_query
from veneur_tpu_torch.query import engine as tengine
from veneur_tpu_torch.query import nameindex as tnameindex
from veneur_tpu_torch.server.server import Server
from veneur_tpu_torch.sinks.debug import DebugMetricSink

TIERS = dict(query_enabled=True, history_enabled=True, watch_enabled=True,
             history_windows=8, history_decimation_tiers=2,
             history_max_keys=64)


# -- (a) parse_request ----------------------------------------------------------

BODIES = [
    {"name": "a"},
    {"queries": [{"name": "a"}, {"prefix": "b", "kinds": ["counter",
                                                          "timer"]}]},
    {"match": "api.*", "kind": "histogram", "quantiles": [0.99, 0.5, 0.5]},
    {"name": "x", "tags": ["env:prod"], "range": 60, "window": "30",
     "step": 10},
    {"prefix": "", "quantiles": [0, 1], "kinds": ["set", "set"]},
    None, [], {}, "x", {"queries": "x"}, {"queries": []}, {"queries": [1]},
    {"name": 1}, {"name": "a", "prefix": "b"}, {"kinds": ["counter"]},
    {"name": "a", "kinds": ["bogus"]}, {"name": "a", "kinds": []},
    {"name": "a", "kinds": "counter"}, {"name": "a", "quantiles": []},
    {"name": "a", "quantiles": [1.5]}, {"name": "a", "quantiles": ["x"]},
    {"name": "a", "quantiles": [0.1] * 65}, {"name": "a", "tags": [1]},
    {"name": "a", "tags": "env:prod"}, {"name": "a", "range": -1},
    {"name": "a", "range": "inf"}, {"name": "a", "range": "x"},
    {"name": "a", "window": 5}, {"name": "a", "step": 5},
    {"queries": [{"name": "a"}] * 3},
]


@pytest.mark.parametrize("i", range(len(BODIES)))
def test_parse_request_matches_jax(i):
    body = BODIES[i]
    try:
        want = jengine.parse_request(body, 2)
    except jengine.QueryError as e:
        with pytest.raises(tengine.QueryError) as got:
            tengine.parse_request(body, 2)
        assert str(got.value) == str(e)
        return
    assert tengine.parse_request(body, 2) == want


# -- (b) NameIndex -------------------------------------------------------------

_Meta = namedtuple("_Meta", "name")
_TABLES = ("counter", "gauge", "status", "set", "histo")


def _metas(seed):
    rng = np.random.default_rng(seed)
    stems = ["api.get", "api.put", "api", "db.get", "db.query.ms",
             "api.get.ms", "zz", "a*b", "api[1]", ""]
    out = {}
    for t in _TABLES:
        n = int(rng.integers(0, 40))
        slots = rng.permutation(256)[:n]
        out[t] = [(int(s), _Meta(stems[int(rng.integers(0, len(stems)))]
                                 + (f".{int(rng.integers(0, 4))}"
                                    if rng.random() < 0.5 else "")))
                  for s in slots]
    return out


LOOKUPS = [("exact", "api.get"), ("exact", "api.get.1"), ("exact", ""),
           ("prefix", "api."), ("prefix", ""), ("prefix", "db"),
           ("match", "*.get*"), ("match", "api.?"), ("match", "a[*]b"),
           ("match", "*"), ("match", "api[[]1]*"), ("match", "nope*")]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_name_index_matches_jax(seed):
    metas = _metas(seed)
    counts = {t: max(0, len(metas[t]) - seed) for t in _TABLES}
    want = jnameindex.NameIndex(metas, counts)
    got = tnameindex.NameIndex(metas, counts)
    hits = 0
    for t in _TABLES:
        for mode, arg in LOOKUPS:
            a = [(p, s, m.name) for p, s, m in getattr(got, mode)(t, arg)]
            b = [(p, s, m.name) for p, s, m in getattr(want, mode)(t, arg)]
            assert a == b, (t, mode, arg)
            hits += len(a)
    assert hits > 0
    for pat in ("abc", "ab*c", "?x", "[ab]c", "abc["):
        assert tnameindex.literal_prefix(pat) == jnameindex.literal_prefix(
            pat)


# -- (c) pack_query_inputs -------------------------------------------------------

SPEC_KW = dict(counter_capacity=256, gauge_capacity=64, status_capacity=16,
               set_capacity=16, histo_capacity=64)


@pytest.mark.parametrize("seed", range(4))
def test_pack_query_inputs_matches_jax(seed):
    rng = np.random.default_rng(seed)
    caps = [256, 64, 16, 16, 64]
    need = [list(rng.integers(0, c, int(rng.integers(0, c + 1))))
            for c in caps]
    qs = set(np.round(rng.random(int(rng.integers(0, 9))), 3).tolist())
    j = jstep.pack_query_inputs(jstate.TableSpec(**SPEC_KW), need, qs)
    t = tstep.pack_query_inputs(tstate.TableSpec(**SPEC_KW), need, qs)
    assert t[0].dtype == j[0].dtype == np.int32
    assert t[0].tobytes() == np.asarray(j[0]).tobytes()
    assert t[1:] == j[1:]


def test_pack_query_inputs_refuses_what_jax_refuses(monkeypatch):
    need = [list(range(300)), [], [], [], []]
    spec = dict(SPEC_KW, counter_capacity=512)
    monkeypatch.setattr(jstep, "FLUSH_BLOCK_ROWS", 256)
    monkeypatch.setattr(tstep, "FLUSH_BLOCK_ROWS", 256)
    with pytest.raises(ValueError) as je:
        jstep.pack_query_inputs(jstate.TableSpec(**spec), need, set())
    with pytest.raises(ValueError) as te:
        tstep.pack_query_inputs(tstate.TableSpec(**spec), need, set())
    assert str(te.value) == str(je.value)


# -- shared helpers --------------------------------------------------------------

def _post(port, path, body, timeout=60.0):
    data = body if isinstance(body, bytes) else json.dumps(body).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data,
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _query(srv, body):
    code, raw = _post(srv.http_port, "/query", body)
    assert code == 200, raw
    return json.loads(raw)


def _seen(srv):
    agg = srv.aggregator
    return (agg.processed + agg.dropped_capacity + srv.parse_errors
            + agg.extra_parse_errors())


def _wait(cond, what, timeout=60.0):
    t0 = time.time()
    while not cond():
        assert time.time() - t0 < timeout, f"{what} after {timeout} s"
        time.sleep(0.02)


def _send(srv, lines):
    """Send `lines` in datagrams of ~1,400 bytes and wait until each is
    parsed (the server's self-metrics re-enter on its Python path, so
    quiet the count first)."""
    last, t_quiet = _seen(srv), time.time()
    while time.time() - t_quiet < 0.3:
        if _seen(srv) != last:
            last, t_quiet = _seen(srv), time.time()
        time.sleep(0.02)
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    cur = []
    for ln in lines + [None]:
        if ln is None or (cur and sum(map(len, cur)) + len(ln) > 1400):
            tx.sendto(b"\n".join(cur), srv.local_addr())
            cur = []
        if ln is not None:
            cur.append(ln)
    tx.close()
    _wait(lambda: _seen(srv) >= last + len(lines), "lines not all seen")


def _lines(seed):
    """Every kind, tags, sample rates and service checks."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(400):
        k = i % 6
        if k == 0:
            tags = "|#env:prod" if i % 4 == 0 else ""
            rate = "|@0.5" if i % 5 == 0 else ""
            out.append(f"app.c{i % 17}:{1 + i % 7}|c{rate}{tags}")
        elif k == 1:
            out.append(f"app.g{i % 9}:{rng.normal():.4f}|g")
        elif k == 2:
            out.append(f"app.t{int(rng.zipf(1.5)) % 6}:"
                       f"{rng.lognormal(3.0, 0.6):.4f}|ms"
                       + ("|#route:r1" if i % 2 else ""))
        elif k == 3:
            out.append(f"app.h{i % 4}:{rng.normal(50, 5):.3f}|h")
        elif k == 4:
            out.append(f"app.s{i % 5}:u{int(rng.integers(0, 200))}|s")
        else:
            out.append(f"_sc|app.sc{i % 3}|{i % 3}|#svc:{i % 2}|m:m{i}")
    return [ln.encode() for ln in out]


INSTANT = {"queries": [
    {"prefix": "app."},
    {"match": "app.t*", "kinds": ["timer"], "quantiles": [0.25, 0.5, 0.99]},
    {"name": "app.c0", "tags": ["env:prod"]},
    {"name": "app.t1", "kinds": ["timer"], "tags": ["route:r1"]},
    {"match": "app.[cg]1*", "kinds": ["counter", "gauge"]},
    {"prefix": "app.sc", "kinds": ["status"]},
    {"name": "nothing.here"},
]}

# the servers flush hourly (interval 3600 s): three intervals back
RANGE = {"queries": [
    {"prefix": "app.", "kinds": ["counter", "gauge", "status", "set"],
     "range": 10800, "step": 3600},
    {"prefix": "app.", "range": 10800},
    {"match": "app.[th]*", "range": 10800, "window": 7200, "step": 3600,
     "quantiles": [0.5, 0.9]},
]}

# wall-clock fields: each server stamps its own flush times
_CLOCK = ("ts", "ts_start")


def _same_answers(got, want, where=""):
    """Equal structure; digest quantiles within rtol/atol 2e-5 (C-watch
    3), set estimates within rtol 1e-6 (the HLL estimator's f32 sum
    reduces in another order than XLA's, as tests/test_torch_server.py
    and tests/test_torch_history.py hold them), the rest exact."""
    if isinstance(want, dict):
        assert sorted(k for k in got if k not in _CLOCK) == sorted(
            k for k in want if k not in _CLOCK), where
        for k in want:
            if k in _CLOCK:
                continue
            if k in ("quantiles", "median"):
                _close(got[k], want[k], f"{where}.{k}", 2e-5, 2e-5)
            elif k == "estimate":
                _close(got[k], want[k], f"{where}.{k}", 1e-6, 0.0)
            else:
                _same_answers(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _same_answers(g, w, f"{where}[{i}]")
    else:
        assert got == want, (where, got, want)


def _close(got, want, where, rtol, atol):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), where
        for k in want:
            _close(got[k], want[k], f"{where}.{k}", rtol, atol)
    elif want is None or got is None:
        assert got is None and want is None, (where, got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                   err_msg=where)


def _by_name(metrics):
    return {(m.name, tuple(m.tags)): m.value for m in metrics}


def _instant_vs_flush(out, flushed):
    """Every instant match against the next flush's InterMetrics, value
    for value (the same program over the same state)."""
    checked = 0
    for res in out["results"]:
        for m in res["matches"]:
            key = tuple(m["tags"])
            if m["kind"] in ("counter", "gauge", "status"):
                assert m["value"] == flushed[(m["name"], key)], m
            elif m["kind"] == "set":
                assert m["estimate"] == flushed[(m["name"], key)], m
            else:
                for q, v in m["quantiles"].items():
                    pct = f"{m['name']}.{int(float(q) * 100)}percentile"
                    if (pct, key) in flushed:
                        assert v == flushed[(pct, key)], (pct, v)
                assert m["max"] == flushed[(m["name"] + ".max", key)]
                assert m["count"] == flushed[(m["name"] + ".count", key)]
            checked += 1
    return checked


# -- (d) both Servers ------------------------------------------------------------

@pytest.fixture(scope="module")
def servers():
    cfg_kw = dict(SMALL, interval="3600s", **TIERS)
    jsink, tsink = JDebugMetricSink(), DebugMetricSink()
    jsrv = _SyncedJServer(jconfig.Config(**cfg_kw), metric_sinks=[jsink])
    tsrv = Server(tconfig.Config(**cfg_kw), metric_sinks=[tsink],
                  device="cpu")
    jsrv.start()
    tsrv.start()
    try:
        yield (jsrv, jsink), (tsrv, tsink)
    finally:
        tsrv.shutdown()
        jsrv.shutdown()


def test_query_answers_match_the_jax_server(servers):
    (jsrv, jsink), (tsrv, tsink) = servers
    checked = 0
    flushed = []
    for interval in range(3):
        lines = _lines(interval)
        _send(jsrv, lines)
        _send(tsrv, lines)
        jout, tout = _query(jsrv, INSTANT), _query(tsrv, INSTANT)
        _same_answers(tout, jout, f"interval {interval}")
        assert any(m["kind"] == k for r in tout["results"]
                   for m in r["matches"]
                   for k in ("counter", "gauge", "status", "set", "timer",
                             "histogram"))
        for sink in (jsink, tsink):
            sink.flushed.clear()
        assert jsrv.trigger_flush(timeout=120)
        assert tsrv.trigger_flush(timeout=120)
        checked += _instant_vs_flush(tout, _by_name(tsink.flushed))
        flushed.append(_by_name(tsink.flushed))
    assert checked > 100
    jout, tout = _query(jsrv, RANGE), _query(tsrv, RANGE)
    _same_answers(tout, jout, "range")
    # the port's range counters are the exact sums of its flushes, its
    # gauges the last value flushed (newest point = the last interval)
    def series(res):
        return {(m["name"], tuple(m["tags"]), m["kind"]): m["points"]
                for m in res["matches"]}
    per_step = {k: v for k, v in series(tout["results"][0]).items()
                if k[2] in ("counter", "gauge")}
    assert len(per_step) > 10
    for (name, tags, _kind), pts in per_step.items():
        assert [p["seq"] for p in pts] == [[0, 0], [1, 1], [2, 2]]
        for p, fl in zip(pts, flushed):
            assert p["value"] == fl.get((name, tags)), (name, tags, p)
    whole = series(tout["results"][1])
    for (name, tags, kind), pts in per_step.items():
        if kind == "counter":
            want = sum(fl.get((name, tags), 0.0) for fl in flushed)
            assert whole[(name, tags, kind)][0]["value"] == want, name
    assert tsrv.query_engine.launches_total >= 4


# -- (e) the port's Server alone -------------------------------------------------

@pytest.fixture
def server():
    srv = Server(tconfig.Config(**dict(SMALL, interval="3600s", **TIERS)),
                 metric_sinks=[DebugMetricSink()], device="cpu")
    srv.start()
    try:
        yield srv
    finally:
        srv.shutdown()


def _value(out, i=0):
    ms = out["results"][i]["matches"]
    return ms[0]["value"] if ms else 0.0


def test_query_read_your_writes_and_the_fresh_interval(server):
    _send(server, [b"ryw.hits:1|c"] * 7)
    assert _value(_query(server, {"name": "ryw.hits"})) == 7.0
    assert server.trigger_flush(timeout=60)
    _send(server, [b"ryw.hits:2|c"])
    assert _value(_query(server, {"name": "ryw.hits"})) == 2.0


def test_swap_boundary_no_torn_reads(server):
    """Two counters always written in one datagram must never disagree in
    one response while flushes race the reads."""
    stop = threading.Event()

    def writer():
        tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        while not stop.is_set():
            tx.sendto(b"pair.a:1|c\npair.b:1|c", server.local_addr())
            time.sleep(0.001)
        tx.close()

    def flusher():
        while not stop.is_set():
            server.trigger_flush()
            time.sleep(0.02)

    threads = [threading.Thread(target=writer),
               threading.Thread(target=flusher)]
    for t in threads:
        t.start()
    try:
        nonzero = 0
        deadline = time.time() + 60
        while time.time() < deadline and nonzero < 5:
            out = _query(server, {"queries": [
                {"name": "pair.a", "kinds": ["counter"]},
                {"name": "pair.b", "kinds": ["counter"]}]})
            va, vb = _value(out, 0), _value(out, 1)
            assert va == vb, f"torn read: pair.a={va} pair.b={vb}"
            nonzero += va > 0
        assert nonzero >= 5, "reads never observed live writes"
    finally:
        stop.set()
        for t in threads:
            t.join()


def test_a_swap_between_the_visits_retries_the_batch(server):
    eng = server.query_engine
    _send(server, [b"roll.c:3|c"])
    orig = eng._build_inputs
    rolled = []

    def build_then_swap(need, union_qs):
        if not rolled:
            rolled.append(1)
            assert server.trigger_flush(timeout=60)
            _send(server, [b"roll.c:4|c"])
        return orig(need, union_qs)
    eng._build_inputs = build_then_swap
    before = eng.rolled_total
    # resolved against the first interval, launched in the second: the
    # batch retries and answers from the fresh interval alone
    assert _value(_query(server, {"name": "roll.c"})) == 4.0
    assert eng.rolled_total == before + 1


def test_a_ring_write_between_plan_and_launch_retries_the_range(server):
    eng, hist = server.query_engine, server.history
    for v in (1, 2):
        _send(server, [f"rng.c:{v}|c".encode()])
        assert server.trigger_flush(timeout=60)
    orig = eng._build_range_inputs
    rolled = []

    def build_then_flush(rinfo):
        if not rolled:
            rolled.append(1)
            _send(server, [b"rng.c:5|c"])
            assert server.trigger_flush(timeout=60)
        return orig(rinfo)
    eng._build_range_inputs = build_then_flush
    before = eng.rolled_total
    out = _query(server, {"name": "rng.c", "range": 30000, "step": 3600})
    pts = out["results"][0]["matches"][0]["points"]
    # planned at seq 2, launched after the third window landed: replanned
    assert hist.seq == 3 and eng.rolled_total == before + 1
    assert [p["value"] for p in pts] == [1.0, 2.0, 5.0]
    assert [p["delta"] for p in pts] == [None, 1.0, 3.0]


def test_query_errors_and_the_shutdown_gate(server):
    port = server.http_port
    for bad in (b"", b"{not json", b'{"name": "x", "prefix": "y"}',
                b'{"name": "x", "quantiles": [1.5]}'):
        code, _body = _post(port, "/query", bad)
        assert code == 400, bad
    shed = server._c_query_shed.value()
    server._shutdown.set()
    try:
        for path in ("/query", "/healthz", "/stats"):
            code, _body = _post(port, path, {"name": "x"}) if \
                path == "/query" else _get(port, path)
            assert code == 503, path
    finally:
        server._shutdown.clear()
    # the pipeline is gone: a query that cannot be scheduled answers 503
    # and is counted as shed
    eng = server.query_engine
    orig = eng._snapshot
    eng._snapshot = lambda: (_ for _ in ()).throw(
        RuntimeError("pipeline backlogged; snapshot not scheduled"))
    try:
        code, body = _post(port, "/query", {"name": "x"})
    finally:
        eng._snapshot = orig
    assert code == 503 and b"backlogged" in body
    assert server._c_query_shed.value() == shed + 1


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=30) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_query_and_range_answer_404_or_400_with_a_tier_off():
    srv = Server(tconfig.Config(**dict(SMALL, query_enabled=True)),
                 metric_sinks=[DebugMetricSink()], device="cpu")
    off = Server(tconfig.Config(**SMALL), metric_sinks=[DebugMetricSink()],
                 device="cpu")
    srv.start()
    off.start()
    try:
        assert off.query_engine is None and off.history is None
        code, body = _post(off.http_port, "/query", {"name": "x"})
        assert code == 404 and body == b"query_enabled is off"
        code, body = _post(srv.http_port, "/query",
                           {"name": "x", "range": 60})
        assert code == 400 and b"history tier" in body
    finally:
        srv.shutdown()
        off.shutdown()


def test_query_self_metrics_and_the_cli(server, capsys):
    _send(server, [b"cli.hits:4|c", b"cli.t:5|ms"])
    url = f"http://127.0.0.1:{server.http_port}/query"
    assert cli_query.main(["cli.hits", "--kind", "counter", "--url",
                           url]) == 0
    text = capsys.readouterr().out
    assert "cli.hits  [counter]  value=4" in text
    assert cli_query.main(["--prefix", "cli.", "--json", "-q", "0.5",
                           "--url", url]) == 0
    out = json.loads(capsys.readouterr().out)
    assert {m["name"] for m in out["results"][0]["matches"]} == {
        "cli.hits", "cli.t"}
    assert server.trigger_flush(timeout=60)
    assert cli_query.main(["cli.hits", "--range", "2h", "--step", "1h",
                           "--url", url]) == 0
    text = capsys.readouterr().out
    assert "seq[0..0]  value=4" in text
    assert cli_query.main(["nope", "--url", url + "x"]) == 1
    assert "HTTP 404" in capsys.readouterr().err
    assert server._c_query_requests.value() == 3
    assert server._c_query_batched.value() >= 3
    assert server._t_query.snapshot(qs=())[0][1].count >= 3
