"""The port's watch tier against the JAX package, on the CPU.

- (a) `parse_watch` on valid and malformed registration bodies: the same
  canonical dict (key order included), or a WatchError with the same
  text;
- (b) the `Watch` state machine over seeded value sequences (every kind,
  op, hysteresis, debounce and no-data setting): the same transitions and
  suppressions, step by step, and byte-identical serialized state;
- (c) StreamHub's drop-oldest accounting, and the engine's bounded offer
  queue dropping the oldest detached interval with exact accounting;
- (d) the slice as a whole: the same watches registered and the same
  datagrams into the port's Server and the JAX Server (built through the
  test-side subclass whose aggregators wait for each JAX step, ROADMAP
  C-watch 4), all three tiers on: over four intervals the same
  transitions on each server's SSE stream and the same listings (values
  within the query tier's tolerances), one fused launch per interval,
  the same evaluated/fired/suppressed counts; in the port, watch values
  equal POST /query answers of the same interval, and a delta watch
  reads its baseline from the history ring;
- (e) the /watch routes: 404 with the tier off, register/list/delete,
  400 on bad bodies, 429 at the cap, 503 at the subscriber cap and
  behind the shutdown gate, and the `cli/watch.py` round trip.
"""

import json
import random
import threading
import types
import urllib.error
import urllib.request

import pytest

from tests.test_torch_query import (TIERS, _close, _lines, _query, _send,
                                    _wait)
from tests.test_torch_server import SMALL, _SyncedJServer
from veneur_tpu import config as jconfig
from veneur_tpu.cli import watch as jcli_watch
from veneur_tpu.sinks.debug import DebugMetricSink as JDebugMetricSink
from veneur_tpu.watch import model as jmodel
from veneur_tpu_torch import config as tconfig
from veneur_tpu_torch.cli import watch as cli_watch
from veneur_tpu_torch.server.server import Server
from veneur_tpu_torch.sinks.debug import DebugMetricSink
from veneur_tpu_torch.watch import engine as tengine
from veneur_tpu_torch.watch import model as tmodel
from veneur_tpu_torch.watch.notify import StreamHub


# -- (a) parse_watch -------------------------------------------------------------

BODIES = [
    {"name": "a", "threshold": 5},
    {"match": "api.*", "kind": "quantile", "threshold": 1},
    {"prefix": "api.", "kind": "quantile", "quantile": 0.5, "op": "<=",
     "threshold": "250", "hysteresis": 25, "for_intervals": "3",
     "metric_kinds": ["timer"], "tags": ["env:prod"], "description": "p"},
    {"name": "s", "kind": "cardinality", "threshold": 100,
     "metric_kinds": ["set"], "no_data_intervals": 2},
    {"name": "d", "kind": "delta", "op": "<", "threshold": -1,
     "metric_kinds": ["counter", "gauge"], "description": ""},
    None, {}, [], "x",
    {"op": ">", "threshold": 1},
    {"name": "a", "prefix": "b", "threshold": 1},
    {"name": "", "threshold": 1}, {"name": 3, "threshold": 1},
    {"name": "a"}, {"name": "a", "threshold": "wat"},
    {"name": "a", "threshold": float("inf")},
    {"name": "a", "op": "!=", "threshold": 1},
    {"name": "a", "threshold": 1, "hysteresis": -1},
    {"name": "a", "threshold": 1, "for_intervals": 0},
    {"name": "a", "threshold": 1, "for_intervals": 100000},
    {"name": "a", "threshold": 1, "for_intervals": "x"},
    {"name": "a", "threshold": 1, "no_data_intervals": -2},
    {"name": "a", "threshold": 1, "kind": "sparkline"},
    {"name": "a", "threshold": 1, "quantile": 0.5},
    {"name": "a", "threshold": 1, "kind": "quantile", "quantile": 2},
    {"name": "a", "threshold": 1, "metric_kinds": ["set"]},
    {"name": "a", "threshold": 1, "metric_kinds": []},
    {"name": "a", "threshold": 1, "kind": "cardinality",
     "metric_kinds": ["counter"]},
    {"name": "a", "threshold": 1, "tags": [7]},
    {"name": "a", "threshold": 1, "description": "x" * 300},
]


@pytest.mark.parametrize("i", range(len(BODIES)))
def test_parse_watch_matches_jax(i):
    body = BODIES[i]
    try:
        want = jmodel.parse_watch(body)
    except jmodel.WatchError as e:
        with pytest.raises(tmodel.WatchError) as got:
            tmodel.parse_watch(body)
        assert str(got.value) == str(e)
        return
    got = tmodel.parse_watch(body)
    assert json.dumps(got) == json.dumps(want)


# -- (b) the state machine -------------------------------------------------------

def _random_spec(rng):
    kind = rng.choice(tmodel.WATCH_KINDS)
    spec = {"kind": kind, "name": "m", "op": rng.choice(tmodel.OPS),
            "threshold": rng.uniform(-5, 5),
            "hysteresis": rng.choice([0.0, 1.0, 3.0]),
            "for_intervals": rng.randint(1, 4),
            "no_data_intervals": rng.choice([0, 1, 2])}
    if kind == "quantile":
        spec["quantile"] = 0.99
    return spec


@pytest.mark.parametrize("seed", range(8))
def test_watch_state_machine_matches_jax(seed):
    rng = random.Random(seed)
    for trial in range(12):
        spec = _random_spec(rng)
        j = jmodel.Watch(trial + 1, jmodel.parse_watch(spec))
        t = tmodel.Watch(trial + 1, tmodel.parse_watch(spec))
        for ts in range(1, 40):
            raw = rng.choice([None, float("nan"), rng.uniform(-10, 10),
                              float(rng.randint(-6, 6))])
            base = rng.choice([tmodel._UNSET, None, rng.uniform(-10, 10)])
            if base is tmodel._UNSET:
                got, want = t.observe(raw, ts), j.observe(raw, ts)
            else:
                got = t.observe(raw, ts, prev_override=base)
                want = j.observe(raw, ts, prev_override=base)
            assert got == want, (spec, ts, raw)
            assert json.dumps(t.state_dict()) == json.dumps(j.state_dict())
            assert json.dumps(t.describe()) == json.dumps(j.describe())
        assert json.dumps(t.to_dict()) == json.dumps(j.to_dict())
        clone = tmodel.Watch(t.wid, tmodel.parse_watch(
            {k: v for k, v in t.to_dict().items() if k != "id"}))
        clone.load_state(t.state_dict())
        assert json.dumps([clone.to_dict(), clone.state_dict()]) == \
            json.dumps([j.to_dict(), j.state_dict()])
        assert t.reduce([1.0, 9.0]) == j.reduce([1.0, 9.0])


# -- (c) fan-out and the offer queue ------------------------------------------------

def _stub_server():
    return types.SimpleNamespace(aggregator=types.SimpleNamespace(
        spec=None, device=None))



class _Ctr:
    """Counter stub recording per-kind increments exactly."""

    def __init__(self):
        self.by_kind = {}

    def inc(self, n=1.0, **labels):
        k = labels.get("kind")
        self.by_kind[k] = self.by_kind.get(k, 0) + n


def test_stream_hub_drop_oldest_exact_accounting():
    ctr = _Ctr()
    hub = StreamHub(4, dropped=ctr, depth=4)
    sub = hub.subscribe()
    events = [{"id": i, "kind": "threshold"} for i in range(10)]
    assert hub.publish(events) == 6
    assert ctr.by_kind == {"threshold": 6}
    assert [sub.get(timeout=1.0)["id"] for _ in range(4)] == [6, 7, 8, 9]
    assert sub.get(timeout=0.01) is None
    hub.unsubscribe(sub)
    assert hub.publish(events) == 0
    one = StreamHub(1, dropped=ctr)
    assert one.subscribe() is not None and one.subscribe() is None


def test_offer_backlog_drops_oldest_interval_with_accounting():
    supp = _Ctr()
    eng = tengine.WatchEngine(_stub_server(), suppressed=supp)
    release = threading.Event()
    try:
        eng.register({"name": "bk.a", "threshold": 1})
        eng.register({"name": "bk.b", "threshold": 1, "kind": "delta"})
        entered = threading.Event()
        seen = []

        def stall(state, table, set_shift, ts, hist_seq=None):
            seen.append(ts)
            entered.set()
            release.wait(30)

        eng._evaluate_interval = stall
        eng.offer(None, None, 0, 1)     # the engine thread takes this...
        assert entered.wait(30)         # ...and stalls inside it
        eng.offer(None, None, 0, 2)
        eng.offer(None, None, 0, 3)     # the queue is full
        eng.offer(None, None, 0, 4)     # displaces ts=2: drop-oldest
        assert eng.intervals_skipped == 1
        assert supp.by_kind == {"threshold": 1, "delta": 1}
        release.set()
        _wait(lambda: len(seen) == 3, "backlog not drained")
    finally:
        release.set()
        eng.close()
    assert seen == [1, 3, 4] and eng.intervals_skipped == 1


# -- (d) both Servers ----------------------------------------------------------------

WATCHES = [
    {"name": "app.c0", "threshold": 20, "hysteresis": 5},
    {"prefix": "app.c1", "threshold": 10, "for_intervals": 2},
    {"name": "app.g1", "op": "<", "threshold": 0.0},
    {"match": "app.t*", "kind": "quantile", "quantile": 0.9,
     "threshold": 30, "metric_kinds": ["timer"]},
    {"name": "app.s1", "kind": "cardinality", "threshold": 20},
    {"name": "app.c2", "kind": "delta", "threshold": 2},
    {"name": "app.c3", "kind": "delta", "threshold": 0.5,
     "metric_kinds": ["counter"], "tags": ["env:prod"]},
    {"name": "ghost", "threshold": 1, "no_data_intervals": 2},
]


def _interval_lines(i):
    """_lines(i), with app.c0, app.c1 and app.c2 swung through their
    watches' thresholds."""
    return _lines(i) + [b"app.c0:%d|c" % (30, 0, 12, 40)[i],
                        b"app.c1:%d|c" % (1, 50, 50, 1)[i],
                        b"app.c2:%d|c" % (1, 6, 6, 31)[i]]


def _stream(srv):
    return urllib.request.urlopen(
        f"http://127.0.0.1:{srv.http_port}/watch/stream", timeout=60)


def _register(srv, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.http_port}/watch",
        data=json.dumps(body).encode())
    with urllib.request.urlopen(req, timeout=60) as r:
        assert r.status == 201
        return json.loads(r.read())


def _evaluated(srv, n):
    eng = srv.watch_engine
    _wait(lambda: eng.intervals_evaluated + eng.intervals_skipped >= n,
          f"watch interval {n} not evaluated")


def _listing(srv):
    """The watch listing without the interval timestamps (each server
    stamps its own swap time)."""
    return [{k: v for k, v in w.items() if k != "last_change_ts"}
            for w in srv.watch_engine.list_watches()]


def _same_listing(got, want):
    assert [sorted(w) for w in got] == [sorted(w) for w in want]
    for g, w in zip(got, want):
        for k in w:
            if k == "value" and g["kind"] in ("quantile", "cardinality"):
                _close(g[k], w[k], f"watch {w['id']}", 2e-5, 2e-5)
            else:
                assert g[k] == w[k], (w["id"], k, g[k], w[k])


@pytest.fixture(scope="module")
def servers():
    cfg_kw = dict(SMALL, interval="3600s", **TIERS)
    jsrv = _SyncedJServer(jconfig.Config(**cfg_kw),
                          metric_sinks=[JDebugMetricSink()])
    tsrv = Server(tconfig.Config(**cfg_kw), metric_sinks=[DebugMetricSink()],
                  device="cpu")
    jsrv.start()
    tsrv.start()
    try:
        yield jsrv, tsrv
    finally:
        tsrv.shutdown()
        jsrv.shutdown()


def _drain(sub):
    out = []
    while True:
        ev = sub.get(timeout=0.0)
        if ev is None:
            return out
        out.append(ev)


def test_watch_transitions_match_the_jax_server(servers):
    jsrv, tsrv = servers
    for w in WATCHES:
        assert _register(tsrv, w) == _register(jsrv, w)
    streams = [_stream(srv) for srv in servers]
    subs = [srv.watch_engine.hub.subscribe() for srv in servers]
    try:
        for i in range(4):
            lines = _interval_lines(i)
            for srv in servers:
                _send(srv, lines)
            q = _query(tsrv, {"queries": [
                {"name": "app.c0", "kinds": ["counter"], "tags": []},
                {"name": "app.s1", "kinds": ["set"]},
                {"match": "app.t*", "kinds": ["timer"],
                 "quantiles": [0.9]}]})
            for srv in servers:
                assert srv.trigger_flush(timeout=120)
            for srv in servers:
                _evaluated(srv, i + 1)
            _same_listing(_listing(tsrv), _listing(jsrv))
            # the port's watch values are the query tier's answers for
            # the same interval (one program over the same state)
            got = {w["id"]: w.get("value") for w in _listing(tsrv)}
            assert got[1] == q["results"][0]["matches"][0]["value"]
            assert got[5] == q["results"][1]["matches"][0]["estimate"]
            assert got[4] == max(m["quantiles"]["0.9"]
                                 for m in q["results"][2]["matches"])
        # each server's SSE stream carries exactly what its hub published
        events = []
        for srv, sub, resp in zip(servers, subs, streams):
            published = _drain(sub)
            srv.watch_engine.hub.unsubscribe(sub)
            assert list(cli_watch.tail_events(
                resp, limit=len(published))) == published
            events.append([{k: v for k, v in ev.items() if k != "ts"}
                           for ev in published])
    finally:
        for resp in streams:
            resp.close()
    jev, tev = events
    assert len(tev) == len(jev) >= 6
    for g, w in zip(tev, jev):
        assert sorted(g) == sorted(w)
        for k in w:
            if k == "value" and w["kind"] in ("quantile", "cardinality"):
                _close(g[k], w[k], "event value", 2e-5, 2e-5)
            else:
                assert g[k] == w[k], (k, g, w)
    assert {(e["id"], e["to"]) for e in tev} >= {
        (1, "ALERT"), (1, "OK"), (2, "ALERT"), (6, "ALERT"),
        (8, "NO_DATA")}
    teng = tsrv.watch_engine
    assert teng.launches_total == 4 and teng.intervals_skipped == 0
    for name in ("evaluated", "fired", "suppressed"):
        c_t = getattr(tsrv, f"_c_watch_{name}")
        c_j = getattr(jsrv, f"_c_watch_{name}")
        for kind in tmodel.WATCH_KINDS:
            assert c_t.value(kind=kind) == c_j.value(kind=kind), (name, kind)
    # the delta watches read their baselines from the ring's previous
    # window, which the last flush wrote
    assert tsrv.history.seq == 4


# -- (e) the routes ------------------------------------------------------------------

def _http(srv, path, data=None, method=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.http_port}{path}", data=data, method=method)
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


ROUTES = [("GET", "/watch", None), ("POST", "/watch", b"{}"),
          ("DELETE", "/watch/1", None), ("GET", "/watch/stream", None)]


def test_watch_routes_answer_404_with_the_tier_off():
    srv = Server(tconfig.Config(**SMALL), metric_sinks=[DebugMetricSink()],
                 device="cpu")
    srv.start()
    try:
        assert srv.watch_engine is None
        for method, path, data in ROUTES:
            code, body = _http(srv, path, data, method)
            assert (code, body) == (404, b"watch_enabled is off"), path
    finally:
        srv.shutdown()


@pytest.fixture
def server():
    srv = Server(tconfig.Config(**dict(
        SMALL, interval="3600s", watch_enabled=True, watch_max_active=2,
        watch_stream_max_subscribers=1)),
        metric_sinks=[DebugMetricSink()], device="cpu")
    srv.start()
    try:
        yield srv
    finally:
        srv.shutdown()


def test_watch_routes_codes_and_the_shutdown_gate(server):
    out = _register(server, {"name": "rt.hits", "threshold": 5,
                             "hysteresis": 1, "for_intervals": 2})
    assert out["id"] == 1 and out["threshold"] == 5.0
    code, raw = _http(server, "/watch")
    listed = json.loads(raw)
    assert code == 200 and listed["active"] == 1
    assert listed["watches"][0]["status"] == "OK"
    for data in (b"not json", b"", json.dumps({"threshold": 1}).encode()):
        assert _http(server, "/watch", data)[0] == 400
    assert _http(server, "/watch/seven", method="DELETE")[0] == 400
    _register(server, {"name": "rt.b", "threshold": 1})
    code, body = _http(server, "/watch", json.dumps(
        {"name": "rt.c", "threshold": 1}).encode())
    assert code == 429 and b"watch_max_active=2" in body
    code, raw = _http(server, "/watch/1", method="DELETE")
    assert code == 200 and json.loads(raw) == {"deleted": 1}
    assert _http(server, "/watch/1", method="DELETE")[0] == 404
    assert server.watch_engine.n_active == 1
    resp = _stream(server)
    try:
        code, body = _http(server, "/watch/stream")
        assert (code, body) == (503, b"watch_stream_max_subscribers reached")
    finally:
        resp.close()
    server._shutdown.set()
    try:
        for method, path, data in ROUTES:
            assert _http(server, path, data, method)[0] == 503, path
    finally:
        server._shutdown.clear()


def test_watch_cli_round_trip(server, capsys):
    url = f"http://127.0.0.1:{server.http_port}"
    assert cli_watch.main(["--url", url, "register", "cli.hits",
                           "--threshold", "5", "--hysteresis", "1"]) == 0
    assert "registered watch #1" in capsys.readouterr().out
    assert cli_watch.main(["--url", url, "list"]) == 0
    text = capsys.readouterr().out
    assert "#1" in text and "cli.hits" in text and "> 5" in text
    got, done = [], threading.Event()

    def tailer():
        with cli_watch._request(f"{url}/watch/stream", 60.0) as resp:
            got.extend(cli_watch.tail_events(resp, limit=1))
        done.set()

    t = threading.Thread(target=tailer, daemon=True)
    t.start()
    _wait(lambda: server.watch_engine.hub.n_subscribers == 1,
          "no SSE subscriber")
    _send(server, [b"cli.hits:9|c"])
    assert server.trigger_flush(timeout=60)
    assert done.wait(60)
    assert got[0]["to"] == "ALERT" and got[0]["value"] == 9.0
    assert cli_watch.main(["--url", url, "delete", "1"]) == 0
    assert "deleted watch #1" in capsys.readouterr().out
    assert cli_watch.main(["--url", url, "delete", "1"]) == 1
    assert "404" in capsys.readouterr().err
    ns = types.SimpleNamespace(
        kind="quantile", name=None, prefix="api.", match=None, op=">",
        threshold=250.0, hysteresis=25.0, for_intervals=3,
        no_data_intervals=0, quantile=0.99, metric_kind=["timer"],
        tag=["env:prod"], description="p99 page")
    body = cli_watch.build_registration(ns)
    assert body == jcli_watch.build_registration(ns)
    assert tmodel.parse_watch(body) == jmodel.parse_watch(body)
    assert server._c_watch_evaluated.value(kind="threshold") == 1.0
    assert server._c_watch_fired.value(kind="threshold") == 1.0
    assert server._g_watch_active.value(kind="threshold") == 0.0
    assert server._c_watch_eval_ns.value() > 0
    assert server.watch_engine.dispatch_ns > 0
