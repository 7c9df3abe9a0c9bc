"""The port's overload controller and its Server wiring against the JAX
package, on the CPU.

- (a) the controller: one injected clock and one scripted signal source
  drive both packages' OverloadController (with a TenantFairness under
  it) through the same state sequence; every poll's state and pressure,
  every admit and import decision, the degradation knobs, the native
  admission push-down tuple, the per-class and per-tenant counts and the
  transition log are equal, exactly;
- (b) /healthz and /readyz on both Servers through one forced pressure
  script (polls driven by the test, hold_s 0): the same codes and
  overload states at every step, /healthz 200 throughout;
- (c) CRITICAL flush protection: both Servers ingest the same datagrams
  while HEALTHY, are forced to CRITICAL and flush; their app
  InterMetrics are equal (only the `shed_priority_tags` rows), and so
  are the `flush` shed counts and the degraded-flush counts;
- (d) query, import and watch shedding at CRITICAL: POST /query and both
  POST /import bodies answer 503 on both Servers, import_metrics sheds
  (False), a watch evaluation is skipped and counted as suppressed, with
  the same counts;
- (e) the degraded set shift: both Servers (Python path, where members
  are subsampled) are driven into SHEDDING by the real poller, which
  pushes the shift; the degraded flush's set estimates match the JAX
  package's within rtol 1e-6 (the HLL estimator's f32 sum order) and
  equal, exactly, the port's own undegraded flush of the admitted
  members times 2^shift.

No test leans on wall-clock admission timing: buckets run on the
injected clock, and the Servers' states are forced through the
controller's signal source.
"""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest

from tests.test_torch_import import _DropSpans
from tests.test_torch_server import (SMALL, _app,
                                     _assert_same_intermetrics,
                                     _CapturingJSink, _CapturingTSink,
                                     _seen, _SyncedJServer, _wait)
from veneur_tpu import config as jconfig
from veneur_tpu.reliability import overload as jov
from veneur_tpu.reliability import tenancy as jten
from veneur_tpu_torch import config as tconfig
from veneur_tpu_torch.forward import jsonmetric as tjson
from veneur_tpu_torch.proto import forwardrpc_pb2 as fpb
from veneur_tpu_torch.proto import metricpb_pb2 as mpb
from veneur_tpu_torch.reliability import overload as tov
from veneur_tpu_torch.reliability import tenancy as tten
from veneur_tpu_torch.server import server as tserver_mod
from veneur_tpu_torch.utils.hashing import fnv1a_64

PKGS = {"jax": (jov, jten), "torch": (tov, tten)}


class VClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


# (seconds advanced, pressure signals) per poll; None makes the signal
# source raise, which holds the last pressure for that tick
SCRIPTS = {
    "ladder": [(0.1, {"q": 0.2}), (0.1, {"q": 0.75}), (0.1, {"q": 0.9}),
               (0.1, {"q": 0.97, "r": 0.1}), (0.5, {"q": 0.97}),
               (2.0, {"q": 0.5}), (2.0, {"q": 0.5}), (0.2, {"q": 0.1}),
               (2.0, {}), (2.0, {}), (2.0, {})],
    "hover": [(0.1, {"q": 0.86}), (0.3, {"q": 0.84}), (3.0, {"q": 0.80}),
              (3.0, {"q": 0.74}), (0.1, {"q": 0.86}), (3.0, {"q": 0.60}),
              (3.0, {"q": 0.60}), (3.0, {"q": 0.0})],
    "broken": [(0.1, {"q": 0.9}), (0.1, None), (3.0, None),
               (3.0, {"q": 0.96}), (0.2, None), (3.0, {"q": 0.0}),
               (3.0, {"q": 0.0}), (3.0, {"q": 0.0}), (3.0, {"q": 0.0})],
}

_DATAGRAMS = [b"app.low:1|c|#tenant:acme", b"app.low:1|c|#tenant:blue",
              b"app.hi:1|c|#prio:high,tenant:acme", b"app.u:1|c",
              b"veneur.self:1|c|#tenant:acme", b"app.hi:2|c|#prio:high",
              b"app.low:3|ms|#tenant:acme", b"app.s:x|s|#tenant:dex"]


def _run_script(pkg, script):
    ov_mod, ten_mod = PKGS[pkg]
    clk = VClock()
    cur = {"sig": {}}

    def signals():
        if cur["sig"] is None:
            raise RuntimeError("signal source down")
        return cur["sig"]

    ten = ten_mod.TenantFairness(base_rate=4.0, weights={"acme": 2.0},
                                 burst_mult=1.5, clock=clk)
    ov = ov_mod.OverloadController(
        signals=signals, hold_s=1.0, admit_rate=6.0, admit_burst=4.0,
        timer_sample_rate=0.25, set_shift=3,
        shed_priority_tags=["prio:high"], tenancy=ten, clock=clk)
    trace = []
    for step, (dt, sig) in enumerate(script):
        clk.t += dt
        cur["sig"] = sig
        state = ov.poll()
        row = [state, ov.state_name, ov.pressure,
               ov.degraded_timer_rate(), ov.degraded_set_shift(),
               ov.import_blocked(), ov.native_admission_params()]
        for k in range(3 * len(_DATAGRAMS)):
            clk.t += 0.01
            row.append(ov.admit(_DATAGRAMS[(k + step) % len(_DATAGRAMS)]))
        row.append(ov.admit_import(step + 1))
        ov.count_flush_shed(step % 3)
        trace.append(row)
    ov.fold_native_counts({"admitted": {"low": 5}, "shed": {"high": 2},
                           "tenants": {"blue": {"admitted": {"low": 5},
                                                "demoted_rows": 1}}})
    return dict(trace=trace, admitted=dict(ov.admitted),
                shed=dict(ov.shed), shed_snapshot=ov.shed_snapshot(),
                admitted_total=ov.admitted_total,
                transitions=list(ov.transitions),
                tenant_admitted=ten.admitted, tenant_shed=ten.shed,
                tenant_rows=ten.demoted_rows_snapshot())


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_controller_matches_jax_decision_for_decision(script):
    want = _run_script("jax", SCRIPTS[script])
    got = _run_script("torch", SCRIPTS[script])
    assert got == want
    states = {row[0] for row in got["trace"]}
    assert len(states) >= 2 and got["transitions"]


def test_controller_admission_ladder_by_state():
    """The ladder itself, on the port: HEALTHY admits all, SHEDDING sheds
    low-priority (no tenancy), CRITICAL meters high through its bucket
    and blocks imports, self-metrics are never shed."""
    clk = VClock()
    sig = {"q": 0.0}
    ov = tov.OverloadController(signals=lambda: dict(sig), hold_s=0.0,
                                admit_rate=2.0, admit_burst=2.0,
                                shed_priority_tags=["prio:high"],
                                clock=clk)
    low, high, own = b"a:1|c", b"a:1|c|#prio:high", b"veneur.x:1|c"
    assert ov.poll() == tov.HEALTHY and ov.admit(low)
    sig["q"] = 0.9
    assert ov.poll() == tov.SHEDDING
    assert not ov.admit(low) and ov.admit(high) and ov.admit(own)
    assert ov.degraded_set_shift() == 2 and ov.degraded_timer_rate() == 0.5
    sig["q"] = 0.99
    assert ov.poll() == tov.CRITICAL
    assert [ov.admit(high) for _ in range(4)] == [True, True, False, False]
    assert ov.admit(own) and not ov.admit_import(7)
    assert ov.shed == {"low": 1, "high": 2, "import": 7}
    assert ov.admitted == {"low": 1, "high": 3, "self": 2}


# -- both Servers -----------------------------------------------------------

def _overload_kw(**kw):
    base = dict(SMALL, statsd_listen_addresses=[], ssf_listen_addresses=[],
                overload_enabled=True, overload_poll_interval_s=3600.0,
                overload_hold_s=0.0, shed_priority_tags=["prio:high"])
    base.update(kw)
    return base


def _start(pkg, **kw):
    if pkg == "jax":
        sink = _CapturingJSink()
        srv = _SyncedJServer(jconfig.Config(**kw), metric_sinks=[sink])
    else:
        sink = _CapturingTSink()
        srv = tserver_mod.Server(tconfig.Config(**kw), metric_sinks=[sink],
                                 device="cpu")
    # the servers' own spans loop back into their pipelines at times the
    # threads set; drop them so both flush the same rows
    srv.trace_client.backend = _DropSpans()
    srv.start()
    return srv, sink


def _pair(**kw):
    out = {}
    try:
        for pkg in ("jax", "torch"):
            out[pkg] = _start(pkg, **kw)
    except BaseException:
        for srv, _ in out.values():
            srv.shutdown()
        raise
    return out


def _close(pair):
    for srv, _ in pair.values():
        srv.shutdown()


def _http(port, path, body=None, headers=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=body, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=20) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _force(srv, pressure):
    srv._overload._signals = lambda: {"forced": pressure}
    return srv._overload.poll()


def _feed(srv, grams):
    base = _seen(srv)
    n = sum(g.count(b"\n") + 1 for g in grams)
    for g in grams:
        srv.packet_queue.put(g)
    _wait(lambda: _seen(srv) >= base + n, "datagrams not all seen")


def test_healthz_readyz_lifecycle_matches_jax():
    pair = _pair(**_overload_kw())
    try:
        script = [0.0, 0.75, 0.9, 0.99, 0.2, 0.2, 0.2, 0.2]
        seen = {}
        for pkg, (srv, _) in pair.items():
            rows = []
            for p in script:
                state = _force(srv, p)
                hc, _ = _http(srv.http_port, "/healthz")
                rc, body = _http(srv.http_port, "/readyz")
                rows.append((state, hc, rc,
                             json.loads(body)["overload_state"]))
            seen[pkg] = rows
        assert seen["torch"] == seen["jax"]
        assert {hc for _, hc, _, _ in seen["torch"]} == {200}
        assert [rc for _, _, rc, _ in seen["torch"]] == [
            200, 200, 503, 503, 503, 200, 200, 200]
    finally:
        _close(pair)


def _protect_grams():
    """Low-priority and prio:high rows in separate datagrams (a datagram
    classifies by its strongest line)."""
    grams = []
    for i in range(12):
        grams.append(b"app.low%d:%d|c" % (i % 4, i + 1))
        grams.append(b"app.keep%d:%d|c|#prio:high" % (i % 3, i + 2))
        grams.append(b"app.t%d:%d|ms|#prio:high,env:x"
                     % (i % 2, 5 * i + 3))
        grams.append(b"app.g%d:%d.5|g" % (i % 2, i))
    return grams


def test_critical_flush_protection_matches_jax():
    pair = _pair(**_overload_kw())
    try:
        out = {}
        for pkg, (srv, sink) in pair.items():
            _feed(srv, _protect_grams())          # admitted while HEALTHY
            assert _force(srv, 0.99) == tov.CRITICAL
            assert srv.trigger_flush(timeout=120)
            ov = srv._overload
            out[pkg] = (_app(sink.flushed), dict(ov.shed),
                        ov.degraded_flushes)
        (tm, tshed, tdeg), (jm, jshed, jdeg) = out["torch"], out["jax"]
        _assert_same_intermetrics(tm, jm)
        assert {m.name.split(".")[1][:4] for m in tm} == {"keep", "t0", "t1"}
        assert tshed == jshed and tshed["flush"] == 4 + 2  # 4 low + 2 g
        assert tdeg == jdeg == 1
    finally:
        _close(pair)


def _import_bodies():
    """A JSONMetric body and a protobuf MetricList body of one counter."""
    m = mpb.Metric(name="imp.c", type=mpb.Counter, scope=mpb.Global)
    m.counter.value = 4
    return (json.dumps(tjson.to_json_metrics([m])).encode(),
            fpb.MetricList(metrics=[m]).SerializeToString())


def test_query_import_and_watch_shed_at_critical_match_jax():
    jbody, pbody = _import_bodies()
    pair = _pair(**_overload_kw(query_enabled=True, watch_enabled=True))
    try:
        out = {}
        for pkg, (srv, sink) in pair.items():
            code, _ = _http(srv.http_port, "/watch", json.dumps(
                {"name": "app.low0", "op": ">", "threshold": 1}).encode())
            assert code in (200, 201)
            _feed(srv, [b"app.low0:3|c"])
            assert _force(srv, 0.99) == tov.CRITICAL
            q = _http(srv.http_port, "/query",
                      json.dumps({"name": "app.low0"}).encode())
            imp = (_http(srv.http_port, "/import", jbody,
                         {"Content-Type": "application/json"})[0],
                   _http(srv.http_port, "/import", pbody,
                         {"Content-Type": "application/x-protobuf"})[0])
            shed_import = srv.import_metrics([])
            assert srv.trigger_flush(timeout=120)
            _wait(lambda: srv.watch_engine.intervals_skipped >= 1,
                  "watch interval not skipped")
            out[pkg] = (q[0], imp, shed_import,
                        srv._c_query_shed.value(),
                        dict(srv._overload.shed),
                        srv.watch_engine.intervals_skipped,
                        sorted(srv._c_watch_suppressed.samples()))
        assert out["torch"] == out["jax"]
        assert out["torch"][:3] == (503, (503, 503), False)
    finally:
        _close(pair)


def _set_line(i):
    # prio:high: SHEDDING sheds low-priority datagrams at admission
    return b"deg.s%d:m-%d|s|#prio:high" % (i % 3, i)


def _set_grams(n):
    return [b"\n".join(_set_line(i) for i in range(k, min(k + 40, n)))
            for k in range(0, n, 40)]


def _set_estimates(metrics):
    return {m.name: m.value for m in _app(metrics)
            if m.name.startswith("deg.s")}


def test_degraded_set_shift_correction_matches_jax():
    n, shift = 1200, 2
    kw = _overload_kw(native_ingest=False, overload_poll_interval_s=0.05,
                      overload_set_shift=shift, tpu_set_capacity=16)
    pair = _pair(**kw)
    try:
        degraded = {}
        for pkg, (srv, sink) in pair.items():
            ov = srv._overload
            ov._signals = lambda: {"forced": 0.9}
            _wait(lambda: srv.aggregator.pending_set_shift == shift,
                  "the poller did not push the set shift")
            assert srv.trigger_flush(timeout=120)   # latches the shift
            sink.flushed.clear()
            _feed(srv, _set_grams(n))
            assert srv.aggregator.degraded_set_skipped > 0
            assert srv.trigger_flush(timeout=120)
            degraded[pkg] = _set_estimates(sink.flushed)
            assert ov.degraded_flushes >= 1
    finally:
        _close(pair)
    got, want = degraded["torch"], degraded["jax"]
    assert sorted(got) == sorted(want) == ["deg.s0", "deg.s1", "deg.s2"]
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-6, atol=0)
    # the port's own undegraded flush of the members the shift admitted
    admitted = [i for i in range(n)
                if not fnv1a_64(b"m-%d" % i) & ((1 << shift) - 1)]
    srv, sink = _start("torch", **_overload_kw(native_ingest=False,
                                               tpu_set_capacity=16))
    try:
        _feed(srv, [_set_line(i) for i in admitted])
        assert srv.trigger_flush(timeout=120)
        plain = _set_estimates(sink.flushed)
    finally:
        srv.shutdown()
    assert {k: v * (1 << shift) for k, v in plain.items()} == got
    assert sum(got.values()) == pytest.approx(n, rel=0.25)
