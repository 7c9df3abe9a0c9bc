"""The port's Server slice against the JAX package, on the CPU.

- (a) `read_config` gives the same Config (`dataclasses.asdict`) on
  example.yaml, on a YAML with unknown keys, and under VENEUR_* env
  overrides;
- (b) the parser's events, service checks, SSF samples, span conversions
  and tag maps match the JAX package's, case by case;
- (c) `tdigest.add_batch_single` and the registry's timer quantiles match
  the JAX package's (quantiles within rtol 1e-5 / atol 1e-3 ns: the
  compress and the two-float sums reduce f32 in the order their own
  library picks, so a centroid can round one ulp apart);
- (d) the slice as a whole: the JAX Server and the port's Server, each
  with a capturing debug sink, take the same datagrams over loopback
  (metrics of every kind, tags, sample rates, bad lines, service checks,
  events, and an SSF span whose samples the extraction sink turns into
  metrics) and flush the same app InterMetrics (percentiles within
  rtol/atol 2e-5, set estimates within rtol 1e-6, the rest exact) and
  the same events; the second flush holds no app metric. Both ingest
  routes: the C++ engine with its UDP readers (`native_ingest`) and the
  Python parser;
- (e) the registry's veneur.* names, and the families /metrics exposes,
  are the JAX package's less veneur.jax.*;
- (f) the HTTP routes answer with the JAX package's codes, and the routes
  of tiers not ported yet answer 501 naming their ROADMAP item; with
  profile_capture_enabled, GET /debug/profile writes a torch.profiler
  trace;
- (g) each config key outside the slice raises NotImplementedError
  naming its ROADMAP item; pallas_ingest_enabled: false changes nothing
  on the CPU;
- (h) without a card, `Server(cfg)` and `Server(cfg, device="cuda")`
  raise.

The JAX Server runs through a test-side subclass whose aggregators wait
for each JAX step (ROADMAP C-watch 4): on the CPU backend a jit call may
read a reused pack buffer late.
"""

import dataclasses
import json
import os
import socket
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from veneur_tpu import config as jconfig
from veneur_tpu.observability import registry as jregistry
from veneur_tpu.ops import tdigest as jtd
from veneur_tpu.proto import ssf_pb2 as jssf
from veneur_tpu.samplers import parser as jparser
from veneur_tpu.server import server as jserver_mod
from veneur_tpu.server.aggregator import Aggregator as JAggregator
from veneur_tpu.server.native_aggregator import (
    NativeAggregator as JNativeAggregator)
from veneur_tpu.sinks.debug import DebugMetricSink as JDebugMetricSink
from veneur_tpu_torch import config as tconfig
from veneur_tpu_torch.observability import registry as tregistry
from veneur_tpu_torch.ops import tdigest as ttd
from veneur_tpu_torch.proto import ssf_pb2 as tssf
from veneur_tpu_torch.samplers import parser as tparser
from veneur_tpu_torch.server import factory as tfactory
from veneur_tpu_torch.server import httpapi as thttp
from veneur_tpu_torch.server import server as tserver_mod
from veneur_tpu_torch.sinks.debug import DebugMetricSink as TDebugMetricSink

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SMALL = dict(
    interval="10s", hostname="testbox", metric_max_length=4096,
    read_buffer_size_bytes=2097152, percentiles=[0.5, 0.9, 0.99],
    aggregates=["min", "max", "median", "avg", "count", "sum", "hmean"],
    statsd_listen_addresses=["udp://127.0.0.1:0"],
    ssf_listen_addresses=["udp://127.0.0.1:0"],
    http_address="127.0.0.1:0", prometheus_metrics_enabled=True,
    tpu_counter_capacity=256, tpu_gauge_capacity=64,
    tpu_status_capacity=16, tpu_set_capacity=16, tpu_histo_capacity=64,
    tpu_batch_counter=512, tpu_batch_gauge=128, tpu_batch_status=16,
    tpu_batch_set=64, tpu_batch_histo=512, tpu_compact_every=2)


# -- (a) config -----------------------------------------------------------------

def _same_config(path_or_text, env=None, tmp_path=None):
    if tmp_path is not None:
        p = tmp_path / "cfg.yaml"
        p.write_text(path_or_text)
        path_or_text = str(p)
    j = jconfig.read_config(path_or_text, env=env)
    t = tconfig.read_config(path_or_text, env=env)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    return t


def test_read_config_example_yaml_matches_jax():
    cfg = _same_config(os.path.join(REPO, "example.yaml"))
    assert cfg.tpu_counter_capacity == 1 << 17


def test_read_config_unknown_keys_match_jax(tmp_path):
    cfg = _same_config('interval: "5s"\nnot_a_key: 1\nalso_not: [1, 2]\n'
                       'percentiles: [0.5, 0.999]\ntags: ["a:b", "c"]\n',
                       tmp_path=tmp_path)
    assert cfg.unknown_keys == ["also_not", "not_a_key"]


def test_read_config_env_overrides_match_jax(tmp_path):
    env = {"VENEUR_INTERVAL": "3s", "VENEUR_TPUCOUNTERCAPACITY": "4096",
           "VENEUR_PERCENTILES": "0.5,0.99", "VENEUR_NATIVE_INGEST": "false",
           "VENEUR_TAGS": "env:prod,team:x",
           "VENEUR_VENEUR_METRICS_SCOPES": "{counter: global}",
           "VENEUR_CIRCUIT_COOLDOWN_S": "1.5"}
    cfg = _same_config('interval: "10s"\nhostname: h\n', env=env,
                       tmp_path=tmp_path)
    assert (cfg.interval, cfg.tpu_counter_capacity, cfg.native_ingest) == (
        "3s", 4096, False)


# -- (b) the parser ---------------------------------------------------------------

EVENTS = [
    b"_e{5,4}:title|text",
    b"_e{5,4}:title|text|d:1700000000|h:host1|k:agg|p:low|s:src|t:error"
    b"|#env:prod,team:x",
    b"_e{3,11}:abc|line\\nbreaks|d:1700000001|#veneurlocalonly",
    b"_e{0,4}:|text",
    b"_e{5,4}:title|text|x:bad",
    b"_e{5}:title|text",
    b"_e{9,4}:title|text",
]
SERVICE_CHECKS = [
    b"_sc|svc.up|0",
    b"_sc|svc.up|2|d:1700000000|h:host1|#env:prod,team:x|m:all down",
    b"_sc|svc.up|1|#veneurglobalonly,env:dev",
    b"_sc|svc.up|7",
    b"_sc|svc.up",
    b"_sc|svc.up|1|m:msg|#late:tag",
    b"_sc|svc.up|1|z:what",
]


def _sample_fields(s):
    return (s.metric, s.name, s.value, s.timestamp, s.message, s.status,
            s.sample_rate, dict(s.tags), s.unit, s.scope)


def _metric_fields(m):
    return {k: v for k, v in vars(m).items() if not k.startswith("_")}


def _call_both(fn_name, *args, **kw):
    out = []
    for mod in (jparser, tparser):
        try:
            out.append(("ok", getattr(mod, fn_name)(*args, **kw)))
        except mod.ParseError as e:
            out.append(("err", str(e)))
    return out


@pytest.mark.parametrize("packet", EVENTS)
def test_parse_event_matches_jax(packet):
    (jk, jv), (tk, tv) = _call_both("parse_event", packet, now=1234)
    assert jk == tk
    if jk == "ok":
        assert _sample_fields(tv) == _sample_fields(jv)
    else:
        assert tv == jv


@pytest.mark.parametrize("packet", SERVICE_CHECKS)
def test_parse_service_check_matches_jax(packet):
    (jk, jv), (tk, tv) = _call_both("parse_service_check", packet, now=1234)
    assert jk == tk
    if jk == "ok":
        assert _metric_fields(tv) == _metric_fields(jv)
    else:
        assert tv == jv


def _samples(pb):
    S = pb.SSFSample
    return [
        S(metric=S.COUNTER, name="ssf.c", value=3, sample_rate=0.5,
          tags={"a": "b", "veneurlocalonly": ""}),
        S(metric=S.GAUGE, name="ssf.g", value=-1.25, tags={"z": "1"}),
        S(metric=S.HISTOGRAM, name="ssf.h", value=12.5, sample_rate=1.0,
          unit="ms"),
        S(metric=S.SET, name="ssf.s", message="member-1",
          tags={"veneurglobalonly": "true"}),
        S(metric=S.STATUS, name="ssf.st", status=S.CRITICAL,
          message="bad", tags={"svc": "x"}),
        S(metric=S.COUNTER, name="", value=1),
        S(metric=S.GAUGE, name="ssf.zero_rate", value=2, sample_rate=0.0),
    ]


@pytest.mark.parametrize("i", range(7))
def test_parse_metric_ssf_matches_jax(i):
    (jk, jv) = _try(jparser.parse_metric_ssf, _samples(jssf)[i], jparser)
    (tk, tv) = _try(tparser.parse_metric_ssf, _samples(tssf)[i], tparser)
    assert jk == tk
    if jk == "ok":
        assert _metric_fields(tv) == _metric_fields(jv)
        assert tparser.valid_metric(tv) == jparser.valid_metric(jv)


def _try(fn, arg, mod):
    try:
        return "ok", fn(arg)
    except mod.ParseError as e:
        return "err", str(e)


def _span(pb, indicator=True, error=False):
    s = pb.SSFSpan(trace_id=7, id=7, parent_id=0, name="op.get",
                   service="svc", start_timestamp=1_000_000_000,
                   end_timestamp=1_250_000_000, indicator=indicator,
                   error=error, tags={"ssf_objective": "obj"})
    s.metrics.extend(_samples(pb))
    return s


@pytest.mark.parametrize("indicator,error", [(True, False), (True, True),
                                             (False, False)])
def test_span_conversions_match_jax(indicator, error):
    jspan, tspan = _span(jssf, indicator, error), _span(tssf, indicator,
                                                        error)
    jm, jbad = jparser.convert_metrics(jspan)
    tm, tbad = tparser.convert_metrics(tspan)
    assert [_metric_fields(m) for m in tm] == [_metric_fields(m) for m in jm]
    assert [_sample_fields(s) for s in tbad] == [_sample_fields(s)
                                                 for s in jbad]
    for names in (("sli.timer", "slo.timer"), ("sli.timer", ""),
                  ("", "slo.timer")):
        for _ in range(2):      # cold template, then the cached one
            got = tparser.convert_indicator_metrics(tspan, *names)
            want = jparser.convert_indicator_metrics(jspan, *names)
            assert ([_metric_fields(m) for m in got]
                    == [_metric_fields(m) for m in want])
    for _ in range(2):
        got = tparser.convert_span_uniqueness_metrics(tspan, rate=1.0)
        want = jparser.convert_span_uniqueness_metrics(jspan, rate=1.0)
        assert ([_metric_fields(m) for m in got]
                == [_metric_fields(m) for m in want])


@pytest.mark.parametrize("tags", [[], ["a:b"], ["a:b", "c", "d:e:f"],
                                  ["a:1", "a:2", ":x"]])
def test_parse_tags_to_map_matches_jax(tags):
    assert tparser.parse_tags_to_map(tags) == jparser.parse_tags_to_map(tags)


# -- (c) the registry's t-digest -------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_add_batch_single_matches_jax(seed):
    rng = np.random.default_rng(seed)
    jt = jtd.empty_table((), compression=50.0, exact_extremes=16)
    tt = ttd.empty_table((), compression=50.0, exact_extremes=16)
    for n in (1024, 700, 1024):
        vals = np.zeros(1024, np.float32)
        wts = np.zeros(1024, np.float32)
        vals[:n] = rng.lognormal(10.0, 1.0, n)
        wts[:n] = 1.0
        jt = jtd.add_batch_single(jt, vals, wts, compression=50.0,
                                  exact_extremes=16)
        tt = ttd.add_batch_single(tt, vals, wts, compression=50.0,
                                  exact_extremes=16)
    for f in ("min", "max", "count_hi", "count_lo"):
        assert np.asarray(getattr(tt, f)) == np.asarray(getattr(jt, f)), f
    for f in ("sum_hi", "recip_hi"):
        np.testing.assert_allclose(np.asarray(getattr(tt, f)),
                                   np.asarray(getattr(jt, f)), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(tt.weight).sum(),
                               np.asarray(jt.weight).sum(), rtol=0)
    qs = np.asarray([0.5, 0.95, 0.99], np.float32)
    np.testing.assert_allclose(ttd.quantiles(tt, qs).numpy(),
                               np.asarray(jtd.quantiles(jt, qs)),
                               rtol=1e-5, atol=1e-3)


def test_registry_timer_quantiles_match_jax():
    rng = np.random.default_rng(3)
    jr = jregistry.TelemetryRegistry(timer_compression=50.0)
    tr = tregistry.TelemetryRegistry(timer_compression=50.0, device="cpu")
    jt = jr.timer("veneur.x", labelnames=("phase",))
    tt = tr.timer("veneur.x", labelnames=("phase",))
    for v in rng.lognormal(12.0, 0.7, 2500):
        for phase in ("a", "b"):
            jt.observe(float(v) * (1 if phase == "a" else 3), phase=phase)
            tt.observe(float(v) * (1 if phase == "a" else 3), phase=phase)
    jsnap, tsnap = jt.snapshot(), tt.snapshot()
    assert [k for k, _ in tsnap] == [k for k, _ in jsnap] == [("a",),
                                                              ("b",)]
    for (_, ts), (_, js) in zip(tsnap, jsnap):
        assert (ts.count, ts.sum) == (js.count, js.sum)
        assert sorted(ts.quantiles) == sorted(js.quantiles)
        for q in js.quantiles:
            np.testing.assert_allclose(ts.quantiles[q], js.quantiles[q],
                                       rtol=1e-5, atol=1e-3)
    assert tr.flat_values() == jr.flat_values()


# -- (d)-(f) both Servers over loopback -----------------------------------------

class _CapturingJSink(JDebugMetricSink):
    def __init__(self):
        super().__init__()
        self.others = []

    def flush_other_samples(self, samples):
        self.others.extend(samples)


class _CapturingTSink(TDebugMetricSink):
    def __init__(self):
        super().__init__()
        self.others = []

    def flush_other_samples(self, samples):
        self.others.extend(samples)


class _SyncedJNative(JNativeAggregator):
    def _emit_native(self):
        super()._emit_native()
        jax.block_until_ready(self.state)


class _SyncedJAggregator(JAggregator):
    def _on_batch(self, batch):
        super()._on_batch(batch)
        jax.block_until_ready(self.state)


class _SyncedJServer(jserver_mod.Server):
    """The JAX Server with aggregators that wait for each JAX step."""

    def _make_aggregator(self, n_shards, engine=None, spec=None):
        cfg = self.cfg
        args = dict(
            spec=jserver_mod.spec_from_config(cfg),
            bspec=jserver_mod.BatchSpec(
                counter=cfg.tpu_batch_counter, gauge=cfg.tpu_batch_gauge,
                status=cfg.tpu_batch_status, set=cfg.tpu_batch_set,
                histo=cfg.tpu_batch_histo),
            compact_every=cfg.tpu_compact_every)
        if cfg.native_ingest:
            return _SyncedJNative(**args), True
        return _SyncedJAggregator(**args), False


def _traffic(seed):
    """Metric lines of every kind (tags, rates, scope tags, a few bad
    lines), service checks and events, in datagrams of at most ~1,400
    bytes, and the number of lines that are neither events nor SSF."""
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(900):
        k = i % 9
        if k in (0, 1):
            rate = ("|@0.5" if i % 5 == 0 else "")
            tags = ("|#env:prod,team:%d" % (i % 3) if i % 4 == 0 else "")
            lines.append(f"app.c{i % 40}:{1 + i % 7}|c{rate}{tags}")
        elif k == 2:
            lines.append(f"app.g{i % 20}:{rng.normal():.4f}|g")
        elif k in (3, 4):
            v = rng.lognormal(3.0, 0.6)
            tags = "|#route:r%d" % (i % 3) if i % 2 else ""
            lines.append(f"app.t{int(rng.zipf(1.5)) % 12}:{v:.4f}|ms{tags}")
        elif k == 5:
            lines.append(f"app.h{i % 6}:{rng.normal(50, 5):.3f}|h"
                         + ("|#veneurlocalonly" if i % 2 else ""))
        elif k == 6:
            lines.append(f"app.s{i % 5}:u{int(rng.integers(0, 300))}|s")
        elif k == 7:
            lines.append(f"app.d{i % 4}:{rng.normal(0, 1):.4f}|d"
                         "|#veneurglobalonly")
        else:
            lines.append(["bad-line", "app.x:1|q", "app.y:zz|c",
                          f"_sc|app.sc{i % 3}|{i % 3}|#svc:{i % 2}|m:m{i}",
                          f"_e{{2,3}}:t{i % 10}|txt|d:{1700000000 + i}"
                          "|#env:prod"][i % 5])
    n_events = sum(ln.startswith("_e{") for ln in lines)
    grams, cur = [], []
    for ln in lines:
        b = ln.encode()
        if cur and sum(map(len, cur)) + len(cur) + len(b) > 1400:
            grams.append(b"\n".join(cur))
            cur = []
        cur.append(b)
    grams.append(b"\n".join(cur))
    return grams, len(lines) - n_events, n_events


def _span_with_samples(pb):
    S = pb.SSFSample
    # trace id 0: a metrics carrier, not a trace, so the extraction sink
    # takes its samples and samples no uniqueness set from it
    span = pb.SSFSpan(trace_id=0, id=12, parent_id=0, name="op",
                      service="svc", start_timestamp=1_000_000_000,
                      end_timestamp=1_100_000_000)
    span.metrics.extend([
        S(metric=S.COUNTER, name="span.c", value=4, tags={"k": "v"}),
        S(metric=S.HISTOGRAM, name="span.h", value=3.5, unit="ms"),
        S(metric=S.GAUGE, name="span.g", value=2.0)])
    return span


def _seen(srv):
    agg = srv.aggregator
    return (agg.processed + agg.dropped_capacity + srv.parse_errors
            + agg.extra_parse_errors())


def _wait(cond, what, timeout=60.0):
    t0 = time.time()
    while not cond():
        assert time.time() - t0 < timeout, f"{what} after {timeout} s"
        time.sleep(0.02)


def _send(srv, grams, n_lines, n_events, span_pb):
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    base = _seen(srv)
    for g in grams:
        tx.sendto(g, srv.local_addr(0))
    tx.sendto(_span_with_samples(span_pb).SerializeToString(),
              srv.local_addr(1))
    tx.close()
    # every line, the span's three samples, and the events
    _wait(lambda: _seen(srv) >= base + n_lines + 3, "lines not all seen")
    _wait(lambda: len(srv.event_samples) >= n_events, "events not all seen")


def _app(metrics):
    """The flush's app metrics: not the veneur.* self-metrics, nor the
    span-name uniqueness sets the extraction sink samples at 1% from the
    server's own flush spans."""
    return sorted((m for m in metrics if not m.name.startswith("veneur.")
                   and m.name != "ssf.names_unique"),
                  key=lambda m: (m.name, tuple(m.tags), m.type))


def _assert_same_intermetrics(got, want):
    """As tests/test_torch_native.py holds flushes, but for the timestamp:
    each server stamps its own swap time, and the two flush apart."""
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert (g.name, g.tags, g.type, g.message, g.hostname, g.sinks) == (
            w.name, w.tags, w.type, w.message, w.hostname, w.sinks)
        assert abs(g.timestamp - w.timestamp) <= 60
        tail = g.name.rsplit(".", 1)[-1]
        if tail.endswith("percentile") or tail == "median":
            np.testing.assert_allclose(g.value, w.value, rtol=2e-5,
                                       atol=2e-5, err_msg=g.name)
        elif g.name.startswith("app.s"):
            np.testing.assert_allclose(g.value, w.value, rtol=1e-6,
                                       err_msg=g.name)
        else:
            assert g.value == w.value, (g.name, g.value, w.value)


@pytest.fixture(scope="module", params=["native", "python"])
def servers(request):
    # no ticker flush within the module: every flush is the test's
    cfg_kw = dict(SMALL, interval="3600s",
                  native_ingest=request.param == "native",
                  profile_capture_enabled=True)
    jsink, tsink = _CapturingJSink(), _CapturingTSink()
    jsrv = _SyncedJServer(jconfig.Config(**cfg_kw), metric_sinks=[jsink])
    tsrv = tserver_mod.Server(tconfig.Config(**cfg_kw),
                              metric_sinks=[tsink], device="cpu")
    jsrv.start()
    tsrv.start()
    try:
        yield request.param, (jsrv, jsink), (tsrv, tsink)
    finally:
        tsrv.shutdown()
        jsrv.shutdown()


def test_servers_flush_the_same_app_intermetrics(servers):
    route, (jsrv, jsink), (tsrv, tsink) = servers
    assert tsrv._native_readers_active == (route == "native")
    grams, n_lines, n_events = _traffic(1)
    _send(jsrv, grams, n_lines, n_events, jssf)
    _send(tsrv, grams, n_lines, n_events, tssf)
    for attr in ("processed", "dropped_capacity"):
        assert getattr(tsrv.aggregator, attr) == getattr(jsrv.aggregator,
                                                         attr), attr
    assert _seen(tsrv) == _seen(jsrv)
    assert tsrv.packets_received == jsrv.packets_received == len(grams)
    assert tsrv.packets_dropped == jsrv.packets_dropped == 0
    for sink in (jsink, tsink):
        sink.flushed.clear()
        sink.others.clear()
    assert jsrv.trigger_flush(timeout=120)
    assert tsrv.trigger_flush(timeout=120)
    got, want = _app(tsink.flushed), _app(jsink.flushed)
    _assert_same_intermetrics(got, want)
    kinds = {m.type for m in got}
    assert kinds == {"counter", "gauge", "status"}, kinds
    assert any(m.name == "span.c" for m in got)
    assert len(tsink.others) == len(jsink.others) == n_events
    assert ([_sample_fields(s) for s in tsink.others]
            == [_sample_fields(s) for s in jsink.others])
    # the second interval carries no app metric, only self-telemetry
    for sink in (jsink, tsink):
        sink.flushed.clear()
    assert jsrv.trigger_flush(timeout=120)
    assert tsrv.trigger_flush(timeout=120)
    assert _app(tsink.flushed) == _app(jsink.flushed) == []
    assert any(m.name == "veneur.flush.metrics_total" for m in tsink.flushed)


def _get(port, path, method="GET", body=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=body, method=method)
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _families(exposition: bytes):
    return {ln.split()[2] for ln in exposition.decode().splitlines()
            if ln.startswith("# TYPE")}


def test_self_metric_names_are_the_jax_names_less_jax_compiles(servers):
    _route, (jsrv, _), (tsrv, _) = servers
    jnames = [n for n in jsrv.metrics.names() if n.startswith("veneur.")]
    assert any(n.startswith("veneur.jax.") for n in jnames)
    assert tsrv.metrics.names() == [n for n in jnames
                                    if not n.startswith("veneur.jax.")]
    jcode, jbody = _get(jsrv.http_port, "/metrics")
    tcode, tbody = _get(tsrv.http_port, "/metrics")
    assert jcode == tcode == 200
    assert _families(tbody) == {f for f in _families(jbody)
                                if not f.startswith("veneur_jax_")}


SAME_CODE_ROUTES = [("GET", p) for p in (
    "/healthcheck", "/healthz", "/readyz", "/healthcheck/tracing",
    "/version", "/builddate", "/stats", "/metrics", "/debug/pprof/threads",
    "/debug/pprof/profile?seconds=0.05", "/debug/pprof/profile?seconds=x",
    "/debug/profile?seconds=-1", "/debug/profilez", "/nope",
    "/quitquitquit")] + [("POST", "/quitquitquit"), ("POST", "/nope"),
                         ("DELETE", "/nope")]


def test_http_routes_answer_as_the_jax_server(servers):
    _route, (jsrv, _), (tsrv, _) = servers
    for method, path in SAME_CODE_ROUTES:
        jcode, _ = _get(jsrv.http_port, path, method)
        tcode, _ = _get(tsrv.http_port, path, method)
        assert tcode == jcode, (method, path, tcode, jcode)
    code, body = _get(tsrv.http_port, "/stats")
    stats = json.loads(body)
    assert stats["processed"] == tsrv.aggregator.processed
    for (method, path), item in thttp.NOT_PORTED_ROUTES.items():
        if path.endswith("/"):
            path += "3"
        code, body = _get(tsrv.http_port, path, method, body=b"{}"
                          if method == "POST" else None)
        assert code == 501, (method, path, code)
        assert f"ROADMAP {item}".encode() in body, body


def test_debug_profile_writes_a_torch_profiler_trace(servers):
    _route, _, (tsrv, _) = servers
    code, body = _get(tsrv.http_port, "/debug/profile?seconds=0.2")
    assert code == 200, body
    out = json.loads(body)
    with open(os.path.join(out["trace_dir"], "trace.json")) as f:
        trace = json.load(f)
    assert "traceEvents" in trace


# -- (g), (h) what the slice refuses ---------------------------------------------

REFUSED = {
    "history_enabled": True, "query_enabled": True, "watch_enabled": True,
    "grpc_address": "127.0.0.1:0", "checkpoint_dir": "ckpt",
    "forward_address": "127.0.0.1:9", "forward_spill_max_bytes": 1,
    "forward_dedup_window": 8, "collective_enabled": True,
    "collective_attach": "default", "tpu_n_shards": 2,
    "table_grow_enabled": True, "reshard_enabled": True,
    "tag_frequency_enabled": True, "overload_enabled": True,
    "tenant_enabled": True,
}


def test_every_refused_key_is_listed():
    assert sorted(REFUSED) == sorted(k for k, _f, _i in
                                     tserver_mod.NOT_PORTED)


@pytest.mark.parametrize("key,item", [(k, i) for k, _f, i in
                                      tserver_mod.NOT_PORTED])
def test_keys_outside_the_slice_raise_naming_their_roadmap_item(key, item):
    cfg = tconfig.Config(**dict(SMALL, **{key: REFUSED[key]}))
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        tserver_mod.Server(cfg, device="cpu")


SINK_KEYS = {
    "datadog_api_key": dict(datadog_api_key="k",
                            datadog_api_hostname="https://x"),
    "signalfx_api_key": dict(signalfx_api_key="k"),
    "splunk_hec_address": dict(splunk_hec_address="https://x",
                               splunk_hec_token="t"),
    "datadog_trace_api_address": dict(datadog_trace_api_address="x"),
    "xray_address": dict(xray_address="x:1", xray_sample_percentage=5.0),
    "falconer_address": dict(falconer_address="x:1"),
    "grpsink_address": dict(grpsink_address="x:1"),
    "kafka_broker": dict(kafka_broker="x:1", kafka_metric_topic="m"),
    "lightstep_access_token": dict(lightstep_access_token="t"),
    "aws_s3_bucket": dict(aws_s3_bucket="b", aws_region="r"),
}


@pytest.mark.parametrize("key", sorted(SINK_KEYS))
def test_sinks_outside_the_slice_raise(key):
    assert {k for k, _f, _w in tfactory.SINKS_NOT_PORTED} == set(SINK_KEYS)
    cfg = tconfig.Config(**dict(SMALL, **SINK_KEYS[key]))
    with pytest.raises(NotImplementedError, match="ROADMAP A12"):
        tfactory.new_from_config(cfg, device="cpu")


def test_pallas_ingest_key_changes_nothing_on_the_cpu():
    cfg = tconfig.Config(**dict(SMALL, pallas_ingest_enabled=False,
                                http_address=""))
    srv = tserver_mod.Server(cfg, device="cpu")
    assert srv.device.type == "cpu"


@pytest.mark.parametrize("device", [None, "cuda"])
def test_server_without_a_card_raises(device):
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tserver_mod.Server(tconfig.Config(**SMALL), device=device)
