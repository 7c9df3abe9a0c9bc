"""The port's forward tier against the JAX package, on the CPU.

- (a) `DedupWindow` gives the JAX window's verdicts for the same
  envelope sequences, and `mint_source_id` ids validate in both packages;
- (b) `ForwardSpillBuffer.to_bytes` is the JAX buffer's byte for byte,
  for legacy (v1-era) entries and enveloped units, under the same cap,
  age and readd accounting, and either package parses the other's bytes;
- (c) local → proxy → two globals, all port Servers, flushes what the
  same topology of JAX Servers flushes, over gRPC and over HTTP: every
  key on one global, counters, gauges and digest sums exact, set
  estimates within rtol 1e-6 (C-watch 7), quantiles within rtol/atol
  2e-5;
- (d) exactly-once: an ack lost after the fold is re-sent under its seq
  and suppressed (counters exact, dup_suppressed equal in both
  packages); a restart replays the pending unit under its old epoch,
  across the packages in both directions; a bad forward address never
  blocks the local flush.

The tiers are fed in a fixed order: each local takes its lines as one
buffer on its pipeline queue, each forwarded unit is folded before the
globals flush, and the globals' self-telemetry stays out of their
pipelines, so no step boundary moves with thread timing
(tests/test_torch_import.py). The JAX Servers are the test-side synced
subclass (ROADMAP C-watch 4).
"""

import struct
import time

import numpy as np
import pytest

from tests.test_torch_import import _DropSpans
from tests.test_torch_server import _SyncedJServer, _wait
from veneur_tpu import config as jconfig
from veneur_tpu.forward import discovery as jdiscovery
from veneur_tpu.forward import envelope as jenvelope
from veneur_tpu.forward import proxysrv as jproxysrv
from veneur_tpu.proto import metricpb_pb2 as jmpb
from veneur_tpu.reliability import faults as jfaults
from veneur_tpu.reliability import spill as jspill
from veneur_tpu.sinks.debug import DebugMetricSink as JDebugMetricSink
from veneur_tpu_torch import config as tconfig
from veneur_tpu_torch.forward import discovery as tdiscovery
from veneur_tpu_torch.forward import envelope as tenvelope
from veneur_tpu_torch.forward import proxysrv as tproxysrv
from veneur_tpu_torch.persistence import restore_spill
from veneur_tpu_torch.proto import metricpb_pb2 as mpb
from veneur_tpu_torch.reliability import faults as tfaults
from veneur_tpu_torch.reliability import spill as tspill
from veneur_tpu_torch.server import server as tserver_mod
from veneur_tpu_torch.sinks.debug import DebugMetricSink

SIDS = ["0123456789abcdef0123456789abcdef",
        "fedcba9876543210fedcba9876543210",
        "00000000000000000000000000000abc"]
FAULTS = {"jax": jfaults.FAULTS, "torch": tfaults.FAULTS}


@pytest.fixture(autouse=True)
def _clean_faults():
    for f in FAULTS.values():
        f.reset()
    yield
    for f in FAULTS.values():
        f.reset()


# -- (a) the dedup window --------------------------------------------------------

def _run_window(env, ops, **kw):
    """Apply ('observe'|'peek'|'mark', sid, epoch, seq) ops to a window of
    `env`'s package; the verdicts (or 'error'), evictions and snapshot."""
    w = env.DedupWindow(**kw)
    out = []
    for op, sid, epoch, seq in ops:
        if op == "restore":
            w2 = env.DedupWindow(**kw)
            out.append(w2.restore(w.snapshot()))
            w = w2
            continue
        try:
            out.append(getattr(w, op)(env.Envelope(SIDS[sid], epoch, seq)))
        except env.EnvelopeError:
            out.append("error")
    return out, w.evictions, w.snapshot(), len(w)


def _obs(*seqs, sid=0, epoch=0):
    return [("observe", sid, epoch, s) for s in seqs]


WINDOW_CASES = {
    "fresh-duplicate-stale": (dict(window=4),
                              _obs(0, 0, 1, 2, 3, 4, 5, 1, 3, 5)),
    "out-of-order": (dict(window=8), _obs(5, 3, 3, 7, 6, 5, 0, 0)),
    "epochs": (dict(window=4),
               _obs(0, 1) + _obs(0, 1, epoch=1) + _obs(0, 2)
               + _obs(1, epoch=1)),
    "migration-replay": (dict(window=256),
                         _obs(0, 1) + _obs(0, 1, 2, 3)
                         + _obs(0, 1, 2, 3, epoch=1)),
    "oversized-skip": (dict(window=4, max_skip=16),
                       _obs(17, 0, 18, 0, 16, 16)),
    "peek-then-mark": (dict(window=8),
                       [("peek", 0, 0, 3), ("peek", 0, 0, 3),
                        ("mark", 0, 0, 3), ("peek", 0, 0, 3),
                        ("observe", 0, 0, 3)]),
    "snapshot-restore": (dict(window=8, max_sources=4),
                         _obs(0, 1) + _obs(7, sid=1)
                         + [("restore", 0, 0, 0)] + _obs(1, 2)
                         + _obs(7, 8, sid=1)),
    "lru-eviction": (dict(window=8, max_sources=2),
                     _obs(0) + _obs(0, sid=1) + _obs(0, sid=2)
                     + _obs(0) + _obs(0, sid=1)),
}


@pytest.mark.parametrize("case", sorted(WINDOW_CASES))
def test_dedup_window_verdicts_match_jax(case):
    kw, ops = WINDOW_CASES[case]
    got = _run_window(tenvelope, ops, **kw)
    assert got == _run_window(jenvelope, ops, **kw)
    assert got[0] and all(v in (tenvelope.FRESH, tenvelope.DUPLICATE,
                                tenvelope.STALE, "error", None)
                          or isinstance(v, int) for v in got[0])


def test_minted_source_ids_validate_in_both_packages():
    ids = {tenvelope.mint_source_id() for _ in range(64)}
    assert len(ids) == 64
    for sid in list(ids)[:8] + [jenvelope.mint_source_id()]:
        for env in (tenvelope, jenvelope):
            e = env.Envelope(sid, 2, 9).validate()
            assert env.Envelope.from_mapping(dict(e.to_metadata())) == e
    assert (tenvelope.FRESH, tenvelope.DUPLICATE, tenvelope.STALE) == (
        jenvelope.FRESH, jenvelope.DUPLICATE, jenvelope.STALE)


# -- (b) the spill ------------------------------------------------------------------

class _Clock:
    def __init__(self):
        self.t = 1_000_000.0

    def __call__(self):
        return self.t


def _spill_metric(pkg_mpb, i):
    m = pkg_mpb.Metric(name=f"sp.m{i}", tags=[f"t:{i % 3}"],
                       type=pkg_mpb.Counter, scope=pkg_mpb.Global)
    m.counter.value = i * 3 + 1
    return m


def _spill_ops(spill, pkg_mpb, case):
    """Run one op sequence on a fresh buffer of `spill`'s package."""
    clk = _Clock()
    cap = 180 if case == "cap" else 1 << 20
    buf = spill.ForwardSpillBuffer(cap, max_age_s=30.0, clock=clk)
    M = [_spill_metric(pkg_mpb, i) for i in range(12)]
    seen = []
    if case in ("legacy", "mixed"):
        buf.add(M[0:3])
        clk.t += 20
        buf.add(M[3:5])
        clk.t += 15                      # the first three pass max_age_s
        drained = buf.drain()
        seen.append([(ts, m.name) for ts, m in drained])
        buf.readd(drained)
        buf.add(M[5:6])
    if case in ("units", "mixed", "cap"):
        for seq in range(4):
            buf.add_unit(M[6 + seq:8 + seq], epoch=1, seq=seq)
            clk.t += 10
        seen.append(buf.ack(1, 1))
        seen.append(buf.ack(1, 1))
        seen.append([(u.epoch, u.seq, u.staged_at, [m.name for m in
                                                     u.metrics])
                     for u in buf.pending_units()])
    if case == "mixed":
        seen.append([m.name for _, m in buf.take_legacy()])
        buf.add(M[11:12])
    seen.append((len(buf), buf.bytes, buf.spilled_total,
                 buf.dropped_capacity, buf.dropped_age))
    return buf.to_bytes(), seen


@pytest.mark.parametrize("case", ["legacy", "units", "mixed", "cap"])
def test_spill_bytes_and_accounting_match_jax(case):
    tb, tseen = _spill_ops(tspill, mpb, case)
    jb, jseen = _spill_ops(jspill, jmpb, case)
    assert tb == jb and tb.startswith(b"VSPL2")
    assert tseen == jseen
    # either package parses the other's bytes to the same entries
    for parse in (tspill.parse_spill_bytes, jspill.parse_spill_bytes):
        entries, caps = parse(jb, with_envelope=True)
        assert [(ts, m.SerializeToString(), e, s)
                for ts, m, e, s in entries] == [
            (ts, m.SerializeToString(), e, s) for ts, m, e, s in
            tspill.parse_spill_bytes(tb, with_envelope=True)[0]]
    assert tspill.ForwardSpillBuffer.from_bytes(jb).to_bytes() == jb
    assert jspill.ForwardSpillBuffer.from_bytes(tb).to_bytes() == tb
    # restore_spill re-seeds a configured buffer with the same units
    buf = tspill.ForwardSpillBuffer(1 << 20, max_age_s=1e9)
    assert restore_spill(buf, jb) == len(
        jspill.parse_spill_bytes(jb)[0])
    header = len(b"VSPL2") + struct.calcsize("<qd")   # the caps differ
    assert buf.to_bytes()[header:] == jb[header:]


def test_v1_spill_bytes_parse_as_legacy_in_both_packages():
    now = 1_700_000_000.5
    blob = _spill_metric(mpb, 9).SerializeToString()
    data = (b"VSPL1" + struct.Struct("<qdI").pack(1 << 20, 123.0, 1)
            + struct.Struct("<dI").pack(now, len(blob)) + blob)
    for spill in (tspill, jspill):
        entries, caps = spill.parse_spill_bytes(data, with_envelope=True)
        assert caps == (1 << 20, 123.0)
        [(ts, m, epoch, seq)] = entries
        assert (ts, epoch, seq, m.SerializeToString()) == (now, -1, -1,
                                                           blob)
    buf = tspill.ForwardSpillBuffer(1 << 20, max_age_s=1e12)
    buf.restore_entries(tspill.parse_spill_bytes(data, True)[0])
    assert len(buf) == 1 and not buf.pending_units()
    jbuf = jspill.ForwardSpillBuffer(1 << 20, max_age_s=1e12)
    jbuf.restore_entries(jspill.parse_spill_bytes(data, True)[0])
    assert buf.to_bytes() == jbuf.to_bytes()
    with pytest.raises(ValueError):
        tspill.parse_spill_bytes(b"VSPLX")


# -- Servers -------------------------------------------------------------------------

CFG = dict(
    interval="3600s", hostname="fwdbox", percentiles=[0.5, 0.99],
    aggregates=["min", "max", "count", "sum", "avg", "hmean"],
    statsd_listen_addresses=[], ssf_listen_addresses=[],
    tpu_counter_capacity=256, tpu_gauge_capacity=64,
    tpu_status_capacity=16, tpu_set_capacity=16, tpu_histo_capacity=64,
    tpu_batch_counter=512, tpu_batch_gauge=128, tpu_batch_status=16,
    tpu_batch_set=64, tpu_batch_histo=512)


def _server(pkg, sink=None, quiet=True, **kw):
    """A started Server of `pkg` on the CPU; `quiet` keeps its own
    telemetry out of its pipeline."""
    cfg_kw = dict(CFG, **kw)
    sinks = [sink] if sink is not None else []
    if pkg == "jax":
        srv = _SyncedJServer(jconfig.Config(**cfg_kw), metric_sinks=sinks)
    else:
        srv = tserver_mod.Server(tconfig.Config(**cfg_kw),
                                 metric_sinks=sinks, device="cpu")
    if quiet:
        srv.trace_client.backend = _DropSpans()
    srv.start()
    return srv


def _sink(pkg):
    return JDebugMetricSink() if pkg == "jax" else DebugMetricSink()


def _lines(seed, n=800):
    """Forwardable traffic of every kind: global counters and gauges,
    mixed timers and sets."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        k = i % 4
        if k == 0:
            out.append(f"fw.c{rng.integers(0, 40)}:{rng.integers(1, 90)}"
                       f"|c|#veneurglobalonly")
        elif k == 1:
            out.append(f"fw.g{rng.integers(0, 12)}:{rng.normal():.5f}"
                       f"|g|#veneurglobalonly")
        elif k == 2:
            out.append(f"fw.t{rng.integers(0, 10)}:"
                       f"{rng.lognormal(1.0, 0.8):.4f}|ms|#svc:api")
        else:
            out.append(f"fw.s{rng.integers(0, 5)}:u{rng.integers(0, 400)}"
                       f"|s")
    return "\n".join(out).encode()


def _feed(srv, data):
    """The lines as one buffer on the pipeline queue: one dispatch, so
    the local's steps fall where the lines put them."""
    base = srv.aggregator.processed
    srv.packet_queue.put(data)
    n = data.count(b"\n") + 1
    _wait(lambda: srv.aggregator.processed - base >= n, "lines processed")


def _app(metrics):
    return sorted((m for m in metrics if not m.name.startswith("veneur.")
                   and m.name != "ssf.names_unique"),
                  key=lambda m: (m.name, tuple(m.tags), m.type))


def _assert_same_intermetrics(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert (g.name, g.tags, g.type, g.message, g.sinks) == (
            w.name, w.tags, w.type, w.message, w.sinks)
        tail = g.name.rsplit(".", 1)[-1]
        if tail.endswith("percentile") or tail == "median":
            np.testing.assert_allclose(g.value, w.value, rtol=2e-5,
                                       atol=2e-5, err_msg=g.name)
        elif g.name.startswith("fw.s"):
            np.testing.assert_allclose(g.value, w.value, rtol=1e-6,
                                       err_msg=g.name)
        else:
            assert g.value == w.value, (g.name, g.value, w.value)


def _flush(srv, sink):
    sink.flushed.clear()
    assert srv.trigger_flush(timeout=120)
    return _app(sink.flushed)


# -- (c) local → proxy → two globals ------------------------------------------------

def _topology(pkg):
    """Two globals (gRPC and HTTP import, dedup 64); a proxy over their
    gRPC ports and one over their HTTP ports; a local forwarding to each
    proxy, exactly once."""
    proxysrv, discovery = ((jproxysrv, jdiscovery) if pkg == "jax"
                           else (tproxysrv, tdiscovery))
    gsinks = [_sink(pkg), _sink(pkg)]
    globs = [_server(pkg, gs, grpc_address="127.0.0.1:0",
                     http_address="127.0.0.1:0", forward_dedup_window=64)
             for gs in gsinks]
    pg = proxysrv.ProxyServer(discovery.StaticDiscoverer(
        [f"127.0.0.1:{g.grpc_port}" for g in globs]), dedup_window=64)
    pg.start("127.0.0.1:0")
    ph = proxysrv.ProxyServer(discovery.StaticDiscoverer(
        [f"127.0.0.1:{g.http_port}" for g in globs]), dedup_window=64)
    ph.start_http("127.0.0.1:0")
    locs = {"grpc": _server(pkg, forward_address=f"127.0.0.1:{pg.port}",
                            forward_dedup_window=64),
            "http": _server(pkg,
                            forward_address=f"http://127.0.0.1:"
                                            f"{ph.http_port}",
                            forward_dedup_window=64)}
    return dict(globs=globs, gsinks=gsinks, proxies={"grpc": pg,
                                                     "http": ph},
                locals=locs)


@pytest.fixture(scope="module")
def tiers():
    tops = {}
    try:
        for pkg in ("jax", "torch"):
            tops[pkg] = _topology(pkg)
        yield tops
    finally:
        for top in tops.values():
            for srv in top["locals"].values():
                srv.shutdown()
            for p in top["proxies"].values():
                p.stop()
            for g in top["globs"]:
                g.shutdown()


def _forward_interval(top, transport, data):
    """Feed one local, flush it, wait until its unit is acked and folded
    on the globals, flush both globals: (per-global app flushes, unit
    metric count)."""
    loc = top["locals"][transport]
    proxy = top["proxies"][transport]
    globs = top["globs"]
    base = sum(g.imported_total + g.import_errors for g in globs)
    fwd0 = proxy.forwarded
    _feed(loc, data)
    assert loc.trigger_flush(timeout=120)
    _wait(lambda: loc.forward_sends_total >= 1
          and len(loc.forward_spill) == 0, "unit acked")
    n = proxy.forwarded - fwd0
    _wait(lambda: sum(g.imported_total + g.import_errors
                      for g in globs) - base >= n, "unit folded")
    return [_flush(g, s) for g, s in zip(globs, top["gsinks"])], n


@pytest.mark.parametrize("transport", ["grpc", "http"])
def test_three_tiers_flush_what_the_jax_tiers_flush(tiers, transport):
    data = _lines(7 if transport == "grpc" else 8)
    out = {pkg: _forward_interval(tiers[pkg], transport, data)
           for pkg in ("jax", "torch")}
    (tg, tn), (jg, jn) = out["torch"], out["jax"]
    assert tn == jn > 40
    assert all(g.import_errors == 0 and g._c_envelope_rejected.value() == 0
               for top in tiers.values() for g in top["globs"])
    # the ring partitions: every key on one global, both get a share
    keys = [{(m.name, tuple(m.tags)) for m in per} for per in tg]
    assert keys[0] and keys[1] and not keys[0] & keys[1]
    union = sorted(tg[0] + tg[1], key=lambda m: (m.name, tuple(m.tags),
                                                 m.type))
    _assert_same_intermetrics(union, sorted(
        jg[0] + jg[1], key=lambda m: (m.name, tuple(m.tags), m.type)))
    names = {m.name for m in union}
    assert any(n.startswith("fw.t") and n.endswith("99percentile")
               for n in names)
    assert any(n.startswith("fw.s") for n in names)
    # the counters are the exact sums of the lines
    want = {}
    for ln in data.decode().split("\n"):
        if "|c|" in ln:
            name, rest = ln.split(":", 1)
            want[name] = want.get(name, 0) + int(rest.split("|")[0])
    assert {m.name: m.value for m in union
            if m.name.startswith("fw.c")} == want


# -- (d) exactly once ----------------------------------------------------------------

def _direct_pair(pkg, tmp_path=None, **local_kw):
    gsink = _sink(pkg)
    glob = _server(pkg, gsink, grpc_address="127.0.0.1:0",
                   forward_dedup_window=64)
    local = _server(pkg, forward_address=f"127.0.0.1:{glob.grpc_port}",
                    forward_dedup_window=64, **local_kw)
    return local, glob, gsink


def test_ack_loss_retry_is_suppressed_as_in_jax():
    """The global folds the unit, the local sees a failure (FORWARD_ACK)
    and re-sends the same seq next interval; the duplicate is suppressed
    with an ack, the unit evicted, and the counter exact."""
    out = {}
    for pkg in ("jax", "torch"):
        local, glob, gsink = _direct_pair(pkg)
        try:
            FAULTS[pkg].arm(tfaults.FORWARD_ACK, error=True, times=1)
            _feed(local, b"eo.count:7|c|#veneurglobalonly")
            assert local.trigger_flush(timeout=120)
            _wait(lambda: local.forward_errors >= 1, "lost-ack failure")
            assert len(local.forward_spill) == 1
            assert local.trigger_flush(timeout=120)
            _wait(lambda: len(local.forward_spill) == 0, "retry acked")
            _wait(lambda: glob.imported_total >= 1, "global import")
            got = {m.name: m.value for m in _flush(glob, gsink)}
            out[pkg] = (got, glob._c_dup_suppressed.value(),
                        local._fwd_acked_seq >= 0,
                        FAULTS[pkg].fired(tfaults.FORWARD_ACK))
        finally:
            local.shutdown()
            glob.shutdown()
    assert out["torch"] == out["jax"]
    assert out["torch"] == ({"eo.count": 7.0}, 1, True, 1)


@pytest.mark.parametrize("first,then", [("jax", "torch"), ("torch", "jax"),
                                        ("torch", "torch")])
def test_restart_replays_the_pending_unit_once(first, then, tmp_path):
    """A unit whose ack was lost rides out in the tail checkpoint's spill
    chunk; the restarted local (of either package) replays it under its
    original (epoch, seq), suppressed at the global, while new data opens
    epoch + 1; the restored tail is not re-exported under a new seq."""
    gsink = DebugMetricSink()
    glob = _server("torch", gsink, grpc_address="127.0.0.1:0",
                   forward_dedup_window=64)
    local_kw = dict(forward_address=f"127.0.0.1:{glob.grpc_port}",
                    forward_dedup_window=64,
                    checkpoint_dir=str(tmp_path / "ckpt"))
    try:
        a = _server(first, quiet=False, **local_kw)
        try:
            FAULTS[first].arm(tfaults.FORWARD_ACK, error=True, times=1)
            _feed(a, b"eo.re:5|c|#veneurglobalonly")
            assert a.trigger_flush(timeout=120)
            _wait(lambda: a.forward_errors >= 1, "lost-ack failure")
            assert len(a.forward_spill) == 1
            sid, epoch0 = a._fwd_source_id, a._fwd_epoch
        finally:
            a.shutdown()           # the tail checkpoint carries the unit
        FAULTS[first].reset()
        b = _server(then, quiet=False, restore_on_start=True, **local_kw)
        try:
            assert (b._fwd_source_id, b._fwd_epoch) == (sid, epoch0 + 1)
            units = [(u.epoch, u.seq)
                     for u in b.forward_spill.pending_units()]
            assert units[0] == (0, 0)
            assert all(epoch == 0 for epoch, _ in units)
            _feed(b, b"eo.re:11|c|#veneurglobalonly")
            assert b.trigger_flush(timeout=120)
            _wait(lambda: len(b.forward_spill) == 0, "replay acked")
            assert glob._c_dup_suppressed.value() == 1
            assert b._fwd_acked_seq >= 0
        finally:
            b.shutdown()
        got = {m.name: m.value for m in _flush(glob, gsink)}
        assert got["eo.re"] == 16.0            # 5 + 11, the replay once
    finally:
        glob.shutdown()


@pytest.mark.parametrize("route", ["native", "python"])
def test_a_step_sums_a_counter_in_f32_as_jax_does(route):
    """ROADMAP C-6: an ingest step sums a slot's entries in one f32 before
    the two-float fold, so three imports of 2^24 - 1 that share a step
    flush their sum rounded to f32's spacing of 4 past 2^25, in both
    packages (a forward tier's global meets it when its locals' byte
    counters land in one import step)."""
    from tests.test_torch_import import (BSPEC, JBSPEC, JSPEC, SPEC,
                                         _SyncedJAggregator, _SyncedJNative,
                                         _flush_map)
    from veneur_tpu.forward import convert as jconvert
    from veneur_tpu_torch.forward import convert as tconvert
    from veneur_tpu_torch.proto import forwardrpc_pb2 as fpb
    from veneur_tpu_torch.server.aggregator import Aggregator
    from veneur_tpu_torch.server.native_aggregator import NativeAggregator
    m = mpb.Metric(name="bytes.sent", type=mpb.Counter, scope=mpb.Global)
    m.counter.value = (1 << 24) - 1
    data = fpb.MetricList(metrics=[m] * 3).SerializeToString()
    if route == "native":
        tagg = NativeAggregator(SPEC, BSPEC, device="cpu")
        jagg = _SyncedJNative(JSPEC, JBSPEC)
        assert tagg.import_pb_bytes(data) == jagg.import_pb_bytes(data)
    else:
        tagg = Aggregator(SPEC, BSPEC, device="cpu")
        jagg = _SyncedJAggregator(JSPEC, JBSPEC)
        for _ in range(3):
            tconvert.import_into(tagg, m)
            jconvert.import_into(jagg, jmpb.Metric.FromString(
                m.SerializeToString()))
    got, want = _flush_map(tagg), _flush_map(jagg)
    key = ("counter", "bytes.sent", "", True)
    exact = 3.0 * ((1 << 24) - 1)
    assert float(got[key]["counter"]) == float(want[key]["counter"]) \
        == float(np.float32(exact)) == exact - 1


def test_bad_forward_address_never_blocks_the_local_flush():
    sink = DebugMetricSink()
    srv = _server("torch", sink, quiet=False, forward_address="127.0.0.1:1",
                  forward_use_grpc=True)
    try:
        _feed(srv, b"local.c:7|c\nfwd.t:3|ms")
        assert srv.trigger_flush(timeout=60)
        assert {m.name: m.value for m in sink.flushed}["local.c"] == 7.0
        _wait(lambda: srv.forward_errors >= 1, "forward error counted")
        deadline = time.time() + 60
        got = {}
        while time.time() < deadline and not got.get(
                "veneur.forward.error_total"):
            sink.flushed.clear()
            assert srv.trigger_flush(timeout=60)
            got = {m.name: m.value for m in sink.flushed}
        assert got.get("veneur.forward.error_total", 0) >= 1.0
    finally:
        srv.shutdown()


def test_envelope_past_the_window_bound_is_rejected_over_grpc():
    from veneur_tpu_torch.forward.rpc import ForwardClient
    glob = _server("torch", grpc_address="127.0.0.1:0",
                   forward_dedup_window=4)
    client = ForwardClient(f"127.0.0.1:{glob.grpc_port}")
    try:
        m = mpb.Metric(name="x", type=mpb.Counter, scope=mpb.Global)
        m.counter.value = 1
        with pytest.raises(Exception):
            client.send_metrics([m], envelope=tenvelope.Envelope(
                SIDS[0], 0, 10 ** 6))
        assert glob._c_envelope_rejected.value() == 1
        client.send_metrics([m], envelope=tenvelope.Envelope(SIDS[0], 0, 0))
        client.send_metrics([m], envelope=tenvelope.Envelope(SIDS[0], 0, 0))
        assert glob._c_dup_suppressed.value() == 1
    finally:
        client.close()
        glob.shutdown()


def test_a_unit_past_grpcs_receive_cap_is_counted_and_held_in_both():
    """ROADMAP C-7: neither package raises gRPC's 4 MiB receive cap, so
    a local's unit of 600 dense set sketches (8 KB each) never reaches
    the proxy: every send, the first and the next interval's re-send of
    the same seq, is a counted error and the unit stays held, in both
    packages alike."""
    data = "\n".join(f"big.s{i}:u{i}|s" for i in range(600)).encode()
    out = {}
    for pkg in ("jax", "torch"):
        proxysrv, discovery = ((jproxysrv, jdiscovery) if pkg == "jax"
                               else (tproxysrv, tdiscovery))
        proxy = proxysrv.ProxyServer(discovery.StaticDiscoverer(
            ["127.0.0.1:1"]), dedup_window=64)
        proxy.start("127.0.0.1:0")
        local = _server(pkg, forward_address=f"127.0.0.1:{proxy.port}",
                        forward_dedup_window=64, tpu_set_capacity=1024,
                        tpu_batch_set=1024)
        try:
            _feed(local, data)
            sent = []
            for n in (1, 2):
                assert local.trigger_flush(timeout=120)
                _wait(lambda: local.forward_errors >= n, "send failed")
                units = local.forward_spill.pending_units()
                sent.append([(u.epoch, u.seq) for u in units])
            unit = units[0]
            size = sum(m.ByteSize() for m in unit.metrics)
            out[pkg] = (sent, len(unit.metrics), size > 4 << 20,
                        local.forward_errors, proxy.forwarded, proxy.errors)
        finally:
            local.shutdown()
            proxy.stop()
    assert out["torch"] == out["jax"]
    assert out["torch"] == ([[(0, 0)], [(0, 0)]], 600, True, 2, 0, 0)
