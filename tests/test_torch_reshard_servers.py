"""Live resharding (ROADMAP A8b) on the Servers, the port against the
JAX package on the CPU.

- (e) the port's and the JAX Server resize 4 -> 8 -> 2 between three
  traffic phases on both backends (Python-sharded and native) and flush
  the same InterMetrics (quantiles within 2e-5, set estimates within
  rtol 1e-6) and set words, with the same migration summaries; counters,
  gauges and set words equal a static run's; the port's Server alone
  flushes what its static run flushes, and a native crash mid-transfer
  replays with duplicates suppressed and stays exact.
"""

import socket

import numpy as np
import pytest

from tests.test_torch_import import _DropSpans
from tests.test_torch_reshard import (PERC, _JAgg, _JNative,
                                      _JNativeSharded, _JSharded,
                                      _reshard_cfg)
from tests.test_torch_server import (SMALL, _app, _CapturingJSink,
                                     _CapturingTSink, _SyncedJServer, _wait)
from tests.test_torch_sharded import _lines
from veneur_tpu import config as jconfig
from veneur_tpu.server import server as jserver_mod
from veneur_tpu_torch import config as tconfig
from veneur_tpu_torch.reliability.faults import FAULTS, RESHARD_FOLD
from veneur_tpu_torch.server import server as tserver_mod
from veneur_tpu_torch.sinks.debug import DebugMetricSink


@pytest.fixture(autouse=True)
def _clean_faults():
    FAULTS.reset()
    yield
    FAULTS.reset()


# -- (e) the live resize on both Servers ------------------------------------------------

class _JReshardServer(_SyncedJServer):
    """The JAX Server whose rebuilt aggregators (the reshard drain's)
    keep the running engine and wait on each step."""

    def _make_aggregator(self, n_shards, engine=None, spec=None):
        cfg = self.cfg
        args = dict(
            spec=spec if spec is not None
            else jserver_mod.spec_from_config(cfg),
            bspec=jserver_mod.BatchSpec(
                counter=cfg.tpu_batch_counter, gauge=cfg.tpu_batch_gauge,
                status=cfg.tpu_batch_status, set=cfg.tpu_batch_set,
                histo=cfg.tpu_batch_histo),
            compact_every=cfg.tpu_compact_every)
        if n_shards > 1:
            if cfg.native_ingest:
                return _JNativeSharded(n_shards=n_shards, engine=engine,
                                       **args), True
            return _JSharded(n_shards=n_shards, **args), False
        if cfg.native_ingest:
            return _JNative(engine=engine, **args), True
        return _JAgg(**args), False


def _start_pair_server(pkg, native):
    kw = dict(SMALL, interval="3600s", statsd_listen_addresses=[],
              ssf_listen_addresses=[], http_address="", tpu_n_shards=4,
              reshard_enabled=True, native_ingest=native)
    if pkg == "jax":
        sink = _CapturingJSink()
        srv = _JReshardServer(jconfig.Config(**kw), metric_sinks=[sink])
    else:
        sink = _CapturingTSink()
        srv = tserver_mod.Server(tconfig.Config(**kw), metric_sinks=[sink],
                                 device="cpu")
    srv.trace_client.backend = _DropSpans()
    srv.start()
    return srv, sink


def _flush_with_words(srv, sink):
    """One flush: its app InterMetrics, and its set words by key (the
    detached interval's raw rows, computed again)."""
    agg = srv.aggregator
    got, orig = [], agg.compute_flush

    def capture(state, table, percentiles, **kw):
        got.append((state, table))
        return orig(state, table, percentiles, **kw)
    agg.compute_flush = capture
    sink.flushed.clear()
    try:
        assert srv.trigger_flush(timeout=120)
    finally:
        del agg.compute_flush
    _res, tb, raw = orig(*got[0], PERC, want_raw=True)
    return _app(sink.flushed), {
        (m.name, m.joined_tags or ""): np.asarray(raw["hll"][i]).tobytes()
        for i, (_s, m) in enumerate(tb.get_meta("set"))
        if not m.name.startswith("veneur.")}


def _pair_run(pkg, native, resizes):
    """Three phases of every kind through the packet queue, each parsed
    whole, with a resize after each of the first two: the swap cuts the
    stream at a phase's end in both packages."""
    srv, sink = _start_pair_server(pkg, native)
    try:
        summaries = []
        for phase in range(3):
            lines = _lines(30 + phase, n=500)
            want = srv.aggregator.processed + len(lines)
            for k in range(0, len(lines), 50):
                srv.packet_queue.put(b"\n".join(lines[k:k + 50]))
            _wait(lambda: srv.aggregator.processed >= want, "lines")
            if phase < len(resizes):
                summaries.append(srv.trigger_reshard(resizes[phase],
                                                     timeout=120))
        ims, words = _flush_with_words(srv, sink)
        return ims, words, summaries, srv
    finally:
        srv.shutdown()


def _same_ims(got, want):
    """Names, tags and types equal; percentiles and medians within
    rtol/atol 2e-5, set estimates (the s<i> names) within rtol 1e-6
    (C-watch 7), every other value exact."""
    assert [(m.name, m.tags, m.type) for m in got] == \
        [(m.name, m.tags, m.type) for m in want] and got
    for g, w in zip(got, want):
        tail = g.name.rsplit(".", 1)[-1]
        if tail.endswith("percentile") or tail == "median":
            np.testing.assert_allclose(g.value, w.value, rtol=2e-5,
                                       atol=2e-5, err_msg=g.name)
        elif g.name.startswith("s"):
            np.testing.assert_allclose(g.value, w.value, rtol=1e-6,
                                       err_msg=g.name)
        else:
            assert g.value == w.value, g.name


@pytest.mark.parametrize("native", [False, True],
                         ids=["python-sharded", "native"])
def test_live_resize_on_both_servers_matches_jax(native):
    """4 -> 8 -> 2 between three phases on the port's and the JAX
    Server: the same InterMetrics (quantiles within 2e-5, set estimates
    within rtol 1e-6) and set words, the same migration summaries."""
    t_ims, t_words, t_sum, tsrv = _pair_run("torch", native, [8, 2])
    j_ims, j_words, j_sum, _ = _pair_run("jax", native, [8, 2])
    _same_ims(t_ims, j_ims)
    assert t_words == j_words and len(t_words) == 10
    keys = ("plan", "units", "rows_folded", "rows_moved", "replays",
            "dup_suppressed", "failed")
    assert [{k: s[k] for k in keys} for s in t_sum] == \
        [{k: s[k] for k in keys} for s in j_sum]
    assert tsrv.aggregator.n_shards == 2 and tsrv._native is native
    # counters, gauges and set words as a static run of the same lines
    s_ims, s_words, _, _ = _pair_run("torch", native, [])
    def kept(ims):      # the c<i> counters and g<i> gauges
        return {(m.name, tuple(m.tags)): m.value for m in ims
                if m.name[0] in "cg"}
    assert kept(s_ims) == kept(t_ims) and len(kept(t_ims)) == 20
    assert s_words == t_words


# -- (e) the live resize on the port's Server alone ----------------------------------

def _seen(srv):
    agg = srv.aggregator
    return agg.processed + agg.dropped_capacity + srv.parse_errors


def _send(srv, grams, n):
    base = _seen(srv)
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    for g in grams:
        tx.sendto(g, srv.local_addr(0))
    tx.close()
    _wait(lambda: _seen(srv) >= base + n, f"{n} lines not all seen")


PHASE_A = ([f"rs.c{i % 6}:1|c".encode() for i in range(24)]
           + [b"rs.g:5|g", b"rs.t:10|ms", b"rs.t:90|ms"]
           + [f"rs.s:m{i}|s".encode() for i in range(10)])
PHASE_B = ([f"rs.c{i % 6}:2|c".encode() for i in range(12)]
           + [b"rs.t:50|ms"] + [f"rs.s:m{i}|s".encode()
                                for i in range(5, 15)])


def _run_resize(kw, resizes, crash=False):
    sink = DebugMetricSink()
    srv = tserver_mod.Server(_reshard_cfg(**kw), metric_sinks=[sink],
                             device="cpu")
    srv.start()
    summaries = []
    try:
        _send(srv, [b"\n".join(PHASE_A)], len(PHASE_A))
        for n in resizes:
            if crash:
                FAULTS.arm(RESHARD_FOLD, error=True, times=1)
            summaries.append(srv.trigger_reshard(n, timeout=120))
        # folds count as processed rows: the wait starts after them
        _send(srv, [b"\n".join(PHASE_B)], len(PHASE_B))
        assert srv.trigger_flush(timeout=120)
    finally:
        srv.shutdown()
    rows = {(m.name, tuple(m.tags)): m.value for m in sink.flushed
            if not m.name.startswith(("veneur.", "ssf."))}
    return rows, summaries, srv


@pytest.mark.parametrize("native", [False, True],
                         ids=["python-sharded", "native"])
def test_live_resize_grow_shrink_equals_static(native):
    kw = dict(tpu_n_shards=4, native_ingest=native)
    ref, _, _ = _run_resize(kw, [])
    got, summaries, srv = _run_resize(kw, [8, 2])
    assert got == ref and len(ref) == 13
    for s in summaries:
        assert not s["failed"]
        assert s["dup_suppressed"] == 0 and s["replays"] == 0
        assert 0 < s["rows_moved"] <= s["rows_folded"]
        assert len(s["fold_ns"]) >= 1 and s["build_ns"] > 0
    assert [s["plan"] for s in summaries] == ["4->8", "8->2"]
    assert srv.reshard.moves_total == 2
    assert srv.reshard.failed_total == 0
    assert srv._c_reshard_moves.value() == 2
    assert srv._c_reshard_rows_moved.value() == \
        sum(s["rows_moved"] for s in summaries)
    assert srv._native is native
    assert srv.aggregator.n_shards == 2


def test_live_resize_native_crash_replays_exactly_once():
    """The engine is reused across the rebuild; a fold fault after a
    unit folded (the receiver dying before it records progress) replays
    the epoch, the folded unit comes back DUPLICATE, and the flush stays
    exact."""
    kw = dict(tpu_n_shards=2)
    ref, _, _ = _run_resize(kw, [])
    got, summaries, srv = _run_resize(kw, [4], crash=True)
    assert srv._native
    assert got == ref
    (s,) = summaries
    assert not s["failed"]
    assert s["replays"] == 1 and s["dup_suppressed"] >= 1
    assert FAULTS.fired(RESHARD_FOLD) == 1

