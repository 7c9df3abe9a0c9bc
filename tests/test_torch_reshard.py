"""Live resharding (ROADMAP A8b) in the port against the JAX package, on
the CPU: the plan, the partition, the surface and the engine. The fold,
multi-wave steps and the Servers' resizes are in
tests/test_torch_reshard_fold.py, tests/test_torch_reshard_servers.py and
tests/test_torch_reshard_storm.py.

- (a) plan math: key_moved, moved_fraction, dest_shard and signature
  equal JAX's over (old, new) in [1..8]^2 and 10k random u32 digests;
  bad counts raise as JAX's do;
- (b) partition_units over one snapshot gives JAX's units (tables,
  arrays, dest_shard, rows, rows_moved); every row lands once and routes
  to its unit's dest_shard;
- (f) the surface: /readyz's phase, the guard rails, POST /reshard (404
  off, 409 busy, 400 bad), stale-bounded query answers and watch
  events, a watch reading an interval detached before a resize, grow
  conflicts and deferred grow planning, units not ready at a flush
  boundary;
- (g) the engine: after shard_map_set and a swap the port engine stages
  the JAX engine's rows word for word; only reshard/quiesce.py calls
  shard_map_set.

The JAX aggregators here wait on each of their steps (ROADMAP C-watch 4);
the other reshard test files import them.
"""

import ast
import json
import os
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from tests.test_torch_server import SMALL, _wait
from tests.test_torch_sharded import _lines
from veneur_tpu.aggregation.host import BatchSpec as JBatchSpec
from veneur_tpu.aggregation.state import TableSpec as JTableSpec
from veneur_tpu.native import NativeIngest as JNativeIngest
from veneur_tpu.reshard import plan as jplan
from veneur_tpu.reshard import quiesce as jquiesce
from veneur_tpu.server.aggregator import Aggregator as JAggregator
from veneur_tpu.server.native_aggregator import (
    NativeAggregator as JNativeAggregator)
from veneur_tpu.server.native_aggregator import (
    NativeShardedAggregator as JNativeSharded)
from veneur_tpu.server.sharded_aggregator import (
    ShardedAggregator as JSharded)
from veneur_tpu_torch import config as tconfig
from veneur_tpu_torch.aggregation.host import BatchSpec
from veneur_tpu_torch.aggregation.state import TableSpec
from veneur_tpu_torch.native import NativeIngest
from veneur_tpu_torch.persistence import build_snapshot
from veneur_tpu_torch.reliability.faults import FAULTS, RESHARD_FOLD
from veneur_tpu_torch.reshard import ReshardError, quiesce
from veneur_tpu_torch.reshard import plan as tplan
from veneur_tpu_torch.reshard.coordinator import _Transfer
from veneur_tpu_torch.samplers import parser as tparser
from veneur_tpu_torch.server import server as tserver_mod
from veneur_tpu_torch.server.aggregator import Aggregator as TAggregator
from veneur_tpu_torch.server.health import check_ready
from veneur_tpu_torch.server.native_aggregator import (
    NativeAggregator as TNativeAggregator)
from veneur_tpu_torch.server.native_aggregator import (
    NativeShardedAggregator as TNativeSharded)
from veneur_tpu_torch.server.sharded_aggregator import (
    ShardedAggregator as TSharded)
from veneur_tpu_torch.sinks.debug import DebugMetricSink
from veneur_tpu_torch.tables.growth import GrowConflict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AGG_KW = dict(counter_capacity=64, gauge_capacity=32, status_capacity=8,
              set_capacity=16, histo_capacity=32)
BSPEC_KW = dict(counter=64, gauge=16, status=8, set=32, histo=128,
                histo_stat=16)
PERC = [0.5, 0.9, 0.99]


@pytest.fixture(autouse=True)
def _clean_faults():
    FAULTS.reset()
    yield
    FAULTS.reset()


# -- (a) plan math ----------------------------------------------------------------

DIGESTS = [int(d) for d in np.random.default_rng(14).integers(
    0, 1 << 32, 10_000, dtype=np.uint64)] + [0, 1, 0xFFFFFFFF]


@pytest.mark.parametrize("old_n", range(1, 9))
def test_plan_math_matches_jax(old_n):
    for new_n in range(1, 9):
        assert tplan.moved_fraction(old_n, new_n) == \
            jplan.moved_fraction(old_n, new_n)
        tp, jp = tplan.ReshardPlan(old_n, new_n), \
            jplan.ReshardPlan(old_n, new_n)
        assert tp.signature == jp.signature == f"{old_n}->{new_n}"
        got = [(tplan.key_moved(d, old_n, new_n), tp.dest_shard(d),
                tp.moved(d)) for d in DIGESTS]
        want = [(jplan.key_moved(d, old_n, new_n), jp.dest_shard(d),
                 jp.moved(d)) for d in DIGESTS]
        assert got == want
    assert tplan.moved_fraction(4, 8) == 0.5
    assert tplan.moved_fraction(8, 2) == 0.75


@pytest.mark.parametrize("old_n,new_n", [(0, 4), (4, -1), (0, 0)])
def test_bad_counts_raise_as_jax_does(old_n, new_n):
    with pytest.raises(ValueError) as jerr:
        jplan.ReshardPlan(old_n, new_n)
    with pytest.raises(ValueError) as terr:
        tplan.ReshardPlan(old_n, new_n)
    assert str(terr.value) == str(jerr.value)


# -- (b) the partition --------------------------------------------------------------

def _port_snapshot(n_shards=4, lines=None):
    """One drained interval of the port's sharded backend as a snapshot
    dict (every kind, tags, a sampled histogram)."""
    spec, bs = TableSpec(**AGG_KW), BatchSpec(**BSPEC_KW)
    agg = TSharded(spec, bs, n_shards=n_shards, device="cpu")
    extra = [b"p.st:1|st", b"p.tag:3|c|#env:prod,team:x",
             b"p.tag:4|c|#env:dev"]
    for line in (lines if lines is not None else _lines(7) + extra):
        if line.endswith(b"|st"):
            agg.process_metric(tparser.parse_service_check(b"_sc|p.st|1"))
        else:
            agg.process_metric(tparser.parse_metric(line))
    st, tb = agg.swap()
    res, tb, raw = agg.compute_flush(st, tb, PERC, want_raw=True)
    return build_snapshot(spec, tb, res, raw, agg_kind="sharded",
                          n_shards=n_shards, interval_ts=1.0,
                          hostname="h")


def _assert_units_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in g:
            if k == "arrays":
                assert set(g[k]) == set(w[k])
                for a in g[k]:
                    np.testing.assert_array_equal(g[k][a], w[k][a])
                    assert g[k][a].dtype == w[k][a].dtype, a
            else:
                assert g[k] == w[k], k


@pytest.mark.parametrize("old_n,new_n", [(1, 2), (4, 8), (8, 2), (3, 5)])
def test_partition_units_matches_jax(old_n, new_n):
    snap = _port_snapshot()
    got = tplan.partition_units(snap, tplan.ReshardPlan(old_n, new_n))
    want = jplan.partition_units(snap, jplan.ReshardPlan(old_n, new_n))
    _assert_units_equal(got, want)
    assert sum(u["rows"] for u in got) == sum(
        len(v) for v in snap["tables"].values())
    seen = set()
    for u in got:
        for kind, entries in u["tables"].items():
            for e in entries:
                key = (kind, e[0], tuple(e[1]), e[6])
                assert key not in seen
                seen.add(key)
                d = tplan._row_digest(e)
                assert d % new_n == u["dest_shard"]
    assert sum(u["rows_moved"] for u in got) == sum(
        1 for entries in snap["tables"].values() for e in entries
        if tplan.key_moved(tplan._row_digest(e), old_n, new_n))


def test_partition_of_a_hand_built_snapshot_matches_jax():
    entries = [[n, [], 0, "", "", False, "counter", ""]
               for n in ("a", "b", "c")]
    snap = {
        "agg_kind": "single", "n_shards": 4, "spec": {"hll_precision": 14},
        "interval_ts": 1.0, "created_at": 1.0, "hostname": "t",
        "tables": {"counter": entries,
                   "gauge": [["g1", ["k:v"], 0, "", "", False, "gauge",
                              "k:v"]],
                   "status": [], "set": [], "histo": []},
        "arrays": {"counter": np.asarray([1.0, 2.0, 3.0]),
                   "gauge": np.asarray([7.0], np.float32),
                   "status": np.zeros(0, np.float32),
                   "hll": np.zeros((0, 2), np.int32),
                   "h_mean": np.zeros(0, np.float32),
                   "h_weight": np.zeros(0, np.float32),
                   "h_min": np.zeros(0, np.float32),
                   "h_max": np.zeros(0, np.float32),
                   "h_recip": np.zeros(0, np.float64)}}
    got = tplan.partition_units(snap, tplan.ReshardPlan(4, 8))
    _assert_units_equal(got, jplan.partition_units(
        snap, jplan.ReshardPlan(4, 8)))
    assert sum(u["rows"] for u in got) == 4


# -- (c) fold parity ------------------------------------------------------------------

class _JAgg(JAggregator):
    def _on_batch(self, batch):
        super()._on_batch(batch)
        jax.block_until_ready(self.state)


class _JNative(JNativeAggregator):
    def _on_batch(self, batch):
        super()._on_batch(batch)
        jax.block_until_ready(self.state)

    def _emit_native(self):
        super()._emit_native()
        jax.block_until_ready(self.state)


class _JSharded(JSharded):
    def _dispatch_row(self, row):
        super()._dispatch_row(row)
        jax.block_until_ready(self.state)


class _JNativeSharded(JNativeSharded):
    def _dispatch_row(self, row):
        super()._dispatch_row(row)
        jax.block_until_ready(self.state)


def _fresh(backend, n, jax_side):
    spec = (JTableSpec if jax_side else TableSpec)(**AGG_KW)
    bs = (JBatchSpec if jax_side else BatchSpec)(**BSPEC_KW)
    kw = {} if jax_side else {"device": "cpu"}
    if backend == "python":
        if n == 1:
            return (_JAgg if jax_side else TAggregator)(spec, bs, **kw)
        return (_JSharded if jax_side else TSharded)(spec, bs, n_shards=n,
                                                     **kw)
    if n == 1:
        return (_JNative if jax_side else TNativeAggregator)(spec, bs, **kw)
    return (_JNativeSharded if jax_side else TNativeSharded)(
        spec, bs, n_shards=n, **kw)


def _rows(agg):
    """name-keyed flush rows: (kind, name, tags) -> value(s)."""
    st, tb = agg.swap()
    res, tb = agg.compute_flush(st, tb, PERC)
    out = {}
    for kind, key in (("counter", "counter"), ("gauge", "gauge"),
                      ("status", "status"), ("set", "set_estimate")):
        for i, (_s, m) in enumerate(tb.get_meta(kind)):
            out[(key, m.name, tuple(m.tags))] = float(res[key][i])
    for i, (_s, m) in enumerate(tb.get_meta("histogram")):
        for k in res:
            if k.startswith("histo_"):
                out[(k, m.name, tuple(m.tags))] = np.asarray(res[k][i])
    return out


EXACT_HISTO = ("histo_count", "histo_min", "histo_max")


def _assert_rows(got, want, q_tol=2e-5):
    assert set(got) == set(want) and got
    for key in want:
        a, b = np.asarray(got[key]), np.asarray(want[key])
        if key[0] == "set_estimate":
            np.testing.assert_allclose(a, b, rtol=1e-6, err_msg=str(key))
        elif key[0].startswith("histo_") and key[0] not in EXACT_HISTO:
            np.testing.assert_allclose(a, b, rtol=q_tol, atol=q_tol,
                                       equal_nan=True, err_msg=str(key))
        else:
            np.testing.assert_array_equal(a, b, err_msg=str(key))


def _reshard_cfg(**kw):
    # the JAX suite's aggregates: a restored digest's sum and reciprocal
    # sum are re-added from its cells (ROADMAP C-5), so avg, sum and
    # hmean are not held exact across a move
    base = dict(SMALL, interval="600s", reshard_enabled=True,
                ssf_listen_addresses=[], http_address="",
                percentiles=[0.5, 0.99], aggregates=["min", "max", "count"])
    base.update(kw)
    return tconfig.Config(**base)



# -- (f) the surface ------------------------------------------------------------------

def test_readyz_phase_pins_the_lifecycle():
    srv = tserver_mod.Server(_reshard_cfg(overload_enabled=True),
                             metric_sinks=[DebugMetricSink()], device="cpu")
    try:
        ok, detail = check_ready(srv)
        assert ok and detail["phase"] == "ready"
        # resharding is ready but announcing: ok stays, the phase flips
        srv._resharding = True
        ok, detail = check_ready(srv)
        assert ok and detail["phase"] == "resharding"
        srv._resharding = False
        srv._overload.enter_resharding()
        ok, detail = check_ready(srv)
        assert ok and detail["phase"] == "resharding"
        srv._overload.exit_resharding()
        srv._restore_complete = False
        ok, detail = check_ready(srv)
        assert not ok and detail["phase"] == "restoring"
        srv._restore_complete = True
        srv._resharding = True
        srv._shutdown.set()
        _, detail = check_ready(srv)
        assert detail["phase"] == "draining"
    finally:
        srv._shutdown.set()


def _post(port, path, data):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data,
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_resize_guard_rails_and_a_second_move_conflicts():
    srv = tserver_mod.Server(
        _reshard_cfg(tpu_n_shards=4, native_ingest=False,
                     http_address="127.0.0.1:0"),
        metric_sinks=[DebugMetricSink()], device="cpu")
    srv.start()
    try:
        with pytest.raises(ReshardError, match="already has 4"):
            srv.trigger_reshard(4)
        with pytest.raises(ReshardError, match="multiple"):   # 16 % 3
            srv.trigger_reshard(3)
        with pytest.raises(ReshardError, match="bad target"):
            srv.trigger_reshard(0)
        assert srv.reshard.failed_total == 1       # the no-op's drain
        assert srv.reshard.moves_total == 0
        srv.packet_queue.put(b"gr.c:1|c\ngr.t:3|ms")
        # each fold stalls: the move stays in flight while we knock
        FAULTS.arm(RESHARD_FOLD, latency_s=2.0)
        t = srv.trigger_reshard(8, wait=False)
        assert srv.reshard_active
        code, body = _post(srv.http_port, "/reshard",
                           json.dumps({"n_shards": 2}).encode())
        assert code == 409, body
        with pytest.raises(ReshardError, match="in progress"):
            srv.trigger_reshard(2)
        assert t.done.wait(60) and not t.failed
        assert srv.reshard.moves_total == 1
    finally:
        srv.shutdown()


def test_reshard_disabled_has_no_coordinator_and_404():
    srv = tserver_mod.Server(
        tconfig.Config(**dict(SMALL, ssf_listen_addresses=[])),
        metric_sinks=[DebugMetricSink()], device="cpu")
    srv.start()
    try:
        assert srv.reshard is None and srv.reshard_active is False
        with pytest.raises(ReshardError, match="disabled"):
            srv.trigger_reshard(2)
        code, _ = _post(srv.http_port, "/reshard",
                        json.dumps({"n_shards": 2}).encode())
        assert code == 404
    finally:
        srv.shutdown()


def test_post_reshard_answers_200_with_the_summary():
    srv = tserver_mod.Server(
        _reshard_cfg(http_address="127.0.0.1:0", native_ingest=False),
        metric_sinks=[DebugMetricSink()], device="cpu")
    srv.start()
    try:
        srv.packet_queue.put(b"hr.c:1|c")
        code, raw = _post(srv.http_port, "/reshard",
                          json.dumps({"n_shards": 2}).encode())
        assert code == 200, raw
        out = json.loads(raw)
        assert out["plan"] == "1->2" and not out["failed"]
        assert out["rows_folded"] == 1 and out["units"] == 1
        assert srv.aggregator.n_shards == 2
        for bad in (b"not json", b"{}", b'{"n_shards": "x"}'):
            code, _ = _post(srv.http_port, "/reshard", bad)
            assert code == 400, bad
        code, body = _post(srv.http_port, "/reshard",
                           json.dumps({"n_shards": 2}).encode())
        assert code == 400 and b"already has 2" in body
    finally:
        srv.shutdown()


def test_query_marked_stale_bounded_during_a_transfer():
    srv = tserver_mod.Server(_reshard_cfg(query_enabled=True),
                             metric_sinks=[DebugMetricSink()], device="cpu")
    srv.start()
    try:
        srv.packet_queue.put(b"sq.c:3|c")
        _wait(lambda: srv.query_engine.submit(
            {"name": "sq.c"})["results"][0]["matches"], "line not seen")
        out = srv.query_engine.submit({"name": "sq.c"})
        assert "stale_bounded" not in out
        # an in-flight transfer: reads stay served, marked and counted
        srv.reshard._transfer = _Transfer(2, 0)
        out = srv.query_engine.submit({"name": "sq.c"})
        assert out["stale_bounded"] is True
        assert out["results"][0]["matches"][0]["value"] == 3.0
        assert srv._c_reshard_stale.value() == 1
    finally:
        srv.reshard._transfer = None
        srv.shutdown()


def _stuck_transfer(srv):
    """An in-flight transfer whose one unit faults at every fold: each
    flush boundary folds it, faults, and leaves the move active."""
    unit = tplan.partition_units(
        _port_snapshot(1, lines=[b"st.c:1|c"]), tplan.ReshardPlan(1, 2))
    t = _Transfer(2, 0)
    t.plan = tplan.ReshardPlan(1, 2)
    t.units = unit
    t.units_ready.set()
    FAULTS.arm(RESHARD_FOLD, error=True)
    srv.reshard._transfer = t
    return t


def test_watch_transition_marked_stale_bounded_during_a_transfer():
    srv = tserver_mod.Server(_reshard_cfg(watch_enabled=True),
                             metric_sinks=[DebugMetricSink()], device="cpu")
    srv.start()
    sub = srv.watch_engine.hub.subscribe()
    try:
        srv.watch_engine.register({"name": "sw.c", "threshold": 5})
        srv.packet_queue.put(b"sw.c:10|c")
        t = _stuck_transfer(srv)
        assert srv.trigger_flush(timeout=60)
        assert srv.reshard_active and t.replays == 1
        ev = sub.get(timeout=30)
        assert ev is not None and (ev["from"], ev["to"]) == ("OK", "ALERT")
        assert ev["stale_bounded"] is True
    finally:
        srv.watch_engine.hub.unsubscribe(sub)
        FAULTS.reset()
        srv.reshard._transfer = None
        srv.shutdown()


def test_a_watch_evaluates_an_interval_detached_before_a_resize():
    """An interval a flush detached from the 2-shard mesh is evaluated by
    the watch thread after the Server resized to one shard: the watch
    reads it by its own [R, S, K] layout."""
    srv = tserver_mod.Server(
        _reshard_cfg(watch_enabled=True, tpu_n_shards=2,
                     native_ingest=False),
        metric_sinks=[DebugMetricSink()], device="cpu")
    srv.start()
    sub = srv.watch_engine.hub.subscribe()
    try:
        srv.watch_engine.register({"name": "wl.c", "threshold": 5})
        old = TSharded(srv.aggregator.spec, srv.aggregator.bspec,
                       n_shards=2, device="cpu")
        old.process_metric(tparser.parse_metric(b"wl.c:10|c"))
        state, table = old.swap()
        assert srv.trigger_reshard(1, timeout=60)["plan"] == "2->1"
        srv.watch_engine._evaluate_interval(state, table, 0, 1)
        ev = sub.get(timeout=30)
        assert ev is not None and ev["to"] == "ALERT"
        assert ev["value"] == 10.0
    finally:
        srv.watch_engine.hub.unsubscribe(sub)
        srv.shutdown()


def test_grow_conflicts_during_a_move_and_planning_waits():
    srv = tserver_mod.Server(
        _reshard_cfg(table_grow_enabled=True, native_ingest=False),
        metric_sinks=[DebugMetricSink()], device="cpu")
    srv.start()
    try:
        t = _stuck_transfer(srv)
        with pytest.raises(GrowConflict) as e:
            srv.trigger_table_grow({"counter": 512})
        assert e.value.status == 409
        # a grow already due waits: the flush mid-move swaps at the
        # capacities it has
        srv.tables.force({"counter": 512})
        assert srv.trigger_flush(timeout=60)
        assert t.replays == 1 and srv.reshard_active
        assert srv.aggregator.spec.counter_capacity == 256
        FAULTS.reset()
        srv.reshard._transfer = None
        assert srv.trigger_flush(timeout=60)
        assert srv.aggregator.spec.counter_capacity == 512
    finally:
        srv.shutdown()


def test_units_not_ready_at_a_flush_boundary_are_dropped_and_counted():
    srv = tserver_mod.Server(
        _reshard_cfg(reshard_transfer_timeout_s=0.2, overload_enabled=True),
        metric_sinks=[DebugMetricSink()], device="cpu")
    srv.start()
    try:
        t = _Transfer(2, 0)
        t.plan = tplan.ReshardPlan(1, 2)
        srv._resharding = True
        srv._overload.enter_resharding()
        srv.reshard._transfer = t
        assert srv.trigger_flush(timeout=60)
        assert t.done.is_set() and t.failed
        assert "not ready" in t.detail
        assert srv.reshard.failed_total == 1
        assert srv._c_reshard_failed.value() == 1
        assert not srv.reshard_active and not srv._resharding
        assert check_ready(srv)[1]["phase"] == "ready"
    finally:
        srv.shutdown()


# -- (g) the engine ------------------------------------------------------------------

def _emit_rows(eng, bs):
    arrays = (np.full(bs.counter, -1, np.int32),
              np.zeros(bs.counter, np.float32),
              np.full(bs.gauge, -1, np.int32),
              np.zeros(bs.gauge, np.float32),
              np.full(bs.set, -1, np.int32), np.zeros(bs.set, np.int32),
              np.zeros(bs.set, np.uint8),
              np.full(bs.histo, -1, np.int32),
              np.zeros(bs.histo, np.float32),
              np.zeros(bs.histo, np.float32))
    counts = eng.emit_into(arrays)
    return counts, arrays


def test_engine_shard_map_set_stages_like_jax():
    spec, bs = TableSpec(**AGG_KW), BatchSpec(**BSPEC_KW)
    jspec, jbs = JTableSpec(**AGG_KW), JBatchSpec(**BSPEC_KW)
    data = b"\n".join(_lines(5, n=300))
    t, j = NativeIngest(spec, bs, 4), JNativeIngest(jspec, jbs, 4)
    fresh = NativeIngest(spec, bs, 8)
    for eng in (t, j):
        eng.feed(data)
        eng.shard_map_set(8)
        # staged only: the next emit is still keyed under 4 shards
        _emit_rows(eng, bs)
        eng.reset()
        eng.feed(data)
    fresh.feed(data)
    (tc, ta), (jc, ja) = _emit_rows(t, bs), _emit_rows(j, bs)
    assert tc == jc and sum(tc) > 0
    for a, b in zip(ta, ja):
        np.testing.assert_array_equal(a, b)
    # the staged map took effect: the slots are an 8-shard engine's
    fc, fa = _emit_rows(fresh, bs)
    assert fc == tc
    for a, b in zip(ta, fa):
        np.testing.assert_array_equal(a, b)


def test_quiesce_helpers_stage_and_swap_like_jax():
    spec, bs = TableSpec(**AGG_KW), BatchSpec(**BSPEC_KW)
    t = TNativeSharded(spec, bs, n_shards=4, device="cpu")
    j = _JNativeSharded(JTableSpec(**AGG_KW), JBatchSpec(**BSPEC_KW),
                        n_shards=4)
    data = b"\n".join(_lines(6, n=300))
    t.feed(data)
    j.feed(data)
    (_, ttb), (_, jtb) = quiesce.shard_map_swap(t, 8), \
        jquiesce.shard_map_swap(j, 8)
    assert ttb.get_meta("counter") and \
        [m.name for _s, m in ttb.get_meta("counter")] == \
        [m.name for _s, m in jtb.get_meta("counter")]
    t8 = TNativeSharded(spec, bs, n_shards=8, device="cpu", engine=t.eng)
    t8.feed(data)
    j8 = _JNativeSharded(JTableSpec(**AGG_KW), JBatchSpec(**BSPEC_KW),
                         n_shards=8, engine=j.eng)
    j8.feed(data)
    _assert_rows(_rows(t8), _rows(j8))


def test_only_the_quiesce_module_calls_shard_map_set():
    """The port's reshard-quiesce rule (the JAX package's vtlint pass,
    analysis/reshard_quiesce.py): no module of veneur_tpu_torch but
    reshard/quiesce.py calls shard_map_set."""
    root = os.path.join(REPO, "veneur_tpu_torch")
    callers = []
    for dirpath, _dirs, files in os.walk(root):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            with open(path, encoding="utf-8") as fh:
                tree = ast.parse(fh.read(), path)
            for node in ast.walk(tree):
                if (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr == "shard_map_set"):
                    callers.append(os.path.relpath(path, root))
    assert sorted(set(callers)) == [os.path.join("reshard", "quiesce.py")]
