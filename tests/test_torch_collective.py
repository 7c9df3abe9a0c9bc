"""The port's collective global tier (ROADMAP A7) against the JAX package,
on the CPU; the JAX tier runs on the 8-device virtual CPU mesh, where
every grid below is a physical mesh (the port routes as one always).

- (a) the replica merges (collective/ops.py) against the JAX merged
  state at R in {1, 2, 4}: counters, gauges, status, stamps and HLL
  words byte-exact, digests re-compressed alike; the two-float fold is
  the exact sum, the HLL merge a register max, the last write the
  highest participant's;
- (b) the absorb: at R = 1 byte-exact against the port's own gRPC import
  path (export -> wire -> import_into), and at R = 1 and 2 against the
  JAX tier (state, flush and raw rows); participants spread over the
  replica rows; the routed ingest is the all_to_all's transpose; a
  query of the tier reads the merged sketches;
- (c) routing: arrival order does not move a key's owner shard, the
  routing signature is the JAX table's, two fresh interpreters agree,
  and route_digest is the restore recipe, the engine's vt_route_digest
  and the JAX route_digest over a corpus with surrogateescape bytes;
- (d) multi-host snapshot assembly restores onto a tier and onto a
  sharded backend alike;
- (e) the Server: a local with collective_attach hands its interval to a
  co-located global with collective_enabled (no wire forward), which
  flushes what the JAX pair flushes, with the connected span tree
  (flush.forward -> collective.absorb -> collective.replica_merge) and
  the veneur.collective.* self-metrics.

Integer sample values throughout: both paths round through f32 staging
alike, so comparisons are byte-equality where the JAX tests hold them so.
"""

import os
import subprocess
import sys
import time
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_server import (SMALL, _app, _assert_same_intermetrics,
                                     _CapturingJSink, _CapturingTSink, _wait)
from veneur_tpu.aggregation.host import BatchSpec as JBatchSpec
from veneur_tpu.aggregation.state import TableSpec as JTableSpec
from veneur_tpu.collective import keytable as jkeytable
from veneur_tpu.collective.router import make_merged_state
from veneur_tpu.collective.tier import CollectiveGlobalTier as JTier
from veneur_tpu.parallel import sharded as jsharded
from veneur_tpu.server.aggregator import Aggregator as JAggregator
from veneur_tpu_torch import config as tconfig
from veneur_tpu_torch.aggregation.host import (SCOPE_GLOBAL, SCOPE_MIXED,
                                               BatchSpec)
from veneur_tpu_torch.aggregation.state import TableSpec
from veneur_tpu_torch.collective import ops as tops
from veneur_tpu_torch.collective import router as trouter
from veneur_tpu_torch.collective import tier as ttier_mod
from veneur_tpu_torch.collective.keytable import (CollectiveKeyTable,
                                                  route_digest, route_shard)
from veneur_tpu_torch.collective.tier import CollectiveGlobalTier
from veneur_tpu_torch.forward.convert import export_metrics, import_into
from veneur_tpu_torch.ops import hll as thll
from veneur_tpu_torch.parallel import sharded as tsharded
from veneur_tpu_torch.server import server as tserver_mod
from veneur_tpu_torch.server.aggregator import Aggregator
from veneur_tpu_torch.server.sharded_aggregator import ShardedAggregator
from veneur_tpu_torch.utils.hashing import fnv1a_32

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC_KW = dict(counter_capacity=64, gauge_capacity=32, status_capacity=8,
               set_capacity=16, histo_capacity=32)
BSPEC_KW = dict(counter=256, gauge=32, status=8, set=64, histo=512,
                histo_stat=32)
SPEC, JSPEC = TableSpec(**SPEC_KW), JTableSpec(**SPEC_KW)
BS, JBS = BatchSpec(**BSPEC_KW), JBatchSpec(**BSPEC_KW)
PCTS = [0.5, 0.99]


def pm(agg, kind, name, value, scope=SCOPE_GLOBAL, tags=(), rate=1.0):
    agg.process_metric(SimpleNamespace(
        type=kind, name=name, tags=tuple(tags), scope=scope,
        digest=fnv1a_32(name.encode()), value=value, sample_rate=rate,
        hostname="", message="", joined_tags=",".join(tags)))


def _interval(agg, seed, pidx):
    """One local tier's interval: counters, a per-local gauge and a
    shared one, a timer, a mixed-scope histogram and a set, integer
    values (f32-exact on every path)."""
    rng = np.random.default_rng(seed)
    for i in range(5):
        for _ in range(3):
            pm(agg, "counter", f"c.{i}", int(rng.integers(1, 100)))
    pm(agg, "gauge", f"g.{pidx}", float(pidx) + 0.5)
    pm(agg, "gauge", "g.shared", float(pidx) + 0.25)
    for v in rng.integers(1, 1000, 20):
        pm(agg, "timer", "t.shared", float(v))
    for v in rng.integers(1, 500, 10):
        pm(agg, "histogram", "h.shared", float(v), scope=SCOPE_MIXED)
    for j in range(30):
        pm(agg, "set", "s.shared", f"member-{seed}-{j}")
    st, tb = agg.swap()
    _res, tb, raw = agg.compute_flush(st, tb, PCTS, want_raw=True)
    return raw, tb


def local_interval(seed, pidx):
    """(raw, table) of one port local's interval."""
    return _interval(Aggregator(SPEC, BS, device="cpu"), seed, pidx)


def _jax_local_interval(seed, pidx):
    return _interval(JAggregator(JSPEC, JBS), seed, pidx)


def _flush(agg):
    st, tb = agg.swap()
    res, tb, raw = agg.compute_flush(st, tb, PCTS, want_raw=True)
    return st, res, tb, raw


def collect(res, tb, raw=None):
    d = {}
    for kind, key in (("counter", "counter"), ("gauge", "gauge"),
                      ("set", "set_estimate")):
        for i, (_s, m) in enumerate(tb.get_meta(kind)):
            d[(key, m.name)] = float(res[key][i])
    for i, (_s, m) in enumerate(tb.get_meta("histogram")):
        for k in res:
            if k.startswith("histo_"):
                d[(k, m.name)] = np.asarray(res[k][i])
    if raw is not None:
        for i, (_s, m) in enumerate(tb.get_meta("set")):
            d[("raw_hll", m.name)] = np.asarray(raw["hll"][i])
        for i, (_s, m) in enumerate(tb.get_meta("histogram")):
            w, mean = raw["h_weight"][i], raw["h_mean"][i]
            live = w > 0
            order = np.lexsort((w[live], mean[live]))
            d[("raw_means", m.name)] = mean[live][order]
            d[("raw_weights", m.name)] = w[live][order]
    return d


def _assert_same(got, want, set_rtol=0.0, exact_hmean=True):
    assert set(got) == set(want) and got
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        if k[0] == "set_estimate":
            np.testing.assert_allclose(a, b, rtol=set_rtol, atol=0,
                                       err_msg=str(k))
        elif k[0] == "histo_hmean" and not exact_hmean:
            np.testing.assert_allclose(a, b, rtol=1e-5, err_msg=str(k))
        else:
            np.testing.assert_array_equal(a, b, err_msg=str(k))


# -- (a) the replica merges ------------------------------------------------------

def _random_state(rng, r, s, spec):
    from tests.test_torch_sharded import _rand_batch
    grid = [[_rand_batch(rng, spec, stats=False) for _ in range(s)]
            for _ in range(r)]
    st = tsharded.sharded_empty_state(spec, r, s, "cpu")
    tsharded.sharded_ingest(st, tsharded.stack_batches(grid, r, s),
                            spec=spec)
    return st


@pytest.mark.parametrize("r", [1, 2, 4])
def test_merged_state_matches_jax(r):
    s = 2
    spec = TableSpec(counter_capacity=32, gauge_capacity=16,
                     status_capacity=8, set_capacity=8, histo_capacity=16)
    jspec = JTableSpec(counter_capacity=32, gauge_capacity=16,
                       status_capacity=8, set_capacity=8, histo_capacity=16)
    st = _random_state(np.random.default_rng(r), r, s, spec)
    mesh = jsharded.make_mesh(r, s)
    jst = jax.device_put(
        type(jsharded.sharded_empty_state(jspec, r, s, mesh))(
            *[x.numpy() for x in st]), jsharded.state_sharding(mesh))
    want = jax.tree.map(np.asarray, make_merged_state(mesh, jspec)(jst))
    got = trouter.merged_state(st, spec, tsharded.Layout(r, s))
    for name in got._fields:
        a, b = getattr(got, name).numpy(), getattr(want, name)
        assert a.shape == b.shape, name
        if name in ("h_wm", "h_w"):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)


def test_twofloat_axis_sum_is_the_exact_sum_in_participant_order():
    rng = np.random.default_rng(0)
    vals = rng.integers(0, 1 << 30, size=(6, 32)).astype(np.float64)
    hi = torch.from_numpy(vals.astype(np.float32))
    lo = torch.from_numpy((vals - vals.astype(np.float32)).astype(
        np.float32))
    acc = torch.ones_like(hi)
    h, l = tops.twofloat_axis_sum(hi, lo, acc)
    got = h.double().numpy() + l.double().numpy()
    np.testing.assert_array_equal(got, vals.sum(0) + 6)


def test_hll_axis_max_is_a_register_max_not_a_word_max():
    rng = np.random.default_rng(1)
    p = 14
    dense = rng.integers(0, 40, size=(3, 4, 1 << p)).astype(np.uint8)
    packed = torch.from_numpy(thll.pack_registers_np(dense, p))
    got = tops.hll_axis_max(packed, precision=p).numpy()
    np.testing.assert_array_equal(
        got, thll.pack_registers_np(dense.max(0), p))
    assert not np.array_equal(got, packed.numpy().max(0))


def test_lww_highest_participant_that_wrote_wins():
    val = torch.tensor([[1.0, 2.0, 3.0], [4.0, 5.0, 6.0], [7.0, 8.0, 9.0]])
    stamp = torch.tensor([[1, 1, 0], [1, 0, 0], [0, 0, 0]], dtype=torch.uint8)
    merged, written = tops.lww_axis_merge(val, stamp)
    assert merged.tolist() == [4.0, 2.0, 3.0]
    assert written.tolist() == [1, 1, 0]


# -- (b) the absorb ------------------------------------------------------------

def test_absorb_byte_exact_vs_the_grpc_import_path_r1():
    tier = CollectiveGlobalTier(SPEC, BS, n_shards=2, n_replicas=1,
                                device="cpu")
    sh = ShardedAggregator(SPEC, BS, n_shards=2, device="cpu")
    from veneur_tpu_torch.proto import metricpb_pb2 as mpb
    for p in range(4):
        raw, tb = local_interval(100 + p, p)
        n = tier.absorb_raw(raw, tb)
        wire = export_metrics(raw, tb, SPEC.compression, SPEC.hll_precision)
        assert n == len(wire)
        for m in wire:
            import_into(sh, mpb.Metric.FromString(m.SerializeToString()))
    _st, rt, tt, rawt = _flush(tier)
    _st2, rs, ts, raws = _flush(sh)
    _assert_same(collect(rt, tt, rawt), collect(rs, ts, raws))


@pytest.mark.parametrize("r", [1, 2])
def test_absorb_matches_the_jax_tier(r):
    tier = CollectiveGlobalTier(SPEC, BS, n_shards=4, n_replicas=r,
                                device="cpu")
    jtier = JTier(JSPEC, JBS, n_shards=4, n_replicas=r)
    assert jtier._route_device   # a physical mesh on 8 devices
    for p in range(5):
        assert tier.absorb_raw(*local_interval(100 + p, p)) == \
            jtier.absorb_raw(*_jax_local_interval(100 + p, p))
    assert tier.absorbed_rows == jtier.absorbed_rows
    tst, rt, tt, rawt = _flush(tier)
    jst, rj, tj, rawj = _flush(jtier)
    for name in tst._fields:
        np.testing.assert_array_equal(getattr(tst, name).numpy(),
                                      np.asarray(getattr(jst, name)),
                                      err_msg=name)
    _assert_same(collect(rt, tt, rawt), collect(rj, tj, rawj),
                 set_rtol=1e-6)
    # the shared gauge: the owner tile takes source columns in order and
    # the merge takes the highest replica row that wrote. R = 1: columns
    # 0 (participants 0, 4) to 3 (participant 3); R = 2: row 1 holds
    # participants 1 and 3. Participant 3's write wins either way.
    assert collect(rt, tt)[("gauge", "g.shared")] == 3.25


def test_participants_spread_over_replica_rows():
    tier = CollectiveGlobalTier(SPEC, BS, n_shards=2, n_replicas=2,
                                device="cpu")
    assert [tier.assign_participant() for _ in range(3)] == [0, 1, 2]
    raw, tb = local_interval(7, 0)
    tier.absorb_raw(raw, tb, participant=1)
    tier._emit_absorbed()
    c = tier.state.counter_hi.numpy()
    assert c[1].sum() > 0 and c[0].sum() == 0


def test_route_batches_is_the_all_to_all_transpose():
    rng = np.random.default_rng(2)
    from tests.test_torch_sharded import _rand_batch
    spec = TableSpec(counter_capacity=32, gauge_capacity=16,
                     status_capacity=8, set_capacity=8, histo_capacity=16)
    r, s = 2, 3
    grid = [[[_rand_batch(rng, spec, b=8) for _ in range(s)]
             for _ in range(s)] for _ in range(r)]
    routed = trouter.route_batches(grid)
    for ri in range(r):
        for d in range(s):
            for i, name in enumerate(grid[0][0][0]._fields):
                want = np.concatenate([grid[ri][j][d][i] for j in range(s)])
                np.testing.assert_array_equal(routed[ri][d][i], want,
                                              err_msg=name)


@pytest.mark.parametrize("r", [1, 2])
def test_tier_query_reads_the_merged_sketches_as_jax(r):
    tier = CollectiveGlobalTier(SPEC, BS, n_shards=4, n_replicas=r,
                                device="cpu")
    jtier = JTier(JSPEC, JBS, n_shards=4, n_replicas=r)
    for p in range(3):
        tier.absorb_raw(*local_interval(200 + p, p))
        jtier.absorb_raw(*_jax_local_interval(200 + p, p))
    st, _tb, _shift = tier.query_snapshot()
    jst, _jtb, _jshift = jtier.query_snapshot()
    got = tier.query_flat_state(st)
    want = jax.tree.map(np.asarray, jtier.query_flat_state(jst))
    for name in got._fields:
        a, b = getattr(got, name).numpy(), getattr(want, name)
        assert a.shape == b.shape, name
        if name in ("h_wm", "h_w"):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)


# -- (c) routing ----------------------------------------------------------------------

_KEYS = [("counter", f"det.c.{i}", "env:prod,zone:a") for i in range(40)] \
    + [("timer", f"det.t.{i}", "") for i in range(40)] \
    + [("set", f"det.s.{i}", "svc:x") for i in range(20)]
_ROUTE_KW = dict(counter_capacity=512, gauge_capacity=64, status_capacity=8,
                 set_capacity=256, histo_capacity=512)


def _routing_table_signature(order_seed, table_cls=CollectiveKeyTable,
                             spec_cls=TableSpec):
    keys = list(_KEYS)
    np.random.default_rng(order_seed).shuffle(keys)
    table = table_cls(spec_cls(**_ROUTE_KW), n_shards=4)
    for kind, name, joined in keys:
        tags = tuple(joined.split(",")) if joined else ()
        table.slot_for_routed(kind, name, tags, SCOPE_GLOBAL,
                              joined_tags=joined)
    return table.routing_signature()


def test_routing_ignores_arrival_order_and_is_the_jax_signature():
    sig = _routing_table_signature(1)
    assert sig == _routing_table_signature(2)
    assert sig == _routing_table_signature(
        3, jkeytable.CollectiveKeyTable, JTableSpec)


def test_routing_determinism_across_process_restarts():
    prog = (
        "from tests.test_torch_collective import ("
        "_routing_table_signature, _KEYS)\n"
        "from veneur_tpu_torch.collective.keytable import route_shard\n"
        "sig = _routing_table_signature(3)\n"
        "shards = [route_shard(k, n, j, 4) for k, n, j in _KEYS]\n"
        "print(sig, ','.join(map(str, shards)))\n")
    want_sig = _routing_table_signature(3)
    want = [route_shard(k, n, j, 4) for k, n, j in _KEYS]
    for hashseed in ("1", "2"):
        env = {**os.environ, "PYTHONHASHSEED": hashseed,
               "JAX_PLATFORMS": "cpu"}
        proc = subprocess.run([sys.executable, "-c", prog],
                              capture_output=True, text=True, cwd=REPO,
                              env=env, timeout=120)
        assert proc.returncode == 0, proc.stderr
        sig, shards = proc.stdout.split()
        assert int(sig) == want_sig
        assert [int(x) for x in shards.split(",")] == want


def test_route_digest_is_the_restore_recipe_the_engine_and_jax():
    from veneur_tpu_torch import native
    from veneur_tpu_torch.persistence.restore import _digest
    rng = np.random.default_rng(4)
    corpus = list(_KEYS) + [
        ("gauge", "caf\u00e9.latency", "r\u00e9gion:eu"),
        ("histogram", b"bad\xff\xfe".decode("utf-8", "surrogateescape"),
         b"t:\x80".decode("utf-8", "surrogateescape")),
        ("counter", "", ""), ("set", "a,b", "x:1,y:2")]
    for _ in range(200):
        raw = bytes(rng.integers(1, 256, int(rng.integers(0, 24))))
        corpus.append((["counter", "gauge", "timer", "set"][
            int(rng.integers(0, 4))],
            raw.decode("utf-8", "surrogateescape"),
            raw[::-1].decode("utf-8", "surrogateescape")))
    for kind, name, joined in corpus:
        d = route_digest(kind, name, joined)
        assert d == _digest(kind, name, joined)
        assert d == native.route_digest(kind, name, joined)
        assert d == jkeytable.route_digest(kind, name, joined)
        assert route_shard(kind, name, joined, 8) == d % 8


# -- (d) multi-host snapshot assembly ----------------------------------------------

def test_assembly_round_trip_onto_a_tier_and_a_sharded_backend(tmp_path):
    from veneur_tpu_torch.persistence import (build_snapshot,
                                              finalize_assembly,
                                              fold_snapshot, restore_latest,
                                              write_part)
    parts = []
    for rank in range(3):
        agg = Aggregator(SPEC, BS, device="cpu")
        rng = np.random.default_rng(900 + rank)
        for i in range(4):
            pm(agg, "counter", f"asm.c.{rank}.{i}", int(rng.integers(1, 50)))
        pm(agg, "gauge", f"asm.g.{rank}", float(rank) * 2.0)
        for v in rng.integers(1, 300, 12):
            pm(agg, "timer", f"asm.t.{rank}", float(v))
        for j in range(15):
            pm(agg, "set", f"asm.s.{rank}", f"m-{rank}-{j}")
        st, tb = agg.swap()
        res, tb, raw = agg.compute_flush(st, tb, PCTS, want_raw=True)
        parts.append(build_snapshot(agg.spec, tb, res, raw,
                                    agg_kind="sharded", n_shards=1,
                                    interval_ts=1722470400,
                                    hostname=f"proc-{rank}"))
    for rank, snap in enumerate(parts):
        write_part(str(tmp_path), 7, rank, snap)
    assert restore_latest(str(tmp_path)) is None
    finalize_assembly(str(tmp_path), 7, n_parts=3)
    snap, path = restore_latest(str(tmp_path))
    assert path.endswith("ckpt-00000007-assembly")
    n_rows = sum(len(snap["tables"][k]) for k in snap["tables"])
    tier = CollectiveGlobalTier(SPEC, BS, n_shards=2, n_replicas=2,
                                device="cpu")
    sh = ShardedAggregator(SPEC, BS, n_shards=2, device="cpu")
    assert fold_snapshot(tier, snap) == n_rows
    assert fold_snapshot(sh, snap) == n_rows
    _st, rt, tt, _ = _flush(tier)
    _st2, rs, ts, _ = _flush(sh)
    _assert_same(collect(rt, tt), collect(rs, ts))


# -- (e) the Server -----------------------------------------------------------------

LINES = ([b"colo.count:3|c|#veneurglobalonly"] * 5
         + [b"colo.timer:%d|ms" % v for v in (10, 20, 30, 40)]
         + [b"colo.set:u%d|s" % i for i in range(8)]
         + [b"colo.gauge:%d|g|#veneurglobalonly" % v for v in (1, 2, 3)])


def _pair(mod, cfg_mod, group, sink_cls, **kw):
    base = dict(SMALL, interval="3600s")
    gsink = sink_cls()
    gkw = dict(metric_sinks=[gsink])
    lkw = dict(metric_sinks=[sink_cls()])
    if mod is tserver_mod:
        gkw["device"] = lkw["device"] = "cpu"
    gsrv = mod.Server(cfg_mod.Config(**dict(
        base, collective_enabled=True, collective_group=group,
        tpu_n_shards=4, tpu_n_replicas=2)), **gkw)
    lsrv = mod.Server(cfg_mod.Config(**dict(
        base, collective_attach=group, **kw)), **lkw)
    return gsrv, gsink, lsrv


def _drive(gsrv, gsink, lsrv):
    import socket
    gsrv.start()
    lsrv.start()
    try:
        assert lsrv.cfg.is_local and lsrv._forward_client is None
        tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        tx.sendto(b"\n".join(LINES), lsrv.local_addr(0))
        tx.close()
        _wait(lambda: lsrv.aggregator.processed >= len(LINES), "lines")
        assert lsrv.trigger_flush(timeout=120)
        assert gsrv.aggregator.absorbed_rows > 0
        gsink.flushed.clear()
        assert gsrv.trigger_flush(timeout=120)
        return _app(gsink.flushed), lsrv._c_coll_rows.value()
    finally:
        lsrv.shutdown()
        gsrv.shutdown()


def test_server_colocated_absorb_skips_the_wire_and_matches_jax():
    from veneur_tpu import config as jconfig
    from veneur_tpu.server import server as jserver_mod
    tg, tsink, tl = _pair(tserver_mod, tconfig, "t-colo", _CapturingTSink)
    assert isinstance(tg.aggregator, CollectiveGlobalTier)
    assert ttier_mod.lookup("t-colo") is tg.aggregator
    got, rows = _drive(tg, tsink, tl)
    assert ttier_mod.lookup("t-colo") is None
    jg, jsink, jl = _pair(jserver_mod, jconfig, "j-colo", _CapturingJSink)
    want, jrows = _drive(jg, jsink, jl)
    assert rows == jrows > 0
    _assert_same_intermetrics(got, want)
    m = {x.name: x.value for x in got}
    assert m["colo.count"] == 15.0
    assert m["colo.timer.50percentile"] == 25.0
    assert round(m["colo.set"]) == 8


def test_colocated_flush_produces_a_connected_span_tree():
    from veneur_tpu_torch.sinks.debug import DebugSpanSink
    base = dict(SMALL, interval="3600s")
    gsrv = tserver_mod.Server(tconfig.Config(**dict(
        base, collective_enabled=True, collective_group="span1",
        tpu_n_shards=4, tpu_n_replicas=2)),
        metric_sinks=[_CapturingTSink()], device="cpu")
    ssink = DebugSpanSink()
    lsrv = tserver_mod.Server(tconfig.Config(**dict(
        base, collective_attach="span1")), metric_sinks=[_CapturingTSink()],
        span_sinks=[ssink], device="cpu")
    gsrv.start()
    lsrv.start()
    want = {"flush.forward", "collective.absorb", "collective.replica_merge"}

    def tree():
        by_trace = {}
        for sp in list(ssink.spans):
            by_trace.setdefault(sp.trace_id, {})[sp.name] = sp
        for t in by_trace.values():
            if want <= set(t):
                return t
        return None
    try:
        import socket
        tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        tx.sendto(b"sp.count:1|c|#veneurglobalonly", lsrv.local_addr(0))
        tx.close()
        _wait(lambda: lsrv.aggregator.processed >= 1, "line")
        assert lsrv.trigger_flush(timeout=120)
        assert gsrv.trigger_flush(timeout=120)
        t0 = time.time()
        t = tree()
        while t is None and time.time() - t0 < 60.0:
            lsrv.trigger_flush(timeout=60)
            time.sleep(0.05)
            t = tree()
        assert t is not None, sorted({s.name for s in list(ssink.spans)})
        fwd, absorb = t["flush.forward"], t["collective.absorb"]
        merge = t["collective.replica_merge"]
        assert fwd.tags.get("transport") == "colocated"
        assert absorb.tags.get("transport") == "colocated"
        assert absorb.parent_id == fwd.id
        assert merge.parent_id == absorb.id
        assert int(absorb.tags["rows"]) > 0
        # the local injected its registry's timer into the tier
        phases = {k[0] for k, _st in lsrv._t_coll_phase.snapshot()}
        assert {"stage", "all_to_all_route", "replica_merge",
                "flush"} <= phases
    finally:
        lsrv.shutdown()
        gsrv.shutdown()



def test_concurrent_absorbs_and_direct_ingest_lose_nothing():
    """Twelve threads absorb the same local's interval under distinct
    participants, three times each, while one more ingests direct
    counters, with a short switch interval and small lanes (many routed
    and direct steps, a compaction every second routed step): every
    counter is the exact sum and `processed` counts every row."""
    import threading
    from veneur_tpu_torch.forward.convert import iter_forwardable
    tier = CollectiveGlobalTier(
        SPEC, BatchSpec(**dict(BSPEC_KW, counter=32, gauge=16)),
        n_shards=2, n_replicas=2, device="cpu", compact_every=2)
    raw, tb = local_interval(300, 0)
    n_rows = sum(1 for _ in iter_forwardable(raw, tb, SPEC.hll_precision))
    one = {m.name: float(raw["counter"][i])
           for i, (_s, m) in enumerate(tb.get_meta("counter"))}
    errors = []

    def absorb(p):
        try:
            for _ in range(3):
                tier.absorb_raw(raw, tb, participant=p)
        except BaseException as e:      # reported on the test's thread
            errors.append(e)

    def direct():
        try:
            for _ in range(400):
                pm(tier, "counter", "direct.c", 1)
        except BaseException as e:
            errors.append(e)

    threads = [threading.Thread(target=absorb, args=(p,))
               for p in range(12)] + [threading.Thread(target=direct)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert tier.processed == 36 * n_rows + 400
    _st, res, table, _raw = _flush(tier)
    got = collect(res, table)
    assert got[("counter", "direct.c")] == 400.0
    for name, v in one.items():
        assert got[("counter", name)] == 36 * v, name
