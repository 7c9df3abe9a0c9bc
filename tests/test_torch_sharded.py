"""The port's sharded key table (ROADMAP A7) against the JAX package, on
the CPU. The JAX side runs on the 8-device virtual CPU mesh of
tests/conftest.py, so every [R, S] grid below is a physical mesh there;
the port keeps the whole grid on one device.

- (a) the layout: per_shard_spec, the [R, S] state as views of one
  flattened table, stack_batches;
- (b) the packed sharded ingest at (R, S) in {(2, 4), (1, 8), (4, 2)}
  against make_sharded_ingest_packed, compaction steps included:
  counters, gauges, status, stamps and HLL words byte-exact, the digest
  leaves too on these integer-valued batches (the kernel-level promise;
  end to end digests are held to quantile tolerance, C-watch 3);
- (c) a tile's padding sentinel stays in its tile: a non-empty tile
  followed by an empty one ingests as the single-device step of each
  tile alone, byte for byte, and leaves the empty tile empty;
- (d) the merged flush against make_merged_flush: counters, gauges and
  status exact, set estimates within rtol 1e-6 (C-watch 7), quantiles
  within rtol/atol 2e-5; merged p50/p99 of one key split over replicas
  against the midpoint quantiles of its samples;
- (e) the backends: ShardedAggregator and NativeShardedAggregator (split
  and pre-sharded emits, reader rings) against the JAX package's, state
  and flush with raw rows; HLL imports folded and merged; imports;
- (f) the Server at tpu_n_shards 8 on both ingest routes against the JAX
  Server, the flush resets, the native sharded backend selected, the
  pre-sharded flush equal to the split one, a sharded local forwarding
  to a single-device global, the Python-side paths of the native
  backend;
- (g) a sharded checkpoint written by either package restores into the
  other's sharded backend.

The JAX aggregators wait for each of their steps (ROADMAP C-watch 4).
"""

import socket

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_server import (
    SMALL, _app, _assert_same_intermetrics, _CapturingJSink,
    _CapturingTSink, _send, _SyncedJServer, _traffic, _wait)
from veneur_tpu import config as jconfig
from veneur_tpu.aggregation import step as jstep
from veneur_tpu.aggregation.host import BatchSpec as JBatchSpec
from veneur_tpu.aggregation.state import TableSpec as JTableSpec
from veneur_tpu.parallel import sharded as jsharded
from veneur_tpu.proto import ssf_pb2 as jssf
from veneur_tpu.samplers import parser as jparser
from veneur_tpu.server import server as jserver_mod
from veneur_tpu.server.native_aggregator import (
    NativeShardedAggregator as JNativeSharded)
from veneur_tpu.server.sharded_aggregator import (
    ShardedAggregator as JSharded)
from veneur_tpu.server.sharded_aggregator import (
    per_shard_spec as jper_shard_spec)
from veneur_tpu_torch import config as tconfig
from veneur_tpu_torch.aggregation import step as tstep
from veneur_tpu_torch.aggregation.host import Batcher, BatchSpec
from veneur_tpu_torch.aggregation.state import TableSpec, empty_state
from veneur_tpu_torch.ops import hll as thll
from veneur_tpu_torch.parallel import sharded as tsharded
from veneur_tpu_torch.proto import ssf_pb2 as tssf
from veneur_tpu_torch.samplers import parser as tparser
from veneur_tpu_torch.server import server as tserver_mod
from veneur_tpu_torch.server.native_aggregator import (
    NativeShardedAggregator as TNativeSharded)
from veneur_tpu_torch.server.sharded_aggregator import (
    ShardedAggregator as TSharded)

SPEC_KW = dict(counter_capacity=32, gauge_capacity=16, status_capacity=8,
               set_capacity=8, histo_capacity=16)
SPEC = TableSpec(**SPEC_KW)
JSPEC = JTableSpec(**SPEC_KW)
AGG_KW = dict(counter_capacity=64, gauge_capacity=32, status_capacity=8,
              set_capacity=16, histo_capacity=32)
BSPEC_KW = dict(counter=64, gauge=16, status=8, set=32, histo=128,
                histo_stat=16)
PERC = [0.5, 0.99]
NON_DIGEST = ("counter_acc", "counter_hi", "counter_lo", "gauge",
              "gauge_stamp", "status", "status_stamp", "hll")
GRIDS = [(2, 4), (1, 8), (4, 2)]


def _np_state(state):
    if isinstance(state[0], torch.Tensor):
        return {k: v.numpy() for k, v in state._asdict().items()}
    return {k: np.asarray(v) for k, v in state._asdict().items()}


def _rand_batch(rng, spec, b=64, stats=True):
    """A padded batch touching every table, integer-valued samples (f32
    exact on both sides), duplicate slots and padding rows."""
    n = b // 2

    def slots(cap, m=n):
        s = rng.integers(0, cap, size=m).astype(np.int32)
        return np.concatenate([s, np.full(b - m, cap, np.int32)])

    live = np.concatenate([np.ones(n), np.zeros(b - n)]).astype(np.float32)
    stat_n = 4
    return tstep.Batch(
        counter_slot=slots(spec.counter_capacity),
        counter_inc=(rng.integers(1, 50, b) * live).astype(np.float32),
        gauge_slot=slots(spec.gauge_capacity),
        gauge_val=rng.integers(-9, 9, b).astype(np.float32),
        status_slot=slots(spec.status_capacity),
        status_val=rng.integers(0, 3, b).astype(np.float32),
        set_slot=slots(spec.set_capacity),
        set_reg=rng.integers(0, spec.registers, b).astype(np.int32),
        set_rho=rng.integers(1, 30, b).astype(np.uint8),
        histo_slot=slots(spec.histo_capacity),
        histo_val=rng.integers(1, 500, b).astype(np.float32),
        histo_wt=live,
        histo_stat_slot=(slots(spec.histo_capacity, stat_n)[:8]
                         if stats else None),
        histo_stat_min=(rng.integers(0, 9, 8).astype(np.float32)
                        if stats else None),
        histo_stat_max=(rng.integers(600, 700, 8).astype(np.float32)
                        if stats else None),
        histo_stat_recip=(np.zeros(8, np.float32) if stats else None))


# -- (a) the layout ---------------------------------------------------------------

def test_per_shard_spec_matches_jax_and_refuses_what_jax_refuses():
    spec = TableSpec(**AGG_KW)
    got = tsharded.per_shard_spec(spec, 4)
    want = jper_shard_spec(JTableSpec(**AGG_KW), 4)
    for f in ("counter_capacity", "gauge_capacity", "status_capacity",
              "set_capacity", "histo_capacity", "hll_precision"):
        assert getattr(got, f) == getattr(want, f), f
    for n in (3, 64):
        with pytest.raises(ValueError, match="multiple of tpu_n_shards"):
            jper_shard_spec(JTableSpec(**AGG_KW), n)
        with pytest.raises(ValueError, match="multiple of tpu_n_shards"):
            tsharded.per_shard_spec(spec, n)


def test_sharded_state_is_views_of_one_flat_table():
    st = tsharded.sharded_empty_state(SPEC, 2, 4, "cpu")
    j = jax.tree.map(np.asarray, jsharded.sharded_empty_state(
        JSPEC, 2, 4, jsharded.make_mesh(2, 4)))
    for name, t in st._asdict().items():
        want = np.asarray(getattr(j, name))
        assert t.numpy().shape == want.shape, name
        np.testing.assert_array_equal(t.numpy(), want, err_msg=name)
    flat = tsharded.flat_view(st)
    fspec = tsharded.flat_spec(SPEC, 8)
    ref = empty_state(fspec, "cpu")
    for name in st._fields:
        a, b = getattr(flat, name), getattr(ref, name)
        assert a.shape == b.shape and a.data_ptr() == getattr(
            st, name).data_ptr(), name
    # a write through the flat view lands in tile (1, 2), row 3
    flat.counter_hi[(1 * 4 + 2) * SPEC.counter_capacity + 3] = 7.0
    assert float(st.counter_hi[1, 2, 3]) == 7.0


def test_stack_batches_matches_jax():
    rng = np.random.default_rng(5)
    grid = [[_rand_batch(rng, SPEC) for _ in range(3)] for _ in range(2)]
    got = tsharded.stack_batches(grid, 2, 3)
    want = jsharded.stack_batches(
        [[jstep.Batch(*b) for b in row] for row in grid], 2, 3)
    for name, a, b in zip(tstep.Batch._fields, got, want):
        np.testing.assert_array_equal(a, b, err_msg=name)
    grid[1][2] = grid[1][2]._replace(histo_stat_slot=None)
    with pytest.raises(ValueError, match="agree"):
        tsharded.stack_batches(grid, 2, 3)


# -- (b) the packed sharded ingest --------------------------------------------------

@pytest.mark.parametrize("r,s", GRIDS)
def test_sharded_ingest_packed_matches_jax(r, s):
    rng = np.random.default_rng(7 + r * s)
    mesh = jsharded.make_mesh(r, s)
    jstate = jsharded.sharded_empty_state(JSPEC, r, s, mesh)
    tstate = tsharded.sharded_empty_state(SPEC, r, s, "cpu")
    for step in range(4):
        grid = [[_rand_batch(rng, SPEC) for _ in range(s)]
                for _ in range(r)]
        compact = step == 2
        flat = tsharded.pack_tiles(tsharded.stack_batches(grid, r, s),
                                   compact)
        sizes = tstep.batch_sizes(grid[0][0])
        jflat = np.stack([np.stack([jstep.pack_batch(jstep.Batch(*b),
                                                     compact)
                                    for b in row]) for row in grid])
        np.testing.assert_array_equal(flat, jflat)
        jstate = jsharded.make_sharded_ingest_packed(mesh, JSPEC, sizes)(
            jstate, jflat)
        tsharded.sharded_ingest_packed(tstate, torch.from_numpy(flat),
                                       spec=SPEC, sizes=sizes,
                                       do_compact=compact)
    got, want = _np_state(tstate), _np_state(jstate)
    for name in got:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    assert any(got["gauge_stamp"].ravel()) and any(got["hll"].ravel())


# -- (c) the padding sentinel stays in its tile ------------------------------------

@pytest.mark.parametrize("r,s", [(1, 2), (2, 2), (1, 4)])
def test_padding_sentinel_stays_in_its_tile(r, s):
    """Tile (0, 0) carries a batch whose padding rows hold its per-shard
    capacity, every other tile only padding. Offset without the remap,
    that sentinel would be row 0 of tile (0, 1): its gauge stamp, set
    row and stats lanes would be written there."""
    rng = np.random.default_rng(11)
    busy = _rand_batch(rng, SPEC)
    idle = Batcher(SPEC, BatchSpec(counter=64, gauge=64, status=64,
                                   set=64, histo=64,
                                   histo_stat=8)).force_emit()
    grid = [[busy if (ri, si) == (0, 0) else idle for si in range(s)]
            for ri in range(r)]
    st = tsharded.sharded_empty_state(SPEC, r, s, "cpu")
    tsharded.sharded_ingest(st, tsharded.stack_batches(grid, r, s),
                            spec=SPEC)
    one = empty_state(SPEC, "cpu")
    tstep.ingest_core(one, tstep.unpack_batch(
        torch.from_numpy(tstep.pack_batch(busy))[1:],
        tstep.batch_sizes(busy)), spec=SPEC)
    blank = empty_state(SPEC, "cpu")
    for name in st._fields:
        tiles = getattr(st, name)
        np.testing.assert_array_equal(tiles[0, 0].numpy(),
                                      getattr(one, name).numpy(),
                                      err_msg=f"{name} tile (0, 0)")
        for ri in range(r):
            for si in range(s):
                if (ri, si) != (0, 0):
                    np.testing.assert_array_equal(
                        tiles[ri, si].numpy(), getattr(blank, name).numpy(),
                        err_msg=f"{name} tile ({ri}, {si})")


# -- (d) the merged flush ------------------------------------------------------------

def _assert_flush_like_jax(got, want, lead=None):
    for key in ("counter", "gauge", "status", "histo_count", "histo_min",
                "histo_max", "histo_sum"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    np.testing.assert_allclose(got["set_estimate"], want["set_estimate"],
                               rtol=1e-6, atol=0)
    for key in ("histo_quantiles", "histo_median"):
        np.testing.assert_allclose(got[key], want[key], rtol=2e-5,
                                   atol=2e-5, equal_nan=True, err_msg=key)


@pytest.mark.parametrize("r,s", GRIDS)
def test_merged_flush_matches_jax(r, s):
    rng = np.random.default_rng(3 + r)
    mesh = jsharded.make_mesh(r, s)
    grid = [[_rand_batch(rng, SPEC, stats=False) for _ in range(s)]
            for _ in range(r)]
    jstate = jsharded.make_sharded_ingest(mesh, JSPEC)(
        jsharded.sharded_empty_state(JSPEC, r, s, mesh),
        jsharded.stack_batches([[jstep.Batch(*b) for b in row]
                                for row in grid], r, s))
    tstate = tsharded.sharded_empty_state(SPEC, r, s, "cpu")
    tsharded.sharded_ingest(tstate, tsharded.stack_batches(grid, r, s),
                            spec=SPEC)
    qs = np.asarray(PERC, np.float32)
    want = jstep.combine_flush_scalars(jax.tree.map(
        np.asarray, jsharded.make_merged_flush(mesh, JSPEC)(jstate, qs)))
    got = tstep.combine_flush_scalars(tsharded.merged_flush(
        tstate, qs, spec=SPEC, layout=tsharded.Layout(r, s)))
    _assert_flush_like_jax(got, want)
    # replica 1's write wins a gauge row wherever it wrote (r > 1)
    if r > 1:
        g = tstate.gauge.numpy()
        st = tstate.gauge_stamp.numpy()
        last = np.where(st[r - 1] > 0, g[r - 1], got["gauge"])
        np.testing.assert_array_equal(got["gauge"], last)


def _midpoint(vals, q):
    v = np.sort(np.asarray(vals, np.float64))
    pos = q * len(v) - 0.5
    i = int(np.clip(np.floor(pos), 0, len(v) - 1))
    j = min(i + 1, len(v) - 1)
    f = np.clip(pos - i, 0.0, 1.0)
    return v[i] + f * (v[j] - v[i])


def test_merged_quantiles_across_replicas_against_the_midpoint_oracle():
    """One key's samples split over two replica rows: the merged p50/p99
    sit within 2% / 1% of the sample range from the midpoint quantiles
    of all the samples, and equal the JAX merged flush's."""
    r, s = 2, 1
    spec_kw = dict(counter_capacity=8, gauge_capacity=8, status_capacity=8,
                   set_capacity=8, histo_capacity=8)
    spec, jspec = TableSpec(**spec_kw), JTableSpec(**spec_kw)
    rng = np.random.default_rng(11)
    vals = rng.uniform(0, 1, 4096).astype(np.float32)
    halves = [vals[:2048], vals[2048:]]
    b = 256
    # lanes wider than a wave: a full lane would emit on its own
    bs = BatchSpec(counter=b, gauge=b, status=b, set=b, histo=2 * b,
                   histo_stat=8)
    mesh = jsharded.make_mesh(r, s)
    jstate = jsharded.sharded_empty_state(jspec, r, s, mesh)
    tstate = tsharded.sharded_empty_state(spec, r, s, "cpu")
    for i in range(2048 // b):
        grid = []
        for ri in range(r):
            bt = Batcher(spec, bs)
            bt.add_histos_bulk(np.zeros(b, np.int32),
                               halves[ri][i * b:(i + 1) * b],
                               np.ones(b, np.float32))
            grid.append([bt.force_emit()])
        jstate = jsharded.make_sharded_ingest(mesh, jspec)(
            jstate, jsharded.stack_batches(
                [[jstep.Batch(*x) for x in row] for row in grid], r, s))
        tsharded.sharded_ingest(tstate, tsharded.stack_batches(grid, r, s),
                                spec=spec)
    qs = np.asarray([0.5, 0.99], np.float32)
    got = tsharded.merged_flush(tstate, qs, spec=spec,
                                layout=tsharded.Layout(r, s))
    want = jax.tree.map(np.asarray,
                        jsharded.make_merged_flush(mesh, jspec)(jstate, qs))
    q = got["histo_quantiles"][0, 0]
    np.testing.assert_allclose(q, want["histo_quantiles"][0, 0], rtol=2e-5,
                               atol=2e-5)
    span = float(vals.max() - vals.min())
    assert abs(q[0] - _midpoint(vals, 0.5)) <= 0.02 * span
    assert abs(q[1] - _midpoint(vals, 0.99)) <= 0.01 * span


# -- (e) the backends ----------------------------------------------------------------

class _SyncedJSharded(JSharded):
    def _dispatch_row(self, row):
        super()._dispatch_row(row)
        jax.block_until_ready(self.state)


class _SyncedJNativeSharded(JNativeSharded):
    def _dispatch_row(self, row):
        super()._dispatch_row(row)
        jax.block_until_ready(self.state)


def _lines(seed, n=1200, names=10):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        k, i = int(rng.integers(0, 5)), int(rng.integers(0, names))
        v = int(rng.integers(1, 1000))
        out.append([f"c{i}:{v}|c", f"g{i}:{v}|g", f"t{i}:{v}|ms",
                    f"s{i}:m{v}|s", f"h{i}:{v}|h|@0.5"][k].encode())
    return out


def _by_name(res, table, raw=None):
    d = {}
    for kind, key in (("counter", "counter"), ("gauge", "gauge"),
                      ("status", "status"), ("set", "set_estimate")):
        for i, (_s, m) in enumerate(table.get_meta(kind)):
            d[(key, m.name)] = float(res[key][i])
    for i, (_s, m) in enumerate(table.get_meta("histogram")):
        for k in res:
            if k.startswith("histo_"):
                d[(k, m.name)] = np.asarray(res[k][i])
    if raw is not None:
        for i, (_s, m) in enumerate(table.get_meta("set")):
            d[("raw_hll", m.name)] = np.asarray(raw["hll"][i])
        for i, (_s, m) in enumerate(table.get_meta("histogram")):
            for k in ("h_mean", "h_weight", "h_min", "h_max", "h_recip"):
                d[("raw_" + k, m.name)] = np.asarray(raw[k][i])
    return d


def _assert_maps(got, want, q_tol=2e-5, set_rtol=1e-6):
    assert set(got) == set(want) and got
    for key in want:
        a, b = np.asarray(got[key]), np.asarray(want[key])
        if key[0] in ("histo_quantiles", "histo_median", "histo_hmean"):
            np.testing.assert_allclose(a, b, rtol=q_tol, atol=q_tol,
                                       equal_nan=True, err_msg=str(key))
        elif key[0] == "set_estimate":
            np.testing.assert_allclose(a, b, rtol=set_rtol, atol=0,
                                       err_msg=str(key))
        else:
            np.testing.assert_array_equal(a, b, err_msg=str(key))


def _flush(agg):
    st, tb = agg.swap()
    res, tb, raw = agg.compute_flush(st, tb, PERC, want_raw=True)
    return st, res, tb, raw


@pytest.mark.parametrize("route", ["python", "native", "preshard"])
def test_sharded_backends_match_jax(route):
    spec, jspec = TableSpec(**AGG_KW), JTableSpec(**AGG_KW)
    bs, jbs = BatchSpec(**BSPEC_KW), JBatchSpec(**BSPEC_KW)
    data = b"\n".join(_lines(3))
    if route == "python":
        t = TSharded(spec, bs, n_shards=4, device="cpu")
        j = _SyncedJSharded(jspec, jbs, n_shards=4)
        for line in data.split(b"\n"):
            t.process_metric(tparser.parse_metric(line))
            j.process_metric(jparser.parse_metric(line))
    else:
        pre = route == "preshard"
        t = TNativeSharded(spec, bs, n_shards=4, device="cpu", preshard=pre)
        j = _SyncedJNativeSharded(jspec, jbs, n_shards=4, preshard=pre)
        t.feed(data)
        j.feed(data)
    assert t.processed == j.processed == 1200
    tst, tres, ttb, traw = _flush(t)
    jst, jres, jtb, jraw = _flush(j)
    got, want = _np_state(tst), _np_state(jst)
    for name in got:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    _assert_maps(_by_name(tres, ttb, traw), _by_name(jres, jtb, jraw))
    assert t.steps_total == j.steps_total > 1


def test_preshard_state_byte_identical_to_split_shards():
    spec, bs = TableSpec(**AGG_KW), BatchSpec(**BSPEC_KW)
    data = b"\n".join(_lines(9, n=3000, names=12))
    split = TNativeSharded(spec, bs, n_shards=4, device="cpu")
    pre = TNativeSharded(spec, bs, n_shards=4, device="cpu", preshard=True)
    split.feed(data)
    pre.feed(data)
    a, b = _flush(split), _flush(pre)
    for name, x in _np_state(a[0]).items():
        np.testing.assert_array_equal(x, _np_state(b[0])[name], err_msg=name)
    _assert_maps(_by_name(*a[1:]), _by_name(*b[1:]), q_tol=0, set_rtol=0)


def test_native_sharded_rings_match_jax():
    """Four fd-less rings, each key's lines on one ring, a whole wave
    parsed before one pump: the pre-sharded ring drain stages ring 0 to
    3 in turn, as the JAX backend does."""
    from veneur_tpu.native import INJECT_OK as J_OK
    from veneur_tpu_torch.native import INJECT_OK
    spec, jspec = TableSpec(**AGG_KW), JTableSpec(**AGG_KW)
    wide = dict(BSPEC_KW, counter=1024, gauge=1024, set=1024, histo=1024)
    bs, jbs = BatchSpec(**wide), JBatchSpec(**wide)
    lines = _lines(21, n=800)
    by_ring = [[], [], [], []]
    for ln in lines:
        by_ring[sum(ln.split(b":")[0]) % 4].append(ln)
    out = []
    for agg, ok in ((TNativeSharded(spec, bs, n_shards=4, device="cpu",
                                    preshard=True), INJECT_OK),
                    (_SyncedJNativeSharded(jspec, jbs, n_shards=4,
                                           preshard=True), J_OK)):
        agg.rings_start(4)
        try:
            for ring, grams in enumerate(by_ring):
                for k in range(0, len(grams), 40):
                    assert agg.eng.rings_inject(
                        ring, b"\n".join(grams[k:k + 40])) == ok
            _wait(lambda: agg.processed >= len(lines), "ring parse")
            agg.pump(0)
            out.append(_flush(agg))
        finally:
            agg.readers_stop()
    (tst, tres, ttb, traw), (jst, jres, jtb, jraw) = out
    # digest cells are held through their quantiles (C-watch 3: the
    # cell plan's f32 reductions round in each library's own order)
    for name in NON_DIGEST:
        np.testing.assert_array_equal(_np_state(tst)[name],
                                      _np_state(jst)[name], err_msg=name)
    _assert_maps(_by_name(tres, ttb), _by_name(jres, jtb))


def test_hll_imports_fold_duplicates_and_merge_like_jax():
    spec, bs = TableSpec(**AGG_KW), BatchSpec(**BSPEC_KW)
    t = TSharded(spec, bs, n_shards=8, device="cpu")
    j = _SyncedJSharded(JTableSpec(**AGG_KW), JBatchSpec(**BSPEC_KW),
                        n_shards=8)
    rng = np.random.default_rng(7)
    p = t.pspec.hll_precision
    rows = [rng.integers(0, 30, t.pspec.registers).astype(np.uint8)
            for _ in range(5)]
    # hll.a twice in one batch: a duplicate target
    keys = [("hll.a", 1), ("hll.a", 1), ("hll.b", 2), ("hll.c", 3),
            ("hll.b", 2)]
    for agg in (t, j):
        for (name, digest), regs in zip(keys, rows):
            agg.import_metric("set", name, (), 0, digest,
                              {"registers": regs})
    assert t._hll_slots == j._hll_slots
    ref = thll.unpack_registers_np(t.state.hll.numpy(), p).copy()
    for (shard, local), regs in zip(t._hll_slots, rows):
        ref[0, shard, local] = np.maximum(ref[0, shard, local], regs)
    t._flush_hll_imports()
    j._apply_hll_imports()
    assert t._hll_slots == [] and t._hll_rows == []
    np.testing.assert_array_equal(t.state.hll.numpy(),
                                  thll.pack_registers_np(ref, p))
    np.testing.assert_array_equal(t.state.hll.numpy(),
                                  np.asarray(j.state.hll))


def test_imports_through_the_sharded_backend_match_jax():
    from tests.test_torch_collective import local_interval
    from veneur_tpu.forward.convert import import_into as jimport_into
    from veneur_tpu_torch.forward.convert import (export_metrics,
                                                  import_into)
    from veneur_tpu_torch.proto import metricpb_pb2 as tmpb
    from veneur_tpu.proto import metricpb_pb2 as jmpb
    t = TSharded(TableSpec(**AGG_KW), BatchSpec(**BSPEC_KW), n_shards=4,
                 device="cpu")
    j = _SyncedJSharded(JTableSpec(**AGG_KW), JBatchSpec(**BSPEC_KW),
                        n_shards=4)
    for p in range(3):
        raw, tb = local_interval(100 + p, p)
        for m in export_metrics(raw, tb, 100.0, 14):
            import_into(t, tmpb.Metric.FromString(m.SerializeToString()))
            jimport_into(j, jmpb.Metric.FromString(m.SerializeToString()))
    _tst, tres, ttb, traw = _flush(t)
    _jst, jres, jtb, jraw = _flush(j)
    _assert_maps(_by_name(tres, ttb, traw), _by_name(jres, jtb, jraw))


# -- (f) the Server --------------------------------------------------------------

def sharded_config(**kw):
    return dict(SMALL, interval="3600s", tpu_n_shards=8,
                tpu_counter_capacity=256, tpu_gauge_capacity=64,
                tpu_status_capacity=16, tpu_set_capacity=32,
                tpu_histo_capacity=64, **kw)


class _SyncedJShardedServer(_SyncedJServer):
    """The JAX Server whose sharded aggregators wait for each step."""

    def _make_aggregator(self, n_shards, engine=None, spec=None):
        if n_shards <= 1:
            return super()._make_aggregator(n_shards, engine, spec)
        cfg = self.cfg
        args = dict(
            spec=jserver_mod.spec_from_config(cfg),
            bspec=jserver_mod.BatchSpec(
                counter=cfg.tpu_batch_counter, gauge=cfg.tpu_batch_gauge,
                status=cfg.tpu_batch_status, set=cfg.tpu_batch_set,
                histo=cfg.tpu_batch_histo),
            n_shards=n_shards, compact_every=cfg.tpu_compact_every)
        if cfg.native_ingest:
            return _SyncedJNativeSharded(
                preshard=cfg.native_preshard_enabled, **args), True
        return _SyncedJSharded(**args), False


@pytest.fixture(scope="module", params=["native", "python"])
def servers(request):
    kw = sharded_config(native_ingest=request.param == "native")
    jsink, tsink = _CapturingJSink(), _CapturingTSink()
    jsrv = _SyncedJShardedServer(jconfig.Config(**kw), metric_sinks=[jsink])
    tsrv = tserver_mod.Server(tconfig.Config(**kw), metric_sinks=[tsink],
                              device="cpu")
    want = TNativeSharded if request.param == "native" else TSharded
    assert type(tsrv.aggregator) is want
    assert tsrv.aggregator.n_shards == 8
    jsrv.start()
    tsrv.start()
    try:
        yield request.param, (jsrv, jsink), (tsrv, tsink)
    finally:
        tsrv.shutdown()
        jsrv.shutdown()


def test_sharded_servers_flush_the_same_app_intermetrics(servers):
    _route, (jsrv, jsink), (tsrv, tsink) = servers
    grams, n_lines, n_events = _traffic(4)
    _send(jsrv, grams, n_lines, n_events, jssf)
    _send(tsrv, grams, n_lines, n_events, tssf)
    for sink in (jsink, tsink):
        sink.flushed.clear()
    assert jsrv.trigger_flush(timeout=120)
    assert tsrv.trigger_flush(timeout=120)
    got, want = _app(tsink.flushed), _app(jsink.flushed)
    _assert_same_intermetrics(got, want)
    assert {m.type for m in got} == {"counter", "gauge", "status"}


def test_sharded_flush_resets(servers):
    _route, (jsrv, jsink), (tsrv, tsink) = servers
    for sink in (jsink, tsink):
        sink.flushed.clear()
    assert jsrv.trigger_flush(timeout=120)
    assert tsrv.trigger_flush(timeout=120)
    assert _app(tsink.flushed) == _app(jsink.flushed) == []


def _server_flush(kw, lines):
    sink = _CapturingTSink()
    srv = tserver_mod.Server(tconfig.Config(**kw), metric_sinks=[sink],
                             device="cpu")
    srv.start()
    try:
        tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        for k in range(0, len(lines), 30):
            tx.sendto(b"\n".join(lines[k:k + 30]), srv.local_addr(0))
        tx.close()
        _wait(lambda: srv.aggregator.processed >= len(lines), "lines")
        sink.flushed.clear()
        assert srv.trigger_flush(timeout=120)
        return srv, _app(sink.flushed)
    finally:
        srv.shutdown()


def test_preshard_server_flush_parity():
    lines = _lines(13, n=600)
    srv, split = _server_flush(sharded_config(native_ingest=True), lines)
    assert isinstance(srv.aggregator, TNativeSharded)
    srv2, pre = _server_flush(sharded_config(
        native_ingest=True, native_preshard_enabled=True), lines)
    assert srv2.aggregator.preshard
    _assert_same_intermetrics(pre, split)


def test_native_sharded_backend_matches_the_python_sharded_backend():
    lines = _lines(17, n=600)
    _s1, nat = _server_flush(sharded_config(native_ingest=True), lines)
    _s2, py = _server_flush(sharded_config(native_ingest=False), lines)
    assert len(nat) == len(py) > 0
    for a, b in zip(nat, py):
        assert (a.name, a.tags, a.type) == (b.name, b.tags, b.type)
        tail = a.name.rsplit(".", 1)[-1]
        if tail.endswith("percentile") or tail == "median":
            np.testing.assert_allclose(a.value, b.value, rtol=1e-6)
        else:
            assert a.value == b.value, a.name


def test_sharded_local_forwards_to_a_single_device_global():
    gsink = _CapturingTSink()
    glob = tserver_mod.Server(tconfig.Config(**dict(
        SMALL, interval="3600s", grpc_address="127.0.0.1:0")),
        metric_sinks=[gsink], device="cpu")
    glob.start()
    local = tserver_mod.Server(tconfig.Config(**sharded_config(
        forward_address=f"127.0.0.1:{glob.grpc_port}")),
        metric_sinks=[_CapturingTSink()], device="cpu")
    local.start()
    try:
        vals = list(range(1, 51))
        lines = ([b"shf.count:3|c|#veneurglobalonly"]
                 + [f"shf.timer:{v}|ms".encode() for v in vals])
        tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        tx.sendto(b"\n".join(lines), local.local_addr(0))
        tx.close()
        _wait(lambda: local.aggregator.processed >= 51, "local lines")
        assert local.trigger_flush(timeout=120)
        _wait(lambda: glob.aggregator.processed >= 2, "global imports")
        gsink.flushed.clear()
        assert glob.trigger_flush(timeout=120)
        g = {m.name: m.value for m in _app(gsink.flushed)}
        assert g["shf.count"] == 3.0
        assert abs(g["shf.timer.99percentile"]
                   - np.percentile(vals, 99)) / 50.0 < 0.05
    finally:
        local.shutdown()
        glob.shutdown()


def test_native_sharded_python_paths():
    """Service checks and imports bypass the C++ wire path and land
    through the sharded backend's Python-side lanes."""
    srv = tserver_mod.Server(tconfig.Config(**sharded_config(
        native_ingest=True, statsd_listen_addresses=[],
        ssf_listen_addresses=[], http_address="")), device="cpu")
    agg = srv.aggregator
    assert isinstance(agg, TNativeSharded)
    from veneur_tpu_torch.samplers.parser import parse_service_check
    agg.process_metric(parse_service_check(b"_sc|nsp.check|1|m:all good"))
    agg.import_metric("counter", "nsp.count", (), 2, 5, {"value": 7.0})
    agg.import_metric("timer", "nsp.timer", (), 2, 9, {
        "means": np.arange(1, 41, dtype=np.float32),
        "weights": np.ones(40, np.float32), "min": 1.0, "max": 40.0})
    _st, res, tb, _raw = _flush(agg)
    m = _by_name(res, tb)
    assert m[("status", "nsp.check")] == 1.0
    assert m[("counter", "nsp.count")] == 7.0
    assert m[("histo_count", "nsp.timer")] == 40.0
    assert abs(m[("histo_median", "nsp.timer")] - 20.5) < 1.0


def test_tpu_n_shards_zero_is_one_shard_on_the_cpu():
    srv = tserver_mod.Server(tconfig.Config(**dict(
        SMALL, tpu_n_shards=0, statsd_listen_addresses=[],
        ssf_listen_addresses=[], http_address="")), device="cpu")
    assert getattr(srv.aggregator, "n_shards", 1) == 1
    assert not isinstance(srv.aggregator, TSharded)


# -- (g) a sharded checkpoint across the packages -----------------------------------

@pytest.mark.parametrize("writer", ["jax", "port"])
def test_sharded_checkpoint_restores_across_packages(writer, tmp_path):
    from veneur_tpu.persistence import build_snapshot as jbuild
    from veneur_tpu.persistence import codec as jcodec
    from veneur_tpu.persistence import fold_snapshot as jfold
    from veneur_tpu_torch.persistence import (build_snapshot, fold_snapshot,
                                              restore_latest)
    from veneur_tpu_torch.persistence.codec import encode_to_dir
    spec, jspec = TableSpec(**AGG_KW), JTableSpec(**AGG_KW)
    bs, jbs = BatchSpec(**BSPEC_KW), JBatchSpec(**BSPEC_KW)
    data = b"\n".join(_lines(5))
    if writer == "jax":
        src, build, encode = (_SyncedJNativeSharded(jspec, jbs, n_shards=4),
                              jbuild, jcodec.encode_to_dir)
    else:
        src, build, encode = (TNativeSharded(spec, bs, n_shards=4,
                                             device="cpu"),
                              build_snapshot, encode_to_dir)
    src.feed(data)
    _st, res, tb, raw = _flush(src)
    snap = build(src.spec, tb, res, raw, agg_kind="sharded", n_shards=4,
                 interval_ts=123, hostname="testbox")
    d = tmp_path / "ckpt-00000000"
    d.mkdir()
    encode(str(d), snap)
    tsnap, _path = restore_latest(str(tmp_path))
    assert tsnap["agg_kind"] == "sharded" and tsnap["n_shards"] == 4
    jsnap = jcodec.load_dir(str(d))
    t = TSharded(spec, bs, n_shards=4, device="cpu")
    j = _SyncedJSharded(jspec, jbs, n_shards=4)
    fold_snapshot(t, tsnap)
    jfold(j, jsnap)
    _tst, tres, ttb, _ = _flush(t)
    _jst, jres, jtb, _ = _flush(j)
    _assert_maps(_by_name(tres, ttb), _by_name(jres, jtb))
    # counters, gauges and set words come back exactly as flushed
    orig = _by_name(res, tb)
    for key, v in _by_name(tres, ttb).items():
        if key[0] in ("counter", "gauge", "histo_count", "histo_min",
                      "histo_max"):
            np.testing.assert_array_equal(v, orig[key], err_msg=str(key))


def test_sharded_query_views_and_history_frames_match_jax():
    """The query tier's view of a sharded backend (query_snapshot, then
    query_flat_state: the shard-major flat table) is the JAX package's,
    and a flush with the history tier feeds the ring the JAX sharded
    backend's frame (record_frame, from the host)."""
    from veneur_tpu.history import HistorySpec as JHistorySpec
    from veneur_tpu.history import HistoryWriter as JWriter
    from veneur_tpu_torch.history import HistorySpec, HistoryWriter
    spec, jspec = TableSpec(**AGG_KW), JTableSpec(**AGG_KW)
    bs, jbs = BatchSpec(**BSPEC_KW), JBatchSpec(**BSPEC_KW)
    data = b"\n".join(_lines(31))
    t = TNativeSharded(spec, bs, n_shards=4, device="cpu")
    j = _SyncedJNativeSharded(jspec, jbs, n_shards=4)
    t.feed(data)
    j.feed(data)
    tst, _ttb, tshift = t.query_snapshot()
    jst, _jtb, jshift = j.query_snapshot()
    assert tshift == jshift == 0
    got = _np_state(t.query_flat_state(tst))
    want = _np_state(j.query_flat_state(jst))
    for name in got:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    assert got["counter_hi"].shape == (spec.counter_capacity,)
    hkw = dict(windows=4, tiers=2, max_keys=256)
    tw = HistoryWriter(HistorySpec.for_table(spec, **hkw), interval_s=10.0,
                       device="cpu")
    jw = JWriter(JHistorySpec.for_table(jspec, **hkw), interval_s=10.0)
    st, tb = t.swap()
    tres, ttb = t.compute_flush(st, tb, PERC, history=tw)
    st, tb = j.swap()
    jres, jtb = j.compute_flush(st, tb, PERC, history=jw)
    _assert_maps(_by_name(tres, ttb), _by_name(jres, jtb))
    ts, js = tw.snapshot(), jw.snapshot()
    assert sorted(ts["arrays"]) == sorted(js["arrays"])
    for name, a in ts["arrays"].items():
        b = np.asarray(js["arrays"][name])
        assert a.shape == b.shape, name
        if name == "h_mean":
            np.testing.assert_allclose(a, b, rtol=2e-5, atol=2e-5,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)


def test_a_jax_sharded_state_converts_and_keeps_ingesting():
    """convert.py carries [R, S] leaves across the packages: a JAX
    sharded state converted into the port, one more step on each side,
    the same bytes (and back to numpy unchanged)."""
    from veneur_tpu_torch import convert
    r, s = 2, 4
    rng = np.random.default_rng(41)
    mesh = jsharded.make_mesh(r, s)
    grid = [[_rand_batch(rng, SPEC) for _ in range(s)] for _ in range(r)]
    jstate = jsharded.make_sharded_ingest(mesh, JSPEC)(
        jsharded.sharded_empty_state(JSPEC, r, s, mesh),
        jsharded.stack_batches([[jstep.Batch(*b) for b in row]
                                for row in grid], r, s))
    arrays = _np_state(jstate)
    tstate = convert.state_from_numpy(arrays, "cpu")
    back = convert.state_to_numpy(tstate)
    for name, a in arrays.items():
        assert back[name].tobytes() == a.tobytes(), name
    grid = [[_rand_batch(rng, SPEC) for _ in range(s)] for _ in range(r)]
    jstate = jsharded.make_sharded_ingest(mesh, JSPEC)(
        jstate, jsharded.stack_batches([[jstep.Batch(*b) for b in row]
                                        for row in grid], r, s))
    tsharded.sharded_ingest(tstate, tsharded.stack_batches(grid, r, s),
                            spec=SPEC)
    got, want = _np_state(tstate), _np_state(jstate)
    for name in got:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_sharded_server_grows_its_tables_through_make_aggregator(native):
    """Table growth at tpu_n_shards 8: the grow swap rebuilds the sharded
    backend (the native one around the same engine) at the doubled
    capacity, keeps n_shards, and the next interval's counters flush
    exactly."""
    kw = sharded_config(native_ingest=native, table_grow_enabled=True,
                        statsd_listen_addresses=["udp://127.0.0.1:0"])
    sink = _CapturingTSink()
    srv = tserver_mod.Server(tconfig.Config(**kw), metric_sinks=[sink],
                             device="cpu")
    srv.start()
    try:
        eng = getattr(srv.aggregator, "eng", None)
        assert srv.trigger_table_grow({"counter": 512}, timeout=120)
        agg = srv.aggregator
        assert type(agg) is (TNativeSharded if native else TSharded)
        assert (agg.spec.counter_capacity, agg.n_shards) == (512, 8)
        assert getattr(agg, "eng", None) is eng
        lines = [b"grow.c%d:%d|c" % (i, i + 1) for i in range(300)]
        tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        for k in range(0, len(lines), 50):
            tx.sendto(b"\n".join(lines[k:k + 50]), srv.local_addr(0))
        tx.close()
        _wait(lambda: srv.aggregator.processed >= len(lines), "lines")
        sink.flushed.clear()
        assert srv.trigger_flush(timeout=120)
        got = {m.name: m.value for m in _app(sink.flushed)}
        assert got == {f"grow.c{i}": float(i + 1) for i in range(300)}
    finally:
        srv.shutdown()


def test_sharded_server_checkpoints_its_tail_and_restores_it(tmp_path):
    """A sharded Server's shutdown tail goes to the checkpoint as a
    "sharded" snapshot of n_shards 8; a sharded Server restoring it
    flushes the tail's counters and gauges exactly."""
    from veneur_tpu_torch.persistence import restore_latest
    lines = _lines(23, n=500)
    kw = sharded_config(checkpoint_dir=str(tmp_path), restore_on_start=True)
    srv = tserver_mod.Server(tconfig.Config(**kw),
                             metric_sinks=[_CapturingTSink()], device="cpu")
    srv.start()
    try:
        tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        for k in range(0, len(lines), 50):
            tx.sendto(b"\n".join(lines[k:k + 50]), srv.local_addr(0))
        tx.close()
        _wait(lambda: srv.aggregator.processed >= len(lines), "lines")
    finally:
        srv.shutdown()
    snap, _path = restore_latest(str(tmp_path))
    assert (snap["agg_kind"], snap["n_shards"]) == ("sharded", 8)
    ref = TSharded(TableSpec(**{k[4:]: v for k, v in kw.items()
                                if k.startswith("tpu_") and
                                k.endswith("capacity")}),
                   BatchSpec(), n_shards=8, device="cpu")
    for line in lines:
        ref.process_metric(tparser.parse_metric(line))
    _st, rres, rtb, _ = _flush(ref)
    sink = _CapturingTSink()
    srv2 = tserver_mod.Server(tconfig.Config(**kw), metric_sinks=[sink],
                              device="cpu")
    srv2.start()
    try:
        sink.flushed.clear()
        assert srv2.trigger_flush(timeout=120)
        got = {(m.name, m.type): m.value for m in _app(sink.flushed)}
    finally:
        srv2.shutdown()
    want = _by_name(rres, rtb)
    for (kind, name), v in want.items():
        if kind == "counter":
            assert got[(name, "counter")] == v, name
        elif kind == "gauge":
            assert got[(name, "gauge")] == v, name
