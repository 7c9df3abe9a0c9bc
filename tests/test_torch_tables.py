"""The port's self-adjusting key tables against the JAX package, on the
CPU.

- (a) TableManager: the same occupancy, grow and shrink plans, forced
  targets (and their refusals), census evictions under an injected
  `now`, and checkpoint payload in both packages;
- (b) a grow on both Servers, on both ingest routes: an interval that
  overflows its counter table (exact counted drops), the flush whose
  swap grows the table (the detached interval flushes at the old spec),
  and an interval at the grown capacity: the same InterMetrics before,
  across and after the grow, the same drops, grows_total and capacity
  telemetry; a grow whose new backend cannot be built fails the flush in
  both packages, and the port keeps serving at the old spec with the
  interval retained, its growth ceiling lowered to what it holds;
- (c) a "keytables" checkpoint chunk written by either package restores
  into the other: the grown capacities are adopted before the fold, and
  the restored interval flushes the same values;
- (d) the Python path's pressure ladder (tag-explosion demotion to a
  rollup row, SALSA merge cells that conserve the value mass, exact
  drops) gives the same counters and flushes in both packages.

Tolerances as tests/test_torch_server.py: percentiles rtol/atol 2e-5,
set estimates rtol 1e-6, everything else exact.
"""

from types import SimpleNamespace

import pytest

from tests.test_torch_import import _DropSpans
from tests.test_torch_native import AGGS, PERC
from tests.test_torch_server import (SMALL, _app,
                                     _assert_same_intermetrics,
                                     _CapturingJSink, _CapturingTSink,
                                     _seen, _SyncedJAggregator,
                                     _SyncedJNative, _SyncedJServer, _wait)
from veneur_tpu import config as jconfig
from veneur_tpu import tables as jtables
from veneur_tpu.aggregation.host import BatchSpec as JBatchSpec
from veneur_tpu.aggregation.host import KeyTable as JKeyTable
from veneur_tpu.aggregation.state import TableSpec as JTableSpec
from veneur_tpu.samplers import parser as jparser
from veneur_tpu.server import server as jserver_mod
from veneur_tpu.server.flusher import generate_intermetrics as jgen
from veneur_tpu_torch import config as tconfig
from veneur_tpu_torch import tables as ttables
from veneur_tpu_torch.aggregation.host import BatchSpec as TBatchSpec
from veneur_tpu_torch.aggregation.host import KeyTable as TKeyTable
from veneur_tpu_torch.aggregation.state import TableSpec as TTableSpec
from veneur_tpu_torch.samplers import parser as tparser
from veneur_tpu_torch.server import server as tserver_mod
from veneur_tpu_torch.server.aggregator import Aggregator as TAggregator
from veneur_tpu_torch.server.flusher import generate_intermetrics as tgen

SPEC_KW = dict(counter_capacity=64, gauge_capacity=32, status_capacity=8,
               set_capacity=16, histo_capacity=32)
BATCH_KW = dict(counter=256, gauge=32, status=8, set=64, histo=512,
                histo_stat=32)


# -- (a) the manager --------------------------------------------------------

def _fake(**kinds):
    """An aggregator surface for TableManager.occupancy: per kind
    (used, dropped this interval, capacity) on one shard."""
    return SimpleNamespace(table=SimpleNamespace(tables={
        k: SimpleNamespace(next_free=[u], dropped=d, capacity=c)
        for k, (u, d, c) in kinds.items()}))


def _manager_run(pkg):
    mod = jtables if pkg == "jax" else ttables
    spec = (JTableSpec if pkg == "jax" else TTableSpec)(**SPEC_KW)
    out = []
    mgr = mod.TableManager(spec, max_capacity=1000, idle_ttl_s=50.0,
                           shrink_window=3)
    for occ in ({"counter": (64, 36, 64), "gauge": (10, 0, 32)},
                {"counter": (120, 0, 128)},
                {"counter": (200, 900, 256)},
                {"counter": (3, 0, 1024), "set": (16, 4, 16)},
                {"counter": (3, 0, 1024)}, {"counter": (3, 0, 1024)},
                {"counter": (3, 0, 64)}):
        out.append(mgr.plan(_fake(**occ)))
    refusals = []
    for bad in ({"bogus": 128}, {"counter": 0}, {}):
        try:
            mgr.force(bad)
        except ValueError as e:
            refusals.append(type(e).__name__)
    mgr.force({"counter": 512, "histo": 64})
    out += [mgr.plan(_fake(counter=(1, 0, 64))),
            mgr.plan(_fake(counter=(1, 0, 64)))]
    mgr.note_grow({"counter": 512}, 12345)
    mgr.note_grow({"counter": 1024, "set": 32}, 99)
    for now, live in ((1000.0, range(10)), (1040.0, range(4)),
                      (1100.0, range(3)), (1300.0, range(1))):
        table = _census_table(pkg, live)
        mgr.census_flush(table, now=now)
        out.append(dict(mgr.evicted))
    snap = mgr.snapshot_state(mod.grown_spec(spec, {"counter": 1024}))
    back = mod.TableManager(spec)
    back.restore_state(snap)
    return dict(plans=out, refusals=refusals, grows=mgr.grows_snapshot(),
                events=mgr.grow_events, pause=mgr.last_grow_swap_ns,
                snap=snap, back=(back.grows, back.evicted,
                                 back.grow_events),
                caps=mod.TableManager.capacity_snapshot(
                    mod.grown_spec(spec, {"gauge": 64})))


def _census_table(pkg, live):
    """A detached Python KeyTable holding counters ev.c<i> for i in
    `live` (the census reads only its metadata)."""
    if pkg == "jax":
        table = JKeyTable(JTableSpec(**SPEC_KW))
    else:
        table = TKeyTable(TTableSpec(**SPEC_KW))
    for i in live:
        name = f"ev.c{i}"
        table.slot_for("counter", name, (), 0, i)
    return table


def test_manager_plans_census_and_snapshot_match_jax():
    got, want = _manager_run("torch"), _manager_run("jax")
    assert got == want
    assert got["plans"][0] == {"counter": 128}
    assert got["plans"][2] == {"counter": 1000}    # clamped to the max
    assert got["refusals"] == ["ValueError"] * 3
    assert got["plans"][1] == {"counter": 256}
    assert got["plans"][3] == {"set": 32}
    assert got["plans"][5] == {"counter": 512}     # idle a full window
    assert got["plans"][6] is None                 # the baseline floor
    assert got["plans"][7] == {"counter": 512, "histo": 64}
    assert got["plans"][8] is None                 # consumed once
    # the census: keys idle past the 50 s TTL, each expired once
    assert got["plans"][9:] == [{}, {}, {"counter": 7}, {"counter": 9}]


# -- (b) a grow on both Servers ---------------------------------------------

class _GrowJServer(_SyncedJServer):
    """The JAX Server with step-synced aggregators that honor the grown
    spec and the running engine (tables/growth.py's rebuild)."""

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
        if cfg.native_ingest:
            return _SyncedJNative(engine=engine, **args), True
        return _SyncedJAggregator(**args), False


def _grow_kw(route, **kw):
    base = dict(SMALL, statsd_listen_addresses=[], ssf_listen_addresses=[],
                http_address="", native_ingest=route == "native",
                table_grow_enabled=True, tpu_counter_capacity=64,
                tpu_batch_counter=128)
    base.update(kw)
    return base


def _start(pkg, **kw):
    if pkg == "jax":
        sink = _CapturingJSink()
        srv = _GrowJServer(jconfig.Config(**kw), metric_sinks=[sink])
    else:
        sink = _CapturingTSink()
        srv = tserver_mod.Server(tconfig.Config(**kw), metric_sinks=[sink],
                                 device="cpu")
    srv.trace_client.backend = _DropSpans()
    srv.start()
    return srv, sink


def _wave(scale, n=100):
    lines = [b"gw.c%d:%d|c" % (i, scale * (i % 7 + 1)) for i in range(n)]
    lines += [b"gw.t%d:%d|ms" % (i % 3, scale * i + 1) for i in range(30)]
    lines += [b"gw.s:u%d|s" % (i % 40) for i in range(60)]
    return [b"\n".join(lines[k:k + 50]) for k in range(0, len(lines), 50)]


def _feed(srv, grams):
    base = _seen(srv)
    n = sum(g.count(b"\n") + 1 for g in grams)
    for g in grams:
        srv.packet_queue.put(g)
    _wait(lambda: _seen(srv) >= base + n, "lines not all seen")


def _flush(srv, sink):
    sink.flushed.clear()
    assert srv.trigger_flush(timeout=120)
    return _app(sink.flushed)


def _telemetry(srv):
    return (srv.aggregator.spec.counter_capacity,
            srv.aggregator.dropped_capacity, srv.tables.grows_snapshot(),
            srv.tables.grow_events,
            srv.tables.capacity_snapshot(srv.aggregator.spec))


def _grow_run(pkg, route):
    srv, sink = _start(pkg, **_grow_kw(route))
    try:
        out = []
        _feed(srv, _wave(1))                  # 36 counters past 64 slots
        out.append((_flush(srv, sink), _telemetry(srv)))   # the grow swap
        _feed(srv, _wave(2))
        out.append((_flush(srv, sink), _telemetry(srv)))
        _feed(srv, _wave(3, n=120))
        out.append((_flush(srv, sink), _telemetry(srv)))
        return out
    finally:
        srv.shutdown()


@pytest.mark.parametrize("route", ["native", "python"])
def test_grow_on_both_servers_matches_jax(route):
    got, want = _grow_run("torch", route), _grow_run("jax", route)
    for (gm, gt), (wm, wt) in zip(got, want):
        _assert_same_intermetrics(gm, wm)
        assert gt == wt
    (m0, t0), (m1, t1), (m2, t2) = got
    # the overflowing interval: 64 counters resident, 36 dropped, exactly
    assert sum(m.name.startswith("gw.c") for m in m0) == 64
    assert t0[:2] == (128, 36) and t0[2] == [(("counter",), 1)]
    # at the grown capacity every counter of the wave flushes its sum
    c1 = {m.name: m.value for m in m1 if m.name.startswith("gw.c")}
    assert c1 == {f"gw.c{i}": 2.0 * (i % 7 + 1) for i in range(100)}
    # 100 keys fit under 0.85 x 128; 120 do not: that flush grows again
    assert t1[:2] == (128, 36) and t2[:2] == (256, 36)
    assert sum(m.name.startswith("gw.c") for m in m2) == 120


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_failed_grow_fails_the_flush_in_both_packages(pkg):
    srv, sink = _start(pkg, **_grow_kw("native"))
    try:
        _feed(srv, _wave(1))

        def no_room(*_a, **_k):
            raise MemoryError("no room for the grown tables")

        srv._make_aggregator = no_room
        assert not srv.trigger_flush(timeout=120)
        assert srv.aggregator.spec.counter_capacity == 64
        assert srv.tables.grows_snapshot() == []
        if pkg == "torch":
            # the port builds the grown backend before it stages or
            # swaps anything: the interval stays in the live state, and
            # the next flush swaps at the capacity the device holds
            assert srv.tables.max_capacity == 64
            flushed = _flush(srv, sink)
            assert sum(m.name.startswith("gw.c") for m in flushed) == 64
            assert srv.aggregator.dropped_capacity == 36
    finally:
        srv.shutdown()


# -- (c) the keytables chunk across packages --------------------------------

@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
def test_keytables_chunk_adopts_capacities_across_packages(writer, reader,
                                                           tmp_path):
    ckpt = dict(checkpoint_dir=str(tmp_path / "ckpt"),
                checkpoint_on_shutdown=True)
    srv, sink = _start(writer, **_grow_kw("native", **ckpt))
    try:
        assert srv.trigger_table_grow({"counter": 256})
        _feed(srv, _wave(5, n=150))
    finally:
        srv.shutdown()          # the final checkpoint holds the tail
    srv, sink = _start(reader, **_grow_kw("native", restore_on_start=True,
                                          **ckpt))
    try:
        assert srv.aggregator.spec.counter_capacity == 256
        assert srv.tables.grows_snapshot() == [(("counter",), 1)]
        restored = _flush(srv, sink)
    finally:
        srv.shutdown()
    c = {m.name: m.value for m in restored if m.name.startswith("gw.c")}
    assert c == {f"gw.c{i}": 5.0 * (i % 7 + 1) for i in range(150)}


# -- (d) the pressure ladder ------------------------------------------------

def _ladder_run(pkg, case):
    if pkg == "jax":
        agg = _SyncedJAggregator(JTableSpec(**SPEC_KW),
                                 JBatchSpec(**BATCH_KW))
        mod, parse, gen = jtables, jparser.parse_metric, jgen
    else:
        agg = TAggregator(TTableSpec(**SPEC_KW), TBatchSpec(**BATCH_KW),
                          device="cpu")
        mod, parse, gen = ttables, tparser.parse_metric, tgen
    if case == "demote":
        pressure = mod.TablePressure(demote_threshold=6)
        lines = [b"exp.hot:%d|c|#v:%d" % (i % 3 + 1, i) for i in range(30)]
        lines += [b"exp.g:%d|g|#v:%d" % (i, i % 9) for i in range(20)]
    else:
        pressure = mod.TablePressure(salsa_enabled=True, salsa_cells=4)
        lines = [b"sl.c%d:1|c" % i for i in range(60)]
        lines += [b"sl.o%d:%d|c" % (i, i + 1) for i in range(30)]
    agg.set_pressure(pressure)
    flushes = []
    for wave in (lines, lines[:10] + [b"exp.hot:1|c|#v:fresh"]):
        for line in wave:
            agg.process_metric(parse(line))
        state, table = agg.swap()
        res, table = agg.compute_flush(state, table, PERC)
        flushes.append(sorted(
            gen(res, table, percentiles=PERC, aggregates=AGGS,
                is_local=False, timestamp=1700000000, hostname="h"),
            key=lambda m: (m.name, tuple(m.tags))))
    return (flushes, pressure.merged_snapshot(),
            pressure.demoted_snapshot(), agg.dropped_capacity)


@pytest.mark.parametrize("case", ["demote", "salsa"])
def test_pressure_ladder_matches_jax(case):
    (tf, tmerged, tdemoted, tdrop) = _ladder_run("torch", case)
    (jf, jmerged, jdemoted, jdrop) = _ladder_run("jax", case)
    for got, want in zip(tf, jf):
        _assert_same_intermetrics(got, want)
    assert (tmerged, tdemoted, tdrop) == (jmerged, jdemoted, jdrop)
    values = {(m.name, tuple(m.tags)): m.value for m in tf[0]}
    if case == "demote":
        # 24 variants past the sixth, then the next interval's ten
        # re-sent variants and a fresh one, all onto the rollup row
        assert tdemoted == [(("counter",), 24 + 11), (("gauge",), 3)]
        assert values[("exp.hot", ("veneur_rollup:true",))] == sum(
            i % 3 + 1 for i in range(6, 30))
    else:
        assert tmerged == [(("counter",), 30)] and tdrop == 0
        cells = sum(v for (n, _), v in values.items()
                    if n == ttables.pressure.MERGE_CELL_NAME)
        assert cells == sum(range(1, 31))       # the mass is conserved


def test_engine_table_stats_and_staged_capacities_match_jax():
    """The engine's occupancy (`table_stats`: used, cumulative drops,
    capacity by kind) and a capacity staged with `capacity_set`, applied
    only by the next swap's reset, in both packages."""
    from tests.test_torch_native import _pair
    jagg, tagg = _pair()
    data = b"\n".join([b"ts.c%d:1|c" % i for i in range(100)]
                      + [b"ts.g%d:1|g" % i for i in range(10)])
    out = []
    for agg, eng in ((jagg, jagg.eng), (tagg, tagg.eng)):
        agg.feed(data)
        before = eng.table_stats()
        eng.capacity_set(128, 0, 0, 0)
        staged = eng.table_stats()
        agg.swap()
        out.append((before, staged, eng.table_stats()))
    assert out[1] == out[0]
    before, staged, after = out[1]
    assert before["counter"] == (64, 36, 64) and before["gauge"][0] == 10
    assert staged == before                     # staged, not applied
    assert after["counter"] == (0, 36, 128)     # applied by the reset
