"""The port's tenant identity, fairness and quarantine against the JAX
package, on the CPU.

- (a) `extract_tenant`: over the malformed-datagram corpus of
  tests/test_intake_fuzz.py, the JAX package's Python mirror, the port's
  Python mirror and the port engine's `tenant_extract` give the same
  tenant, byte for byte, and the corpus's expected one;
- (b) TenantFairness: the weighted buckets under one injected clock, the
  exact per-(tenant, class) counts, the native fold, the quarantine
  mirror and the checkpoint payload are equal in both packages;
- (c) the engine: the same `rings_inject` datagrams through the port's
  engine and the JAX engine (two rings, admission off, then a runaway
  tenant on one ring) give the same per-tenant admitted and shed counts
  (sent == admitted + shed exactly), the same demoted rows (the runaway
  past its key budget counts exactly its post-demotion rows) and the
  same tenant table;
- (d) both Servers, tenancy on the C++ rings: the same datagrams give
  the same per-tenant ledger, quarantine and flushed InterMetrics, and
  a "tenants" checkpoint chunk written by either package restores into
  the other: the runaway stays quarantined in the restored engine, the
  demoted-row totals carry over.
"""

import json
import time

import pytest

from tests.test_intake_fuzz import TENANT_CORPUS
from tests.test_torch_import import _DropSpans
from tests.test_torch_server import (SMALL, _app,
                                     _assert_same_intermetrics,
                                     _CapturingJSink, _CapturingTSink,
                                     _SyncedJServer, _wait)
from veneur_tpu import config as jconfig
from veneur_tpu import native as jnative
from veneur_tpu.aggregation.host import BatchSpec as JBatchSpec
from veneur_tpu.aggregation.state import TableSpec as JTableSpec
from veneur_tpu.reliability import tenancy as jten
from veneur_tpu_torch import config as tconfig
from veneur_tpu_torch import native as tnative
from veneur_tpu_torch.aggregation.host import BatchSpec as TBatchSpec
from veneur_tpu_torch.aggregation.state import TableSpec as TTableSpec
from veneur_tpu_torch.reliability import tenancy as tten
from veneur_tpu_torch.server import server as tserver_mod


class VClock:
    def __init__(self):
        self.t = 50.0

    def __call__(self):
        return self.t


@pytest.mark.parametrize("i", range(len(TENANT_CORPUS)))
def test_extract_tenant_corpus_parity(i):
    data, want = TENANT_CORPUS[i]
    got = (jten.extract_tenant("tenant:", data),
           tten.extract_tenant("tenant:", data),
           tnative.tenant_extract("tenant:", data))
    assert got == (want, want, want)
    ten = tten.TenantFairness()
    assert ten.resolve(data) == (want or tten.DEFAULT_TENANT)


def _fairness_run(mod):
    clk = VClock()
    ten = mod.TenantFairness(base_rate=10.0, weights={"big": 2.0,
                                                      "tiny": 0.25},
                             burst_mult=1.5, quarantine_max_keys=9,
                             clock=clk)
    decisions = []
    for step in range(12):
        clk.t += 0.07 * step
        for tenant in ("big", "small", "tiny", "default"):
            for _ in range(3 + step % 4):
                ok = ten.allow(tenant)
                ten.count(tenant, ("low", "high")[step % 2], ok)
                decisions.append(ok)
    ten.fold_native({"big": {"admitted": {"low": 4}, "shed": {"high": 1},
                             "demoted_rows": 2},
                     "fresh": {"admitted": {"self": 3}}})
    ten.update_table({"runaway": {"demoted": True, "key_est": 42.5},
                      "big": {"demoted": False, "key_est": 3.0}})
    snap = json.loads(json.dumps(ten.snapshot_state()))
    back = mod.TenantFairness()
    entries = back.restore_state(snap)
    return dict(decisions=decisions, admitted=ten.admitted_snapshot(),
                shed=ten.shed_snapshot(),
                rows=ten.demoted_rows_snapshot(),
                quarantined=ten.quarantined_snapshot(), snap=snap,
                entries=entries, back=back.quarantined_tenants(),
                native=(ten.native_config(), ten.native_params()))


def test_fairness_buckets_counts_and_snapshot_match_jax():
    got, want = _fairness_run(tten), _fairness_run(jten)
    assert got == want
    assert 0 < sum(got["decisions"]) < len(got["decisions"])


# -- the engine -------------------------------------------------------------

_SPEC_KW = dict(counter_capacity=4096, gauge_capacity=1024,
                status_capacity=64, set_capacity=256, histo_capacity=512)
_BATCH_KW = dict(counter=4096, gauge=1024, status=64, set=256, histo=512)


def _engine(pkg, **cfg):
    if pkg == "jax":
        eng = jnative.NativeIngest(JTableSpec(**_SPEC_KW),
                                   JBatchSpec(**_BATCH_KW))
    else:
        eng = tnative.NativeIngest(TTableSpec(**_SPEC_KW),
                                   TBatchSpec(**_BATCH_KW))
    eng.tenant_config(True, **cfg)
    eng.rings_start(2, fds=None, max_len=8192, ring_cap=8192)
    return eng


def _drain_parsed(eng, lines, timeout=30.0):
    """Wait until the ring workers have parsed `lines` lines (so every
    demoted row is counted), then fold one per-tenant drain."""
    t0 = time.time()
    while True:
        st = eng.stats()
        if st["processed"] + st["parse_errors"] + st["dropped"] >= lines:
            break
        assert time.time() - t0 < timeout, (st, lines)
        time.sleep(0.01)
    out = {}
    for t, ent in eng.admission_drain().get("tenants", {}).items():
        out[t] = {"admitted": sum(ent.get("admitted", {}).values()),
                  "shed": sum(ent.get("shed", {}).values()),
                  "rows": ent.get("demoted_rows", 0)}
    return out


def _engine_run(pkg):
    eng = _engine(pkg, q_max_keys=8, q_decay=0.5, q_readmit_frac=0.5)
    try:
        sent = {"acme": 60, "bar": 35, "default": 25}
        for i in range(sent["acme"]):
            assert eng.rings_inject(i % 2,
                                    b"m%d:1|c|#tenant:acme" % (i % 4))
        for i in range(sent["bar"]):
            assert eng.rings_inject(i % 2,
                                    b"g%d:2|g|#tenant:bar" % (i % 3))
        for i in range(sent["default"]):
            assert eng.rings_inject(i % 2, b"u%d:1|c" % (i % 2))
        ledger = _drain_parsed(eng, sum(sent.values()))
        # the runaway on one ring: its key order is fixed
        n = 200
        for i in range(n):
            assert eng.rings_inject(0, b"explode.%d:1|c|#tenant:runaway"
                                    % i)
        runaway = _drain_parsed(eng, sum(sent.values()) + n)
        assert not eng.admission_drain().get("tenants")
        return sent, ledger, runaway, eng.tenant_table()
    finally:
        eng.readers_stop()


def test_engine_ring_accounting_and_quarantine_match_jax():
    sent, tl, tr, ttable = _engine_run("torch")
    _, jl, jr, jtable = _engine_run("jax")
    assert (tl, tr, ttable) == (jl, jr, jtable)
    for name, n in sent.items():
        assert tl[name] == {"admitted": n, "shed": 0, "rows": 0}
    assert tr["runaway"]["admitted"] == 200
    assert tr["runaway"]["rows"] == 200 - 8 - 1
    assert ttable["runaway"]["demoted"] and not ttable["acme"]["demoted"]


# -- both Servers -----------------------------------------------------------

def _tenant_kw(**kw):
    base = dict(SMALL, statsd_listen_addresses=["udp://127.0.0.1:0"],
                ssf_listen_addresses=[], tenant_enabled=True,
                tenant_quarantine_max_keys=12, tenant_quarantine_decay=0.5,
                tenant_quarantine_readmit_frac=0.5,
                tpu_counter_capacity=512)
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
    srv.trace_client.backend = _DropSpans()
    srv.start()
    return srv, sink


def _tenant_grams():
    grams = []
    for i in range(30):
        grams.append(b"app.c%d:%d|c|#tenant:acme" % (i % 5, i + 1))
        grams.append(b"app.g%d:%d.5|g|#tenant:blue" % (i % 3, i))
        grams.append(b"app.t%d:%d|ms" % (i % 2, 3 * i + 1))
    for i in range(40):
        grams.append(b"boom.k%d:1|c|#tenant:crux" % i)
    return grams


def _settled_ledger(srv, n):
    """The tenant ledger once the ring workers have parsed all `n`
    lines (demoted rows are counted at the parse) and the drains have
    folded all `n` admission decisions."""
    def parsed():
        st = srv.aggregator.eng.stats()
        return st["processed"] + st["parse_errors"] + st["dropped"]

    def total():
        srv._sync_native_tenancy(drain=True)
        ten = srv.tenancy
        return sum(v for _, v in ten.admitted_snapshot()
                   + ten.shed_snapshot())
    _wait(lambda: parsed() >= n, "lines not all parsed")
    _wait(lambda: total() >= n, "tenant ledger short")
    srv._sync_native_tenancy(drain=True)
    ten = srv.tenancy
    return (ten.admitted_snapshot(), ten.shed_snapshot(),
            ten.demoted_rows_snapshot(), ten.quarantined_snapshot())


def _inject(srv, grams):
    eng = srv.aggregator.eng
    for g in grams:     # one ring: each key's order is fixed
        assert eng.rings_inject(0, g) == tnative.INJECT_OK


def test_servers_tenant_ledger_quarantine_and_flush_match_jax():
    out = {}
    for pkg in ("jax", "torch"):
        srv, sink = _start(pkg, **_tenant_kw())
        try:
            grams = _tenant_grams()
            _inject(srv, grams)
            ledger = _settled_ledger(srv, len(grams))
            assert srv.trigger_flush(timeout=120)
            out[pkg] = (ledger, _app(sink.flushed))
        finally:
            srv.shutdown()
    (tl, tm), (jl, jm) = out["torch"], out["jax"]
    assert tl == jl
    adm, shed, rows, quarantined = tl
    assert dict(adm) == {("acme",): 30, ("blue",): 30, ("crux",): 40,
                         ("default",): 30} and not shed
    assert dict(rows) == {("crux",): 40 - 12 - 1}
    assert dict(quarantined)[("crux",)] == 1
    _assert_same_intermetrics(tm, jm)


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
def test_tenants_chunk_restores_across_packages(writer, reader, tmp_path):
    ckpt = dict(checkpoint_dir=str(tmp_path / "ckpt"),
                checkpoint_on_shutdown=True)
    srv, _ = _start(writer, **_tenant_kw(**ckpt))
    try:
        grams = _tenant_grams()
        _inject(srv, grams)
        written = _settled_ledger(srv, len(grams))
    finally:
        srv.shutdown()          # the final checkpoint carries the chunk
    srv, _ = _start(reader, **_tenant_kw(restore_on_start=True, **ckpt))
    try:
        assert srv.tenancy.quarantined_tenants() == ["crux"]
        assert srv.tenancy.demoted_rows_snapshot() == written[2]
        assert srv.aggregator.tenant_table()["crux"]["demoted"]
        # the restored engine keeps demoting the runaway's new keys
        _inject(srv, [b"boom.new%d:1|c|#tenant:crux" % i for i in range(5)])
        _wait(lambda: (srv._sync_native_tenancy(drain=True),
                       dict(srv.tenancy.demoted_rows_snapshot()))[1]
              .get(("crux",), 0) >= 27 + 5, "restored demotion")
    finally:
        srv.shutdown()


def test_feed_path_tenant_context_demotes_as_jax_does():
    """`set_tenant` on the feed path (no rings): the engine parses as the
    named tenant and demotes it past its key budget; the tenant's state
    is read when the context is set, so the next context's new keys roll
    up, each counted as a demoted row, as the JAX engine does; both
    flush the same rollup."""
    from tests.test_torch_native import (_assert_same_intermetrics,
                                         _flush, _pair)
    from veneur_tpu.server.flusher import generate_intermetrics as jgen
    from veneur_tpu_torch.server.flusher import generate_intermetrics as tgen
    jagg, tagg = _pair()
    lines = b"\n".join(b"explode.%d:1|c" % i for i in range(40))
    out = []
    for agg, set_tenant, gen in ((jagg, jagg.eng.set_tenant, jgen),
                                 (tagg, tagg.set_tenant, tgen)):
        agg.tenant_config(True, q_max_keys=8)
        set_tenant("runaway")
        agg.feed(lines)
        set_tenant("runaway")
        agg.feed(b"\n".join(b"late.%d:1|c" % i for i in range(20)))
        rows = agg.tenant_rows_drain()
        set_tenant("")
        out.append((rows, agg.tenant_table(), _flush(agg, gen)))
    (jrows, jtable, jims), (trows, ttable, tims) = out
    assert (trows, ttable) == (jrows, jtable)
    assert trows == {"runaway": 20} and ttable["runaway"]["demoted"]
    _assert_same_intermetrics(tims, jims)
