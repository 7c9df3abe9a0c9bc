"""The port's global-tier import path against the JAX package, on the CPU.

- (a) `export_metrics` gives the same serialized MetricList for the same
  local flush, on both ingest routes;
- (b) `import_into` (Python aggregators) and `import_pb_bytes` (native
  aggregators, the engine's vi_import) give the JAX package's flush for
  the same lists: percentiles within rtol/atol 2e-5, set estimates
  within rtol 1e-6 (the HLL estimator's f32 sums round differently in
  the two libraries; the registers are byte-equal), the rest exact;
- (c) the native decoder's edge cases of tests/test_native_import.py:
  native == Python import, imported_only marking, a lane that fills
  mid-request or before it is re-entered at its boundary, a malformed
  tail counted as one error, and a fuzz corpus answering as the JAX
  engine answers;
- (d) the reference's fixtures decode as the JAX package decodes them
  (gob digests in `import.uncompressed`, its zlib body `import.deflate`,
  `oldgob.base64`), the gob encoder is byte-identical, and the HLL wire
  codec and `merge_rows_packed` agree with the JAX ops;
- (e) envelopes: malformed ones raise EnvelopeError in both packages,
  and POST /import answers both Servers' codes (400 counted in
  veneur.forward.envelope_rejected_total);
- (f) both Servers over gRPC (ForwardClient) and HTTP POST /import flush
  the same InterMetrics, and the JSONMetric POST flushes what the same
  batch flushes over gRPC.

The JAX aggregators are the test-side synced subclasses of
tests/test_torch_server.py (ROADMAP C-watch 4).
"""

import base64
import json
import os
import urllib.error
import urllib.request
import zlib

import numpy as np
import pytest

from tests.test_torch_server import (_SyncedJAggregator, _SyncedJNative,
                                     _SyncedJServer, _wait)
from veneur_tpu import config as jconfig
from veneur_tpu.aggregation.host import BatchSpec as JBatchSpec
from veneur_tpu.aggregation.state import TableSpec as JTableSpec
from veneur_tpu.forward import convert as jconvert
from veneur_tpu.forward import envelope as jenvelope
from veneur_tpu.forward import gob as jgob
from veneur_tpu.forward import jsonmetric as jjson
from veneur_tpu.ops import hll as jhll
from veneur_tpu.proto import forwardrpc_pb2 as jfpb
from veneur_tpu.proto import metricpb_pb2 as jmpb
from veneur_tpu.sinks.debug import DebugMetricSink as JDebugMetricSink
from veneur_tpu_torch import config as tconfig
from veneur_tpu_torch.aggregation.host import BatchSpec
from veneur_tpu_torch.aggregation.host import Batcher
from veneur_tpu_torch.aggregation.state import TableSpec
from veneur_tpu_torch.forward import convert as tconvert
from veneur_tpu_torch.forward import envelope as tenvelope
from veneur_tpu_torch.forward import gob as tgob
from veneur_tpu_torch.forward import jsonmetric as tjson
from veneur_tpu_torch.forward.rpc import ForwardClient
from veneur_tpu_torch.ops import hll as thll
from veneur_tpu_torch.proto import forwardrpc_pb2 as fpb
from veneur_tpu_torch.proto import metricpb_pb2 as mpb
from veneur_tpu_torch.server import server as tserver_mod
from veneur_tpu_torch.server.aggregator import Aggregator
from veneur_tpu_torch.server.native_aggregator import NativeAggregator
from veneur_tpu_torch.sinks.debug import DebugMetricSink

TESTDATA = os.path.join(os.path.dirname(__file__), "testdata")
PERC = [0.5, 0.99]
SPEC_KW = dict(counter_capacity=256, gauge_capacity=64, status_capacity=16,
               set_capacity=32, histo_capacity=64)
SPEC = TableSpec(**SPEC_KW)
JSPEC = JTableSpec(**SPEC_KW)
BSPEC_KW = dict(counter=512, gauge=128, status=16, set=64, histo=512,
                histo_stat=64)
BSPEC = BatchSpec(**BSPEC_KW)
JBSPEC = JBatchSpec(**BSPEC_KW)


def fixture(name) -> bytes:
    with open(os.path.join(TESTDATA, name), "rb") as f:
        return f.read()


def _mk_list(rng, n_counters=40, n_gauges=10, n_timers=8, n_sets=3):
    """A MetricList shaped like a local's forward payload, with the
    proto3-default edge cases of tests/test_native_import.py: a digest
    whose min 0.0 is elided on the wire, and an all-negative one."""
    ml = fpb.MetricList()
    for i in range(n_counters):
        m = ml.metrics.add(name=f"imp.c.{i}", type=mpb.Counter)
        m.tags.extend([f"host:h{i % 3}", "env:prod"])
        m.counter.value = int(rng.integers(-5, 1000))
    for i in range(n_gauges):
        m = ml.metrics.add(name=f"imp.g.{i}", type=mpb.Gauge)
        m.gauge.value = float(rng.uniform(-10, 10))
    for i in range(n_timers):
        m = ml.metrics.add(name=f"imp.t.{i}", type=mpb.Timer,
                           scope=mpb.Global)
        m.tags.append("svc:api")
        td = m.histogram.t_digest
        vals = rng.lognormal(2, 0.8, 30)
        for v in vals:
            td.main_centroids.add(mean=float(v),
                                  weight=float(rng.integers(1, 4)))
        td.min, td.max = float(vals.min()), float(vals.max())
        td.reciprocalSum = float(np.sum(1.0 / vals))
    for i in range(n_sets):
        m = ml.metrics.add(name=f"imp.s.{i}", type=mpb.Set)
        regs = np.zeros(thll.num_registers(SPEC.hll_precision), np.uint8)
        regs[rng.integers(0, len(regs), 50)] = rng.integers(1, 20, 50)
        m.set.hyper_log_log = thll.serialize(regs)
    m = ml.metrics.add(name="imp.t.zero_min", type=mpb.Timer)
    td = m.histogram.t_digest
    for mean, weight in ((0.0, 1.0), (3.5, 2.0), (8.0, 1.0)):
        td.main_centroids.add(mean=mean, weight=weight)
    td.max = 8.0
    m = ml.metrics.add(name="imp.t.negative", type=mpb.Timer)
    td = m.histogram.t_digest
    for mean, weight in ((-9.5, 1.0), (-2.25, 3.0)):
        td.main_centroids.add(mean=mean, weight=weight)
    td.min, td.max = -9.5, -2.25
    td.reciprocalSum = float(1.0 / -9.5 + 3.0 / -2.25)
    return ml


def _local_lines(seed):
    """One local's interval: global counters and gauges, mixed timers and
    sets, as chip_smoke.py phase 11 sends at full size."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(30):
        out.append(b"fl.c%d:%d|c|#veneurglobalonly,env:prod"
                   % (i, int(rng.integers(1, 100))))
    for i in range(8):
        out.append(b"fl.g%d:%.3f|g|#veneurglobalonly" % (i, rng.normal()))
    for _ in range(300):
        out.append(b"fl.t%d:%.4f|ms|#svc:api"
                   % (int(rng.zipf(1.3)) % 12, rng.lognormal(2, 0.7)))
    for _ in range(200):
        out.append(b"fl.s%d:u%d|s" % (int(rng.integers(0, 4)),
                                      int(rng.integers(0, 5000))))
    return b"\n".join(out)


def _local_export(seed, route="native"):
    """The port's export of one local interval: (MetricList bytes, JAX
    bytes) from the same lines through each package's aggregator."""
    if route == "native":
        tloc = NativeAggregator(SPEC, BSPEC, device="cpu")
        jloc = _SyncedJNative(JSPEC, JBSPEC)
        tloc.feed(_local_lines(seed))
        jloc.feed(_local_lines(seed))
    else:
        from veneur_tpu.samplers.parser import parse_metric as jparse
        from veneur_tpu_torch.samplers.parser import parse_metric as tparse
        tloc = Aggregator(SPEC, BSPEC, device="cpu")
        jloc = _SyncedJAggregator(JSPEC, JBSPEC)
        for ln in _local_lines(seed).split(b"\n"):
            tloc.process_metric(tparse(ln))
            jloc.process_metric(jparse(ln))
    tres, ttab, traw = tloc.flush(PERC, want_raw=True)
    jres, jtab, jraw = jloc.flush(PERC, want_raw=True)
    tml = tconvert.export_metrics(traw, ttab, SPEC.compression,
                                  SPEC.hll_precision)
    jml = jconvert.export_metrics(jraw, jtab, JSPEC.compression,
                                  JSPEC.hll_precision)
    return (fpb.MetricList(metrics=tml).SerializeToString(),
            jfpb.MetricList(metrics=jml).SerializeToString())


@pytest.mark.parametrize("route", ["native", "python"])
def test_export_metrics_bytes_match_jax(route):
    tbytes, jbytes = _local_export(3, route)
    assert tbytes == jbytes
    kinds = {m.type for m in fpb.MetricList.FromString(tbytes).metrics}
    assert kinds == {mpb.Counter, mpb.Gauge, mpb.Timer, mpb.Set}


_FIELD_PREFIX = {"counter": ("counter",), "gauge": ("gauge",),
                 "status": ("status",), "set": ("set_",),
                 "histogram": ("histo_",)}


def _flush_map(agg):
    """The flush by (kind, name, tags, imported_only) -> {field: value}."""
    res, table = agg.flush(PERC)
    out = {}
    for kind, prefixes in _FIELD_PREFIX.items():
        for i, (_slot, meta) in enumerate(table.get_meta(kind)):
            key = (meta.kind, meta.name, ",".join(meta.tags),
                   meta.imported_only)
            out[key] = {k: np.asarray(v)[i] for k, v in res.items()
                        if k.startswith(prefixes)}
    return out


def _assert_same_flush(got, want):
    assert set(got) == set(want), set(got) ^ set(want)
    assert got
    for key in want:
        for field, w in want[key].items():
            g = got[key][field]
            if field in ("histo_quantiles", "histo_median"):
                np.testing.assert_allclose(g, w, rtol=2e-5, atol=2e-5,
                                           err_msg=f"{key} {field}")
            elif field == "set_estimate":
                np.testing.assert_allclose(g, w, rtol=1e-6,
                                           err_msg=f"{key} {field}")
            else:
                np.testing.assert_array_equal(g, w,
                                              err_msg=f"{key} {field}")


def _import_lists():
    rng = np.random.default_rng(11)
    return [_mk_list(rng).SerializeToString(),
            _local_export(5)[0], _local_export(6)[0],
            _mk_list(rng, n_counters=7).SerializeToString()]


@pytest.mark.parametrize("route", ["native", "python"])
def test_import_flushes_match_jax(route):
    lists = _import_lists()
    if route == "native":
        tagg = NativeAggregator(SPEC, BSPEC, device="cpu")
        jagg = _SyncedJNative(JSPEC, JBSPEC)
        for data in lists:
            assert tagg.import_pb_bytes(data) == jagg.import_pb_bytes(data)
    else:
        tagg = Aggregator(SPEC, BSPEC, device="cpu")
        jagg = _SyncedJAggregator(JSPEC, JBSPEC)
        for data in lists:
            for m in fpb.MetricList.FromString(data).metrics:
                tconvert.import_into(tagg, m)
                jconvert.import_into(jagg, jmpb.Metric.FromString(
                    m.SerializeToString()))
    assert tagg.processed == jagg.processed > 0
    assert tagg.steps_total == jagg.steps_total
    _assert_same_flush(_flush_map(tagg), _flush_map(jagg))


# a server's own import timer: the sample its self-telemetry loops back
# into its pipeline after a fold (veneur.import.response_duration_ns)
_SELF_TIMER = b"veneur.import.response_duration_ns:1675407|ms|#part:merge"


@pytest.mark.parametrize("route", ["native", "python"])
@pytest.mark.parametrize("after", [0, 1, 2])
def test_a_self_timer_between_lists_cuts_steps_as_jax_does(route, after):
    """The same item sequence, with one self-telemetry timer sample
    between two imported lists, folds to the same flush in both packages:
    the sample takes a histogram-lane entry and moves every later step
    boundary (and with them the f32 grouping of each digest's sum) the
    same way in each, so the sums stay exact."""
    from veneur_tpu.samplers.parser import parse_metric as jparse
    from veneur_tpu_torch.samplers.parser import parse_metric as tparse
    lists = _import_lists()
    if route == "native":
        tagg = NativeAggregator(SPEC, BSPEC, device="cpu")
        jagg = _SyncedJNative(JSPEC, JBSPEC)
    else:
        tagg = Aggregator(SPEC, BSPEC, device="cpu")
        jagg = _SyncedJAggregator(JSPEC, JBSPEC)
    for i, data in enumerate(lists):
        if route == "native":
            assert tagg.import_pb_bytes(data) == jagg.import_pb_bytes(data)
        else:
            for m in fpb.MetricList.FromString(data).metrics:
                tconvert.import_into(tagg, m)
                jconvert.import_into(jagg, jmpb.Metric.FromString(
                    m.SerializeToString()))
        if i == after:
            tagg.process_metric(tparse(_SELF_TIMER))
            jagg.process_metric(jparse(_SELF_TIMER))
    assert tagg.steps_total == jagg.steps_total
    got, want = _flush_map(tagg), _flush_map(jagg)
    assert any(k[1] == "veneur.import.response_duration_ns" for k in got)
    _assert_same_flush(got, want)


def test_native_import_matches_python_import():
    ml = _mk_list(np.random.default_rng(11))
    py = Aggregator(SPEC, BSPEC, device="cpu")
    for m in ml.metrics:
        tconvert.import_into(py, m)
    nat = NativeAggregator(SPEC, BSPEC, device="cpu")
    assert nat.import_pb_bytes(ml.SerializeToString()) == (len(ml.metrics),
                                                           0)
    a, b = _flush_map(py), _flush_map(nat)
    assert set(a) == set(b), set(a) ^ set(b)
    for key in a:
        for field in a[key]:
            np.testing.assert_allclose(a[key][field], b[key][field],
                                       rtol=1e-5, atol=1e-6,
                                       err_msg=f"{key} {field}")


def test_native_import_imported_only_marking():
    nat = NativeAggregator(SPEC, BSPEC, device="cpu")
    nat.feed(b"wire.c:1|c")        # a wire-created slot first
    nat.import_pb_bytes(_mk_list(np.random.default_rng(3))
                        .SerializeToString())
    assert all(m.imported_only for _s, m in nat.table.get_meta("histogram"))
    by_name = {m.name: m for _s, m in nat.table.get_meta("counter")}
    assert not by_name["wire.c"].imported_only
    assert by_name["imp.c.0"].imported_only


def _both_native(bspec_kw):
    return (NativeAggregator(SPEC, BatchSpec(**bspec_kw), device="cpu"),
            _SyncedJNative(JSPEC, JBatchSpec(**bspec_kw)))


def test_native_import_staging_overflow_reenters():
    """A list bigger than the lanes emits mid-request and re-enters at
    the reported boundary: nothing lost, counters exact, as JAX."""
    small = dict(counter=16, gauge=8, status=8, set=16, histo=64,
                 histo_stat=8)
    ml = _mk_list(np.random.default_rng(5), n_counters=100, n_gauges=20,
                  n_timers=6, n_sets=0)
    tagg, jagg = _both_native(small)
    for agg in (tagg, jagg):
        assert agg.import_pb_bytes(ml.SerializeToString()) == (
            len(ml.metrics), 0)
    assert tagg.steps_total == jagg.steps_total > 8
    got, want = _flush_map(tagg), _flush_map(jagg)
    _assert_same_flush(got, want)
    vals = {k[1]: v["counter"] for k, v in got.items() if k[0] == "counter"}
    assert len(vals) == 100
    for m in ml.metrics:
        if m.WhichOneof("value") == "counter":
            assert vals[m.name] == float(m.counter.value)


def test_native_import_lane_full_at_entry_not_dropped():
    tiny = dict(counter=4, gauge=8, status=8, set=16, histo=64,
                histo_stat=8)
    ml = _mk_list(np.random.default_rng(9), n_counters=10, n_gauges=0,
                  n_timers=0, n_sets=0)
    tagg, jagg = _both_native(tiny)
    for agg in (tagg, jagg):
        for i in range(4):        # the counter lane full from the wire
            agg.feed(b"wire.%d:1|c" % i)
        assert agg.import_pb_bytes(ml.SerializeToString()) == (
            len(ml.metrics), 0)
    got = _flush_map(tagg)
    _assert_same_flush(got, _flush_map(jagg))
    assert {f"imp.c.{i}" for i in range(10)} <= {k[1] for k in got}


def test_native_import_malformed_tail_counted():
    ml = _mk_list(np.random.default_rng(7), n_counters=5, n_gauges=0,
                  n_timers=0, n_sets=0)
    data = ml.SerializeToString() + b"\x0a\xff\xff\xff\xff\x7f"
    tagg, jagg = _both_native(BSPEC_KW)
    assert tagg.import_pb_bytes(data) == (len(ml.metrics), 1)
    assert jagg.import_pb_bytes(data) == (len(ml.metrics), 1)
    _assert_same_flush(_flush_map(tagg), _flush_map(jagg))


def _mutate(rng, b: bytearray) -> bytes:
    op = rng.integers(0, 5)
    if op == 0 and len(b) > 1:
        return bytes(b[:rng.integers(0, len(b))])
    if op == 1:
        for _ in range(int(rng.integers(1, 8))):
            b[int(rng.integers(0, len(b)))] = int(rng.integers(0, 256))
        return bytes(b)
    if op == 2 and len(b) > 8:
        i0 = int(rng.integers(0, len(b) - 4))
        j0 = int(rng.integers(i0, min(len(b), i0 + 64)))
        return bytes(b[:i0]) + bytes(b[j0:])
    if op == 3:
        i0 = int(rng.integers(0, len(b) + 1))
        junk = rng.integers(0, 256, int(rng.integers(1, 32))).astype(
            np.uint8)
        return bytes(b[:i0]) + junk.tobytes() + bytes(b[i0:])
    return rng.integers(0, 256, int(rng.integers(0, 512))).astype(
        np.uint8).tobytes()


def test_native_import_fuzz_answers_as_jax():
    """vi_import parses untrusted bytes: mutated lists (truncate, flip,
    splice, insert, random) never crash the engine, and each answers the
    (metrics, errors) the JAX engine answers."""
    rng = np.random.default_rng(99)
    bases = [_mk_list(rng, n_counters=8, n_gauges=4, n_timers=3,
                      n_sets=2).SerializeToString() for _ in range(4)]
    tagg, jagg = _both_native(BSPEC_KW)
    for _ in range(600):
        data = _mutate(rng, bytearray(bases[int(rng.integers(0, 4))]))
        got = tagg.import_pb_bytes(data)
        assert got == jagg.import_pb_bytes(data)
        assert got[0] >= 0 and got[1] >= 0


def test_import_digest_consistent_hash_partition():
    """reference importsrv/server_test.go:31 TestSendMetrics_ConsistentHash
    pins the import hash bit for bit, in both packages."""
    inputs = [("test.counter", mpb.Counter, ("tag:1",)),
              ("test.gauge", mpb.Gauge, ()),
              ("test.histogram", mpb.Histogram, ("type:histogram",)),
              ("test.set", mpb.Set, ()),
              ("test.gauge3", mpb.Gauge, ())]
    for conv in (tconvert, jconvert):
        assert [conv.metric_digest(n, t, tags) % 2
                for n, t, tags in inputs] == [0, 1, 1, 1, 0]


def test_batcher_histo_stats_lanes_match_jax():
    from veneur_tpu.aggregation.host import Batcher as JBatcher
    small = dict(counter=8, gauge=8, status=8, set=8, histo=8,
                 histo_stat=4)
    tb, jb = [], []
    tbat = Batcher(SPEC, BatchSpec(**small), on_batch=tb.append)
    jbat = JBatcher(JSPEC, JBatchSpec(**small), on_batch=jb.append)
    recips = np.random.default_rng(2).uniform(size=7).astype(np.float32)
    for bat in (tbat, jbat):
        bat.add_histo_stats(3, 1.5, 9.0, 0.25)
        bat.add_histo_stats_bulk(np.arange(7, dtype=np.int32),
                                 np.full(7, -1.0, np.float32),
                                 np.full(7, 4.0, np.float32),
                                 recips)
        bat.emit()
    assert len(tb) == len(jb) == 2
    for t, j in zip(tb, jb):
        for name in t._fields:
            np.testing.assert_array_equal(getattr(t, name), getattr(j, name),
                                          err_msg=name)


# -- (d) wire formats -----------------------------------------------------------

def test_oldgob_fixture_decodes_as_jax_and_reencodes():
    data = base64.b64decode(fixture("oldgob.base64"))
    d = tgob.decode_digest(data)
    assert d == jgob.decode_digest(data)
    assert float(np.sum(np.asarray(d["means"]) * np.asarray(d["weights"]))
                 ) == 499500.0
    enc = tgob.encode_digest(d["means"], d["weights"], d["compression"],
                             d["min"], d["max"], d["recip"])
    assert enc == jgob.encode_digest(d["means"], d["weights"],
                                     d["compression"], d["min"], d["max"],
                                     d["recip"])
    assert enc[:len(data)] == data
    for cut in (1, 5, 40, len(data) // 2):
        with pytest.raises(tgob.GobError):
            tgob.decode_digest(data[:cut])


@pytest.mark.parametrize("name", ["import.uncompressed", "import.deflate"])
def test_reference_import_body_decodes_as_jax(name):
    body = fixture(name)
    if name.endswith("deflate"):
        body = zlib.decompress(body)
    assert body == fixture("import.uncompressed")
    jms = json.loads(body)
    for jm in jms:
        t = tjson.from_json_metric(jm)
        assert t.SerializeToString() == jjson.from_json_metric(
            jm).SerializeToString()
    first = tjson.from_json_metric(jms[0])
    assert first.name == "a.b.c"
    assert [c.mean for c in first.histogram.t_digest.main_centroids] == [
        1.0, 2.0, 7.0, 8.0, 100.0]
    # and back: the JSONMetric form of the decoded list is the JAX one
    back = tjson.to_json_metrics([tjson.from_json_metric(jm) for jm in jms])
    jback = jjson.to_json_metrics([jmpb.Metric.FromString(
        tjson.from_json_metric(jm).SerializeToString()) for jm in jms])
    assert back == jback


def _hll_cases():
    rng = np.random.default_rng(4)
    p = 14
    dense = rng.integers(0, 30, 1 << p).astype(np.uint8)
    wide = dense.copy()
    wide[:5] = 50                                   # spread past a nibble
    based = (dense + 3).astype(np.uint8)            # nonzero base
    empty = np.zeros(1 << p, np.uint8)
    return {"dense": dense, "wide": wide, "based": based, "empty": empty}


@pytest.mark.parametrize("case", sorted(_hll_cases()))
def test_hll_serialize_and_deserialize_match_jax(case):
    regs = _hll_cases()[case]
    data = thll.serialize(regs, 14)
    assert data == jhll.serialize(regs, 14)
    tp, tregs = thll.deserialize(data)
    jp, jregs = jhll.deserialize(data)
    assert tp == jp == 14
    np.testing.assert_array_equal(tregs, jregs)
    # packed rows serialize to the dense rows' bytes
    assert thll.serialize(thll.pack_registers_np(regs, 14), 14) == data


def test_hll_sparse_and_legacy_payloads_decode_as_jax():
    rng = np.random.default_rng(8)
    p = 14
    pp = 25
    keys = []
    for _ in range(300):
        idx = int(rng.integers(0, 1 << p))
        if rng.integers(0, 2):
            r = int(rng.integers(pp - p + 1, pp - p + 40))
            keys.append((idx << (32 - p)) | ((r - pp + p) << 1) | 1)
        else:
            low = int(rng.integers(1, 1 << (pp - p)))
            keys.append((idx << (pp - p + 1)) | (low << 1))
    keys = sorted(set(k & 0xFFFFFFFF for k in keys))
    tmp, lst = keys[:40], keys[40:]
    deltas = np.diff(np.asarray([0] + lst, np.int64))
    varint = bytearray()
    for d in deltas:
        d = int(d)
        while d >= 0x80:
            varint.append((d & 0x7F) | 0x80)
            d >>= 7
        varint.append(d)
    data = (bytes([1, p, 0, 1]) + len(tmp).to_bytes(4, "big")
            + b"".join(k.to_bytes(4, "big") for k in tmp)
            + len(lst).to_bytes(4, "big") + (lst[-1]).to_bytes(4, "big")
            + len(varint).to_bytes(4, "big") + bytes(varint))
    tp, tregs = thll.deserialize(data)
    jp, jregs = jhll.deserialize(data)
    assert tp == jp and tregs.any()
    np.testing.assert_array_equal(tregs, jregs)
    legacy = thll.MAGIC + bytes([10]) + rng.integers(
        0, 20, 1 << 10).astype(np.uint8).tobytes()
    np.testing.assert_array_equal(thll.deserialize(legacy)[1],
                                  jhll.deserialize(legacy)[1])
    for bad in (b"", b"\x02" * 12, data[:20]):
        with pytest.raises(ValueError):
            thll.deserialize(bad)


def test_merge_rows_packed_matches_jax():
    """Duplicate slots combine by a segment max before the unique-index
    write; out-of-range and negative slots drop."""
    import jax.numpy as jnp
    import torch
    rng = np.random.default_rng(1)
    p, k = 10, 6
    words = thll.pack_registers_np(
        rng.integers(0, 8, (k, 1 << p)).astype(np.uint8), p)
    slots = np.asarray([2, 5, 2, -1, 6, 0, 5, 2, 99], np.int32)
    rows = rng.integers(0, 40, (len(slots), 1 << p)).astype(np.uint8)
    got = thll.merge_rows_packed(torch.from_numpy(words.copy()),
                                 torch.from_numpy(slots),
                                 torch.from_numpy(rows), precision=p)
    want = jhll.merge_rows_packed(jnp.asarray(words), jnp.asarray(slots),
                                  jnp.asarray(rows), precision=p)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    untouched = [1, 3, 4]
    np.testing.assert_array_equal(got.numpy()[untouched], words[untouched])


# -- (e) envelopes ----------------------------------------------------------------

SID = "0123456789abcdef0123456789abcdef"
BAD_MAPPINGS = [
    {"veneur-source-id": SID},
    {"veneur-source-id": "XYZ", "veneur-epoch": "1", "veneur-seq": "2"},
    {"veneur-source-id": SID, "veneur-epoch": "-1", "veneur-seq": "2"},
    {"veneur-source-id": SID, "veneur-epoch": "x", "veneur-seq": "2"},
    {"veneur-source-id": SID, "veneur-epoch": "1", "veneur-seq": "2",
     "veneur-trace-id": "5"},
    {"veneur-source-id": SID, "veneur-epoch": "1", "veneur-seq": "2",
     "veneur-trace-id": "0", "veneur-parent-span-id": "3"},
]


@pytest.mark.parametrize("i", range(len(BAD_MAPPINGS)))
def test_malformed_envelopes_raise_in_both_packages(i):
    meta = BAD_MAPPINGS[i]
    with pytest.raises(tenvelope.EnvelopeError) as te:
        tenvelope.Envelope.from_mapping(meta)
    with pytest.raises(jenvelope.EnvelopeError) as je:
        jenvelope.Envelope.from_mapping(meta)
    assert str(te.value) == str(je.value)


def test_envelope_parse_matches_jax():
    good = {"veneur-source-id": SID, "veneur-epoch": "3",
            "veneur-seq": "7", "veneur-trace-id": "11",
            "veneur-parent-span-id": "12"}
    t = tenvelope.Envelope.from_mapping(good)
    j = jenvelope.Envelope.from_mapping(good)
    assert t.to_json() == j.to_json() and t.to_metadata() == j.to_metadata()
    assert tenvelope.Envelope.from_mapping({}) is None
    assert tenvelope.Envelope.from_json(t.to_json()) == t
    for bad in ("x", {"source_id": SID, "epoch": "a", "seq": 1},
                {"source_id": "", "epoch": 1, "seq": 1}):
        with pytest.raises(tenvelope.EnvelopeError):
            tenvelope.Envelope.from_json(bad)
        with pytest.raises(jenvelope.EnvelopeError):
            jenvelope.Envelope.from_json(bad)


# -- (e), (f) both Servers over gRPC and HTTP --------------------------------------

SERVER_KW = dict(
    interval="3600s", hostname="globalbox", percentiles=PERC,
    aggregates=["min", "max", "count", "sum"],
    statsd_listen_addresses=[], ssf_listen_addresses=[],
    http_address="127.0.0.1:0", grpc_address="127.0.0.1:0",
    tpu_counter_capacity=256, tpu_gauge_capacity=64,
    tpu_status_capacity=16, tpu_set_capacity=32, tpu_histo_capacity=64,
    tpu_batch_counter=512, tpu_batch_gauge=128, tpu_batch_status=16,
    tpu_batch_set=64, tpu_batch_histo=512)


def _app(metrics):
    return sorted((m for m in metrics if not m.name.startswith("veneur.")
                   and m.name != "ssf.names_unique"),
                  key=lambda m: (m.name, tuple(m.tags), m.type))


def _assert_same_intermetrics(got, want, same_ts=False):
    assert len(got) == len(want) > 0
    set_names = {m.name for m in want if m.type == "gauge"
                 and m.name.startswith(("imp.s.", "fl.s"))}
    for g, w in zip(got, want):
        assert (g.name, g.tags, g.type, g.message, g.hostname, g.sinks) == (
            w.name, w.tags, w.type, w.message, w.hostname, w.sinks)
        assert abs(g.timestamp - w.timestamp) <= (0 if same_ts else 60)
        tail = g.name.rsplit(".", 1)[-1]
        if tail.endswith("percentile") or tail == "median":
            np.testing.assert_allclose(g.value, w.value, rtol=2e-5,
                                       atol=2e-5, err_msg=g.name)
        elif g.name in set_names:
            np.testing.assert_allclose(g.value, w.value, rtol=1e-6,
                                       err_msg=g.name)
        else:
            assert g.value == w.value, (g.name, g.value, w.value)


def _post(port, body, ctype="application/json", headers=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/import", data=body, method="POST",
        headers={"Content-Type": ctype, **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status
    except urllib.error.HTTPError as e:
        return e.code


class _DropSpans:
    """A trace backend that drops every span."""

    def send(self, span) -> None:
        pass

    def close(self) -> None:
        pass


@pytest.fixture(scope="module", params=["native", "python"])
def servers(request):
    kw = dict(SERVER_KW, native_ingest=request.param == "native")
    jsink, tsink = JDebugMetricSink(), DebugMetricSink()
    jsrv = _SyncedJServer(jconfig.Config(**kw), metric_sinks=[jsink])
    tsrv = tserver_mod.Server(tconfig.Config(**kw), metric_sinks=[tsink],
                              device="cpu")
    # A Server's self-telemetry (the import timers of each fold and each
    # POST) loops back into its own pipeline at a point set by thread
    # timing, in both packages. A timer sample that lands between two
    # imported lists takes a histogram-lane entry and moves the later
    # step boundaries, and with them the f32 grouping of a digest's sum
    # (test_a_self_timer_between_lists_cuts_steps_as_jax_does). With the
    # loop-back dropped, both Servers fold the same item sequence.
    for srv in (jsrv, tsrv):
        srv.trace_client.backend = _DropSpans()
    jsrv.start()
    tsrv.start()
    try:
        yield request.param, (jsrv, jsink), (tsrv, tsink)
    finally:
        tsrv.shutdown()
        jsrv.shutdown()


def _flush_app(srv, sink):
    sink.flushed.clear()
    assert srv.trigger_flush(timeout=120)
    return _app(sink.flushed)


def _wait_imported(srv, n):
    _wait(lambda: srv.imported_total + srv.import_errors >= n,
          "imports not all folded")


def test_servers_import_over_grpc_and_http_flush_the_same(servers):
    route, (jsrv, jsink), (tsrv, tsink) = servers
    lists = _import_lists()
    n = sum(len(fpb.MetricList.FromString(d).metrics) for d in lists)
    for srv in (jsrv, tsrv):
        client = ForwardClient(f"127.0.0.1:{srv.grpc_port}")
        for data in lists:
            client.send_metrics(list(fpb.MetricList.FromString(data)
                                     .metrics))
        client.close()
    body = json.dumps(tjson.to_json_metrics(list(
        fpb.MetricList.FromString(lists[1]).metrics))).encode()
    m_json = len(json.loads(body))
    for srv in (jsrv, tsrv):
        assert _post(srv.http_port, zlib.compress(body),
                     headers={"Content-Encoding": "deflate"}) == 202
        _wait_imported(srv, n + m_json)
    assert tsrv.imported_total == jsrv.imported_total == n + m_json
    assert tsrv.import_errors == jsrv.import_errors == 0
    _assert_same_intermetrics(_flush_app(tsrv, tsink),
                              _flush_app(jsrv, jsink))


def test_json_import_flushes_what_grpc_flushes(servers):
    _route, _j, (tsrv, tsink) = servers
    data = _local_export(8)[0]
    metrics = list(fpb.MetricList.FromString(data).metrics)
    base = tsrv.imported_total
    client = ForwardClient(f"127.0.0.1:{tsrv.grpc_port}")
    client.send_metrics(metrics)
    client.close()
    _wait_imported(tsrv, base + len(metrics))
    over_grpc = _flush_app(tsrv, tsink)
    body = json.dumps(tjson.to_json_metrics(metrics)).encode()
    assert _post(tsrv.http_port, body) == 202
    _wait_imported(tsrv, base + 2 * len(metrics))
    over_http = _flush_app(tsrv, tsink)
    assert len(over_grpc) > 20
    _assert_same_intermetrics(over_http, over_grpc)


def _envelope_cases():
    ml = json.loads(json.dumps(tjson.to_json_metrics(
        list(_mk_list(np.random.default_rng(1), 3, 1, 1, 0).metrics))))
    good = {"source_id": SID, "epoch": 1, "seq": 4}
    return [
        ("bare", json.dumps(ml).encode(), {}),
        ("wrapped", json.dumps({"envelope": good, "metrics": ml}).encode(),
         {}),
        ("headers", json.dumps(ml).encode(),
         {"veneur-source-id": SID, "veneur-epoch": "1", "veneur-seq": "5"}),
        ("partial-headers", json.dumps(ml).encode(),
         {"veneur-source-id": SID}),
        ("bad-body-envelope", json.dumps(
            {"envelope": dict(good, source_id="nothex"), "metrics": ml})
         .encode(), {}),
        ("non-object-envelope", json.dumps(
            {"envelope": [1], "metrics": ml}).encode(), {}),
        ("bad-json", b"[{", {}),
        ("empty", b"[]", {}),
        ("bad-deflate", b"xx", {"Content-Encoding": "deflate"}),
        ("gzip", b"xx", {"Content-Encoding": "gzip"}),
        ("bad-protobuf", b"\x0a\xff\xff", {}),
    ]


def test_import_http_codes_and_envelope_rejections_match_jax(servers):
    _route, (jsrv, _), (tsrv, _) = servers
    codes = []
    for name, body, headers in _envelope_cases():
        ctype = ("application/x-protobuf" if name == "bad-protobuf"
                 else "application/json")
        got = (_post(tsrv.http_port, body, ctype, headers),
               _post(jsrv.http_port, body, ctype, headers))
        assert got[0] == got[1], (name, got)
        codes.append((name, got[0]))
    assert dict(codes) == {
        "bare": 202, "wrapped": 202, "headers": 202, "partial-headers": 400,
        "bad-body-envelope": 400, "non-object-envelope": 400,
        "bad-json": 400, "empty": 400, "bad-deflate": 400, "gzip": 415,
        "bad-protobuf": 400}
    assert (tsrv._c_envelope_rejected.value()
            == jsrv._c_envelope_rejected.value() == 3)
