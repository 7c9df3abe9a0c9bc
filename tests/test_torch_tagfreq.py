"""The tag-frequency sketch (ROADMAP A9) in the port against the JAX
package, on the CPU.

- (a) hashing: the engine's hash64_batch, columns_for and
  columns_for_batch equal JAX's word for word;
- (b) the sketch ops: insert_batch, estimate, insert_and_estimate and
  merge equal JAX's, exactly for integer weights (padding dropped),
  within rtol 1e-6 for fractional ones;
- (c) HeavyHitters: top() and its 4K -> 2K prune match JAX's over a Zipf
  stream;
- (d) the sink: TagFrequencySink's samples equal JAX's; the tag-key
  filter and the reset; an update that raises changes nothing;
- (e) the Server: with tag_frequency_enabled the port's Server reports
  the true top tags through the metric pipeline, the rows the JAX Server
  reports;
- (f) the t-digest table ops beside the sketch: merge_tables (both
  orders, a table with itself) and cdf equal JAX's within 2e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_server import SMALL, _SyncedJServer, _wait
from veneur_tpu import config as jconfig
from veneur_tpu import native as jnative
from veneur_tpu.ops import countmin as jcm
from veneur_tpu.ops import tdigest as jtd
from veneur_tpu.proto import ssf_pb2 as jssf
from veneur_tpu.sinks.debug import DebugMetricSink as JDebugMetricSink
from veneur_tpu.sinks.tagfreq import TagFrequencySink as JTagFrequencySink
from veneur_tpu_torch import config as tconfig
from veneur_tpu_torch import native as tnative
from veneur_tpu_torch.ops import countmin as tcm
from veneur_tpu_torch.ops import tdigest as ttd
from veneur_tpu_torch.proto import ssf_pb2 as tssf
from veneur_tpu_torch.server import server as tserver_mod
from veneur_tpu_torch.sinks.debug import DebugMetricSink as TDebugMetricSink
from veneur_tpu_torch.sinks.tagfreq import TagFrequencySink
from veneur_tpu_torch.utils.hashing import fnv1a_64


def _members(seed, n=300):
    rng = np.random.default_rng(seed)
    out = [bytes(rng.integers(0, 256, int(k)).astype(np.uint8))
           for k in rng.integers(0, 40, n)]
    return out + [b"", b"a", b"customer:hot1", b"x" * 100]


# -- (a) hashing -----------------------------------------------------------------

def test_hash64_batch_matches_jax_and_fnv():
    m = _members(0)
    got = tnative.hash64_batch(m)
    assert got.dtype == np.uint64
    np.testing.assert_array_equal(got, jnative.hash64_batch(m))
    assert [int(h) for h in got] == [fnv1a_64(x) for x in m]
    assert tnative.hash64_batch([]).shape == (0,)


@pytest.mark.parametrize("depth,width", [(4, 1 << 16), (3, 1 << 10),
                                         (1, 2)])
def test_columns_match_jax(depth, width):
    m = _members(depth)
    got = tcm.columns_for_batch(m, depth, width)
    np.testing.assert_array_equal(got, jcm.columns_for_batch(m, depth, width))
    assert got.dtype == np.int32
    for i, x in enumerate(m[:50] + m[-4:]):
        one = tcm.columns_for(x, depth, width)
        np.testing.assert_array_equal(one, jcm.columns_for(x, depth, width))
        np.testing.assert_array_equal(one, got[m.index(x)])
    with pytest.raises(ValueError):
        tcm.empty_counters(2, 12, "cpu")


# -- (b) the sketch ops -------------------------------------------------------------

def _batch(seed, depth=4, width=1 << 10, n=2000, frac=False, pad=0.1):
    rng = np.random.default_rng(seed)
    items = [b"m%d" % int(i) for i in rng.zipf(1.3, n) % 500]
    cols = jcm.columns_for_batch(items, depth, width)
    cols[rng.random(n) < pad] = -1          # padding rows
    w = (rng.random(n).astype(np.float32) * 3 if frac
         else rng.integers(1, 4, n).astype(np.float32))
    return cols, w


def _both(fn_name, counters, *args):
    t = getattr(tcm, fn_name)(torch.from_numpy(counters),
                              *[torch.from_numpy(a) for a in args])
    j = getattr(jcm, fn_name)(jnp.asarray(counters),
                              *[jnp.asarray(a) for a in args])
    if isinstance(t, tuple):
        return [x.numpy() for x in t], [np.asarray(x) for x in j]
    return t.numpy(), np.asarray(j)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sketch_ops_match_jax_exactly_for_integer_weights(seed):
    cols, w = _batch(seed)
    c0 = np.zeros((4, 1 << 10), np.float32)
    c1, jc1 = _both("insert_batch", c0, cols, w)
    np.testing.assert_array_equal(c1, jc1)
    est, jest = _both("estimate", c1, cols)
    np.testing.assert_array_equal(est, jest)
    assert np.all(est[(cols < 0).any(axis=1)] == 0.0)
    (c2, e2), (jc2, je2) = _both("insert_and_estimate", c1, cols, w)
    np.testing.assert_array_equal(c2, jc2)
    np.testing.assert_array_equal(e2, je2)
    m, jm = _both("merge", c1, c2)
    np.testing.assert_array_equal(m, jm)
    # the fused pass equals the two ops one after the other
    sep = tcm.insert_batch(torch.from_numpy(c1), torch.from_numpy(cols),
                           torch.from_numpy(w))
    np.testing.assert_array_equal(c2, sep.numpy())
    np.testing.assert_array_equal(e2, tcm.estimate(
        sep, torch.from_numpy(cols)).numpy())
    # the input table is not written (from_numpy shares its memory)
    assert not c0.any() and np.array_equal(c1, jc1)


def test_sketch_ops_match_jax_for_fractional_weights():
    cols, w = _batch(5, frac=True)
    c0 = np.zeros((4, 1 << 10), np.float32)
    (c, e), (jc, je) = _both("insert_and_estimate", c0, cols, w)
    np.testing.assert_allclose(c, jc, rtol=1e-6)
    np.testing.assert_allclose(e, je, rtol=1e-6)


def test_padding_is_dropped_like_jax():
    cols = np.asarray([[1, 2], [-1, -1], [3, -1]], np.int32)
    w = np.asarray([5.0, 7.0, 11.0], np.float32)
    c, jc = _both("insert_batch", np.zeros((2, 16), np.float32), cols, w)
    np.testing.assert_array_equal(c, jc)
    # the last row's valid depth counts; its estimate is 0 (a padded
    # column reads as missing)
    assert c.sum() == 10.0 + 11.0
    est, jest = _both("estimate", c, cols)
    np.testing.assert_array_equal(est, jest)
    assert est.tolist() == [5.0, 0.0, 0.0]


# -- (c) HeavyHitters ----------------------------------------------------------------

def _zipf_stream(seed, n=6000, values=2000):
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, values + 1, dtype=np.float64)
    p = (1.0 / ranks) / np.sum(1.0 / ranks)
    return [b"tag%d" % int(i) for i in rng.choice(values, size=n, p=p)]


def test_heavy_hitters_top_and_prune_match_jax():
    stream = _zipf_stream(1)
    t = tcm.HeavyHitters(k=5, width=1 << 12, device="cpu")
    j = jcm.HeavyHitters(k=5, width=1 << 12)
    pruned = 0
    for i in range(0, len(stream), 512):
        t.update(stream[i:i + 512])
        j.update(stream[i:i + 512])
        assert t.candidates == j.candidates
        pruned += len(t.candidates) <= 2 * t.k
    assert pruned > 0          # the 4K -> 2K prune ran
    assert t.top() == j.top() and t.top(3) == j.top(3)
    assert t.total == j.total == len(stream)
    true = {m: stream.count(m) for m in set(stream)}
    for m, est in t.top():
        assert est >= true[m]
    assert t.top(1)[0][0] == b"tag0"
    t.reset()
    assert t.candidates == {} and t.total == 0.0
    assert float(t.counters.sum()) == 0.0


# -- (d) the sink ---------------------------------------------------------------------

def _span(pb, tags, i=0):
    span = pb.SSFSpan(version=0, trace_id=i + 1, id=i + 2, service="svc",
                      name="op", start_timestamp=1, end_timestamp=2)
    for k, v in tags.items():
        span.tags[k] = v
    return span


def _fields(samples):
    return [(s.name, dict(s.tags), s.value, s.metric) for s in samples]


def test_sink_samples_match_jax():
    draws = np.random.default_rng(0).zipf(1.2, 6000) % 2000
    t = TagFrequencySink(top_k=10, batch_size=256, device="cpu")
    j = JTagFrequencySink(top_k=10, batch_size=256)
    spans = [({"customer": f"c{d}"}, i) for i, d in enumerate(draws)]
    for k in range(0, len(spans), 100):      # both ingest flavours
        chunk = spans[k:k + 100]
        if k % 200:
            t.ingest_many([_span(tssf, tg, i) for tg, i in chunk])
            j.ingest_many([_span(jssf, tg, i) for tg, i in chunk])
        else:
            for tg, i in chunk:
                t.ingest(_span(tssf, tg, i))
                j.ingest(_span(jssf, tg, i))
    assert (t.spans_seen, t.members_seen) == (j.spans_seen, j.members_seen)
    got, want = t.flush(), j.flush()
    assert _fields(got) == _fields(want) and len(got) == 11
    true = np.bincount(draws)
    top5 = np.argsort(-true, kind="stable")[:5]
    rows = {s.tags["tag"]: s.value for s in got
            if s.name == "veneur.span.tag_frequency"}
    for v in top5:
        assert true[v] <= rows[f"customer:c{v}"] <= true[v] + 0.01 * 6000
    assert got[-1].name == "veneur.span.tag_frequency.total"
    assert got[-1].value == 6000


def test_sink_tag_key_filter_and_reset():
    sink = TagFrequencySink(top_k=5, tag_keys=["tracked"], batch_size=8,
                            device="cpu")
    for i in range(20):
        sink.ingest(_span(tssf, {"tracked": "yes", "ignored": f"x{i}"}))
    got = {s.tags["tag"] for s in sink.flush()
           if s.name == "veneur.span.tag_frequency"}
    assert got == {"tracked:yes"}
    assert sink.flush() == []          # the interval resets
    reported = []
    sink.report = reported.extend
    sink.ingest(_span(tssf, {"tracked": "again"}))
    assert len(sink.flush()) == 2 and len(reported) == 2


def test_sink_update_that_raises_changes_nothing():
    sink = TagFrequencySink(top_k=5, batch_size=4, device="cpu")
    sink.ingest_many([_span(tssf, {"k": "a"}), _span(tssf, {"k": "b"})])
    before = (list(sink._buf), sink.spans_seen, sink.members_seen,
              sink.hh.counters.clone(), dict(sink.hh.candidates))

    def boom(members, weights=None):
        raise RuntimeError("device gone")

    real, sink.hh.update = sink.hh.update, boom
    with pytest.raises(RuntimeError):
        sink.ingest_many([_span(tssf, {"k": "c"}), _span(tssf, {"k": "d"})])
    after = (list(sink._buf), sink.spans_seen, sink.members_seen,
             sink.hh.counters, dict(sink.hh.candidates))
    assert after[:3] == before[:3] and after[4] == before[4]
    assert torch.equal(after[3], before[3])
    sink.hh.update = real
    sink.ingest_many([_span(tssf, {"k": "c"}), _span(tssf, {"k": "d"})])
    assert sink.spans_seen == 4 and sink._buf == []
    assert {s.tags.get("tag") for s in sink.flush()} == {
        "k:a", "k:b", "k:c", "k:d", None}


# -- (e) the Server -------------------------------------------------------------------

def _tagfreq_rows(sink):
    return sorted((m.name, tuple(m.tags), m.value) for m in sink.flushed
                  if m.name.startswith("veneur.span.tag_frequency"))


def test_server_reports_the_top_tags_as_the_jax_server_does():
    kw = dict(SMALL, statsd_listen_addresses=[], ssf_listen_addresses=[],
              http_address="", tag_frequency_enabled=True,
              tag_frequency_top_k=5, tag_frequency_batch_size=64,
              span_channel_capacity=1024, num_span_workers=1)
    tsink, jsink = TDebugMetricSink(), JDebugMetricSink()
    tsrv = tserver_mod.Server(tconfig.Config(**kw), metric_sinks=[tsink],
                              device="cpu")
    jsrv = _SyncedJServer(jconfig.Config(**kw), metric_sinks=[jsink])
    rows = []
    for srv, sink, pb in ((tsrv, tsink, tssf), (jsrv, jsink, jssf)):
        srv.start()
        try:
            for i in range(120):
                srv.span_pipeline.handle_span(_span(
                    pb, {"customer": "hot" if i % 2 == 0 else f"cold{i}"},
                    i))
            _wait(lambda: srv.tag_frequency.spans_seen >= 120,
                  "spans not all through the sketch")
            # the span sinks flush with the metric flush; the samples
            # loop back into the next interval
            for _ in range(20):
                assert srv.trigger_flush(timeout=60)
                if _tagfreq_rows(sink):
                    break
        finally:
            srv.shutdown()
        rows.append(_tagfreq_rows(sink))
    trows, jrows = rows
    assert trows and len(trows) == len(jrows)
    hot = [r for r in trows if r[1] == ("tag:customer:hot",)]
    assert hot == [r for r in jrows if r[1] == ("tag:customer:hot",)]
    assert hot[0][2] == 60.0
    total = [r for r in trows if r[0].endswith(".total")]
    assert total == [r for r in jrows if r[0].endswith(".total")]
    assert total[0][2] == 120.0
    assert tsrv.tag_frequency.hh.counters.device.type == "cpu"


# -- (f) t-digest table ops -------------------------------------------------------------

def _tables(seed, lo, hi, n=5000):
    data = np.random.default_rng(seed).uniform(lo, hi, n).astype(np.float32)
    w = np.ones(n, np.float32)
    t = ttd.add_batch_single(ttd.empty_table(()), data, w)
    j = jtd.add_batch_single(jtd.empty_table(()), jnp.asarray(data),
                             jnp.asarray(w))
    lift_t = ttd.TDigestTable(*[x[None] for x in t])
    lift_j = jtd.TDigestTable(*[jnp.asarray(np.asarray(x))[None] for x in j])
    return lift_t, lift_j, data


def _same_table(t, j, tol=2e-5):
    """Cells and extremes within tol; each two-float pair as its f64
    value (the batch sums split into hi and lo by their own f32 order)."""
    for name in ("mean", "weight", "min", "max"):
        np.testing.assert_allclose(getattr(t, name).numpy(),
                                   np.asarray(getattr(j, name)), rtol=tol,
                                   atol=tol, err_msg=name)
    for name in ("count", "sum", "recip"):
        got = (getattr(t, name + "_hi").numpy().astype(np.float64)
               + getattr(t, name + "_lo").numpy())
        want = (np.asarray(getattr(j, name + "_hi"), np.float64)
                + np.asarray(getattr(j, name + "_lo")))
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=name)


@pytest.mark.parametrize("order", ["ab", "ba", "aa"])
def test_merge_tables_matches_jax(order):
    ta, ja, da = _tables(1, 0.0, 100.0)
    tb, jb, db = _tables(2, 50.0, 200.0)
    pick = {"a": (ta, ja), "b": (tb, jb)}
    (t1, j1), (t2, j2) = pick[order[0]], pick[order[1]]
    tm, jm = ttd.merge_tables(t1, t2), jtd.merge_tables(j1, j2)
    _same_table(tm, jm)
    total = float(tm.count_hi[0] + tm.count_lo[0])
    assert total == 2 * len(da)
    qs = [0.1, 0.5, 0.9, 0.99]
    np.testing.assert_allclose(ttd.quantiles(tm, qs).numpy(),
                               np.asarray(jtd.quantiles(jm, qs)),
                               rtol=2e-5, atol=2e-5)


def test_cdf_matches_jax():
    t, j, data = _tables(5, 0.0, 1.0, n=20_000)
    xs = np.asarray([-1.0, 0.1, 0.5, 0.9, 2.0], np.float32)
    got = ttd.cdf(t, xs).numpy()
    np.testing.assert_allclose(got, np.asarray(jtd.cdf(j, xs)), rtol=2e-5,
                               atol=2e-5)
    assert got[0, 0] == 0.0 and got[0, -1] == 1.0
    np.testing.assert_allclose(got[0, 1:4], [0.1, 0.5, 0.9], atol=0.01)
    empty = ttd.TDigestTable(*[x[None] for x in ttd.empty_table(())])
    assert np.isnan(ttd.cdf(empty, xs).numpy()).all()
