"""Live resharding (ROADMAP A8b): the fold and multi-wave steps, the
port against the JAX package on the CPU.

- (c) fold parity: the same units folded into a fresh port aggregator
  and a fresh JAX aggregator at new_n in {1, 2, 8}, Python and native
  backends, flush the same (counters, gauges, histogram count/min/max
  exact; set estimates within rtol 1e-6, C-watch 7; the rest of the
  digest within rtol/atol 2e-5);
- (d) multi-wave steps: the same waves through the port's and the JAX
  package's NativeShardedAggregator at S = 4 on four reader rings,
  pumped by hand one wave a step and three waves a step, flush the same
  quantiles within 2e-5 in each grouping, and each grouping's error
  against the exact quantiles is the JAX package's own: the grouping
  moves the digests in both packages alike (ROADMAP C-10, the cause of
  chip_smoke.py phase 14a's unpaced ring run's error).
"""

import jax
import numpy as np
import pytest

from tests.test_torch_reshard import (PERC, _assert_rows, _fresh,
                                      _JNativeSharded, _port_snapshot,
                                      _rows)
from tests.test_torch_server import _wait
from veneur_tpu.aggregation.host import BatchSpec as JBatchSpec
from veneur_tpu.aggregation.state import TableSpec as JTableSpec
from veneur_tpu.persistence import fold_snapshot as jfold_snapshot
from veneur_tpu_torch.aggregation.host import BatchSpec
from veneur_tpu_torch.aggregation.state import TableSpec
from veneur_tpu_torch.persistence import fold_snapshot
from veneur_tpu_torch.reshard import plan as tplan
from veneur_tpu_torch.server.native_aggregator import (
    NativeShardedAggregator as TNativeSharded)


# -- (c) fold parity ------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["python", "native"])
@pytest.mark.parametrize("new_n", [1, 2, 8])
def test_folded_units_flush_like_jax(backend, new_n):
    snap = _port_snapshot()
    units = tplan.partition_units(snap, tplan.ReshardPlan(4, new_n))
    t, j = _fresh(backend, new_n, False), _fresh(backend, new_n, True)
    folded = [(fold_snapshot(t, u), jfold_snapshot(j, u)) for u in units]
    assert all(a == b for a, b in folded)
    assert sum(a for a, _ in folded) == sum(u["rows"] for u in units)
    jax.block_until_ready(j.state)
    _assert_rows(_rows(t), _rows(j))


# -- (d) multi-wave steps --------------------------------------------------------------

WAVE_KW = dict(counter_capacity=64, gauge_capacity=32, status_capacity=8,
               set_capacity=16, histo_capacity=32)
WAVE_BS = dict(counter=1024, gauge=1024, status=8, set=1024, histo=4096,
               histo_stat=16)


def _wave_traffic(seed=10, n_waves=6, per=600):
    """Waves of lines (timers Zipf-hot over 6 names, counters, gauges,
    sets), each a list of (ring, datagram): a name's lines ride one of
    four rings, as phase 14a routes them. Returns the waves, their line
    counts and every timer's samples."""
    import zlib
    rng = np.random.default_rng(seed)
    waves, samples = [], {}
    for _w in range(n_waves):
        per_ring = [[] for _ in range(4)]
        for _i in range(per):
            k = int(rng.integers(0, 10))
            if k < 6:
                name = b"mw.t%d" % ((int(rng.zipf(1.5)) - 1) % 6)
                v = float(rng.lognormal(3.0, 1.0))
                line = b"%s:%.4f|ms" % (name, v)
                samples.setdefault(name, []).append(
                    float(np.float32(float(b"%.4f" % v))))
            elif k < 8:
                name = b"mw.c%d" % int(rng.integers(0, 40))
                line = b"%s:%d|c" % (name, int(rng.integers(1, 9)))
            elif k == 8:
                name = b"mw.g%d" % int(rng.integers(0, 20))
                line = b"%s:%.3f|g" % (name, float(rng.normal()))
            else:
                name = b"mw.s%d" % int(rng.integers(0, 10))
                line = b"%s:u%d|s" % (name, int(rng.integers(0, 5000)))
            per_ring[zlib.crc32(name) % 4].append(line)
        grams = [(r, b"\n".join(lines[i:i + 50])) for r, lines in
                 enumerate(per_ring) for i in range(0, len(lines), 50)]
        waves.append((grams, per))
    return waves, samples


def _waves_run(jax_side, waves, per_step):
    """The waves through four reader rings of a NativeShardedAggregator
    at S = 4 (pre-sharded ring drain), pumped by hand: `per_step` waves
    injected and parsed, then one step (query_snapshot's drain); then
    the flush, with raw rows."""
    spec = (JTableSpec if jax_side else TableSpec)(**WAVE_KW)
    bs = (JBatchSpec if jax_side else BatchSpec)(**WAVE_BS)
    kw = {} if jax_side else {"device": "cpu"}
    agg = (_JNativeSharded if jax_side else TNativeSharded)(
        spec, bs, n_shards=4, compact_every=2, preshard=True, **kw)
    agg.rings_start(4)
    try:
        sent = 0
        for g in range(0, len(waves), per_step):
            steps0 = agg.steps_total if not jax_side else None
            for grams, n in waves[g:g + per_step]:
                for ring, gram in grams:
                    assert agg.eng.rings_inject(ring, gram) == 1
                sent += n
            _wait(lambda: agg.eng.stats()["processed"] >= sent,
                  f"{sent} lines not parsed")
            agg.query_snapshot()
            if steps0 is not None:
                assert agg.steps_total - steps0 == 1
        st, tb = agg.swap()
        res, tb, raw = agg.compute_flush(st, tb, PERC, want_raw=True)
    finally:
        agg.readers_stop()
    out = {}
    for kind, key in (("counter", "counter"), ("gauge", "gauge")):
        for i, (_s, m) in enumerate(tb.get_meta(kind)):
            out[(key, m.name)] = float(res[key][i])
    for i, (_s, m) in enumerate(tb.get_meta("set")):
        out[("words", m.name)] = np.asarray(raw["hll"][i]).tobytes()
    q = {m.name: np.asarray(res["histo_quantiles"][i], np.float64)
         for i, (_s, m) in enumerate(tb.get_meta("histogram"))}
    return out, q


@pytest.fixture(scope="module")
def wave_runs():
    """Each package's flush of the same waves, one and three waves a
    step: {(jax_side, per_step): (rows, quantiles)}, and the samples."""
    waves, samples = _wave_traffic()
    return {(j, k): _waves_run(j, waves, k) for j in (False, True)
            for k in (1, 3)}, samples


@pytest.mark.parametrize("per_step", [1, 3], ids=["one-wave", "three-waves"])
def test_multi_wave_steps_match_jax(wave_runs, per_step):
    """Several waves in one step, as phase 14a's unpaced ring run makes
    them: the port's quantiles are the JAX package's within 2e-5, and so
    is each key's error against its samples' midpoint quantiles. Which
    samples share a step moves the digests in both packages alike: the
    unpaced run's error is the reference's own (ROADMAP C-10)."""
    runs, samples = wave_runs
    t_rows, t_q = runs[False, per_step]
    j_rows, j_q = runs[True, per_step]
    assert t_rows == j_rows and len(t_rows) > 60
    assert sorted(t_q) == sorted(j_q) == sorted(
        n.decode() for n in samples)
    for name, got in t_q.items():
        np.testing.assert_allclose(got, j_q[name], rtol=2e-5, atol=2e-5,
                                   err_msg=name)
        vals = np.asarray(samples[name.encode()])
        for qi, q in enumerate(PERC):
            exact = _midpoint(vals, q)
            t_err = abs(got[qi] - exact) / exact
            j_err = abs(j_q[name][qi] - exact) / exact
            assert abs(t_err - j_err) <= 2e-5, (name, q)


def test_the_step_grouping_moves_the_digests_in_both_packages(wave_runs):
    """One wave a step and three waves a step give different quantiles,
    in the port and in the JAX package alike."""
    runs, _ = wave_runs
    gaps = []
    for jax_side in (False, True):
        one, three = runs[jax_side, 1][1], runs[jax_side, 3][1]
        gaps.append(max(np.abs(one[k] - three[k]).max() / np.abs(
            three[k]).max() for k in one))
    assert gaps[0] > 1e-6 and gaps[1] > 1e-6
    assert abs(gaps[0] - gaps[1]) <= 2e-5


def _midpoint(vals, q):
    """Quantile of raw samples under the t-digest midpoint convention."""
    v = np.sort(np.asarray(vals, np.float64))
    x = q * len(v) - 0.5
    if x <= 0:
        return v[0]
    if x >= len(v) - 1:
        return v[-1]
    i = int(np.floor(x))
    return v[i] * (1 - (x - i)) + v[i + 1] * (x - i)

