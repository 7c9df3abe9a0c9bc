"""The plain reference against a brute-force answer on tiny corpora."""

import math

import numpy as np
import pytest

from bench_port import harness, reference
from bench_port.tests.test_bench_generate import MIXED

statsd = harness.kind("statsd")


def _interp_quantile(points, mn, mx, q):
    """ops/tdigest.py's convention, one key at a time: centroids (value,
    weight) sorted, their mass midpoints interpolated, min and max at
    the ends."""
    points = sorted(points)
    tot = sum(w for _v, w in points)
    xs, ys, cum = [0.0], [mn], 0.0
    for v, w in points:
        xs.append(cum + w / 2)
        ys.append(v)
        cum += w
    xs.append(tot)
    ys.append(mx)
    t = q * tot
    for i in range(len(xs) - 1):
        if xs[i] <= t <= xs[i + 1]:
            if xs[i + 1] == xs[i]:
                return ys[i]
            return ys[i] + (t - xs[i]) * (ys[i + 1] - ys[i]) / (
                xs[i + 1] - xs[i])
    return mx


def test_statsd_reference_is_the_brute_force_answer():
    c = statsd.corpus(MIXED, 21)
    ref = statsd.reference(c)
    n_items = len(c.items)
    start, stop = 3, n_items + n_items // 2        # 1.5 passes of the corpus
    want = ref.interval(start, stop)
    per_key = {}
    for item in range(start, stop):
        i = item % n_items
        a = int(c.item_samples[:i].sum())
        for j in range(a, a + int(c.item_samples[i])):
            per_key.setdefault(int(c.line_key[j]), []).append(
                float(np.float32(c.line_value[j])))
    kinds = {c.key_type[k] for k in per_key}
    assert kinds == {"timer", "counter", "gauge"}
    for k in range(len(c.key_name)):
        vals = per_key.get(k)
        kind = c.key_type[k]
        if kind == "counter":
            assert want["counter"][k] == (sum(vals) if vals else None) \
                or (vals is None and np.isnan(want["counter"][k]))
            continue
        if kind == "gauge":
            assert want["gauge"][k] == (vals[-1] if vals else None) \
                or (vals is None and np.isnan(want["gauge"][k]))
            continue
        assert want["count"][k] == (len(vals) if vals else 0)
        if not vals:
            continue
        assert want["min"][k] == min(vals) and want["max"][k] == max(vals)
        for j, q in enumerate(reference.QUANTILES):
            got = _interp_quantile([(v, 1.0) for v in vals], min(vals),
                                   max(vals), q)
            assert math.isclose(want["q"][k, j], got, rel_tol=1e-12)


def test_multiplicity_counts_each_row():
    for start, stop in ((0, 10), (3, 29), (7, 7), (5, 6)):
        m = reference.multiplicity(7, start, stop)
        want = np.bincount(np.arange(start, stop) % 7, minlength=7)
        assert list(m) == list(want)


def test_bf16_rounds_to_nearest_even():
    x = np.asarray([1.0, 1.00390625, 1.01171875, 3.14159, -2.5e-3, 0.0])
    got = reference.bf16(x)
    # 8 significant bits: 1 + 2^-8 ties to 1, 1 + 3·2^-8 ties to 1 + 2^-6
    assert list(got[:3]) == [1.0, 1.0, 1.015625]
    assert abs(got[3] - 3.14159) / 3.14159 < 2 ** -8
    assert got[5] == 0.0


def _rank_range(samples, v):
    """Brute force: the q range for which the midpoint interpolation
    over sorted unit samples reports v (min at 0, max at 1)."""
    xs = sorted(samples)
    n = len(xs)
    if v < xs[0]:
        return 0.0, 0.0
    if v > xs[-1]:
        return 1.0, 1.0
    at = [i for i, x in enumerate(xs) if x == v]
    if at:
        lo = 0.0 if at[0] == 0 else (at[0] + 0.5) / n
        hi = 1.0 if at[-1] == n - 1 else (at[-1] + 0.5) / n
        return lo, hi
    i = max(i for i, x in enumerate(xs) if x < v)
    f = (v - xs[i]) / (xs[i + 1] - xs[i])
    q = (i + 0.5 + f) / n
    return q, q


@pytest.mark.parametrize("q", reference.QUANTILES)
def test_ranks_are_the_brute_force_answer(q):
    rng = np.random.default_rng(3)
    # three keys: distinct values, ties, a single sample
    keys = [np.round(rng.lognormal(3, 0.5, 40), 1),
            np.repeat([1.0, 2.0, 2.0, 5.0], [3, 1, 4, 2]).astype(float),
            np.asarray([7.5])]
    vals = np.concatenate(keys)
    key = np.repeat(np.arange(3), [len(k) for k in keys])
    o = np.lexsort((vals, key))
    ranks = reference.Ranks(vals[o], np.ones(len(vals)), key[o], 3)
    for k, xs in enumerate(keys):
        probes = np.concatenate([xs, [xs.min() - 1, xs.max() + 1],
                                 rng.uniform(xs.min(), xs.max(), 20)])
        got = ranks.error(np.full(len(probes), k), probes, q)
        for v, e in zip(probes.tolist(), got.tolist()):
            lo, hi = _rank_range(xs.tolist(), v)
            want = (max(lo - q, 0.0) + max(q - hi, 0.0)) / math.sqrt(
                q * (1 - q))
            assert math.isclose(e, want, abs_tol=1e-12), (k, v)


def test_the_unmerged_digest_reads_no_rank_error():
    c = statsd.corpus(MIXED, 23)
    ref = statsd.reference(c)
    want = ref.interval(2, len(c.items) + 5)
    live = np.flatnonzero(want["count"] > 0)
    for j, q in enumerate(reference.QUANTILES):
        e = want["ranks"].error(live, want["q"][live, j], q)
        assert float(e.max()) < 1e-9
