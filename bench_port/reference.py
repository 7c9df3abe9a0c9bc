"""What every plain reference shares: the replay's multiplicities, the
quantiles of a digest that merged nothing, the rank of a reported
percentile among the exact samples, and the precision step down that
the control takes. NumPy only; the reference of each kind of traffic
(`kinds/<kind>.py`) builds on these.

An interval is a contiguous stretch of the replayed item stream; each
corpus row appears in it a whole number of times, so every answer is
computed once per corpus row with that multiplicity.
"""

from __future__ import annotations

import numpy as np

QUANTILES = (0.5, 0.9, 0.99)
SUFFIX = {".count": "count", ".min": "min", ".max": "max",
          ".50percentile": "p50", ".90percentile": "p90",
          ".99percentile": "p99"}
PERCENTILES = ("p50", "p90", "p99")


def bf16(x) -> np.ndarray:
    """Round to bfloat16 (nearest, ties to even), returned as float64."""
    f = np.asarray(x, np.float32)
    bits = f.view(np.uint32).astype(np.uint64)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    out = bits.astype(np.uint32).view(np.float32).astype(np.float64)
    return np.where(np.isfinite(f), out, f.astype(np.float64))


def multiplicity(n_rows: int, start: int, stop: int) -> np.ndarray:
    """How often each of `n_rows` corpus rows appears in the replayed
    stream's positions [start, stop)."""
    length = stop - start
    m = np.full(n_rows, length // n_rows, np.int64)
    rem = length % n_rows
    first = start % n_rows
    idx = (first + np.arange(rem)) % n_rows
    m[idx] += 1
    return m


def digest_quantiles(vals, w, mult, key, n_keys, mn, mx, qs):
    """Per key, the quantiles that a digest holding every row unmerged
    reports: row i is `mult[i]` centroids of weight `w[i]` at `vals[i]`
    (a raw sample is a centroid of weight 1), and a quantile is the
    interpolation through the centroids' mass midpoints, with the key's
    min and max at its two ends (ops/tdigest.py's convention). Rows are
    sorted by key, then value. Returns (total weight per key,
    float64[n_keys, len(qs)])."""
    W = w * mult
    keep = W > 0
    vals, w, W, key = vals[keep], w[keep], W[keep], key[keep]
    tot = np.bincount(key, weights=W, minlength=n_keys)
    cum = np.cumsum(W)
    # a row's first and last centroid midpoints (equal when mult is 1)
    xs = np.empty(2 * len(W))
    xs[0::2] = cum - W + 0.5 * w
    xs[1::2] = cum - 0.5 * w
    ys = np.repeat(vals, 2)
    kp = np.repeat(key, 2)
    start = np.concatenate([[0.0], np.cumsum(tot)[:-1]])
    out = np.full((n_keys, len(qs)), np.nan)
    live = np.flatnonzero(tot > 0)
    s, t_k = start[live], tot[live]
    for j, q in enumerate(qs):
        t = s + q * t_k
        hi = np.searchsorted(xs, t, side="right")
        lo = hi - 1
        lo_ok = (lo >= 0) & (kp[np.maximum(lo, 0)] == live)
        hi_ok = (hi < len(xs)) & (kp[np.minimum(hi, len(xs) - 1)] == live)
        x0 = np.where(lo_ok, xs[np.maximum(lo, 0)], s)
        y0 = np.where(lo_ok, ys[np.maximum(lo, 0)], mn[live])
        x1 = np.where(hi_ok, xs[np.minimum(hi, len(xs) - 1)], s + t_k)
        y1 = np.where(hi_ok, ys[np.minimum(hi, len(xs) - 1)], mx[live])
        v = y0 + (t - x0) * (y1 - y0) / np.maximum(x1 - x0, 1e-30)
        out[live, j] = np.where(q < 1.0, v, mx[live])
    return tot, out


class Ranks:
    """Where a value falls among a key's exact samples, in quantile
    units: the inverse of the midpoint interpolation above. Samples are
    rows sorted by key, then value, each of weight `W` (unit samples
    repeated). Equal values of a key form one group, which the midpoint
    interpolation reports for every q from its first sample's mass
    midpoint to its last's; between two groups the rank is linear in the
    value. A digest that merged nothing reports, for each q, a value
    whose rank range holds q."""

    def __init__(self, vals, W, key, n_keys):
        keep = W > 0
        vals, W, key = vals[keep], W[keep].astype(np.float64), key[keep]
        head = np.ones(len(vals), bool)
        head[1:] = (key[1:] != key[:-1]) | (vals[1:] != vals[:-1])
        at = np.flatnonzero(head)
        self.gk, self.gx = key[at], vals[at]
        gw = np.add.reduceat(W, at) if len(at) else np.zeros(0)
        tot = np.bincount(self.gk, weights=gw, minlength=n_keys)
        cum = np.cumsum(gw)
        first = np.concatenate([[0], np.cumsum(np.bincount(
            self.gk, minlength=n_keys))[:-1]])
        before = cum - gw - np.concatenate([[0.0], cum])[first[self.gk]]
        t = tot[self.gk]
        self.lo = (before + 0.5) / t
        self.hi = (before + gw - 0.5) / t
        # the key's min and max sit at q = 0 and 1: its first and last
        # groups are reported below and above their samples' midpoints
        last = np.ones(len(at), bool)
        last[:-1] = self.gk[1:] != self.gk[:-1]
        self.lo[before == 0] = 0.0
        self.hi[last] = 1.0
        # one integer order over (key, value): a value's index among all
        # the groups' distinct values
        self.u = np.unique(self.gx)
        self.code = self.gk * len(self.u) + np.searchsorted(self.u, self.gx)

    def error(self, key, value, q: float) -> np.ndarray:
        """|rank − q| / sqrt(q(1 − q)) of each (key, value): 0 where the
        value's rank range holds q; a value outside its key's samples
        ranks 0 or 1. NaN values read inf."""
        key = np.asarray(key, np.int64)
        v = np.asarray(value, np.float64)
        nan = np.isnan(v)
        v = np.where(nan, 0.0, v)
        r = np.searchsorted(self.u, v, side="right") - 1
        p = np.searchsorted(self.code, key * len(self.u) + r,
                            side="right") - 1
        pc = np.maximum(p, 0)
        below = (p < 0) | (self.gk[pc] != key)        # under the key's min
        nxt = np.minimum(pc + 1, len(self.gk) - 1)
        above = ~below & ((pc + 1 >= len(self.gk)) | (self.gk[nxt] != key))
        exact = ~below & (self.gx[pc] == v)
        with np.errstate(invalid="ignore", divide="ignore"):
            frac = (v - self.gx[pc]) / (self.gx[nxt] - self.gx[pc])
            mid = self.hi[pc] + frac * (self.lo[nxt] - self.hi[pc])
        lo = np.where(exact, self.lo[pc], mid)
        hi = np.where(exact, self.hi[pc], mid)
        lo = np.where(below, 0.0, np.where(above & ~exact, 1.0, lo))
        hi = np.where(below, 0.0, np.where(above & ~exact, 1.0, hi))
        gap = np.maximum(lo - q, 0.0) + np.maximum(q - hi, 0.0)
        return np.where(nan, np.inf, gap / np.sqrt(q * (1.0 - q)))


def scalar_gap(got, want) -> float:
    """The largest |flushed − reference| over the keys the reference
    holds (NaN elsewhere); a missing row counts in full, a stray one too."""
    have = ~np.isnan(want)
    if (~np.isnan(got) & ~have).any():
        return float("inf")
    d = np.abs(np.nan_to_num(got[have], nan=np.inf) - want[have])
    return float(np.max(d, initial=0.0))


def quantile_errs(got, want, live, exact_max, ranks) -> dict:
    """The percentiles' two numbers. `exact_q_err`: the worst relative
    error of any percentile over the keys of at most `exact_max`
    samples, whose digest keeps every sample as its own cell, so the
    flush must report the unmerged digest's quantile up to f32
    arithmetic. `rank_err`: over every key, the worst distance of a
    reported percentile's rank among the exact samples from its q, in
    units of sqrt(q(1 − q)), the shape of the k1 scale's centroid
    widths; past `exact_max` samples compaction merges the interior
    into centroids of about 2π·sqrt(q(1 − q))/(3·100) of the mass (3
    cells a k-unit at compression 100), so a sound merge reads a few
    hundredths, and one that lumps samples of different ranks together
    reads more."""
    small = live & (want["count"] <= exact_max)
    keys = np.flatnonzero(live)
    worst = rank = 0.0
    for j, (name, q) in enumerate(zip(PERCENTILES, QUANTILES)):
        with np.errstate(invalid="ignore", divide="ignore"):
            r = np.abs(got[name] - want["q"][:, j]) / np.maximum(
                np.abs(want["q"][:, j]), 1e-30)
        r[np.isnan(got[name])] = np.inf
        worst = max(worst, float(np.max(r[small], initial=0.0)))
        e = ranks.error(keys, got[name][keys], q)
        rank = max(rank, float(np.max(e, initial=0.0)))
    return dict(exact_q_err=worst, rank_err=rank)
