"""Batched fixed-shape t-digest over torch tensors.

Each digest is a fixed row of C (mean, weight) cells, weight 0 marking an
empty cell. Centroids are sized by the arcsine scale function
k1(q) = δ/(2π)·asin(2q−1) (the reference's merging_digest.go
indexEstimate). A merge sorts a row's cells by mean, takes the cumulative
weight, assigns every centroid to the k-cell of its weight midpoint and
segment-reduces each cell; the bottom/top `exact_extremes` centroids pass
through unmerged. Quantiles interpolate between centroid-mass midpoints
with min/max endpoints (the reference's merging_digest.go Quantile); the
per-row sort, prefix sum and interpolation run in the digest kernel
(ops/cuda_digest.py).

Every sort is stable, matching jnp.argsort, so ties break by position
exactly as in the JAX package.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from veneur_tpu_torch.ops import cuda_digest
from veneur_tpu_torch.utils.numerics import twofloat_add, twofloat_merge

DEFAULT_COMPRESSION = 100.0
# 3 cells per k-unit: finer interior cells shrink the interpolation bias
# of hot keys' interior quantiles (the per-key p99 budget is 1%)
DEFAULT_CELLS_PER_K = 3
# bottom/top E centroids (by mean) are never merged by compression, so
# tail samples stay raw while they rank at the distribution's ends
DEFAULT_EXACT_EXTREMES = 64


def interior_capacity(compression: float = DEFAULT_COMPRESSION,
                      cells_per_k: int = DEFAULT_CELLS_PER_K) -> int:
    """k-cell slots between the protected extremes: k1 spans δ/2 k-units
    over q∈[0,1], so at most ceil(δ/2 · cells_per_k) + 1 occupied cells."""
    return int(math.ceil(compression / 2.0 * cells_per_k)) + 2


def centroid_capacity(compression: float = DEFAULT_COMPRESSION,
                      cells_per_k: int = DEFAULT_CELLS_PER_K,
                      exact_extremes: int = DEFAULT_EXACT_EXTREMES) -> int:
    """Centroid slots per digest: 2·E protected extremes around the
    k-cell interior, rounded up to a multiple of 8 (the JAX layout)."""
    c = interior_capacity(compression, cells_per_k) + 2 * exact_extremes
    return (c + 7) // 8 * 8


class TDigestTable(NamedTuple):
    """A batch of t-digests plus the exact scalar aggregates kept beside
    each histogram (count/sum/reciprocal sum as two-float pairs)."""
    mean: torch.Tensor      # f32[..., C]
    weight: torch.Tensor    # f32[..., C]; 0 = empty cell
    min: torch.Tensor       # f32[...]
    max: torch.Tensor       # f32[...]
    count_hi: torch.Tensor
    count_lo: torch.Tensor
    sum_hi: torch.Tensor
    sum_lo: torch.Tensor
    recip_hi: torch.Tensor
    recip_lo: torch.Tensor


def empty_table(key_shape, compression: float = DEFAULT_COMPRESSION,
                cells_per_k: int = DEFAULT_CELLS_PER_K,
                exact_extremes: int = DEFAULT_EXACT_EXTREMES,
                device="cpu") -> TDigestTable:
    """Empty digests of shape key_shape on `device` (min +inf, max -inf)."""
    key_shape = ((key_shape,) if isinstance(key_shape, int)
                 else tuple(key_shape))
    c = centroid_capacity(compression, cells_per_k, exact_extremes)
    f = dict(dtype=torch.float32, device=device)
    z = torch.zeros(key_shape, **f)
    return TDigestTable(
        mean=torch.zeros(key_shape + (c,), **f),
        weight=torch.zeros(key_shape + (c,), **f),
        min=torch.full(key_shape, math.inf, **f),
        max=torch.full(key_shape, -math.inf, **f),
        count_hi=z, count_lo=z.clone(), sum_hi=z.clone(), sum_lo=z.clone(),
        recip_hi=z.clone(), recip_lo=z.clone())


def _k1(q, compression):
    q = torch.clamp(q, 0.0, 1.0)
    return compression / (2.0 * math.pi) * torch.asin(2.0 * q - 1.0)


def _argsort_stable(x, dim=-1):
    return torch.sort(x, dim=dim, stable=True).indices


def cumsum_f32(x, dim):
    """Prefix sums of f32 values accumulated in f64, each rounded back to
    f32: what torch's CPU kernel does for f32, made the same on the card
    (whose f32 scan accumulates in f32), so both devices assign centroids
    to the same cells."""
    return torch.cumsum(x, dim=dim, dtype=torch.float64).to(torch.float32)


def compress_rows(mean, weight, *, compression: float = DEFAULT_COMPRESSION,
                  cells_per_k: int = DEFAULT_CELLS_PER_K,
                  out_c: int | None = None,
                  exact_extremes: int = DEFAULT_EXACT_EXTREMES):
    """Compress each row of (mean, weight) cells to out_c centroids: the
    bottom/top `exact_extremes` occupied cells pass through unmerged,
    everything between is k-cell bucketed and segment-reduced. Rows need
    not be sorted. Returns (mean', weight') of shape [..., out_c] with
    occupied cells in ascending-mean order at their cell index."""
    if out_c is None:
        out_c = centroid_capacity(compression, cells_per_k, exact_extremes)
    interior = out_c - 2 * exact_extremes
    if interior < 8:
        raise ValueError(f"out_c={out_c} leaves no k-cell interior around "
                         f"2x{exact_extremes} protected extremes")
    lead = tuple(mean.shape[:-1])
    m_in = mean.reshape(-1, mean.shape[-1])
    w_in = weight.reshape(-1, weight.shape[-1])
    n, m_len = m_in.shape
    dev = m_in.device
    f32 = torch.float32

    occupied = w_in > 0
    order = _argsort_stable(torch.where(occupied, m_in, math.inf), dim=1)
    m = m_in.gather(1, order)
    w = torch.where(occupied.gather(1, order), w_in.gather(1, order), 0.0)

    tot = w.sum(dim=1, keepdim=True)
    cum = cumsum_f32(w, 1)
    q_mid = (cum - 0.5 * w) / torch.clamp(tot, min=1e-30)
    k0 = -compression / 4.0
    cell = torch.floor((_k1(q_mid, compression) - k0)
                       * cells_per_k).to(torch.int32)
    cell = torch.clamp(cell, 0, interior - 1) + exact_extremes
    if exact_extremes > 0:
        # protected extremes go to dedicated end columns: bottom rank r
        # -> column r, top rank r' -> column out_c-1-r'; columns stay
        # non-decreasing along the sorted row
        occ32 = (w > 0).to(torch.int32)
        rnk = torch.cumsum(occ32, dim=1, dtype=torch.int32) - 1
        r_top = occ32.sum(dim=1, keepdim=True, dtype=torch.int32) - 1 - rnk
        cell = torch.where(rnk < exact_extremes, rnk,
                           torch.where(r_top < exact_extremes,
                                       out_c - 1 - r_top, cell))
    cell = torch.where(w > 0, cell, out_c)

    # per-(row, cell) sums: scatter each run's trailing cumulative at a
    # unique index, forward-fill empty cells with a running max, difference
    cum_wm = cumsum_f32(w * m, 1)
    ones = torch.ones((n, 1), dtype=torch.bool, device=dev)
    is_last = torch.cat([cell[:, :-1] != cell[:, 1:], ones], dim=1)
    rows = torch.arange(n, device=dev, dtype=torch.int64)[:, None]
    sentinel = n * out_c
    flat = torch.where(
        is_last & (cell < out_c),
        rows * out_c + torch.clamp(cell, max=out_c - 1).to(torch.int64),
        sentinel).reshape(-1)

    def scatter_at_run_ends(vals, reduce=None):
        # in-bounds indices are unique (one per run end); the sentinel
        # slot collects every dropped entry and is sliced off
        buf = torch.zeros(sentinel + 1, dtype=f32, device=dev)
        if reduce is None:
            buf.scatter_(0, flat, vals.reshape(-1))
        else:
            buf.scatter_reduce_(0, flat, vals.reshape(-1), reduce)
        return buf[:sentinel].reshape(n, out_c)

    end_w = scatter_at_run_ends(cum, "amax")
    end_wm = scatter_at_run_ends(cum_wm)
    fill_w = torch.cummax(end_w, dim=1).values
    has = end_w > 0
    end_wm = torch.where(has, end_wm, 0.0)
    col = torch.arange(out_c, dtype=torch.int64, device=dev)[None, :]
    idx = torch.cummax(torch.where(has, col, 0), dim=1).values
    fill_wm = end_wm.gather(1, idx)
    zcol = torch.zeros((n, 1), dtype=f32, device=dev)
    w_out = fill_w - torch.cat([zcol, fill_w[:, :-1]], dim=1)
    wm_out = fill_wm - torch.cat([zcol, fill_wm[:, :-1]], dim=1)
    # single-entry runs bypass the cumulative difference, which would
    # cost f32 ulps of the row total on exactly the protected extremes
    is_first = torch.cat([ones, cell[:, 1:] != cell[:, :-1]], dim=1)
    single = is_first & is_last
    w_single = scatter_at_run_ends(torch.where(single, w, 0.0))
    m_single = scatter_at_run_ends(torch.where(single, m, 0.0))
    w_out = torch.where(w_single > 0, w_single, w_out)
    m_out = torch.where(
        w_single > 0, m_single,
        torch.where(w_out > 0, wm_out / torch.clamp(w_out, min=1e-30), 0.0))
    return m_out.reshape(lead + (out_c,)), w_out.reshape(lead + (out_c,))


def merge_tables(a: TDigestTable, b: TDigestTable, *,
                 compression: float = DEFAULT_COMPRESSION,
                 cells_per_k: int = DEFAULT_CELLS_PER_K,
                 exact_extremes: int = DEFAULT_EXACT_EXTREMES
                 ) -> TDigestTable:
    """Key-wise merge of two digest tables (the reference's
    samplers.go:726 Histo.Merge): both rows' cells compressed together,
    so the union's bottom/top `exact_extremes` centroids pass through
    unmerged; the scalar aggregates merge as two-float pairs."""
    m2, w2 = compress_rows(torch.cat([a.mean, b.mean], dim=-1),
                           torch.cat([a.weight, b.weight], dim=-1),
                           compression=compression, cells_per_k=cells_per_k,
                           out_c=a.mean.shape[-1],
                           exact_extremes=exact_extremes)
    ch, cl = twofloat_merge(a.count_hi, a.count_lo, b.count_hi, b.count_lo)
    sh, sl = twofloat_merge(a.sum_hi, a.sum_lo, b.sum_hi, b.sum_lo)
    rh, rl = twofloat_merge(a.recip_hi, a.recip_lo, b.recip_hi, b.recip_lo)
    return TDigestTable(
        mean=m2, weight=w2, min=torch.minimum(a.min, b.min),
        max=torch.maximum(a.max, b.max), count_hi=ch, count_lo=cl,
        sum_hi=sh, sum_lo=sl, recip_hi=rh, recip_lo=rl)


def _interp(x, xp, fp):
    """jnp.interp over a batch of rows: x [..., Q], xp/fp [..., N] with xp
    non-decreasing; constant extrapolation at both ends."""
    n = xp.shape[-1]
    i = torch.clamp(torch.searchsorted(xp.contiguous(), x.contiguous(),
                                       right=True), 1, n - 1)
    x0, x1 = xp.gather(-1, i - 1), xp.gather(-1, i)
    f0, f1 = fp.gather(-1, i - 1), fp.gather(-1, i)
    dx = x1 - x0
    eps = float(np.spacing(np.finfo(np.float32).eps))
    dx0 = torch.abs(dx) <= eps
    f = torch.where(dx0, f0,
                    f0 + ((x - x0) / torch.where(dx0, 1.0, dx)) * (f1 - f0))
    f = torch.where(x < xp[..., :1], fp[..., :1], f)
    return torch.where(x > xp[..., -1:], fp[..., -1:], f)


def _quantiles_one(mean, weight, mn, mx, qs):
    """Quantiles of digests [..., C] at qs [Q] by midpoint interpolation
    through jnp.interp semantics (the JAX package's XLA path). Empty
    digests give NaN."""
    order = _argsort_stable(torch.where(weight > 0, mean, math.inf))
    m = mean.gather(-1, order)
    wo = weight.gather(-1, order)
    w = torch.where(wo > 0, wo, 0.0)
    tot = w.sum(dim=-1, keepdim=True)
    mid = cumsum_f32(w, -1) - 0.5 * w
    xs = torch.where(w > 0, mid, tot)
    ys = torch.where(w > 0, m, mx[..., None])
    zero = torch.zeros_like(tot)
    xs = torch.cat([zero, xs, tot], dim=-1)
    ys = torch.cat([mn[..., None], ys, mx[..., None]], dim=-1)
    t = qs.to(torch.float32) * tot
    out = _interp(t, xs, ys)
    return torch.where(tot > 0, out, math.nan)


def quantiles(table: TDigestTable, qs) -> torch.Tensor:
    """Quantiles for every digest: f32[..., Q], through the digest kernel
    (its plain version for CPU tensors)."""
    qs = torch.as_tensor(qs, dtype=torch.float32, device=table.mean.device)
    lead = tuple(table.mean.shape[:-1])
    c = table.mean.shape[-1]
    flat = cuda_digest.quantiles_rows(
        table.mean.reshape(-1, c).contiguous(),
        table.weight.reshape(-1, c).contiguous(),
        table.min.reshape(-1).contiguous(),
        table.max.reshape(-1).contiguous(), qs)
    return flat.reshape(lead + (qs.shape[0],))


def cdf(table: TDigestTable, xs) -> torch.Tensor:
    """The CDF of every digest at the points xs: f32[..., len(xs)], by
    interpolation between centroid means (the x axis, with min and max as
    endpoints) and their mass midpoints over the total. Empty digests
    give NaN."""
    mean, weight = table.mean, table.weight
    xs_q = torch.as_tensor(xs, dtype=torch.float32, device=mean.device)
    order = _argsort_stable(torch.where(weight > 0, mean, math.inf))
    m = mean.gather(-1, order)
    wo = weight.gather(-1, order)
    w = torch.where(wo > 0, wo, 0.0)
    tot = w.sum(dim=-1, keepdim=True)
    mid = cumsum_f32(w, -1) - 0.5 * w
    mn, mx = table.min[..., None], table.max[..., None]
    px = torch.cat([mn, torch.where(w > 0, m, mx), mx], dim=-1)
    py = torch.cat([torch.zeros_like(tot), torch.where(w > 0, mid, tot),
                    tot], dim=-1)
    x = xs_q.expand(tuple(mean.shape[:-1]) + (xs_q.shape[0],))
    out = _interp(x, px, py) / torch.clamp(tot, min=1e-30)
    return torch.where(tot > 0, out, math.nan)


def add_batch_single(table: TDigestTable, values, weights, *,
                     compression: float = DEFAULT_COMPRESSION,
                     cells_per_k: int = DEFAULT_CELLS_PER_K,
                     exact_extremes: int = DEFAULT_EXACT_EXTREMES
                     ) -> TDigestTable:
    """Add a batch of samples (weight 0 = an empty slot) to ONE digest, a
    table with key shape (): the cells and the batch are compressed
    together, and the scalar aggregates take the batch's live samples."""
    dev = table.mean.device
    values = torch.as_tensor(values, dtype=torch.float32, device=dev)
    weights = torch.as_tensor(weights, dtype=torch.float32, device=dev)
    m = torch.cat([table.mean, values])
    w = torch.cat([table.weight, weights])
    m2, w2 = compress_rows(m[None, :], w[None, :], compression=compression,
                           cells_per_k=cells_per_k,
                           out_c=table.mean.shape[-1],
                           exact_extremes=exact_extremes)
    live = weights > 0
    ch, cl = twofloat_add(table.count_hi, table.count_lo, weights.sum())
    sh, sl = twofloat_add(table.sum_hi, table.sum_lo,
                          torch.where(live, weights * values, 0.0).sum())
    rh, rl = twofloat_add(
        table.recip_hi, table.recip_lo,
        torch.where(live, weights / torch.where(live, values, 1.0),
                    0.0).sum())
    return TDigestTable(
        mean=m2[0], weight=w2[0],
        min=torch.minimum(table.min,
                          torch.where(live, values, math.inf).min()),
        max=torch.maximum(table.max,
                          torch.where(live, values, -math.inf).max()),
        count_hi=ch, count_lo=cl, sum_hi=sh, sum_lo=sl,
        recip_hi=rh, recip_lo=rl)
