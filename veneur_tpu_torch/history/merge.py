"""Windowed-merge program for range queries over the history ring.

One call answers a whole batch of range queries: for every requested
STEP (a [t0, t1] slice of the lookback) the host selects the minimal
cover set of ring columns (writer.py plan_range) and ships a {0,1}
selection mask per step; the device folds the selected columns per
kind --

    counters / counts / sums   compensated two-float fold, ascending
                               column order (deterministic)
    gauges / status            last-writer-wins via a recency-rank
                               argmax over finite selected columns
    sets                       masked 6-bit register max (kernel K3,
                               ops/cuda_history.py)
    histos                     selected centroids re-compressed through
                               the ring's own k-cell compression, then
                               the digest-quantile kernel (K2)

-- and returns one packed f32 tensor, the flush program's wire
(aggregation/step.py _pack_outputs / unpack_flush). `query_combined`
evaluates an instant-query batch and a range batch in one call.

Byte-exactness contract: a range answer equals re-merging the archived
flush frames, because the replay (writer.record_frame) feeds the frames
through the same write/roll code into a fresh ring and asks the same
merge: every float op runs in the same order on the same bits.
"""

from __future__ import annotations

import numpy as np
import torch

from veneur_tpu_torch.aggregation.step import (_pack_outputs, _take,
                                               flush_live_in_packed)
from veneur_tpu_torch.history.device import HistoryState
from veneur_tpu_torch.history.spec import HistorySpec
from veneur_tpu_torch.ops import cuda_history
from veneur_tpu_torch.ops import hll as hll_ops
from veneur_tpu_torch.ops import tdigest as td
from veneur_tpu_torch.utils.numerics import twofloat_merge

# A range batch pads its step count to a power of two (min 4, cap 32),
# the same bucketing as the query tier's quantile padding.
MAX_STEPS = 32


def merge_windows(rows, sel, *, precision: int, idx=None):
    """Masked window merge: i32[R, W, nw] packed rows, f32[S, W] masks,
    optional i32[N] row index -> i32[N, S, nw], through kernel K3 (its
    plain version on the CPU), which reads the indexed rows in place."""
    return cuda_history.merge_windows_packed(rows, sel, precision=precision,
                                             idx=idx)


def _fold_pair(hi_rows, lo_rows, sel):
    """Masked compensated fold of two-float pairs over the column axis:
    hi/lo f32[N, W], sel f32[S, W] -> (hi, lo) f32[N, S], one column at a
    time in ascending order, which is what makes the result byte-equal
    to the JAX package's fold and to a replay of the frames."""
    n = hi_rows.shape[0]
    s, w = sel.shape
    hi = torch.zeros((n, s), dtype=torch.float32, device=hi_rows.device)
    lo = torch.zeros_like(hi)
    for i in range(w):
        m = sel[:, i][None, :]
        hi, lo = twofloat_merge(hi, lo, hi_rows[:, i, None] * m,
                                lo_rows[:, i, None] * m)
    return hi, lo


def _lww(rows, sel, rank):
    """Last-writer-wins over selected finite columns: rows f32[N, W],
    sel f32[S, W], rank f32[W] (larger = newer) -> f32[N, S]; NaN where
    no selected column holds a value."""
    fin = torch.isfinite(rows)                                 # [N, W]
    eff = torch.where(fin[:, None, :] & (sel[None, :, :] > 0.0),
                      rank[None, None, :], -torch.inf)         # [N, S, W]
    best, i = torch.max(eff, dim=2)
    v = torch.gather(rows, 1, i)
    return torch.where(best == -torch.inf, torch.nan, v)


def range_merge_core(hist: HistoryState, qs, cidx, gidx, stidx, setidx,
                     hidx, sel, rank, *, hspec: HistorySpec) -> dict:
    s = sel.shape[0]
    chi, clo = _fold_pair(_take(hist.counter_hi, cidx),
                          _take(hist.counter_lo, cidx), sel)
    gauge = _lww(_take(hist.gauge, gidx), sel, rank)
    status = _lww(_take(hist.status, stidx), sel, rank)

    merged = merge_windows(hist.hll, sel, precision=hspec.hll_precision,
                           idx=setidx)
    est = hll_ops.estimate_packed_rows(merged,
                                       precision=hspec.hll_precision)

    mean = _take(hist.h_mean, hidx)          # [bh, W, C]
    weight = _take(hist.h_weight, hidx)
    hmin = _take(hist.h_min, hidx)           # [bh, W]
    hmax = _take(hist.h_max, hidx)
    bh, w, c = mean.shape
    cm_steps, cw_steps, mn_steps, mx_steps = [], [], [], []
    for i in range(s):
        m = sel[i]                           # [W]
        wm = weight * m[None, :, None]
        cm, cw = td.compress_rows(
            mean.reshape(bh, w * c), wm.reshape(bh, w * c),
            compression=hspec.compression, cells_per_k=hspec.cells_per_k,
            out_c=hspec.centroids, exact_extremes=hspec.exact_extremes)
        on = m[None, :] > 0
        mn_steps.append(torch.amin(torch.where(on, hmin, torch.inf), dim=1))
        mx_steps.append(torch.amax(torch.where(on, hmax, -torch.inf), dim=1))
        cm_steps.append(cm)
        cw_steps.append(cw)
    # every step's digests in one kernel launch: rows are independent, so
    # the [bh, S] rows give the bytes the per-step calls would
    hmn, hmx = torch.stack(mn_steps, dim=1), torch.stack(mx_steps, dim=1)
    zeros = torch.zeros_like(hmn)
    table = td.TDigestTable(mean=torch.stack(cm_steps, dim=1),
                            weight=torch.stack(cw_steps, dim=1),
                            min=hmn, max=hmx, count_hi=zeros, count_lo=zeros,
                            sum_hi=zeros, sum_lo=zeros, recip_hi=zeros,
                            recip_lo=zeros)
    hct_hi, hct_lo = _fold_pair(_take(hist.h_count_hi, hidx),
                                _take(hist.h_count_lo, hidx), sel)
    hs_hi, hs_lo = _fold_pair(_take(hist.h_sum_hi, hidx),
                              _take(hist.h_sum_lo, hidx), sel)
    return {
        "r_counter_hi": chi, "r_counter_lo": clo,
        "r_gauge": gauge, "r_status": status,
        "r_set_estimate": est,
        "r_histo_quantiles": td.quantiles(table, qs),   # [bh, S, Q]
        "r_histo_min": hmn,
        "r_histo_max": hmx,
        "r_histo_count_hi": hct_hi, "r_histo_count_lo": hct_lo,
        "r_histo_sum_hi": hs_hi, "r_histo_sum_lo": hs_lo,
    }


def range_in_packed(hist: HistoryState, hflat: torch.Tensor, *,
                    hspec: HistorySpec, n_q: int, n_steps: int,
                    buckets: tuple) -> torch.Tensor:
    """The range program on the packed wire: hflat is ONE i32 tensor on
    the ring's device, [qs-bits | 5 row buckets | sel-bits | rank-bits]
    (pack_range_inputs builds it); the result is one packed f32 tensor."""
    w = hspec.total_cols
    qs = hflat[:n_q].view(torch.float32)
    idx, off = [], n_q
    for n in buckets:
        idx.append(hflat[off:off + n])
        off += n
    sel = hflat[off:off + n_steps * w].view(torch.float32).reshape(
        n_steps, w)
    off += n_steps * w
    rank = hflat[off:off + w].view(torch.float32)
    out = range_merge_core(hist, qs, *idx, sel, rank, hspec=hspec)
    return _pack_outputs(out)


def query_combined(state, flat, hist, hflat, *, spec, n_q: int,
                   buckets: tuple, hspec: HistorySpec, hn_q: int,
                   hsteps: int, hbuckets: tuple):
    """An instant-query batch (the flush program) and a range batch in
    one call: (instant packed, range packed)."""
    inst = flush_live_in_packed(state, flat, spec=spec, n_q=n_q,
                                buckets=buckets)
    rng = range_in_packed(hist, hflat, hspec=hspec, n_q=hn_q,
                          n_steps=hsteps, buckets=hbuckets)
    return inst, rng


def pad_steps(n: int) -> int:
    p = 4
    while p < n:
        p <<= 1
    return min(p, MAX_STEPS)


def pad_rows(n: int, cap: int) -> int:
    p = 4
    while p < n:
        p <<= 1
    return min(p, max(cap, 1))


def pack_range_inputs(hspec: HistorySpec, need, sel, rank, union_qs):
    """Host side: the range batch's gather plan -> (hflat, n_q, n_steps,
    buckets, qcol). `need` is (counter, gauge, status, set, histo) row
    lists in batch-match order; `sel` f32[S, W] selection masks from
    writer.plan_range; `rank` f32[W] recency ranks; `union_qs` the
    batch's union quantile set. Steps and quantiles pad to powers of two;
    pad steps carry all-zero masks and render as empty."""
    w = hspec.total_cols
    qs = sorted(union_qs) or [0.5]
    n_q = 4
    while n_q < len(qs):
        n_q <<= 1
    qcol = {v: i for i, v in enumerate(qs)}
    qs_padded = np.asarray(qs + [0.5] * (n_q - len(qs)), np.float32)
    s_real = sel.shape[0]
    n_steps = pad_steps(s_real)
    if s_real > n_steps:
        raise ValueError("range step count exceeds MAX_STEPS")
    sel_p = np.zeros((n_steps, w), np.float32)
    sel_p[:s_real] = sel
    caps = tuple(hspec.rows_for(k) for k in range(5))
    buckets, idx_arrays = [], []
    for rows_list, cap in zip(need, caps):
        b = pad_rows(len(rows_list), cap)
        if len(rows_list) > b:
            raise ValueError("range gather exceeds history capacity")
        arr = np.zeros(b, np.int32)
        arr[:len(rows_list)] = rows_list
        buckets.append(b)
        idx_arrays.append(arr)
    flat = np.concatenate(
        [qs_padded.view(np.int32)]
        + [a.ravel() for a in idx_arrays]
        + [sel_p.ravel().view(np.int32),
           np.asarray(rank, np.float32).ravel().view(np.int32)])
    return flat, n_q, n_steps, tuple(buckets), qcol


def range_shapes(hspec: HistorySpec, buckets: tuple, n_steps: int,
                 n_q: int) -> dict:
    """unpack_flush shape table for the packed range output."""
    bc, bg, bst, bs, bh = buckets
    f32 = "float32"
    return {
        "r_counter_hi": ((bc, n_steps), f32),
        "r_counter_lo": ((bc, n_steps), f32),
        "r_gauge": ((bg, n_steps), f32),
        "r_status": ((bst, n_steps), f32),
        "r_set_estimate": ((bs, n_steps), f32),
        "r_histo_quantiles": ((bh, n_steps, n_q), f32),
        "r_histo_min": ((bh, n_steps), f32),
        "r_histo_max": ((bh, n_steps), f32),
        "r_histo_count_hi": ((bh, n_steps), f32),
        "r_histo_count_lo": ((bh, n_steps), f32),
        "r_histo_sum_hi": ((bh, n_steps), f32),
        "r_histo_sum_lo": ((bh, n_steps), f32),
    }
