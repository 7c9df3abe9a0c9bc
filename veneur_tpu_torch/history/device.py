"""Device-resident history ring: the state container and the write,
decimation-merge and column-read programs, on torch tensors.

The JAX package donates the ring through every write program so that
exactly one HistoryState is resident; here the programs update the
ring's tensors IN PLACE to the same effect, so `HistorySpec.hbm_bytes()`
is the whole device footprint of the ring. Callers (history/writer.py)
serialise every dispatch that touches the ring under one lock. Every
program runs on the ring device's current stream, so a read enqueued
before a later write sees the ring as it was when it was enqueued.

Column, source and destination indices are host ints, and the per-kind
destination rows arrive as host arrays: nothing is read back from the
device. Rows out of range (the writer pads with SENTINEL = 1 << 30) are
dropped on the host before the scatter, which is the JAX scatter's
mode="drop": torch's index_put_ would neither drop nor wrap them.

Absence is encoded in the values, not in side masks; each kind's neutral
element is also its merge identity:

    counter   (0, 0)        additive identity of the two-float pair
    gauge     NaN           last-writer-wins skips NaN
    status    NaN           same
    hll       all-zero      register max identity
    digest    weight 0      compress_rows ignores empty cells
    min/max   +inf / -inf   order identities
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from veneur_tpu_torch.history.spec import HistorySpec
from veneur_tpu_torch.ops import hll as hll_ops
from veneur_tpu_torch.ops import tdigest as td
from veneur_tpu_torch.utils.numerics import twofloat_merge


class HistoryState(NamedTuple):
    """One ring per kind; axis 1 is the flat column index
    tier * windows + (slot % windows) (see spec.py)."""
    counter_hi: torch.Tensor   # f32[Rc, W]
    counter_lo: torch.Tensor   # f32[Rc, W]
    gauge: torch.Tensor        # f32[Rg, W]
    status: torch.Tensor       # f32[Rst, W]
    hll: torch.Tensor          # i32[Rs, W, hll_words]
    h_mean: torch.Tensor       # f32[Rh, W, C]
    h_weight: torch.Tensor     # f32[Rh, W, C]
    h_min: torch.Tensor        # f32[Rh, W]
    h_max: torch.Tensor        # f32[Rh, W]
    h_count_hi: torch.Tensor   # f32[Rh, W]
    h_count_lo: torch.Tensor   # f32[Rh, W]
    h_sum_hi: torch.Tensor     # f32[Rh, W]
    h_sum_lo: torch.Tensor     # f32[Rh, W]


HISTORY_FIELDS = HistoryState._fields

# write_window's value-dict contract (all in table get_meta order, padded
# to the dest buckets): h_mean/h_weight arrive at the flush table's cell
# count and are compressed to hspec.centroids in the write.
WRITE_KEYS = ("counter_hi", "counter_lo", "gauge", "status", "hll",
              "h_mean", "h_weight", "h_min", "h_max",
              "h_count_hi", "h_count_lo", "h_sum_hi", "h_sum_lo")

# the ring-kind index (0 counter .. 4 histogram) each field is keyed by
FIELD_KIND = {"counter_hi": 0, "counter_lo": 0, "gauge": 1, "status": 2,
              "hll": 3, "h_mean": 4, "h_weight": 4, "h_min": 4, "h_max": 4,
              "h_count_hi": 4, "h_count_lo": 4, "h_sum_hi": 4,
              "h_sum_lo": 4}

_NEUTRAL = {
    "counter_hi": 0.0, "counter_lo": 0.0,
    "gauge": math.nan, "status": math.nan,
    "h_min": math.inf, "h_max": -math.inf,
    "h_count_hi": 0.0, "h_count_lo": 0.0,
    "h_sum_hi": 0.0, "h_sum_lo": 0.0,
}


def empty_history(hspec: HistorySpec, device) -> HistoryState:
    w = hspec.total_cols
    f = dict(dtype=torch.float32, device=device)
    out = {}
    for name in HISTORY_FIELDS:
        rows = hspec.rows_for(FIELD_KIND[name])
        if name == "hll":
            out[name] = torch.zeros((rows, w, hspec.hll_words),
                                    dtype=torch.int32, device=device)
        elif name in ("h_mean", "h_weight"):
            out[name] = torch.zeros((rows, w, hspec.centroids), **f)
        else:
            out[name] = torch.full((rows, w), _NEUTRAL[name], **f)
    return HistoryState(**out)


def _clear_column(hist: HistoryState, col: int) -> HistoryState:
    """Neutralise ring column `col` for every kind: the ring-wraparound
    eviction of the window being overwritten."""
    for name in HISTORY_FIELDS:
        a = getattr(hist, name)
        if a.dim() == 2:
            a[:, col] = _NEUTRAL[name]
        else:
            a[:, col, :] = 0
    return hist


def _kept_rows(dests, hspec: HistorySpec, device):
    """Per kind, (positions, rows) long tensors on `device` of the
    destinations inside the ring (out-of-range rows drop), built on the
    host and shipped in one copy; None for a kind with nothing to write."""
    parts, spans = [], []
    for k, d in enumerate(dests):
        d = np.asarray(d, np.int64).ravel()
        pos = np.nonzero((d >= 0) & (d < hspec.rows_for(k)))[0]
        spans.append(pos.size)
        parts += [pos, d[pos]]
    flat = torch.from_numpy(np.concatenate(parts)).to(device)
    out, off = [], 0
    for n in spans:
        out.append(None if n == 0 else
                   (flat[off:off + n], flat[off + n:off + 2 * n]))
        off += 2 * n
    return out


def write_window_core(hist: HistoryState, vals: dict, dests, col: int, *,
                      hspec: HistorySpec, clear: bool) -> HistoryState:
    """Scatter one flush interval's per-key values into ring column `col`
    (in place). `vals` holds WRITE_KEYS tensors on the ring's device in
    get_meta order, `dests` the (counter, gauge, status, set, histo) ring
    rows as host int arrays of the same lengths, padded with an
    out-of-range sentinel; `clear` neutralises the column first (set by
    the FIRST block of a tiled flush only). The fused flush
    (aggregation/step.py flush_live_hist_packed) and the replay path
    (`write_window`) both run this function, so they store the same
    bytes."""
    if clear:
        _clear_column(hist, col)
    kept = _kept_rows(dests, hspec, hist.counter_hi.device)
    for name in HISTORY_FIELDS:
        if name == "h_weight":
            continue
        sel = kept[FIELD_KIND[name]]
        if sel is None:
            continue
        pos, rows = sel
        if name == "h_mean":
            cm, cw = td.compress_rows(
                vals["h_mean"][pos], vals["h_weight"][pos],
                compression=hspec.compression,
                cells_per_k=hspec.cells_per_k, out_c=hspec.centroids,
                exact_extremes=hspec.exact_extremes)
            hist.h_mean[rows, col] = cm
            hist.h_weight[rows, col] = cw
        else:
            getattr(hist, name)[rows, col] = vals[name][pos]
    return hist


write_window = write_window_core


def wipe_rows(hist: HistoryState, resets, *,
              hspec: HistorySpec) -> HistoryState:
    """Neutralise whole ROWS across every column (in place): run when the
    writer reassigns an evicted key's row to a new key, so the new key
    never inherits the old key's windows. `resets` mirrors `dests`: per
    kind, host row arrays; out-of-range rows drop."""
    dev = hist.counter_hi.device
    idx = []
    for k, r in enumerate(resets):
        r = np.asarray(r, np.int64).ravel()
        r = r[(r >= 0) & (r < hspec.rows_for(k))]
        idx.append(torch.from_numpy(r).to(dev) if r.size else None)
    for name in HISTORY_FIELDS:
        rows = idx[FIELD_KIND[name]]
        if rows is not None:
            getattr(hist, name).index_fill_(0, rows, _NEUTRAL.get(name, 0))
    return hist


def roll_tiers(hist: HistoryState, src0: int, src1: int, dst: int, *,
               hspec: HistorySpec) -> HistoryState:
    """Decimation merge (in place): fold columns src0 (older) and src1
    (newer) of tier t-1 into column dst of tier t, for all rows. dst is
    never src0 or src1, so the in-place write reads nothing it wrote.

    Counters and histo count/sum fold with compensated two-float merges;
    gauges/status are last-writer-wins (src1 wins when not NaN); HLL
    takes the register max (exact union); digest centroids concatenate
    and re-compress through the same k-cell compression as the write."""
    h = hist
    chi, clo = twofloat_merge(h.counter_hi[:, src0], h.counter_lo[:, src0],
                              h.counter_hi[:, src1], h.counter_lo[:, src1])
    g0, g1 = h.gauge[:, src0], h.gauge[:, src1]
    gauge = torch.where(torch.isnan(g1), g0, g1)
    s0, s1 = h.status[:, src0], h.status[:, src1]
    status = torch.where(torch.isnan(s1), s0, s1)
    p = hspec.hll_precision
    regs = torch.maximum(
        hll_ops.unpack_registers(h.hll[:, src0], precision=p),
        hll_ops.unpack_registers(h.hll[:, src1], precision=p))
    words = hll_ops.pack_registers(regs, precision=p)
    cm, cw = td.compress_rows(
        torch.cat([h.h_mean[:, src0], h.h_mean[:, src1]], dim=-1),
        torch.cat([h.h_weight[:, src0], h.h_weight[:, src1]], dim=-1),
        compression=hspec.compression, cells_per_k=hspec.cells_per_k,
        out_c=hspec.centroids, exact_extremes=hspec.exact_extremes)
    hct_hi, hct_lo = twofloat_merge(
        h.h_count_hi[:, src0], h.h_count_lo[:, src0],
        h.h_count_hi[:, src1], h.h_count_lo[:, src1])
    hs_hi, hs_lo = twofloat_merge(
        h.h_sum_hi[:, src0], h.h_sum_lo[:, src0],
        h.h_sum_hi[:, src1], h.h_sum_lo[:, src1])
    hmin = torch.minimum(h.h_min[:, src0], h.h_min[:, src1])
    hmax = torch.maximum(h.h_max[:, src0], h.h_max[:, src1])
    for name, v in (("counter_hi", chi), ("counter_lo", clo),
                    ("gauge", gauge), ("status", status), ("hll", words),
                    ("h_mean", cm), ("h_weight", cw), ("h_min", hmin),
                    ("h_max", hmax), ("h_count_hi", hct_hi),
                    ("h_count_lo", hct_lo), ("h_sum_hi", hs_hi),
                    ("h_sum_lo", hs_lo)):
        getattr(hist, name)[:, dst] = v
    return hist


def _take(a, idx):
    """Row gather with clamped indices (jnp.take mode="clip")."""
    return a[torch.clamp(idx.long(), 0, a.shape[0] - 1)]


def read_column(hist: HistoryState, col: int, cidx, gidx, stidx, *,
                hspec: HistorySpec):
    """One ring column's counter/gauge/status values for a row subset
    (the watch tier's previous-interval lookback). Pads ride clamped
    gathers; the caller trims."""
    def grab(arr, idx):
        return _take(arr[:, col], idx)

    return (grab(hist.counter_hi, cidx), grab(hist.counter_lo, cidx),
            grab(hist.gauge, gidx), grab(hist.status, stidx))
