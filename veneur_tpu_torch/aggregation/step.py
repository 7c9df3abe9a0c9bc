"""The ingest step and the live flush, on torch tensors.

Ingest: one padded batch of parsed samples of every type arrives as one
packed i32 buffer (`pack_batch`, the JAX package's wire layout), is
unpacked with views on the device, sorted into per-lane streams
(`build_streams`) and applied by the fused ingest kernel in one launch.
Histogram samples are assigned a digest cell on the way in
(`_histo_plan`): the first samples of a key each cycle land verbatim in
raw temp cells, the rest in the k-cell of their estimated quantile
midpoint. The accumulators are folded into the two-float pairs at the end
of every step, and every `compact_every` steps the digest rows are
re-compressed (`compact_core`).

Flush: the live rows of each kind are gathered, quantiles (+ median) are
computed by the digest kernel, HLL rows are estimated, and everything
leaves the device as one packed f32 buffer (`flush_live_in_packed`); the
host combines the two-float pairs in float64 (`combine_flush_scalars`).

The step functions update the state's tensors IN PLACE (the JAX package
donates its state to the same effect) and return the same state.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from veneur_tpu_torch.aggregation.state import DeviceState, TableSpec
from veneur_tpu_torch.history.device import write_window_core
from veneur_tpu_torch.ops import cuda_ingest
from veneur_tpu_torch.ops import hll as hll_ops
from veneur_tpu_torch.ops import tdigest as td
from veneur_tpu_torch.utils.numerics import twofloat_add


class Batch(NamedTuple):
    """A padded batch of parsed samples; padding rows carry
    slot == capacity. Numpy arrays on the host, tensors once unpacked."""
    counter_slot: object   # i32[Bc]
    counter_inc: object    # f32[Bc]  value * (1/sample_rate)
    gauge_slot: object     # i32[Bg]
    gauge_val: object      # f32[Bg]
    status_slot: object    # i32[Bst]
    status_val: object     # f32[Bst]
    set_slot: object       # i32[Bs]
    set_reg: object        # i32[Bs]
    set_rho: object        # u8[Bs]
    histo_slot: object     # i32[Bh]
    histo_val: object      # f32[Bh]
    histo_wt: object       # f32[Bh]  1/sample_rate
    # imported digests' exact min/max/reciprocal sums; None when absent
    histo_stat_slot: object = None    # i32[Bm]
    histo_stat_min: object = None     # f32[Bm]
    histo_stat_max: object = None     # f32[Bm]
    histo_stat_recip: object = None   # f32[Bm]


def _argsort_stable(x):
    return torch.sort(x, stable=True).indices


def _histo_plan(state: DeviceState, slot, val, wt, spec: TableSpec):
    """Digest cell assignment for a batch of histogram samples. Returns
    (s, cell, v, w, tadd): the batch sorted by (slot, value) with invalid
    rows at slot == histo_capacity, the target cell per row, the value
    and weight streams, and the temp-cell consumption (0/1) per row."""
    c = spec.centroids
    t = spec.temp_cells
    kh = spec.histo_capacity
    dev = slot.device
    valid = (slot >= 0) & (slot < kh) & (wt > 0)
    slot = torch.where(valid, slot, kh).to(torch.int32)
    # lexsort((val, slot)): stable sort by the minor key, then the major
    o1 = _argsort_stable(val)
    order = o1[_argsort_stable(slot[o1])]
    s = slot[order]
    ok = valid[order]
    v = torch.where(ok, val[order], 0.0)
    w = torch.where(ok, wt[order], 0.0)

    n = s.shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    seg_start = torch.ones(n, dtype=torch.bool, device=dev)
    seg_start[1:] = s[1:] != s[:-1]
    seg_id = torch.cumsum(seg_start.to(torch.int32), 0) - 1
    seg_id = seg_id.long()
    rank = idx - torch.cummax(torch.where(seg_start, idx, 0), 0).values

    # temp priority within each key's batch segment goes to the most
    # extreme samples, alternating bottom/top, so the samples that decide
    # the tail quantiles stay raw until compaction protects them
    seg_cnt = torch.zeros(n, dtype=torch.int32, device=dev).index_add_(
        0, seg_id, ok.to(torch.int32))[seg_id]
    r_top = seg_cnt - 1 - rank
    ext_order = 2 * torch.minimum(rank, r_top) + (rank > r_top).to(
        torch.int32)
    # budget per batch: half of what is left (with a small floor)
    sc = torch.clamp(s, max=kh - 1).long()
    tn = state.h_temp_n[sc]
    avail = t - tn
    allowed = torch.maximum(avail // 2, torch.clamp(avail, max=16))
    use_temp = ok & (ext_order < allowed)
    temp_idx = tn + ext_order

    # mass of the current digest below each sample value (temp cells
    # take part: their means are raw sample values)
    row_w = state.h_w[sc]
    row_mean = state.h_wm[sc] / torch.clamp(row_w, min=1e-30)
    w_main = torch.sum(row_w, dim=-1)
    below = (torch.sum(row_w * (row_mean < v[:, None]), dim=-1)
             + 0.5 * torch.sum(row_w * (row_mean == v[:, None]), dim=-1))

    # mass of earlier batch samples in the same segment
    cum_excl = td.cumsum_f32(w, 0) - w
    base = torch.cummax(torch.where(seg_start, cum_excl, 0.0), 0).values
    cum_seg = cum_excl - base
    seg_tot = torch.zeros(n, dtype=torch.float32, device=dev).index_add_(
        0, seg_id, w)[seg_id]

    q_mid = (below + cum_seg + 0.5 * w) / torch.clamp(w_main + seg_tot,
                                                      min=1e-30)
    k0 = -spec.compression / 4.0
    cell = torch.floor((td._k1(q_mid, spec.compression) - k0)
                       * spec.cells_per_k).to(torch.int32)
    # estimate-based cells land in the k-cell interior only; the protected
    # extreme columns are written by compaction alone
    cell = spec.exact_extremes + torch.clamp(cell, 0, spec.interior_cells - 1)
    cell = torch.where(use_temp, c + torch.clamp(temp_idx, max=t - 1), cell)
    return s, cell, v, w, use_temp.to(torch.int32)


def build_streams(state: DeviceState, batch: Batch,
                  spec: TableSpec) -> cuda_ingest.IngestStreams:
    """The kernel's prologue: each lane sorted by (slot, batch index), the
    histogram lane from `_histo_plan`, invalid rows at the BIG sentinel
    (negative slots are dropped, as the fused path drops them)."""
    stream = cuda_ingest.stream
    c_sk, (c_inc,) = stream(batch.counter_slot, spec.counter_capacity,
                            batch.counter_inc)
    g_sk, (g_val,) = stream(batch.gauge_slot, spec.gauge_capacity,
                            batch.gauge_val)
    st_sk, (st_val,) = stream(batch.status_slot, spec.status_capacity,
                              batch.status_val)
    reg_ok = (batch.set_reg >= 0) & (batch.set_reg < spec.registers)
    s_sk, (s_reg, s_rho) = stream(
        batch.set_slot, spec.set_capacity, batch.set_reg.to(torch.int32),
        batch.set_rho.to(torch.int32), extra_valid=reg_ok)
    hs, h_cell, h_v, h_w, h_tadd = _histo_plan(
        state, batch.histo_slot, batch.histo_val, batch.histo_wt, spec)
    h_sk = torch.where(hs < spec.histo_capacity, hs,
                       cuda_ingest.BIG).to(torch.int32)
    return cuda_ingest.IngestStreams(
        c_slot=c_sk, c_inc=c_inc, g_slot=g_sk, g_val=g_val,
        st_slot=st_sk, st_val=st_val, s_slot=s_sk, s_reg=s_reg, s_rho=s_rho,
        h_slot=h_sk, h_cell=h_cell, h_v=h_v, h_w=h_w, h_wv=h_w * h_v,
        h_rcp=torch.where(h_w > 0, h_w / h_v, 0.0), h_tadd=h_tadd)


def ingest_core(state: DeviceState, batch: Batch, *,
                spec: TableSpec) -> DeviceState:
    """Apply one padded batch to the table (in place) and fold the
    accumulators into the two-float pairs."""
    cuda_ingest.fused_ingest(state, build_streams(state, batch, spec), spec)
    if batch.histo_stat_slot is not None:
        _histo_stats(state, batch, spec)
    return _fold_core(state)


def _histo_stats(state: DeviceState, batch: Batch, spec: TableSpec) -> None:
    """The imported digests' exact min/max/reciprocal-sum lanes, applied
    after K1 as the JAX package applies them outside its kernel (XLA
    scatters there). Rows with a slot outside [0, histo_capacity) drop,
    negative ones too (the fused path's rule), without a host sync: they
    are pointed at row 0 with the operation's identity (+inf for min,
    -inf for max, -0.0 for the add, which leaves every value's bits as
    they were). Min and max do not depend on row order. The add does: on
    CPU tensors index_add_ adds rows in batch order, as the JAX package's
    CPU scatter does; on the card it adds with atomics in no set order,
    so duplicate slots in one batch may round differently there."""
    s = batch.histo_stat_slot
    ok = (s >= 0) & (s < spec.histo_capacity)
    idx = torch.where(ok, s, 0).long()
    state.h_min.scatter_reduce_(
        0, idx, torch.where(ok, batch.histo_stat_min, torch.inf), "amin")
    state.h_max.scatter_reduce_(
        0, idx, torch.where(ok, batch.histo_stat_max, -torch.inf), "amax")
    state.h_recip_acc.index_add_(
        0, idx, torch.where(ok, batch.histo_stat_recip, -0.0))


def _fold_core(state: DeviceState) -> DeviceState:
    for acc, hi, lo in (("counter_acc", "counter_hi", "counter_lo"),
                        ("h_count_acc", "h_count_hi", "h_count_lo"),
                        ("h_sum_acc", "h_sum_hi", "h_sum_lo"),
                        ("h_recip_acc", "h_recip_hi", "h_recip_lo")):
        a, h, l = getattr(state, acc), getattr(state, hi), getattr(state, lo)
        nh, nl = twofloat_add(h, l, a)
        h.copy_(nh)
        l.copy_(nl)
        a.zero_()
    return state


def compact_core(state: DeviceState, *, spec: TableSpec) -> DeviceState:
    """Re-compress every digest row (k-cells and raw temp cells) into
    canonical k-cells, emptying temp."""
    c = spec.centroids
    mean = state.h_wm / torch.clamp(state.h_w, min=1e-30)
    m2, w2 = td.compress_rows(mean, state.h_w, compression=spec.compression,
                              cells_per_k=spec.cells_per_k, out_c=c,
                              exact_extremes=spec.exact_extremes)
    state.h_wm[:, :c] = m2 * w2
    state.h_wm[:, c:] = 0.0
    state.h_w[:, :c] = w2
    state.h_w[:, c:] = 0.0
    state.h_temp_n.zero_()
    return state


# -- packed batch transfer ---------------------------------------------------
# The whole batch crosses to the device as ONE flat i32 buffer; word 0 is
# the compaction control word, lanes follow in Batch._fields order (f32
# lanes bit-viewed, u8 lanes padded to whole words, None lanes absent).
# i32 is the carrier because integer copies are bit-exact.

_U8_LANES = frozenset({"set_rho"})
_F32_LANES = frozenset({
    "counter_inc", "gauge_val", "status_val", "histo_val", "histo_wt",
    "histo_stat_min", "histo_stat_max", "histo_stat_recip"})


def batch_sizes(batch: Batch) -> tuple:
    """Lane lengths of a batch; None lanes encode as 0."""
    return tuple(0 if a is None else int(a.size) for a in batch)


def packed_layout(sizes: tuple):
    """({lane: (word_off, n, words)}, total_words) of the packed buffer."""
    layout = {}
    off = 1
    for name, n in zip(Batch._fields, sizes):
        if n == 0:
            continue
        words = (n + 3) // 4 if name in _U8_LANES else n
        layout[name] = (off, n, words)
        off += words
    return layout, off


def pack_batch(batch: Batch, do_compact: bool = False, out=None):
    """Host: every lane into one i32 numpy buffer, preceded by the control
    word. A reused `out` must have been zeroed once at allocation: u8 pad
    bytes are never rewritten, every other word is rewritten each pack."""
    layout, words = packed_layout(batch_sizes(batch))
    if out is None:
        out = np.zeros(words, np.int32)
    out[0] = 1 if do_compact else 0
    for name, a in zip(Batch._fields, batch):
        if a is None:
            continue
        off, n, w = layout[name]
        if name in _U8_LANES:
            out[off:off + w].view(np.uint8)[:n] = a
        elif name in _F32_LANES:
            out[off:off + n].view(np.float32)[:] = a
        else:
            out[off:off + n] = a
    return out


def unpack_batch(flat: torch.Tensor, sizes: tuple) -> Batch:
    """Device: contiguous slices + bitcast views back into lanes."""
    out = []
    off = 0
    for name, n in zip(Batch._fields, sizes):
        if n == 0:
            out.append(None)
            continue
        if name in _U8_LANES:
            words = (n + 3) // 4
            a = flat[off:off + words].view(torch.uint8)[:n]
            off += words
        elif name in _F32_LANES:
            a = flat[off:off + n].view(torch.float32)
            off += n
        else:
            a = flat[off:off + n]
            off += n
        out.append(a)
    return Batch(*out)


def packed_step_core(state: DeviceState, flat: torch.Tensor, *,
                     spec: TableSpec, sizes: tuple,
                     do_compact: bool) -> DeviceState:
    """The production step: ingest one packed batch, then re-compress the
    digest rows when the host asked for it. The control word still rides
    in flat[0] (the JAX layout); the branch is taken on the host's bool,
    since reading the word back would cost a device sync every step."""
    state = ingest_core(state, unpack_batch(flat[1:], sizes), spec=spec)
    if do_compact:
        state = compact_core(state, spec=spec)
    return state


def packed_rings_core(state: DeviceState, arena: torch.Tensor, *,
                      spec: TableSpec, sizes: tuple,
                      do_compact: bool) -> DeviceState:
    """The multi-ring step: `arena` is i32[R, words], one packed batch per
    reader ring, shipped in one copy. Row 0 is a whole packed step (its
    ingest, then the compaction if asked); rows 1..R-1 are ingested after
    it with no compaction. That order is the JAX package's, and the
    digest bytes depend on it. Only row 0 carries the control word. An
    idle ring's row holds sentinels only, and its scatters all drop."""
    state = packed_step_core(state, arena[0], spec=spec, sizes=sizes,
                             do_compact=do_compact)
    for r in range(1, arena.shape[0]):
        state = ingest_core(state, unpack_batch(arena[r, 1:], sizes),
                            spec=spec)
    return state


# -- flush -------------------------------------------------------------------

def quantiles_with_median(table: td.TDigestTable, qs: torch.Tensor):
    """One quantile pass for (qs, median): the median rides as an extra
    column. Returns (quantiles[..., Q], median[...])."""
    half = torch.full((1,), 0.5, dtype=torch.float32, device=qs.device)
    all_q = td.quantiles(table, torch.cat([qs, half]))
    return all_q[..., :-1], all_q[..., -1]


def _take(a, idx):
    """Row gather with clamped indices (jnp.take mode="clip")."""
    return a[torch.clamp(idx.long(), 0, a.shape[0] - 1)]


def flush_live_core(state: DeviceState, qs, cidx, gidx, stidx, setidx, hidx,
                    *, spec: TableSpec, want_raw: bool = False) -> dict:
    """Final per-row values of the LIVE slots of each kind; row i of each
    output corresponds to position i of that kind's index array."""
    wm = _take(state.h_wm, hidx)
    w = _take(state.h_w, hidx)
    mn = _take(state.h_min, hidx)
    mx = _take(state.h_max, hidx)
    chi, clo = _take(state.h_count_hi, hidx), _take(state.h_count_lo, hidx)
    shi, slo = _take(state.h_sum_hi, hidx), _take(state.h_sum_lo, hidx)
    rhi, rlo = _take(state.h_recip_hi, hidx), _take(state.h_recip_lo, hidx)
    mean = wm / torch.clamp(w, min=1e-30)
    table = td.TDigestTable(mean=mean, weight=w, min=mn, max=mx,
                            count_hi=chi, count_lo=clo, sum_hi=shi,
                            sum_lo=slo, recip_hi=rhi, recip_lo=rlo)
    hll_rows = _take(state.hll, setidx)
    hq, hmed = quantiles_with_median(table, qs)
    out = {
        "counter_hi": _take(state.counter_hi, cidx),
        "counter_lo": _take(state.counter_lo, cidx),
        "gauge": _take(state.gauge, gidx),
        "status": _take(state.status, stidx),
        "set_estimate": hll_ops.estimate_packed_rows(
            hll_rows, precision=spec.hll_precision),
        "histo_quantiles": hq,
        "histo_min": mn,
        "histo_max": mx,
        "histo_count_hi": chi, "histo_count_lo": clo,
        "histo_sum_hi": shi, "histo_sum_lo": slo,
        "histo_recip_hi": rhi, "histo_recip_lo": rlo,
        "histo_median": hmed,
    }
    if want_raw:
        out["raw_hll"] = hll_rows
        out["raw_h_mean"] = mean
        out["raw_h_weight"] = w
    return out


def _pack_outputs(out: dict) -> torch.Tensor:
    """Every output, in sorted key order, as one flat f32 tensor (u8 and
    i32 leaves bit-cast; a 6-bit register field never forms a NaN)."""
    parts = []
    for k in sorted(out):
        a = out[k].contiguous()
        if a.dtype == torch.uint8:
            a = a.reshape(-1, 4).view(torch.float32)
        elif a.dtype == torch.int32:
            a = a.view(torch.float32)
        parts.append(a.reshape(-1).to(torch.float32))
    return torch.cat(parts)


def pack_flush_inputs(perc, idx_arrays):
    """Host: quantile list (f32 bit-viewed) + the five live-index buckets
    as ONE i32 buffer."""
    qs = np.asarray(perc, np.float32).view(np.int32)
    return np.concatenate([qs] + [np.asarray(i, np.int32).ravel()
                                  for i in idx_arrays])


def flush_live_in_packed(state: DeviceState, flat: torch.Tensor, *,
                         spec: TableSpec, n_q: int, buckets: tuple,
                         want_raw: bool = False) -> torch.Tensor:
    """The flush program: packed inputs in (`pack_flush_inputs`, on the
    state's device), one packed f32 tensor out."""
    qs = flat[:n_q].view(torch.float32)
    idx, off = [], n_q
    for n in buckets:
        idx.append(flat[off:off + n])
        off += n
    out = flush_live_core(state, qs, *idx, spec=spec, want_raw=want_raw)
    return _pack_outputs(out)


def flush_live_hist_packed(state: DeviceState, flat: torch.Tensor, hist,
                           dests, col: int, *, spec: TableSpec, hspec,
                           n_q: int, buckets: tuple, want_raw: bool = False,
                           clear: bool = False):
    """The flush program WITH the history tier's window write: the same
    flush math and packed output as `flush_live_in_packed`, plus the
    scatter of the interval's values into ring column `col` of `hist`
    (in place), from the flush's own device tensors. `dests` holds the
    per-kind ring rows of this block as host int arrays (bucket-sized,
    sentinel-padded) and `col` is a host int, so nothing is read back
    from the device. Returns (packed, hist).

    The write is history/device.write_window_core, the function the
    replay path runs too, so both store bit-identical window bytes."""
    qs = flat[:n_q].view(torch.float32)
    idx, off = [], n_q
    for n in buckets:
        idx.append(flat[off:off + n])
        off += n
    out = flush_live_core(state, qs, *idx, spec=spec, want_raw=True)
    vals = {
        "counter_hi": out["counter_hi"], "counter_lo": out["counter_lo"],
        "gauge": out["gauge"], "status": out["status"],
        "hll": out["raw_hll"],
        "h_mean": out["raw_h_mean"], "h_weight": out["raw_h_weight"],
        "h_min": out["histo_min"], "h_max": out["histo_max"],
        "h_count_hi": out["histo_count_hi"],
        "h_count_lo": out["histo_count_lo"],
        "h_sum_hi": out["histo_sum_hi"], "h_sum_lo": out["histo_sum_lo"],
    }
    write_window_core(hist, vals, dests, col, hspec=hspec, clear=clear)
    if not want_raw:
        out = {k: v for k, v in out.items() if not k.startswith("raw_")}
    return _pack_outputs(out), hist


def unpack_flush(packed, shapes: dict) -> dict:
    """Host inverse of the packing: slice the flat f32 array back into
    named arrays, keys consumed in sorted order."""
    out = {}
    off = 0
    for k in sorted(shapes):
        shape, dtype = shapes[k]
        n = int(np.prod(shape))
        if np.dtype(dtype) == np.uint8:
            words = n // 4
            out[k] = np.frombuffer(
                packed[off:off + words].tobytes(), np.uint8).reshape(shape)
            off += words
        elif np.dtype(dtype) == np.int32:
            out[k] = np.frombuffer(
                packed[off:off + n].tobytes(), np.int32).reshape(shape)
            off += n
        else:
            out[k] = packed[off:off + n].reshape(shape)
            off += n
    return out


def flush_live_shapes(spec: TableSpec, n_c, n_g, n_st, n_set, n_h, n_q,
                      want_raw: bool = False) -> dict:
    """The packer's output layout for given live-bucket sizes."""
    f32 = "float32"
    shapes = {
        "counter_hi": ((n_c,), f32), "counter_lo": ((n_c,), f32),
        "gauge": ((n_g,), f32), "status": ((n_st,), f32),
        "set_estimate": ((n_set,), f32),
        "histo_quantiles": ((n_h, n_q), f32),
        "histo_min": ((n_h,), f32), "histo_max": ((n_h,), f32),
        "histo_count_hi": ((n_h,), f32), "histo_count_lo": ((n_h,), f32),
        "histo_sum_hi": ((n_h,), f32), "histo_sum_lo": ((n_h,), f32),
        "histo_recip_hi": ((n_h,), f32), "histo_recip_lo": ((n_h,), f32),
        "histo_median": ((n_h,), f32),
    }
    if want_raw:
        cells = spec.centroids + spec.temp_cells
        shapes["raw_hll"] = ((n_set, spec.hll_words), "int32")
        shapes["raw_h_mean"] = ((n_h, cells), f32)
        shapes["raw_h_weight"] = ((n_h, cells), f32)
    return shapes


# Which live-index bucket each flush output key rides (0=counter,
# 1=gauge, 2=status, 3=set, 4=histo): the tiled flush trims each block's
# padded rows back to the kind's real length with it.
FLUSH_KEY_KIND = {
    "counter_hi": 0, "counter_lo": 0, "gauge": 1, "status": 2,
    "set_estimate": 3, "raw_hll": 3,
    "histo_quantiles": 4, "histo_min": 4, "histo_max": 4,
    "histo_count_hi": 4, "histo_count_lo": 4, "histo_sum_hi": 4,
    "histo_sum_lo": 4, "histo_recip_hi": 4, "histo_recip_lo": 4,
    "histo_median": 4, "raw_h_mean": 4, "raw_h_weight": 4,
}

# Row-block size of the tiled flush: larger live sets loop over blocks of
# at most this many rows per kind.
FLUSH_BLOCK_ROWS = 1 << 17


def live_slots(table, kind: str):
    """Unpadded int32 slot-index array for a kind, in get_meta order."""
    metas = table.get_meta(kind)
    return np.fromiter((slot for slot, _m in metas), np.int32, len(metas))


def pack_bucket_chunks(slots, buckets, block_i: int, fill: int = 0):
    """Block `block_i`'s per-kind index chunk, padded to each kind's
    bucket size with `fill` (0: a clamped gather whose rows are trimmed)."""
    out = []
    for sarr, b in zip(slots, buckets):
        c = sarr[block_i * b:(block_i + 1) * b]
        buf = np.full(b, fill, np.int32)
        buf[:len(c)] = c
        out.append(buf)
    return out


def pad_bucket(n: int, cap: int) -> int:
    """Size bucket for live-slot index arrays: next power of two (min 64),
    clamped to capacity."""
    p = 64
    while p < n:
        p <<= 1
    return min(p, max(cap, 1))


def pack_query_inputs(spec: TableSpec, need, union_qs):
    """Host: a query or watch batch's gather plan -> the flush program's
    packed input buffer and static shape arguments (n_q, buckets, qcol).

    The wire is `pack_flush_inputs`'s, shaped for ad-hoc reads: the
    quantiles pad to the next power of two (min 4) and each kind's slot
    list pads with `pad_bucket`, capped at FLUSH_BLOCK_ROWS as the tiled
    flush caps its blocks, so a read runs the flush's own program and is
    value-exact against the next flush. `need` is the (counter, gauge,
    status, set, histo) slot lists; `union_qs` the batch's quantiles;
    `qcol` maps a quantile to its column in the padded vector."""
    caps = (spec.counter_capacity, spec.gauge_capacity,
            spec.status_capacity, spec.set_capacity, spec.histo_capacity)
    qs = sorted(union_qs) or [0.5]
    n_q = 4
    while n_q < len(qs):
        n_q <<= 1
    qcol = {v: i for i, v in enumerate(qs)}
    qs_padded = qs + [0.5] * (n_q - len(qs))
    buckets, idx_arrays = [], []
    for slots, cap in zip(need, caps):
        b = min(pad_bucket(len(slots), cap), FLUSH_BLOCK_ROWS)
        if len(slots) > b:
            raise ValueError("query gather exceeds one flush block")
        arr = np.zeros(b, np.int32)
        arr[:len(slots)] = slots
        buckets.append(b)
        idx_arrays.append(arr)
    return (pack_flush_inputs(qs_padded, idx_arrays), n_q,
            tuple(buckets), qcol)


def combine_flush_scalars(result: dict) -> dict:
    """Host finish of the flush output: collapse each two-float pair in
    float64 (exact for the pair's ~48 significand bits) and derive
    count/sum/avg/hmean. The input dict is left untouched."""
    def f64(key):
        return (np.asarray(result[key + "_hi"], np.float64)
                + np.asarray(result[key + "_lo"], np.float64))

    out = {k: v for k, v in result.items()
           if not (k.endswith("_hi") or k.endswith("_lo"))}
    out["counter"] = f64("counter")
    count = f64("histo_count")
    total = f64("histo_sum")
    recip = f64("histo_recip")
    out["histo_count"] = count
    out["histo_sum"] = total
    out["histo_avg"] = total / np.maximum(count, 1e-30)
    out["histo_hmean"] = count / np.maximum(recip, 1e-30)
    return out


def finish_flush(out: dict) -> dict:
    """Device flush output -> host numpy dict with pairs combined."""
    return combine_flush_scalars(
        {k: v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
         for k, v in out.items()})
