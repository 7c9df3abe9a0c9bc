"""Fused ingest kernel (kernel K1) and its plain PyTorch version.

`fused_ingest(state, streams, spec)` applies one batch, already sorted
into per-lane streams (`IngestStreams`, built by aggregation/step.py
build_streams), to the 14 state leaves IN PLACE: counter add,
gauge/status last-write-wins plus stamps, 6-bit packed HLL register max,
and the digest cell insert with its scalar accumulators. It replaces the
Pallas kernel veneur_tpu/ops/pallas_ingest.py fused_ingest_core; the CUDA
source is csrc/fused_ingest.cu.

Duplicates of a target are applied one after another in stream order,
starting from the resident value -- the order of the JAX scatter chain,
which makes every leaf byte-identical to it. The plain version keeps
that order with a loop over rank within run: at rank r each slot appears
at most once, so one vectorised scatter per rank is exact.

For CPU tensors the wrapper runs `fused_ingest_plain`; for CUDA tensors it
launches the kernel, or raises. The kernel needs no plan beyond the
streams: it groups the set lane by 16-register group and the histogram
lane by (slot, cell) itself, on the card. It stages a hot key's row in
shared memory; at widths whose rows do not fit a block's (hll_precision
16, or more than 3,630 digest cells) the wrapper launches the kernel's
in-place instantiation instead, which walks such a row where it lies in
global memory (`rows_in_place`). Its offsets into the state are 64-bit,
so it serves every width the plain version does; it refuses (ValueError)
only slots past the stream sentinel and launches past a block's shared
memory. `launches` counts launches of the staging kernel,
`wide_launches` those of the in-place one, and nothing else.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from veneur_tpu_torch.ops import hll as hll_ops

launches = 0
wide_launches = 0

BIG = 1 << 30   # sentinel slot of dropped rows: sorts after every valid slot

# the state leaves the kernel updates, in the C entry's pointer order
STATE_LEAVES = ("counter_acc", "gauge", "gauge_stamp", "status",
                "status_stamp", "hll", "h_w", "h_wm", "h_temp_n", "h_min",
                "h_max", "h_count_acc", "h_sum_acc", "h_recip_acc")


class IngestStreams(NamedTuple):
    """One batch as five sorted lanes (invalid rows at slot == BIG, at
    each lane's tail)."""
    c_slot: torch.Tensor   # i32[Nc]
    c_inc: torch.Tensor    # f32[Nc]
    g_slot: torch.Tensor   # i32[Ng]
    g_val: torch.Tensor    # f32[Ng]
    st_slot: torch.Tensor  # i32[Nst]
    st_val: torch.Tensor   # f32[Nst]
    s_slot: torch.Tensor   # i32[Ns]
    s_reg: torch.Tensor    # i32[Ns]
    s_rho: torch.Tensor    # i32[Ns]
    h_slot: torch.Tensor   # i32[Nh]
    h_cell: torch.Tensor   # i32[Nh]
    h_v: torch.Tensor      # f32[Nh]
    h_w: torch.Tensor      # f32[Nh]
    h_wv: torch.Tensor     # f32[Nh]  w * v
    h_rcp: torch.Tensor    # f32[Nh]  w / v where w > 0, else 0
    h_tadd: torch.Tensor   # i32[Nh]  temp-cell consumption (0/1)


_LANES = (("c_slot", "c_inc"), ("g_slot", "g_val"), ("st_slot", "st_val"),
          ("s_slot", "s_reg", "s_rho"),
          ("h_slot", "h_cell", "h_v", "h_w", "h_wv", "h_rcp", "h_tadd"))


def stream(slot, cap: int, *vals, extra_valid=None):
    """Sort one lane by (slot, batch index); rows with a negative or
    past-capacity slot (or failing `extra_valid`) keep their relative
    order at the tail under the BIG sentinel."""
    valid = (slot >= 0) & (slot < cap)
    if extra_valid is not None:
        valid = valid & extra_valid
    skey = torch.where(valid, slot, BIG).to(torch.int32)
    order = torch.sort(skey, stable=True).indices
    return skey[order], tuple(v[order] for v in vals)


def runs(slot):
    """(valid, rank within run) of a sorted slot stream."""
    n = slot.shape[0]
    idx = torch.arange(n, device=slot.device)
    head = torch.ones(n, dtype=torch.bool, device=slot.device)
    head[1:] = slot[1:] != slot[:-1]
    start = torch.cummax(torch.where(head, idx, 0), dim=0).values
    return (slot >= 0) & (slot < BIG), idx - start


def seq_add_(targets, valid, rank):
    """targets: [(flat tensor, index i64[N], values[N])]. Adds values into
    the targets one rank at a time, so duplicates land in stream order."""
    rows = valid.nonzero().squeeze(1)
    if rows.numel() == 0:
        return
    rk = rank[rows]
    rows = rows[torch.sort(rk, stable=True).indices]
    for chunk in torch.split(rows, torch.bincount(rk).tolist()):
        for flat, index, vals in targets:
            ix = index[chunk]
            flat[ix] = flat[ix] + vals[chunk]


def _last_of_runs(slot):
    last = torch.ones(slot.shape[0], dtype=torch.bool, device=slot.device)
    last[:-1] = slot[:-1] != slot[1:]
    return last & (slot >= 0) & (slot < BIG)


def fused_ingest_plain(state, st: IngestStreams, spec) -> None:
    """The kernel's function in plain torch, in place on `state`."""
    valid, rank = runs(st.c_slot)
    seq_add_([(state.counter_acc, st.c_slot.long(), st.c_inc)], valid, rank)

    for slot, val, tgt, stamp in ((st.g_slot, st.g_val, state.gauge,
                                   state.gauge_stamp),
                                  (st.st_slot, st.st_val, state.status,
                                   state.status_stamp)):
        last = _last_of_runs(slot)
        s = slot[last].long()
        tgt[s] = val[last]
        stamp[s] = 1

    ok = (st.s_slot >= 0) & (st.s_slot < BIG)
    hll_ops.insert_rows_packed_(state.hll, st.s_slot[ok], st.s_reg[ok],
                                st.s_rho[ok], precision=spec.hll_precision)

    valid, rank = runs(st.h_slot)
    s = st.h_slot.long()
    cells = state.h_w.shape[1]
    flat = s * cells + st.h_cell.long()
    seq_add_([(state.h_w.view(-1), flat, st.h_w),
               (state.h_wm.view(-1), flat, st.h_wv),
               (state.h_count_acc, s, st.h_w),
               (state.h_sum_acc, s, st.h_wv),
               (state.h_recip_acc, s, st.h_rcp)], valid, rank)
    sv = s[valid]
    live = st.h_w > 0
    state.h_temp_n.index_add_(0, sv, st.h_tadd[valid])
    state.h_min.scatter_reduce_(
        0, sv, torch.where(live, st.h_v, math.inf)[valid], "amin")
    state.h_max.scatter_reduce_(
        0, sv, torch.where(live, st.h_v, -math.inf)[valid], "amax")


_STATE_DTYPES = {"gauge_stamp": torch.uint8, "status_stamp": torch.uint8,
                 "hll": torch.int32, "h_temp_n": torch.int32}
_STREAM_I32 = frozenset({"c_slot", "g_slot", "st_slot", "s_slot", "s_reg",
                         "s_rho", "h_slot", "h_cell", "h_tadd"})

SMEM_PER_BLOCK = 227 * 1024   # the most shared memory an sm_90 block has
_ROW = 260                    # a staged stream's row, in floats


def _up4(x: int) -> int:
    return (x + 3) & ~3


def shared_bytes(hll_words: int, cells: int, in_place: bool = False) -> int:
    """Dynamic shared memory the kernel asks of each block at these widths
    (csrc/fused_ingest.cu block_smem_bytes): each of its 4 warps reserves
    the largest of its long walks -- the slot chain's staging, the cell
    walk's digest row, the set walk's packed HLL row; in place, the walks'
    stages without the rows."""
    rows = not in_place
    slot = 7 * 2 * _ROW
    cell = rows * _up4(3 * cells) + 3 * 4 * _ROW + _up4(2 * 256 + 1)
    sets = 64 + 2 * 2 * _ROW + rows * (_up4(hll_words)
                                       + _up4(hll_words // 3))
    return max(slot, cell, sets) * 4 * 4


@functools.lru_cache(maxsize=None)
def rows_in_place(spec) -> bool:
    """True where a set row (hll_precision 16) or a digest row (more than
    3,630 cells: compression above ~2,200) is too wide to stage in a
    block's shared memory, so the in-place kernel runs."""
    return shared_bytes(spec.hll_words, spec.total_cells) > SMEM_PER_BLOCK


@functools.lru_cache(maxsize=None)
def _check_spec(spec):
    """Refuse only what the kernel cannot run (once a spec: a refusal
    raises, so only accepted specs are cached). Its global offsets are
    64-bit, so no table width is refused for its size; what stays is a
    slot past the stream sentinel (slots are i32 and BIG marks a dropped
    row), and a launch's shared memory past what an sm_90 block may have
    (the in-place instantiation needs the stages alone, so no width the
    spec allows reaches it)."""
    for name, rows in (("counter", spec.counter_capacity),
                       ("gauge", spec.gauge_capacity),
                       ("status", spec.status_capacity),
                       ("set", spec.set_capacity),
                       ("histo", spec.histo_capacity)):
        if rows > BIG:
            raise ValueError(f"{name}_capacity {rows}: slots must stay "
                             f"below the stream sentinel 2^30")
    smem = shared_bytes(spec.hll_words, spec.total_cells,
                        rows_in_place(spec))
    if smem > SMEM_PER_BLOCK:
        raise ValueError(f"{smem} bytes of shared memory a block: past the "
                         f"{SMEM_PER_BLOCK} an sm_90 block may have")


def _validate(state, st: IngestStreams, spec, device):
    _check_spec(spec)
    shapes = {
        "counter_acc": (spec.counter_capacity,),
        "gauge": (spec.gauge_capacity,), "gauge_stamp": (spec.gauge_capacity,),
        "status": (spec.status_capacity,),
        "status_stamp": (spec.status_capacity,),
        "hll": (spec.set_capacity, spec.hll_words),
        "h_w": (spec.histo_capacity, spec.total_cells),
        "h_wm": (spec.histo_capacity, spec.total_cells)}
    for name in STATE_LEAVES:
        t = getattr(state, name)
        want = _STATE_DTYPES.get(name, torch.float32)
        shape = shapes.get(name, (spec.histo_capacity,))
        if t.dtype != want or tuple(t.shape) != shape:
            raise ValueError(f"state.{name}: want {want}{list(shape)}, got "
                             f"{t.dtype}{list(t.shape)}")
        if t.device != device or not t.is_contiguous():
            raise ValueError(f"state.{name}: must be contiguous on {device}")
    for lane in _LANES:
        n = getattr(st, lane[0]).shape[0]
        for name in lane:
            t = getattr(st, name)
            want = torch.int32 if name in _STREAM_I32 else torch.float32
            if t.dtype != want or tuple(t.shape) != (n,):
                raise ValueError(f"stream {name}: want {want}[{n}], got "
                                 f"{t.dtype}{list(t.shape)}")
            if (t.device != device or not t.is_contiguous()
                    or t.data_ptr() % 16):
                raise ValueError(f"stream {name}: must be contiguous and "
                                 f"16-byte aligned on {device}")


def fused_ingest(state, st: IngestStreams, spec) -> None:
    """Apply the streams to `state` in place (kernel on CUDA tensors,
    plain version on CPU tensors)."""
    global launches, wide_launches
    device = state.counter_acc.device
    if device.type == "cpu":
        fused_ingest_plain(state, st, spec)
        return
    if device.type != "cuda":
        raise ValueError(f"no ingest kernel for device {device}")
    _validate(state, st, spec, device)
    from veneur_tpu_torch.ops import _build
    lib = _build.load()
    ptrs = (ctypes.c_void_p * 30)(
        *[getattr(state, n).data_ptr() for n in STATE_LEAVES],
        *[t.data_ptr() for t in st])
    in_place = rows_in_place(spec)
    dims = (ctypes.c_longlong * 8)(
        st.c_slot.shape[0], st.g_slot.shape[0], st.st_slot.shape[0],
        st.s_slot.shape[0], st.h_slot.shape[0], spec.hll_words,
        spec.total_cells, in_place)
    rc = lib.vt_fused_ingest(ptrs, dims,
                             torch.cuda.current_stream(device).cuda_stream)
    _build.check(rc, "fused_ingest launch")
    if in_place:
        wide_launches += 1
    else:
        launches += 1
