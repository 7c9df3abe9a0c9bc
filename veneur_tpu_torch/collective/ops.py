"""Replica-axis merges of sketch state.

The flush-time merge of the replica rows is a composition of five
independent sketch merges, each tied to a metric family's algebra:

- two-float pair totals for counters and digest scalars: every
  participant's pair is gathered and folded with error-free TwoSum
  merges in participant order 0..N-1 (a plain sum of hi + lo would
  round the ~48-bit pairs back to 24 bits);
- 6-bit packed HLL: unpack, register max, repack (a max of packed
  words is not a register max);
- last write wins for gauges/status: the highest participant index that
  wrote;
- t-digest cells: every participant's cells concatenated in participant
  order and re-compressed to canonical cells;
- min/max for histogram extremes.

Every function takes tensors with a leading local replica dim
[r_local, ...] and reduces it. Given a `torch.distributed` group, the
participants are every process's rows: each function first gathers the
rows over the group (`all_gather`, rank-major, so participant
rank·r_local + local, the JAX `axis_index(axis)·r_local + arange`) and
then applies the same fold in the same participant order. Without a
group the participants are the local rows.
"""

from __future__ import annotations

import torch

from veneur_tpu_torch.aggregation.state import DeviceState, TableSpec
from veneur_tpu_torch.ops import hll as hll_ops
from veneur_tpu_torch.ops import tdigest as td
from veneur_tpu_torch.utils.numerics import twofloat_add, twofloat_merge


def _gather(x: torch.Tensor, group) -> torch.Tensor:
    """[r_local, ...] -> [world·r_local, ...], rank-major."""
    if group is None:
        return x
    import torch.distributed as dist
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, 0)


def _first_participant(r_local: int, group) -> int:
    if group is None:
        return 0
    import torch.distributed as dist
    return dist.get_rank(group) * r_local


def twofloat_axis_sum(hi, lo, acc, group=None):
    """Sum two-float pairs over every participant without collapsing them
    to f32: absorb any unfolded acc, gather, then fold participant by
    participant with TwoSum merges."""
    hi, lo = twofloat_add(hi, lo, acc)
    hs, ls = _gather(hi, group), _gather(lo, group)
    h, l = hs[0], ls[0]
    for i in range(1, hs.shape[0]):
        h, l = twofloat_merge(h, l, hs[i], ls[i])
    return h, l


def hll_axis_max(packed, group=None, *, precision: int):
    """Register-wise HLL union over every participant: unpack the 6-bit
    packed words to dense registers, max, repack."""
    dense = hll_ops.unpack_registers(packed, precision=precision)
    dense = _gather(dense.amax(dim=0, keepdim=True), group).amax(dim=0)
    return hll_ops.pack_registers(dense, precision=precision)


def lww_axis_merge(val, stamp, group=None):
    """Last write wins, the highest participant index that wrote taking
    the row. Returns (merged values, written mask u8)."""
    r_local = val.shape[0]
    ridx = (_first_participant(r_local, group)
            + torch.arange(r_local, device=val.device))
    ridx = ridx.reshape((r_local,) + (1,) * (val.ndim - 1))
    prio = torch.where(stamp > 0, ridx + 1, 0)
    vals, prios = _gather(val, group), _gather(prio, group)
    # argmax takes the first of equal maxima, as jnp.argmax does: a row
    # nobody wrote reads participant 0's value
    win = torch.argmax(prios, dim=0, keepdim=True)
    merged = torch.take_along_dim(vals, win, dim=0)[0]
    written = prios.amax(dim=0) > 0
    return merged, written.to(torch.uint8)


def digest_axis_merge(wm, w, group=None, *, spec: TableSpec):
    """t-digest merge: every participant's cells of a row concatenated in
    participant order, re-compressed to canonical cells. Returns
    (h_wm, h_w) in the state's [C + temp] column layout with the temp
    cells empty."""
    wm, w = _gather(wm, group), _gather(w, group)
    r = w.shape[0]
    lead = tuple(w.shape[1:-1])
    cells = w.shape[-1]
    mean = (wm / torch.clamp(w, min=1e-30)).movedim(0, -2)
    w = w.movedim(0, -2)
    m2, w2 = td.compress_rows(mean.reshape(lead + (r * cells,)),
                              w.reshape(lead + (r * cells,)),
                              compression=spec.compression,
                              cells_per_k=spec.cells_per_k,
                              out_c=spec.centroids,
                              exact_extremes=spec.exact_extremes)
    pad = torch.zeros(lead + (spec.temp_cells,), dtype=w2.dtype,
                      device=w2.device)
    return torch.cat([m2 * w2, pad], -1), torch.cat([w2, pad], -1)


def extremes_axis_merge(h_min, h_max, group=None):
    mn = _gather(h_min.amin(dim=0, keepdim=True), group).amin(dim=0)
    mx = _gather(h_max.amax(dim=0, keepdim=True), group).amax(dim=0)
    return mn, mx


def merge_replica_block(state: DeviceState, spec: TableSpec,
                        group=None) -> DeviceState:
    """Merge a [r_local, ...]-leading state over every participant;
    returns the state with the replica dim reduced away."""
    counters = twofloat_axis_sum(state.counter_hi, state.counter_lo,
                                 state.counter_acc, group)
    h_count = twofloat_axis_sum(state.h_count_hi, state.h_count_lo,
                                state.h_count_acc, group)
    h_sum = twofloat_axis_sum(state.h_sum_hi, state.h_sum_lo,
                              state.h_sum_acc, group)
    h_recip = twofloat_axis_sum(state.h_recip_hi, state.h_recip_lo,
                                state.h_recip_acc, group)
    hll = hll_axis_max(state.hll, group, precision=spec.hll_precision)
    gauge, gauge_stamp = lww_axis_merge(state.gauge, state.gauge_stamp,
                                        group)
    status, status_stamp = lww_axis_merge(state.status,
                                          state.status_stamp, group)
    wm2, w2 = digest_axis_merge(state.h_wm, state.h_w, group, spec=spec)
    h_min, h_max = extremes_axis_merge(state.h_min, state.h_max, group)
    z = torch.zeros_like
    return DeviceState(
        counter_acc=z(counters[0]), counter_hi=counters[0],
        counter_lo=counters[1],
        gauge=gauge, gauge_stamp=gauge_stamp,
        status=status, status_stamp=status_stamp,
        hll=hll, h_wm=wm2, h_w=w2,
        h_temp_n=torch.zeros(w2.shape[:-1], dtype=torch.int32,
                             device=w2.device),
        h_min=h_min, h_max=h_max,
        h_count_acc=z(h_count[0]), h_count_hi=h_count[0],
        h_count_lo=h_count[1],
        h_sum_acc=z(h_sum[0]), h_sum_hi=h_sum[0], h_sum_lo=h_sum[1],
        h_recip_acc=z(h_recip[0]), h_recip_hi=h_recip[0],
        h_recip_lo=h_recip[1])
