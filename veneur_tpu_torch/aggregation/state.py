"""Device-side aggregation state: the metric-key table as torch tensors.

A fixed-capacity struct of tensors, one slot per live metric key,
assigned by the host key table (host.py); strings never reach the device.
The field names, dtypes and shapes are those of the JAX package's
DeviceState, so states convert both ways byte for byte (convert.py):

- counters: a plain f32 scatter target `counter_acc` plus a two-float
  (hi, lo) pair the ingest step folds it into (utils/numerics.py);
- gauges/status: last-write-wins values plus a u8 "written this interval"
  stamp;
- sets: 6-bit packed HLL registers, i32[Ks, W] (ops/hll.py);
- histograms/timers: the digest as (weight·mean, weight) cells — columns
  [0, C) canonical k-cells, [C, C+T) raw temp cells — plus exact
  min/max and count/sum/reciprocal-sum accumulators.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from veneur_tpu_torch.ops import hll
from veneur_tpu_torch.ops import tdigest as td


@dataclasses.dataclass(frozen=True)
class TableSpec:
    """Static capacities and sketch parameters of one key table."""
    counter_capacity: int = 1 << 16
    gauge_capacity: int = 1 << 14
    status_capacity: int = 1 << 10
    set_capacity: int = 1 << 10
    histo_capacity: int = 1 << 14
    compression: float = td.DEFAULT_COMPRESSION
    cells_per_k: int = td.DEFAULT_CELLS_PER_K
    exact_extremes: int = td.DEFAULT_EXACT_EXTREMES
    # 192 raw temp cells + 280 centroids = 472 digest columns
    temp_cells: int = 192
    hll_precision: int = hll.DEFAULT_PRECISION

    @property
    def centroids(self) -> int:
        return td.centroid_capacity(self.compression, self.cells_per_k,
                                    self.exact_extremes)

    @property
    def interior_cells(self) -> int:
        """k-cell columns between the 2·exact_extremes protected slots."""
        return self.centroids - 2 * self.exact_extremes

    @property
    def total_cells(self) -> int:
        """Digest columns per row: C canonical cells + T raw temp cells."""
        return self.centroids + self.temp_cells

    @property
    def registers(self) -> int:
        return hll.num_registers(self.hll_precision)

    @property
    def hll_words(self) -> int:
        """int32 words per set row in the 6-bit packed layout."""
        return hll.packed_words(self.hll_precision)


class DeviceState(NamedTuple):
    """One flush interval's aggregation state; every tensor is per-slot."""
    counter_acc: torch.Tensor   # f32[Kc] unfolded scatter target
    counter_hi: torch.Tensor    # f32[Kc] two-float accumulator
    counter_lo: torch.Tensor
    gauge: torch.Tensor         # f32[Kg]
    gauge_stamp: torch.Tensor   # u8[Kg] 1 if written this interval
    status: torch.Tensor        # f32[Kst]
    status_stamp: torch.Tensor  # u8[Kst]
    hll: torch.Tensor           # i32[Ks, W]
    h_wm: torch.Tensor          # f32[Kh, C+T] sum of weight*mean per cell
    h_w: torch.Tensor           # f32[Kh, C+T]
    h_temp_n: torch.Tensor      # i32[Kh] temp cells used since last compact
    h_min: torch.Tensor         # f32[Kh]
    h_max: torch.Tensor         # f32[Kh]
    h_count_acc: torch.Tensor   # f32[Kh] + two-float pair, like counters
    h_count_hi: torch.Tensor
    h_count_lo: torch.Tensor
    h_sum_acc: torch.Tensor
    h_sum_hi: torch.Tensor
    h_sum_lo: torch.Tensor
    h_recip_acc: torch.Tensor   # sum of weight/value (harmonic mean)
    h_recip_hi: torch.Tensor
    h_recip_lo: torch.Tensor


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    another. Never falls back to the CPU on its own: a card that is asked
    for, by default or by name, and absent raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to "
                           "run the plain versions on the CPU")
    return dev


def empty_state(spec: TableSpec, device) -> DeviceState:
    """A zeroed state on `device` (h_min = +inf, h_max = -inf)."""
    f = dict(dtype=torch.float32, device=device)
    kc, kg, kst = spec.counter_capacity, spec.gauge_capacity, \
        spec.status_capacity
    ks, kh, c = spec.set_capacity, spec.histo_capacity, spec.total_cells

    def z(*shape):
        return torch.zeros(shape, **f)

    return DeviceState(
        counter_acc=z(kc), counter_hi=z(kc), counter_lo=z(kc),
        gauge=z(kg), gauge_stamp=torch.zeros(kg, dtype=torch.uint8,
                                             device=device),
        status=z(kst), status_stamp=torch.zeros(kst, dtype=torch.uint8,
                                                device=device),
        hll=torch.zeros((ks, spec.hll_words), dtype=torch.int32,
                        device=device),
        h_wm=z(kh, c), h_w=z(kh, c),
        h_temp_n=torch.zeros(kh, dtype=torch.int32, device=device),
        h_min=torch.full((kh,), float("inf"), **f),
        h_max=torch.full((kh,), float("-inf"), **f),
        h_count_acc=z(kh), h_count_hi=z(kh), h_count_lo=z(kh),
        h_sum_acc=z(kh), h_sum_hi=z(kh), h_sum_lo=z(kh),
        h_recip_acc=z(kh), h_recip_hi=z(kh), h_recip_lo=z(kh),
    )
