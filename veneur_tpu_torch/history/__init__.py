"""History tier: a packed per-key ring of the last K flush intervals on
the device, with tiered 2x decimation and windowed-merge range queries.

    spec.py     HistorySpec -- frozen shape contract (ring geometry)
    device.py   HistoryState + the in-place write / decimate / read code
    writer.py   HistoryWriter -- host admission index, window metadata,
                fused-flush protocol, persistence
    merge.py    the range-merge program and its packed wire helpers

The masked HLL window merge of a range query is kernel K3
(ops/cuda_history.py, csrc/merge_windows.cu).
"""

from veneur_tpu_torch.history.spec import HistorySpec
from veneur_tpu_torch.history.writer import (HistoryPlan, HistoryWriter,
                                             RangePlan)

__all__ = ["HistorySpec", "HistoryWriter", "HistoryPlan", "RangePlan"]
