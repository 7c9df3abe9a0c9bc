"""Device state carried across packages, as numpy.

`state_from_numpy` takes a state given as ``{field: ndarray}`` (the JAX
package's DeviceState converts with
``{k: np.asarray(v) for k, v in state._asdict().items()}``) and returns
the port's DeviceState on `device`; `state_to_numpy` is the reverse.
`history_from_numpy` / `history_to_numpy` do the same for the history
ring (the ``arrays`` of a HistoryWriter snapshot, in either package).
Field names, dtypes and shapes are the same in both packages, so the
round trips are byte-exact. A sharded state's leaves carry leading
[R, S] dims in both packages and convert the same way; every leaf comes
out contiguous, which is all the sharded step's flattened view needs
(parallel/sharded.py flat_view).
"""

from __future__ import annotations

import numpy as np
import torch

from veneur_tpu_torch.aggregation.state import DeviceState
from veneur_tpu_torch.history.device import HistoryState


def _from_numpy(cls, d: dict, device):
    missing = set(cls._fields) - set(d)
    if missing:
        raise ValueError(f"{cls.__name__} is missing fields "
                         f"{sorted(missing)}")
    return cls(**{
        k: torch.from_numpy(np.ascontiguousarray(d[k]).copy()).to(device)
        for k in cls._fields})


def _to_numpy(tensors) -> dict:
    """Copies, never views: on the CPU a view would follow later in-place
    updates (a checkpoint's ring would change under its async writer)."""
    return {k: v.detach().to("cpu", copy=True).numpy()
            for k, v in tensors._asdict().items()}


def state_from_numpy(d: dict, device) -> DeviceState:
    return _from_numpy(DeviceState, d, device)


def state_to_numpy(state: DeviceState) -> dict:
    return _to_numpy(state)


def history_from_numpy(arrays: dict, device) -> HistoryState:
    return _from_numpy(HistoryState, arrays, device)


def history_to_numpy(hist: HistoryState) -> dict:
    return _to_numpy(hist)
