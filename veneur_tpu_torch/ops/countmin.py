"""Count-min sketch: heavy-hitter counting for unbounded tag cardinality.

No reference counterpart: the sketch BASELINE config 5 calls for (a span
firehose with 1M tail tags -> top-K tag frequencies). Strings hash on the
host; the device holds one [depth, width] f32 counter table, updated by
one `index_add_` a batch, and an estimate is the min over the depth rows
gathered at an item's columns.

The counts are integers below 2^24, where every f32 sum is exact, so the
order in which the card's atomic adds land cannot change a count: the
table is bit-equal to the CPU's, and to the JAX package's.

Guarantee (Cormode & Muthukrishnan): estimate >= true count, and
estimate <= true + eps*N with probability 1-delta for width >= e/eps,
depth >= ln(1/delta).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from veneur_tpu_torch.aggregation.state import resolve_device
from veneur_tpu_torch.utils.hashing import fnv1a_64, splitmix64

DEFAULT_DEPTH = 4
DEFAULT_WIDTH = 1 << 16

_M64 = (1 << 64) - 1
_GOLDEN = 0x9E3779B97F4A7C15


def _check_width(width: int) -> None:
    if width & (width - 1) or width <= 0:
        raise ValueError(f"count-min width must be a power of two, "
                         f"got {width} (column hashing masks low bits)")


def empty_counters(depth: int = DEFAULT_DEPTH, width: int = DEFAULT_WIDTH,
                   device=None) -> torch.Tensor:
    _check_width(width)
    return torch.zeros((depth, width), dtype=torch.float32,
                       device=resolve_device(device))


def _splitmix64_np(x: np.ndarray) -> np.ndarray:
    """utils.hashing.splitmix64 over a uint64 array (numpy wraps mod
    2^64, as the scalar's `& _M64` does)."""
    x = x + np.uint64(_GOLDEN)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def columns_for(member: bytes, depth: int = DEFAULT_DEPTH,
                width: int = DEFAULT_WIDTH) -> np.ndarray:
    """The depth column indices of one item: one 64-bit base hash,
    re-mixed for each row."""
    h = fnv1a_64(member)
    return np.asarray([splitmix64(h ^ ((_GOLDEN * (d + 1)) & _M64))
                       & (width - 1) for d in range(depth)], np.int32)


def columns_for_batch(members: List[bytes], depth: int = DEFAULT_DEPTH,
                      width: int = DEFAULT_WIDTH) -> np.ndarray:
    """columns_for over a batch, i32[B, depth]: the member hashes in one
    call into the C++ engine (native.hash64_batch), the per-row remix in
    numpy; bit-identical to the scalar."""
    from veneur_tpu_torch import native
    hs = native.hash64_batch(members)
    cols = np.empty((len(members), depth), np.int32)
    mask = np.uint64(width - 1)
    with np.errstate(over="ignore"):
        for d in range(depth):
            salt = np.uint64((_GOLDEN * (d + 1)) & _M64)
            cols[:, d] = (_splitmix64_np(hs ^ salt) & mask).astype(np.int32)
    return cols


def _flat_cols(counters: torch.Tensor, cols):
    """(flat cell index [B, D] with padding sent to cell 0, live mask):
    cols i32[B, D], a negative column is padding."""
    d, w = counters.shape
    cols = torch.as_tensor(cols, device=counters.device).long()
    live = cols >= 0
    rows = torch.arange(d, device=counters.device)[None, :]
    return torch.where(live, rows * w + cols, 0), live


def insert_batch(counters: torch.Tensor, cols, weights) -> torch.Tensor:
    """A new table with each item's weight added at its columns:
    counters f32[D, W], cols i32[B, D] (negative = padding, dropped),
    weights f32[B]. One index_add_ over all D rows of a copy; padding adds
    0.0 to cell 0, which changes no count and needs no host sync. The
    input table is not written, so a caller that fails later keeps it."""
    flat, live = _flat_cols(counters, cols)
    weights = torch.as_tensor(weights, dtype=torch.float32,
                              device=counters.device)
    upd = torch.where(live, weights[:, None], 0.0)
    out = counters.clone()
    out.view(-1).index_add_(0, flat.reshape(-1), upd.reshape(-1))
    return out


def estimate(counters: torch.Tensor, cols) -> torch.Tensor:
    """Point estimates f32[B]: the min over depth of the gathered cells
    (0 for a padded item)."""
    flat, live = _flat_cols(counters, cols)
    vals = counters.view(-1)[flat]
    return torch.where(live.all(dim=1), vals.min(dim=1).values, 0.0)


def insert_and_estimate(counters: torch.Tensor, cols, weights):
    """insert_batch, then estimate of the same items: (new table, f32[B])."""
    out = insert_batch(counters, cols, weights)
    return out, estimate(out, cols)


def merge(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sketch union: the cell-wise sum (a global tier adds tables)."""
    return a + b


class HeavyHitters:
    """Host-side top-K tracking over a device sketch.

    Each batch: insert on the device, estimate the batch's own items on
    the device, then keep a bounded dict of the highest-estimate members
    (pruned to 2K when it passes 4K). The sketch's one-sided error makes
    this a superset-biased top-K, the standard count-min heavy-hitter
    construction."""

    def __init__(self, k: int = 100, depth: int = DEFAULT_DEPTH,
                 width: int = DEFAULT_WIDTH, device=None):
        self.k = k
        self.depth = depth
        self.width = width
        self.device = resolve_device(device)
        self.counters = empty_counters(depth, width, self.device)
        self.candidates: Dict[bytes, float] = {}
        self.total = 0.0

    def update(self, members: List[bytes],
               weights: Optional[np.ndarray] = None) -> None:
        if not members:
            return
        cols = torch.from_numpy(columns_for_batch(members, self.depth,
                                                  self.width))
        w = (np.ones(len(members), np.float32) if weights is None
             else np.asarray(weights, np.float32))
        counters, est = insert_and_estimate(
            self.counters, cols.to(self.device),
            torch.from_numpy(w).to(self.device))
        est = est.cpu().tolist()
        # state changes only once the device work has come back
        self.counters = counters
        self.total += float(w.sum())
        for m, e in zip(members, est):
            self.candidates[m] = float(e)
        if len(self.candidates) > 4 * self.k:
            self._prune()

    def _prune(self) -> None:
        keep = sorted(self.candidates.items(), key=lambda kv: -kv[1])
        self.candidates = dict(keep[:2 * self.k])

    def top(self, k: Optional[int] = None) -> List[Tuple[bytes, float]]:
        k = k or self.k
        return sorted(self.candidates.items(), key=lambda kv: -kv[1])[:k]

    def reset(self) -> None:
        self.counters.zero_()
        self.candidates.clear()
        self.total = 0.0
