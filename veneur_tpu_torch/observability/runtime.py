"""Device sync timing for dispatch sites that launch work asynchronously.

CUDA work is enqueued on a stream and returns at once, so a host clock
around a launch measures the enqueue. `sync_and_time(token)` waits for
the work that produced `token`: it records a CUDA event on the current
stream of the token's device, after the token's producer, and waits on
that event (no `.item()`, no copy). `SampledSync` does so on every
`every`-th token only, so the other launches pay the enqueue alone.
"""

from __future__ import annotations

import time

import torch


def _first_tensor(token):
    if isinstance(token, torch.Tensor):
        return token
    if isinstance(token, dict):
        token = list(token.values())
    if isinstance(token, (tuple, list)):
        for t in token:
            found = _first_tensor(t)
            if found is not None:
                return found
    return None


def sync_and_time(token) -> int:
    """Wall nanoseconds until the work that produced `token` (a tensor or
    a tuple/list/dict of tensors) has finished on its device. A token on
    the CPU is ready when it exists."""
    t0 = time.perf_counter_ns()
    t = _first_tensor(token)
    if t is not None and t.device.type == "cuda":
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(t.device))
        done.synchronize()
    return time.perf_counter_ns() - t0


class SampledSync:
    """Every `every`-th token is synced through sync_and_time(), so
    `sync_ns` accumulates device completion time while the other N-1
    launches pay only their enqueue."""

    def __init__(self, every: int = 64) -> None:
        self.every = max(1, int(every))
        self.count = 0
        self.synced = 0
        self.sync_ns = 0

    def tick(self, token) -> int:
        """Count one launch; on the sampling edge, wait for `token` and
        accumulate the wait. Returns the sampled nanoseconds (0 when this
        launch was not sampled)."""
        self.count += 1
        if self.count % self.every:
            return 0
        dt = sync_and_time(token)
        self.synced += 1
        self.sync_ns += dt
        return dt
