"""Device runtime telemetry: sync timing, device memory, profiler capture.

CUDA work is enqueued on a stream and returns at once, so a host clock
around a launch measures the enqueue. `sync_and_time(token)` waits for
the work that produced `token`: it records a CUDA event on the current
stream of the token's device, after the token's producer, and waits on
that event (no `.item()`, no copy). `SampledSync` does so on every
`every`-th token only, so the other launches pay the enqueue alone.

`hbm_stats` reads each card's allocator (the `veneur.device.hbm_*`
collectors) and `capture_profile` runs torch.profiler with CUDA activity
for `GET /debug/profile`.
"""

from __future__ import annotations

import tempfile
import threading
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
        # vtlint: disable=torch-hot-path -- deliberate sampled device sync
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


# -- device memory ---------------------------------------------------------

def hbm_stats() -> dict:
    """{"cuda:<i>": {"bytes_in_use", "peak_bytes_in_use", "bytes_limit"}}
    from each card's caching allocator (torch.cuda.memory_stats: tensor
    bytes allocated now and at peak) and torch.cuda.mem_get_info (the
    card's total memory). Empty without a card: callers treat absence as
    'no series'."""
    if not torch.cuda.is_available():
        return {}
    out = {}
    for i in range(torch.cuda.device_count()):
        ms = torch.cuda.memory_stats(i)
        _free, total = torch.cuda.mem_get_info(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": int(ms.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(ms.get("allocated_bytes.all.peak", 0)),
            "bytes_limit": int(total),
        }
    return out


def hbm_bytes_in_use() -> dict:
    return {(label,): s["bytes_in_use"] for label, s in hbm_stats().items()}


def hbm_bytes_peak() -> dict:
    return {(label,): s["peak_bytes_in_use"]
            for label, s in hbm_stats().items()}


# -- on-demand profiler capture ---------------------------------------------

_profile_lock = threading.Lock()


def init_profiler() -> None:
    """Start and stop one empty CUDA profile on the calling thread. The
    profiler's CUDA tracing initializes at its first start, which takes
    long enough to eat a short capture's window, and wants to run on the
    thread that initialized CUDA; a server that serves captures from its
    HTTP threads calls this once where it built its device state."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        pass


def capture_profile(seconds: float, base_dir: str = None) -> str:
    """Run torch.profiler (CPU and CUDA activity) for `seconds` and return
    the directory holding its Chrome trace, trace.json. One capture at a
    time per process (the profiler is a global resource); a concurrent
    request raises RuntimeError, which the HTTP layer maps to 409."""
    if not _profile_lock.acquire(blocking=False):
        raise RuntimeError("profile capture already in progress")
    try:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        trace_dir = tempfile.mkdtemp(prefix="veneur-trace-", dir=base_dir)
        with profile(activities=acts) as prof:
            time.sleep(max(0.0, float(seconds)))
        prof.export_chrome_trace(f"{trace_dir}/trace.json")
        return trace_dir
    finally:
        _profile_lock.release()
