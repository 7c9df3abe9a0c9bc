"""The traced slice: torch.profiler over a few seconds that span a flush,
read back from its Chrome trace.

The profiler records CPU operations on the thread that starts it, so the
harness starts and stops it on the Server's pipeline thread (the thread
that launches every ingest step); CUDA kernels, copies and runtime calls
are recorded for the whole process. The harness puts named ranges
(`record_function`) around the calls into each layer on that thread;
a kernel belongs to a range when the runtime call that launched it lies
inside the range on the same thread.
"""

from __future__ import annotations

import bisect
import json
import os
import shutil
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
LAUNCH_PREFIXES = ("cudaLaunch", "cuLaunch")


def read_trace(prof) -> list:
    """The profile's Chrome trace events (the file is deleted again)."""
    d = tempfile.mkdtemp(prefix="bench_trace_")
    try:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f).get("traceEvents", [])
    finally:
        shutil.rmtree(d, ignore_errors=True)


def _union(intervals):
    """Merged [start, end) intervals of a list of (start, end)."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


class Slice:
    """What one traced slice holds, in seconds."""

    def __init__(self, events: list, window_s: float):
        self.window_s = window_s
        dev = [e for e in events if e.get("cat") in DEVICE_CATS
               and "dur" in e]
        self.device = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                        e["name"], e.get("args", {})) for e in dev]
        busy = _union([(a, b) for a, b, _n, _a in self.device])
        self.busy = busy
        self.busy_s = sum(b - a for a, b in busy) / 1e6
        launches = [e for e in events if e.get("cat") in LAUNCH_CATS
                    and e["name"].startswith(LAUNCH_PREFIXES)]
        counts = {}
        for e in launches:
            counts[e.get("tid")] = counts.get(e.get("tid"), 0) + 1
        # the thread that launches most: the pipeline thread
        self.tid = max(counts, key=counts.get) if counts else None
        host = [e for e in events if e.get("cat") in HOST_CATS
                and e.get("tid") == self.tid and "dur" in e]
        self.host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                            e["name"]) for e in host)
        self._launch = sorted((float(e["ts"]), e.get("args", {}).get(
            "correlation")) for e in launches if e.get("tid") == self.tid)

    def _correlations(self, name: str) -> set:
        """Correlation ids of the launches made inside `name`'s ranges."""
        spans = [(a, b) for a, b, n in self.host if n == name]
        times = [t for t, _c in self._launch]
        out = set()
        for a, b in spans:
            i = bisect.bisect_left(times, a)
            while i < len(times) and times[i] <= b:
                out.add(self._launch[i][1])
                i += 1
        return out

    def device_s(self, match=None, in_range=None) -> float:
        """Seconds of device work whose name contains `match` and, with
        `in_range`, that was launched inside that named range."""
        corr = self._correlations(in_range) if in_range else None
        total = 0.0
        for a, b, n, args in self.device:
            if match is not None and match not in n:
                continue
            if corr is not None and args.get("correlation") not in corr:
                continue
            total += b - a
        return total / 1e6

    def kernels(self, match: str) -> list:
        """(start, seconds, args) of each kernel whose name holds `match`,
        in start order."""
        return sorted((a, (b - a) / 1e6, args)
                      for a, b, n, args in self.device if match in n)

    def top_ops(self, k: int = 10) -> list:
        by = {}
        for a, b, n, _args in self.device:
            key = n[:80]
            by[key] = by.get(key, 0.0) + (b - a) / 1e6
        return sorted(([n, s] for n, s in by.items()),
                      key=lambda x: -x[1])[:k]

    def _host_at(self, t: float) -> str:
        """The innermost operation on the pipeline thread at time t."""
        best = None
        i = bisect.bisect_right(self.host, (t, float("inf"), ""))
        for a, b, n in reversed(self.host[max(0, i - 4000):i]):
            if a <= t < b and (best is None or b - a < best[1] - best[0]):
                best = (a, b, n)
        return best[2] if best else "pipeline:outside any operation"

    def idle_gaps(self, k: int = 10) -> list:
        gaps = [(b0, a1) for (_a0, b0), (a1, _b1) in
                zip(self.busy, self.busy[1:])]
        gaps.sort(key=lambda g: g[0] - g[1])
        return [[self._host_at((a + b) / 2), (b - a) / 1e6]
                for a, b in gaps[:k]]


class CardClock:
    """The card's busy time over a span of the untraced run: the profiler
    recording CUDA activity alone (the kernels, copies and memsets of every
    thread; no operation of the host), read back in memory as the union
    of their intervals."""

    def __init__(self):
        import torch
        self.torch = torch
        self.prof = None
        self.kinds, self.top = {}, []
        # the first profile of a process initializes CUPTI: in set-up
        self.start()
        self.stop()

    def start(self):
        prof = self.torch.profiler
        self.prof = prof.profile(activities=[prof.ProfilerActivity.CUDA])
        self.prof.start()

    def stop(self) -> float:
        """Seconds in which the card ran something since start()."""
        self.torch.cuda.synchronize()
        self.prof.stop()
        cuda = self.torch.autograd.DeviceType.CUDA
        spans, kinds, by = [], {}, {}
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() != cuda:
                kind = "host"
            elif e.is_user_annotation():
                kind = "card range"         # a named range, not work
            else:
                kind = "card"
                spans.append((e.start_ns(), e.start_ns() + e.duration_ns()))
                s, n = by.get(e.name()[:60], (0, 0))
                by[e.name()[:60]] = (s + e.duration_ns() / 1e9, n + 1)
            kinds[kind] = kinds.get(kind, 0) + 1
        self.prof, self.kinds = None, kinds
        self.top = sorted(([k, s, n] for k, (s, n) in by.items()),
                          key=lambda x: -x[1])[:8]
        return sum(b - a for a, b in _union(spans)) / 1e9
