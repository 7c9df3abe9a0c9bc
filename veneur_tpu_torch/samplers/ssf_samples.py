"""SSFSample constructor helpers (reference ssf/samples.go:
Count/Gauge/Histogram/Timing/Set/Status + RandomlySample)."""

from __future__ import annotations

import random
import time
from typing import Dict, List, Optional

from veneur_tpu_torch.proto import ssf_pb2


def _mk(metric, name, value, tags, unit="", message="", status=None,
        timestamp=None):
    s = ssf_pb2.SSFSample(
        metric=metric, name=name, value=float(value),
        timestamp=int(timestamp if timestamp is not None
                      else time.time() * 1e9),
        sample_rate=1.0, unit=unit, message=message)
    if status is not None:
        s.status = status
    if tags:
        for k, v in tags.items():
            s.tags[k] = v
    return s


def count(name: str, value: float, tags: Optional[Dict] = None, **kw):
    return _mk(ssf_pb2.SSFSample.COUNTER, name, value, tags, **kw)


def gauge(name: str, value: float, tags: Optional[Dict] = None, **kw):
    return _mk(ssf_pb2.SSFSample.GAUGE, name, value, tags, **kw)


def histogram(name: str, value: float, tags: Optional[Dict] = None, **kw):
    return _mk(ssf_pb2.SSFSample.HISTOGRAM, name, value, tags, **kw)


def timing(name: str, duration_s: float, tags: Optional[Dict] = None, **kw):
    """Duration as a nanosecond-resolution timer (samples.go:209 Timing with
    time.Nanosecond resolution)."""
    return _mk(ssf_pb2.SSFSample.HISTOGRAM, name, duration_s * 1e9, tags,
               unit="ns", **kw)


def set_(name: str, value: str, tags: Optional[Dict] = None, **kw):
    s = _mk(ssf_pb2.SSFSample.SET, name, 0.0, tags, **kw)
    s.message = value  # set member rides the message field (samples.go:197)
    return s


def status(name: str, state: int, tags: Optional[Dict] = None,
           message: str = "", **kw):
    return _mk(ssf_pb2.SSFSample.STATUS, name, float(state), tags,
               message=message, **kw)


def randomly_sample(rate: float, *samples) -> List:
    """Keep samples with probability `rate`, marking the effective sample
    rate (samples.go:128-134 RandomlySample)."""
    if rate >= 1.0:
        return list(samples)
    kept = []
    for s in samples:
        if random.random() < rate:
            s.sample_rate = rate
            kept.append(s)
    return kept
