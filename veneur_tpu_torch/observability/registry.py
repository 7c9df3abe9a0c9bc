"""The telemetry registry: one source of truth for self-metrics.

The reference scatters its self-observation across ad-hoc Server fields
and per-worker counters (worker.go:513, flusher.go:300-336); this module
replaces that with a single thread-safe registry that THREE consumers
read — the JSON `/stats` endpoint, the per-interval self-metric flush
(server._report_self_metrics), and the Prometheus `/metrics` exposition
(observability/export.py) — so they can never disagree.

Three owned instrument kinds plus a collector hook:

- Counter: monotonically increasing float, optional label names. inc()
  is atomic under the instrument's lock — this is what fixes the
  lost-increment race on Server.imported_total (server.py `+=` from
  multiple threads).
- Gauge: last-write-wins value per label set.
- Timer: duration samples folded into the repo's OWN fixed-shape
  t-digest (ops/tdigest.py, Dunning & Ertl arXiv:1902.04023) on the
  registry's device — the observability layer exercises the same
  mergeable-sketch machinery it observes. Quantiles (p50/p95/p99) come
  out of `ops.tdigest.quantiles`, the digest kernel on the card.
- callback(): a read-through collector for values owned elsewhere
  (circuit-breaker state, spill occupancy, packet counters folded from
  C++ readers) — registered once, evaluated at collect time, so the
  registry exports live values without double-owning them.

Timers buffer raw observations and fold lazily in fixed-size padded
batches of _FOLD samples, so every fold launches the same shapes.
"""

from __future__ import annotations

import logging
import math
import threading
from typing import Callable, Dict, Iterable, List, Optional, Tuple

log = logging.getLogger("veneur_tpu_torch.observability")

# quantiles every Timer exports (the exposition's summary lines)
TIMER_QUANTILES = (0.5, 0.95, 0.99)

# fixed fold width — see module docstring
_FOLD = 1024

# small exact-extreme reservation: self-timers care about tail accuracy
# and hold few distinct values per interval
_EXACT_EXTREMES = 16


LabelValues = Tuple[str, ...]


def _label_key(labelnames: Tuple[str, ...], labels: Dict) -> LabelValues:
    if set(labels) != set(labelnames):
        raise ValueError(
            f"labels {sorted(labels)} != declared {sorted(labelnames)}")
    return tuple(str(labels[n]) for n in labelnames)


class Counter:
    """Monotonic counter; inc() under a lock is the atomic replacement
    for the racy `server.attr += 1` pattern."""

    kind = "counter"

    def __init__(self, name: str, help: str = "",
                 labelnames: Tuple[str, ...] = ()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._values: Dict[LabelValues, float] = {}

    def inc(self, n: float = 1.0, **labels) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name}: negative inc {n}")
        key = _label_key(self.labelnames, labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + n

    def value(self, **labels) -> float:
        key = _label_key(self.labelnames, labels)
        with self._lock:
            return self._values.get(key, 0.0)

    def samples(self) -> List[Tuple[LabelValues, float]]:
        with self._lock:
            if not self._values and not self.labelnames:
                return [((), 0.0)]
            return sorted(self._values.items())


class Gauge:
    kind = "gauge"

    def __init__(self, name: str, help: str = "",
                 labelnames: Tuple[str, ...] = ()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._values: Dict[LabelValues, float] = {}

    def set(self, v: float, **labels) -> None:
        key = _label_key(self.labelnames, labels)
        with self._lock:
            self._values[key] = float(v)

    def value(self, **labels) -> float:
        key = _label_key(self.labelnames, labels)
        with self._lock:
            return self._values.get(key, 0.0)

    def samples(self) -> List[Tuple[LabelValues, float]]:
        with self._lock:
            if not self._values and not self.labelnames:
                return [((), 0.0)]
            return sorted(self._values.items())


class TimerStat:
    """One label set's snapshot: exact count/sum plus sketch quantiles."""

    __slots__ = ("count", "sum", "quantiles")

    def __init__(self, count: int, sum_: float, quantiles: Dict[float, float]):
        self.count = count
        self.sum = sum_
        self.quantiles = quantiles


class _TimerState:
    __slots__ = ("buf", "table", "count", "sum")

    def __init__(self):
        self.buf: List[float] = []
        self.table = None       # ops.tdigest.TDigestTable, scalar key
        self.count = 0
        self.sum = 0.0


class Timer:
    """Duration sketch backed by ops/tdigest.py. observe() is an append
    under the lock (plus one device fold per _FOLD observations — flush
    phases observe a handful of samples per ~10s interval, so folds are
    effectively scrape-time work)."""

    kind = "summary"

    def __init__(self, name: str, help: str = "",
                 labelnames: Tuple[str, ...] = (),
                 compression: float = 50.0, device="cpu"):
        self.name = name
        self.device = device
        self.help = help
        self.labelnames = tuple(labelnames)
        self.compression = float(compression)
        self._lock = threading.Lock()
        self._states: Dict[LabelValues, _TimerState] = {}

    def observe(self, value: float, **labels) -> None:
        value = float(value)
        if not math.isfinite(value):
            return
        key = _label_key(self.labelnames, labels)
        with self._lock:
            st = self._states.get(key)
            if st is None:
                st = self._states[key] = _TimerState()
            st.buf.append(value)
            st.count += 1
            st.sum += value
            if len(st.buf) >= _FOLD:
                self._fold(st)

    def _fold(self, st: _TimerState) -> None:
        """Fold the buffered samples into the digest (caller holds the
        lock). Zero-padded to _FOLD with zero WEIGHT — empty slots, not
        zero-valued samples — so every fold has the same shapes."""
        if not st.buf:
            return
        import numpy as np

        from veneur_tpu_torch.ops import tdigest
        if st.table is None:
            st.table = tdigest.empty_table(
                (), compression=self.compression,
                exact_extremes=_EXACT_EXTREMES, device=self.device)
        buf, st.buf = st.buf, []
        for i in range(0, len(buf), _FOLD):
            chunk = buf[i:i + _FOLD]
            vals = np.zeros(_FOLD, np.float32)
            wts = np.zeros(_FOLD, np.float32)
            vals[:len(chunk)] = chunk
            wts[:len(chunk)] = 1.0
            st.table = tdigest.add_batch_single(
                st.table, vals, wts, compression=self.compression,
                exact_extremes=_EXACT_EXTREMES)

    def snapshot(self, qs: Tuple[float, ...] = TIMER_QUANTILES
                 ) -> List[Tuple[LabelValues, TimerStat]]:
        import numpy as np
        out = []
        with self._lock:
            states = sorted(self._states.items())
            if not states and not self.labelnames:
                states = [((), _TimerState())]
            for key, st in states:
                self._fold(st)
                quantiles: Dict[float, float] = {}
                if qs and st.table is not None and st.count:
                    from veneur_tpu_torch.ops import tdigest
                    vals = tdigest.quantiles(
                        st.table, np.asarray(qs, np.float32)).cpu().numpy()
                    quantiles = {q: float(v) for q, v in zip(qs, vals)
                                 if math.isfinite(float(v))}
                out.append((key, TimerStat(st.count, st.sum, quantiles)))
        return out

    # collect-protocol alias so families iterate uniformly
    def samples(self) -> List[Tuple[LabelValues, TimerStat]]:
        return self.snapshot()


class _CallbackMetric:
    """Read-through collector: the value(s) live elsewhere; `fn` is
    evaluated at collect time. `fn` may return a scalar (unlabeled), a
    dict {labelvalues_tuple: value}, or an iterable of
    (labelvalues_tuple, value) pairs."""

    def __init__(self, name: str, fn: Callable, kind: str = "gauge",
                 help: str = "", labelnames: Tuple[str, ...] = ()):
        if kind not in ("counter", "gauge"):
            raise ValueError(f"callback kind {kind!r}")
        self.name = name
        self.fn = fn
        self.kind = kind
        self.help = help
        self.labelnames = tuple(labelnames)

    def samples(self) -> List[Tuple[LabelValues, float]]:
        try:
            got = self.fn()
        except Exception as e:
            # a broken collector degrades that one family, never the
            # scrape (an exporter that 500s on one bad read is useless
            # during exactly the incident it exists for)
            log.warning("telemetry collector %s failed: %s", self.name, e)
            return []
        if got is None:
            return []
        if isinstance(got, (int, float)):
            return [((), float(got))]
        if isinstance(got, dict):
            return sorted((tuple(k) if isinstance(k, tuple) else (str(k),),
                           float(v)) for k, v in got.items())
        return sorted((tuple(k), float(v)) for k, v in got)


class TelemetryRegistry:
    """Thread-safe name → instrument map. Registration is get-or-create:
    re-registering an identical (class, labelnames) pair returns the
    existing instrument; a conflicting re-registration raises (the
    check_metric_names.py lint additionally enforces one registration
    SITE per name across the tree)."""

    def __init__(self, timer_compression: float = 50.0, device=None):
        from veneur_tpu_torch.aggregation.state import resolve_device
        self.timer_compression = float(timer_compression)
        # timer digests live here: the card unless the caller names
        # another device
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        self._metrics: Dict[str, object] = {}

    def _register(self, cls, name: str, help: str,
                  labelnames: Iterable[str], **kw):
        labelnames = tuple(labelnames)
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if (type(existing) is cls
                        and existing.labelnames == labelnames):
                    return existing
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{type(existing).__name__}{existing.labelnames}")
            m = cls(name, help=help, labelnames=labelnames, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "",
                labelnames: Iterable[str] = ()) -> Counter:
        return self._register(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Iterable[str] = ()) -> Gauge:
        return self._register(Gauge, name, help, labelnames)

    def timer(self, name: str, help: str = "",
              labelnames: Iterable[str] = (),
              compression: Optional[float] = None) -> Timer:
        return self._register(
            Timer, name, help, labelnames,
            compression=(self.timer_compression if compression is None
                         else compression), device=self.device)

    def callback(self, name: str, fn: Callable, kind: str = "gauge",
                 help: str = "",
                 labelnames: Iterable[str] = ()) -> _CallbackMetric:
        labelnames = tuple(labelnames)
        with self._lock:
            if name in self._metrics:
                raise ValueError(f"metric {name!r} already registered")
            m = _CallbackMetric(name, fn, kind=kind, help=help,
                                labelnames=labelnames)
            self._metrics[name] = m
            return m

    def get(self, name: str):
        with self._lock:
            return self._metrics[name]

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def collect(self) -> List[object]:
        """Instruments in name order; each has .name/.kind/.help/
        .labelnames/.samples(). samples() values are floats, except
        Timers which yield TimerStat."""
        with self._lock:
            metrics = sorted(self._metrics.items())
        return [m for _, m in metrics]

    def flat_values(self) -> Dict[str, float]:
        """The JSON-friendly view `/stats` serves: one key per series,
        labeled series as name{k=v,...}; timers contribute exact
        .count/.sum (quantile extraction is scrape-time work that a
        JSON poller doesn't need)."""
        out: Dict[str, float] = {}

        def series(name, labelnames, labelvalues):
            if not labelnames:
                return name
            inner = ",".join(f"{k}={v}"
                             for k, v in zip(labelnames, labelvalues))
            return f"{name}{{{inner}}}"

        for m in self.collect():
            if isinstance(m, Timer):
                for lv, stat in m.snapshot(qs=()):
                    base = series(m.name, m.labelnames, lv)
                    out[base + ".count"] = float(stat.count)
                    out[base + ".sum"] = float(stat.sum)
            else:
                for lv, v in m.samples():
                    out[series(m.name, m.labelnames, lv)] = float(v)
        return out
