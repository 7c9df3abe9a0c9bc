"""Overload management: one controller that sees every pressure signal.

Host code, the same on every device: a copy of the JAX package's
reliability/overload.py, whose state machine, admission decisions and
exact per-class counts it reproduces decision for decision under one
clock and one signal source.

The pipeline already measures everything that matters under load —
packet-queue depth, flush-job backlog, flush lag vs. the deadline,
key-table capacity drops, spill occupancy, breaker states, checkpoint
age — but each signal acted alone: queue.Full dropped, capacity dropped,
deferred flushes deferred, with no coordination, no priority, and no
externally visible health state. The OverloadController samples those
signals on a poller thread and drives a hysteresis state machine

    HEALTHY -> PRESSURED -> SHEDDING -> CRITICAL

whose states activate concrete degradations, shed-last-by-priority:

- admission control at the ingest boundaries (token bucket per source,
  priority classifier: self-metrics never shed, `shed_priority_tags`
  matches shed last, everything else sheds first);
- degraded aggregation (timers switch to probabilistic sampling with
  recorded sample-rate correction; sets subsample members by hash
  prefix with an exact 2^k flush correction — accuracy degrades
  boundedly instead of rows dropping), see server/aggregator.py;
- flush protection (CRITICAL skips sink fan-out for low-priority rows
  but never the device update, forward, or checkpoint cadence), see
  server/server.py _do_flush.

Upgrades are immediate (pressure is an emergency); downgrades step one
level at a time, gated on a dwell time (`hold_s`) AND an exit margin
below the state's entry threshold, so a load step cannot flap the
state machine across a threshold (SALSA, arXiv:2102.12531, motivates
the bounded-degradation stance). Everything takes an injectable clock
and signal source, so tests run in virtual time — the CircuitBreaker
pattern (policy.py).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple

log = logging.getLogger("veneur_tpu_torch.reliability.overload")

HEALTHY = 0
PRESSURED = 1
SHEDDING = 2
CRITICAL = 3

STATE_NAMES = {HEALTHY: "healthy", PRESSURED: "pressured",
               SHEDDING: "shedding", CRITICAL: "critical"}

# priority classes, shed-first order: low sheds first, high sheds only
# under CRITICAL rate-limiting, self NEVER sheds (blinding the operator's
# own telemetry during an incident is the one unforgivable degradation)
CLASS_SELF = "self"
CLASS_HIGH = "high"
CLASS_LOW = "low"
CLASS_IMPORT = "import"

_SELF_PREFIXES = (b"veneur.", b"veneur_tpu.")


class TokenBucket:
    """Classic token bucket: `rate` tokens/s refill up to `burst`.
    Single-threaded by design (admission runs on the pipeline thread);
    the clock is injectable for virtual-time tests."""

    def __init__(self, rate: float, burst: float,
                 clock: Callable[[], float] = time.monotonic):
        self.rate = float(rate)
        self.burst = float(burst) if burst > 0 else float(rate)
        self._clock = clock
        self._tokens = self.burst
        self._last = clock()

    def allow(self, n: float = 1.0) -> bool:
        now = self._clock()
        self._tokens = min(self.burst,
                           self._tokens + (now - self._last) * self.rate)
        self._last = now
        if self._tokens >= n:
            self._tokens -= n
            return True
        return False


class PriorityClassifier:
    """Raw-bytes packet classifier (it must run before parsing — the
    whole point is to shed before paying the parse). Granularity is the
    packet: a multi-line datagram classifies by its strongest line
    (any high-priority tag match promotes the packet)."""

    def __init__(self, high_tags: Iterable = ()):
        self._high = tuple(
            t.encode() if isinstance(t, str) else bytes(t)
            for t in high_tags if t)

    def classify(self, data: bytes) -> str:
        if data.startswith(_SELF_PREFIXES):
            return CLASS_SELF
        for tag in self._high:
            if tag in data:
                return CLASS_HIGH
        return CLASS_LOW


class OverloadController:
    """Samples pressure signals and drives the health state machine.

    `signals` is a zero-arg callable returning {name: pressure} where
    each pressure is normalized to [0, 1] against that resource's
    capacity; overall pressure is the max (one saturated resource is
    an overloaded server — averaging would hide it).

    Admission policy by state (self-class always admitted):
      HEALTHY    admit everything
      PRESSURED  low-priority through the token bucket (if configured)
      SHEDDING   shed low-priority; degraded aggregation active
      CRITICAL   shed low; high through the token bucket; imports shed
    """

    def __init__(self, *,
                 signals: Callable[[], Dict[str, float]],
                 enter_pressured: float = 0.70,
                 enter_shedding: float = 0.85,
                 enter_critical: float = 0.95,
                 exit_margin: float = 0.10,
                 hold_s: float = 5.0,
                 admit_rate: float = 0.0,
                 admit_burst: float = 0.0,
                 timer_sample_rate: float = 0.5,
                 set_shift: int = 2,
                 shed_priority_tags: Iterable = (),
                 tenancy=None,
                 clock: Callable[[], float] = time.monotonic):
        self._signals = signals
        self._clock = clock
        self._enter = {PRESSURED: float(enter_pressured),
                       SHEDDING: float(enter_shedding),
                       CRITICAL: float(enter_critical)}
        self.exit_margin = float(exit_margin)
        self.hold_s = float(hold_s)
        self.admit_rate = float(admit_rate)
        self.admit_burst = float(admit_burst)
        self.timer_sample_rate = float(timer_sample_rate)
        self.set_shift = int(set_shift)
        self.classifier = PriorityClassifier(shed_priority_tags)
        # optional reliability/tenancy.py TenantFairness: layers the
        # weighted per-tenant bucket under the class ladder at SHEDDING+
        # and receives per-(tenant, class) counts for every decision
        self.tenancy = tenancy
        self._buckets: Dict[str, TokenBucket] = {}
        # accounting: exact per-class admit/shed counters. The lock only
        # guards the increments — imports arrive on gRPC/HTTP threads
        # while packets arrive on the pipeline thread, and the storm
        # benchmark asserts shed + admitted == sent EXACTLY.
        self._lock = threading.Lock()
        self.admitted: Dict[str, int] = {}
        self.shed: Dict[str, int] = {}
        self.degraded_flushes = 0
        self.state = HEALTHY
        # RESHARDING is a sub-state orthogonal to the pressure ladder:
        # ready-but-announcing. /readyz stays ok (peers keep sending —
        # the whole point of LIVE resharding), but health exposes it as
        # the machine-readable phase so the proxy prober and dashboards
        # can tell "moving shards" from "broken".
        self.resharding = False
        self.pressure = 0.0
        self.last_signals: Dict[str, float] = {}
        self.state_since = clock()
        # (clock_ts, from_state, to_state), newest last, bounded
        self.transitions: List[Tuple[float, int, int]] = []
        self._stop: Optional[threading.Event] = None
        self._thread: Optional[threading.Thread] = None

    # -- state machine -------------------------------------------------------
    @property
    def state_name(self) -> str:
        return STATE_NAMES[self.state]

    def poll(self) -> int:
        """Sample signals once and advance the state machine. Called by
        the poller thread in production, directly by virtual-time
        tests."""
        now = self._clock()
        try:
            sig = dict(self._signals() or {})
        except Exception as e:
            # a broken signal source must never take down the poller;
            # pressure holds at its last value for this tick
            log.warning("overload signal sampling failed: %s", e)
            sig = dict(self.last_signals)
        pressure = 0.0
        for v in sig.values():
            if v > pressure:
                pressure = min(float(v), 1.0)
        self.pressure = pressure
        self.last_signals = sig
        target = HEALTHY
        for s in (CRITICAL, SHEDDING, PRESSURED):
            if pressure >= self._enter[s]:
                target = s
                break
        cur = self.state
        if target > cur:
            # upgrades are immediate: waiting out a dwell during an
            # ingest storm just converts the dwell into queue drops
            self._transition(now, target)
        elif target < cur and now - self.state_since >= self.hold_s \
                and pressure < self._enter[cur] - self.exit_margin:
            # downgrades step ONE level with dwell + exit margin: a
            # load step that hovers at a threshold cannot flap
            self._transition(now, cur - 1)
        return self.state

    def _transition(self, now: float, to: int) -> None:
        log.info("overload state %s -> %s (pressure=%.3f, signals=%s)",
                 STATE_NAMES[self.state], STATE_NAMES[to], self.pressure,
                 {k: round(v, 3) for k, v in self.last_signals.items()})
        self.transitions.append((now, self.state, to))
        del self.transitions[:-256]
        self.state = to
        self.state_since = now

    # -- resharding sub-state ------------------------------------------------
    def enter_resharding(self) -> None:
        self.resharding = True

    def exit_resharding(self) -> None:
        self.resharding = False

    # -- admission -----------------------------------------------------------
    def _bucket_allow(self, key: str) -> bool:
        if self.admit_rate <= 0:
            return True
        b = self._buckets.get(key)
        if b is None:
            b = self._buckets[key] = TokenBucket(
                self.admit_rate, self.admit_burst, self._clock)
        return b.allow()

    def admit(self, data: bytes, source: str = "statsd") -> bool:
        """Admission decision for one raw wire packet at an ingest
        boundary. Token buckets are keyed per (source, class) so a
        flood of low-priority traffic cannot starve high-priority
        packets out of their own bucket. With tenancy configured, the
        tenant's weighted bucket layers under the class ladder at
        SHEDDING+ (mirror of dogstatsd.cpp admit_datagram2): low-class
        traffic the ladder would shed outright instead runs the
        tenant's bucket, so isolated tenants keep their budget while a
        noisy one is throttled to its share."""
        cls = self.classifier.classify(data)
        s = self.state
        ten = self.tenancy
        tenant = ten.resolve(data) if ten is not None else None
        fair = ten is not None and ten.base_rate > 0
        if s == HEALTHY or cls == CLASS_SELF:
            ok = True
        elif cls == CLASS_HIGH:
            ok = s < CRITICAL or self._bucket_allow(source + "/high")
            if ok and fair and s >= SHEDDING:
                ok = ten.allow(tenant)
        elif s >= SHEDDING:
            ok = ten.allow(tenant) if fair else False
        else:  # low priority under PRESSURED
            ok = self._bucket_allow(source)
        with self._lock:
            d = self.admitted if ok else self.shed
            d[cls] = d.get(cls, 0) + 1
        if ten is not None:
            ten.count(tenant, cls, ok)
        return ok

    def import_blocked(self) -> bool:
        """Imports (global-tier merges) shed only at CRITICAL: they are
        pre-aggregated sketches — dense value per byte — so they are the
        last boundary to close."""
        return self.state >= CRITICAL

    def admit_import(self, n: int = 1) -> bool:
        ok = not self.import_blocked()
        with self._lock:
            d = self.admitted if ok else self.shed
            d[CLASS_IMPORT] = d.get(CLASS_IMPORT, 0) + n
        return ok

    # -- degradation knobs ---------------------------------------------------
    def degraded_timer_rate(self) -> float:
        """Timer admit fraction for the aggregators: <1.0 switches timers
        to probabilistic sampling with recorded sample-rate correction
        (exact in expectation; see Aggregator._histo_admit)."""
        if self.state >= SHEDDING and 0.0 < self.timer_sample_rate < 1.0:
            return self.timer_sample_rate
        return 1.0

    def degraded_set_shift(self) -> int:
        """HLL member-subsample bits: admit a member iff the low k bits
        of its 64-bit hash are zero (rate 2^-k) and multiply the flushed
        estimate by 2^k. Deterministic per member, so repeated members
        stay idempotent — cardinality accuracy degrades boundedly
        instead of set rows dropping."""
        return self.set_shift if self.state >= SHEDDING else 0

    def note_degraded_flush(self) -> None:
        with self._lock:
            self.degraded_flushes += 1

    def count_flush_shed(self, n: int) -> None:
        """Rows withheld from sink fan-out by CRITICAL flush
        protection (class `flush`)."""
        if n <= 0:
            return
        with self._lock:
            self.shed["flush"] = self.shed.get("flush", 0) + n

    # -- telemetry snapshots -------------------------------------------------
    @property
    def admitted_total(self) -> int:
        with self._lock:
            return sum(self.admitted.values())

    def shed_snapshot(self) -> List[Tuple[Tuple[str], int]]:
        """Labeled pairs for a registry counter callback."""
        with self._lock:
            return [((cls,), n) for cls, n in sorted(self.shed.items())]

    # -- native-ring admission push-down / fold-back -------------------------
    def native_admission_params(self) -> tuple:
        """(state, admit_rate, admit_burst, high_tags) snapshot for
        push-down into the C++ reader ring (vr_admission_set), which
        replicates admit(source='statsd') off-GIL at the ring boundary.
        Pushed on every poll so state transitions reach the ring within
        one poll interval."""
        tags = tuple(t.decode("utf-8", "surrogateescape")
                     for t in self.classifier._high)
        return self.state, self.admit_rate, self.admit_burst, tags

    def fold_native_counts(self, drained: dict) -> None:
        """Fold the exact per-class admitted/shed deltas drained from the
        C++ reader ring (vr_admission_counters drain-and-reset) into the
        same counters admit() feeds, preserving sent == admitted + shed
        exactly across both admission sites."""
        with self._lock:
            for cls, n in drained.get("admitted", {}).items():
                if n:
                    self.admitted[cls] = self.admitted.get(cls, 0) + int(n)
            for cls, n in drained.get("shed", {}).items():
                if n:
                    self.shed[cls] = self.shed.get(cls, 0) + int(n)
        # per-tenant deltas (already summed across rings by the drain
        # fold) route to the tenancy ledger, same exactness contract
        if self.tenancy is not None and drained.get("tenants"):
            self.tenancy.fold_native(drained["tenants"])

    # -- poller thread -------------------------------------------------------
    def start(self, poll_interval: float,
              on_poll: Optional[Callable[["OverloadController"], None]]
              = None) -> None:
        if self._thread is not None:
            return
        self._stop = threading.Event()

        def loop():
            while not self._stop.wait(poll_interval):
                self.poll()
                if on_poll is not None:
                    try:
                        on_poll(self)
                    except Exception as e:
                        log.warning("overload on_poll hook failed: %s", e)

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="overload-poller")
        self._thread.start()

    def stop(self) -> None:
        if self._stop is not None:
            self._stop.set()
        if self._thread is not None:
            self._thread.join(2.0)
            self._thread = None
            self._stop = None
