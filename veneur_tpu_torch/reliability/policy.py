"""Retry and circuit-breaker policies for egress paths.

Both are pure Python with injectable clock/sleep so tests run in virtual
time. Defaults are reference-compatible: a RetryPolicy is only built when
`sink_retry_max > 0`, a CircuitBreaker only when
`circuit_failure_threshold > 0` — unconfigured, every egress path keeps
today's single-attempt behavior byte for byte.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from veneur_tpu_torch.utils.hashing import splitmix64

# CircuitBreaker states; the numeric values ARE the wire values of the
# veneur.circuit.state gauge (0 healthy, 2 fully tripped, 1 probing).
CLOSED, HALF_OPEN, OPEN = 0, 1, 2
_STATE_NAMES = {CLOSED: "closed", HALF_OPEN: "half-open", OPEN: "open"}


class CircuitOpenError(RuntimeError):
    """An egress call was refused because the destination's breaker is
    open — counted as a skip, never silent."""


class RetryPolicy:
    """Exponential backoff with deterministic seeded jitter.

    backoff(attempt) = min(base_ms * 2^attempt, max_ms) * (1 + U*jitter)
    where U in [0, 1) is derived from splitmix64(seed, attempt) — the
    same (seed, attempt) always yields the same delay, so retry schedules
    are reproducible in tests and across a fleet each instance decorrelates
    by seeding with something instance-unique.

    `deadline_s` bounds the WHOLE retry loop (a retry that cannot finish
    before the deadline is not started); `attempt_timeout_s` is the
    per-attempt budget, advisory for callers whose underlying call takes
    a timeout parameter (a thread cannot be interrupted mid-call).
    """

    def __init__(self, max_retries: int = 2, base_ms: float = 100.0,
                 max_ms: float = 10_000.0, jitter: float = 0.5,
                 seed: int = 0, attempt_timeout_s: Optional[float] = None,
                 deadline_s: Optional[float] = None):
        if max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        self.max_retries = int(max_retries)
        self.base_ms = float(base_ms)
        self.max_ms = float(max_ms)
        self.jitter = float(jitter)
        self.seed = int(seed)
        self.attempt_timeout_s = attempt_timeout_s
        self.deadline_s = deadline_s

    def backoff(self, attempt: int) -> float:
        """Delay in seconds before retry number `attempt` (0-based)."""
        base = min(self.base_ms * (2.0 ** attempt), self.max_ms) / 1000.0
        u = splitmix64(((self.seed & 0xFFFFFFFF) << 20) ^ attempt) / 2.0**64
        return base * (1.0 + u * self.jitter)

    def run(self, fn: Callable, *, sleep: Callable[[float], None] = None,
            clock: Callable[[], float] = None,
            on_retry: Optional[Callable] = None):
        """Call `fn()` with up to max_retries retries. `on_retry(attempt,
        exc, delay)` fires before each backoff sleep. The final failure
        re-raises — callers keep their own error accounting."""
        sleep = time.sleep if sleep is None else sleep
        clock = time.monotonic if clock is None else clock
        start = clock()
        attempt = 0
        while True:
            try:
                return fn()
            except CircuitOpenError:
                # retrying into an open breaker is pure delay: the
                # cooldown is longer than any backoff step by design
                raise
            except Exception as e:
                if attempt >= self.max_retries:
                    raise
                delay = self.backoff(attempt)
                if (self.deadline_s is not None
                        and clock() - start + delay > self.deadline_s):
                    raise
                if on_retry is not None:
                    on_retry(attempt, e, delay)
                sleep(delay)
                attempt += 1


class CircuitBreaker:
    """Per-destination breaker: closed -> open -> half-open.

    `failure_threshold` consecutive failures open the circuit (the
    degenerate 100%-rate window — consecutive counting keeps the state
    machine exactly testable where a sampled-rate window is not). While
    open, allow() is False until `cooldown_s` has elapsed, then ONE probe
    is admitted (half-open); its success closes the circuit, its failure
    re-opens it for another cooldown. Thread-safe: sink flush threads,
    aux forward threads, and the self-telemetry reporter all touch it.
    """

    def __init__(self, failure_threshold: int = 5, cooldown_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic):
        if failure_threshold <= 0:
            raise ValueError("failure_threshold must be > 0")
        self.failure_threshold = int(failure_threshold)
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._probe_in_flight = False
        self.opens_total = 0
        self.rejected_total = 0

    @property
    def state(self) -> int:
        with self._lock:
            # an expired cooldown reads as half-open even before the
            # next allow() call arms the probe
            if (self._state == OPEN
                    and self._clock() - self._opened_at >= self.cooldown_s):
                return HALF_OPEN
            return self._state

    @property
    def state_name(self) -> str:
        return _STATE_NAMES[self.state]

    def allow(self) -> bool:
        """May a call proceed right now? Open-state refusals are counted
        (rejected_total); a True in half-open claims the single probe."""
        with self._lock:
            if self._state == CLOSED:
                return True
            if self._state == OPEN:
                if self._clock() - self._opened_at >= self.cooldown_s:
                    self._state = HALF_OPEN
                    self._probe_in_flight = True
                    return True
                self.rejected_total += 1
                return False
            # HALF_OPEN: one probe at a time
            if self._probe_in_flight:
                self.rejected_total += 1
                return False
            self._probe_in_flight = True
            return True

    def record_success(self) -> None:
        with self._lock:
            self._state = CLOSED
            self._failures = 0
            self._probe_in_flight = False

    def record_failure(self) -> None:
        with self._lock:
            self._failures += 1
            if (self._state == HALF_OPEN
                    or self._failures >= self.failure_threshold):
                self._state = OPEN
                self._opened_at = self._clock()
                self._probe_in_flight = False
                self._failures = 0
                self.opens_total += 1
