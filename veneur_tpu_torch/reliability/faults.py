"""Process-global fault injector for chaos testing the egress paths.

Named injection points are wired into forward/rpc.py (`forward.send`),
forward/tracedhttp.py (`http.post`), forward/proxysrv.py
(`proxy.forward`), the sink flush dispatch in sinks/base.py
(`sink.flush`), and the server's flush worker (`flush.worker`). Each
point calls `FAULTS.inject(point, name=...)`, which is a single
attribute check when nothing is armed — the production cost is nil.

Activation:
- tests: `FAULTS.arm("sink.flush", error="boom", times=2)` (and
  `FAULTS.reset()` in teardown);
- env:    VENEUR_FAULT_INJECTION="forward.send:error:2,sink.flush:latency:0.05"
- config: the `fault_injection` key, same spec grammar.

Spec grammar (comma-separated):  point:error[:times]  or
point:latency:seconds[:times]. Latency uses the injector's sleep, which
tests may replace with a virtual clock.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Callable, Dict, Optional

log = logging.getLogger("veneur_tpu_torch.reliability.faults")

# the canonical point names (keep in sync with the wiring listed above)
FORWARD_SEND = "forward.send"
# injected AFTER a forward send succeeded on the wire: the receiver has
# folded the batch but the sender sees a failure — i.e. a lost ack. The
# sender must retry the SAME (source_id, epoch, seq) and the receiver's
# dedup window must suppress the re-fold.
FORWARD_ACK = "forward.ack"
HTTP_POST = "http.post"
PROXY_FORWARD = "proxy.forward"
SINK_FLUSH = "sink.flush"
FLUSH_WORKER = "flush.worker"
CHECKPOINT_WRITE = "checkpoint.write"
# injected AFTER a migration unit folded into the receiving aggregator
# but BEFORE the coordinator records its progress — the mid-move receiver
# crash: the whole migration epoch replays under the ORIGINAL seqs and
# the dedup window must answer DUPLICATE for everything already folded.
RESHARD_FOLD = "reshard.fold"


class InjectedFault(RuntimeError):
    """The error raised by an armed `error` rule — distinguishable from
    organic failures in logs and assertions."""


@dataclasses.dataclass
class _Rule:
    error: bool = False
    latency_s: float = 0.0
    times: Optional[int] = None   # None = until reset
    match: Optional[str] = None   # substring filter on the point's name
    message: str = ""
    fired: int = 0


class FaultInjector:
    def __init__(self, sleep: Callable[[float], None] = time.sleep):
        self._sleep = sleep
        self._lock = threading.Lock()
        self._rules: Dict[str, _Rule] = {}
        self._armed = False   # fast-path gate, read without the lock
        self.injected_total = 0   # faults actually fired, across all
        #                           points (exported by the telemetry
        #                           registry so a chaos drill is visible
        #                           in /metrics next to its victims)

    def arm(self, point: str, *, error: bool = False, latency_s: float = 0.0,
            times: Optional[int] = None, match: Optional[str] = None,
            message: str = "") -> None:
        with self._lock:
            self._rules[point] = _Rule(error=error, latency_s=latency_s,
                                       times=times, match=match,
                                       message=message or
                                       f"injected fault at {point}")
            self._armed = True

    def reset(self) -> None:
        with self._lock:
            self._rules.clear()
            self._armed = False

    def fired(self, point: str) -> int:
        with self._lock:
            rule = self._rules.get(point)
            return rule.fired if rule is not None else 0

    def inject(self, point: str, name: str = "") -> None:
        """The hook every wired egress point calls. No-op unless armed."""
        if not self._armed:
            return
        with self._lock:
            rule = self._rules.get(point)
            if rule is None:
                return
            if rule.match is not None and rule.match not in name:
                return
            if rule.times is not None:
                if rule.times <= 0:
                    return
                rule.times -= 1
            rule.fired += 1
            self.injected_total += 1
            latency, raise_error, msg = (rule.latency_s, rule.error,
                                         rule.message)
        if latency > 0:
            self._sleep(latency)
        if raise_error:
            raise InjectedFault(f"{msg} ({point}{f' {name}' if name else ''})")

    def configure(self, spec: str) -> None:
        """Arm from the env/config spec grammar (see module docstring)."""
        for entry in spec.split(","):
            entry = entry.strip()
            if not entry:
                continue
            parts = entry.split(":")
            if len(parts) < 2:
                raise ValueError(f"bad fault spec {entry!r}: want "
                                 "point:error[:times] or "
                                 "point:latency:seconds[:times]")
            point, mode = parts[0], parts[1]
            if mode == "error":
                times = int(parts[2]) if len(parts) > 2 else None
                self.arm(point, error=True, times=times)
            elif mode == "latency":
                if len(parts) < 3:
                    raise ValueError(
                        f"bad fault spec {entry!r}: latency needs seconds")
                times = int(parts[3]) if len(parts) > 3 else None
                self.arm(point, latency_s=float(parts[2]), times=times)
            else:
                raise ValueError(f"bad fault mode {mode!r} in {entry!r}")
            log.warning("fault injection ARMED: %s", entry)


# the process-global injector every wired point consults
FAULTS = FaultInjector()
