"""Liveness and readiness evaluation for GET /healthz and /readyz.

Two different questions, two different consumers:

- /healthz (liveness): "is the process worth keeping?" — consumed by a
  supervisor that will RESTART on failure. True iff the pipeline and
  flush-worker threads are alive and the last completed flush is inside
  the watchdog budget (the same `min(last_flush, last_flush_done)`
  staleness the crash-only watchdog enforces, so the two can never
  disagree about what "stuck" means). Overload state is deliberately
  NOT consulted: a SHEDDING server is doing its job; restarting it
  would turn graceful degradation into an outage.

- /readyz (readiness): "should peers send this server NEW traffic?" —
  consumed by load balancers and the proxy ring. True iff the overload
  state is at most PRESSURED, checkpoint restore has completed (a
  restoring server would flush partial aggregates), and the forward
  breaker is not open (a local that cannot reach its global tier only
  accumulates what it will shed).

Both return (ok, detail) where detail is a JSON-ready dict, so the HTTP
handlers and tests share one evaluation.
"""

from __future__ import annotations

from typing import Dict, Tuple

from veneur_tpu_torch.reliability.overload import PRESSURED, STATE_NAMES
from veneur_tpu_torch.reliability.policy import OPEN


def _flush_staleness_budget(server) -> float:
    """Seconds of flush silence tolerated before liveness fails. With
    the watchdog armed this is the watchdog's own budget; without it, a
    generous multiple of the interval (manual-flush rigs — tests,
    benchmarks — idle between flushes by design)."""
    missed = getattr(server.cfg, "flush_watchdog_missed_flushes", 0)
    if missed and missed > 0:
        return missed * server.interval
    return 10.0 * server.interval + 60.0


def check_live(server) -> Tuple[bool, Dict]:
    import time

    pipeline = getattr(server, "_pipeline_thread", None)
    flusher = getattr(server, "_flush_thread", None)
    pipeline_ok = pipeline is not None and pipeline.is_alive()
    flusher_ok = flusher is not None and flusher.is_alive()
    stale_s = time.time() - min(server.last_flush, server.last_flush_done)
    budget = _flush_staleness_budget(server)
    flush_ok = stale_s <= budget
    ok = pipeline_ok and flusher_ok and flush_ok
    return ok, {
        "live": ok,
        "pipeline_thread_alive": pipeline_ok,
        "flush_worker_alive": flusher_ok,
        "flush_staleness_s": round(stale_s, 3),
        "flush_staleness_budget_s": round(budget, 3),
    }


def ready_phase(server) -> str:
    """Machine-readable lifecycle phase for /readyz consumers that need
    to distinguish "joining"/"moving" from "broken": a restoring or
    resharding server is doing planned work (dashboards should not page)
    while a draining one is leaving the ring on purpose. Exactly one of
    `restoring | resharding | draining | ready`, in that precedence —
    restore wins because a restoring server is not yet serving at all,
    and drain wins over reshard because shutdown abandons any move."""
    if not bool(getattr(server, "_restore_complete", True)):
        return "restoring"
    shutdown = getattr(server, "_shutdown", None)
    if shutdown is not None and shutdown.is_set():
        return "draining"
    ov = getattr(server, "_overload", None)
    if bool(getattr(server, "_resharding", False)) or (
            ov is not None and getattr(ov, "resharding", False)):
        return "resharding"
    return "ready"


def check_ready(server) -> Tuple[bool, Dict]:
    ov = getattr(server, "_overload", None)
    state = ov.state if ov is not None else 0
    state_ok = state <= PRESSURED
    restored = bool(getattr(server, "_restore_complete", True))
    fb = getattr(server, "_forward_breaker", None)
    forward_ok = fb is None or fb.state != OPEN
    ok = state_ok and restored and forward_ok
    return ok, {
        "ready": ok,
        # resharding is ready-but-announcing: ok stays True (peers keep
        # sending — the move is live), only the phase flips
        "phase": ready_phase(server),
        "overload_state": STATE_NAMES.get(state, str(state)),
        "overload_pressure": round(ov.pressure, 4) if ov is not None
        else 0.0,
        "restore_complete": restored,
        "forward_breaker_open": not forward_ok,
    }
