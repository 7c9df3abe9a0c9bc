"""Watch registrations and per-watch alert state machines.

A watch is a STANDING query (Datadog-monitor-shaped): a selector over
metric names (exact name, prefix, or fnmatch wildcard — the query
tier's three modes), a predicate (`op` + `threshold`) over one derived
value per interval, and alerting dynamics:

- `hysteresis` — a recovery band. An up-watch (`>`/`>=`) that fired at
  `value > threshold` recovers only once `value <= threshold −
  hysteresis` (mirrored for down-watches), so a series oscillating on
  the threshold produces one transition pair, not one per interval.
- `for_intervals` — debounce. The predicate must breach on N
  CONSECUTIVE evaluated intervals before OK/NO_DATA becomes ALERT; a
  non-breaching interval resets the streak. Breaches that do not yet
  (or cannot — already ALERT, inside the band) transition are counted
  as `suppressed`, which is what makes the fired+suppressed accounting
  exact under a storm.
- `no_data_intervals` — after N consecutive intervals where the
  selector matched nothing (or every match was non-finite), the watch
  enters NO_DATA; any datapoint leaves it. 0 disables.

Four watch kinds, keyed to what the fused flush program computes:

- `threshold`  — counter / gauge / status scalar per interval;
- `delta`      — interval-over-interval difference of that scalar
  (the previous interval's raw value rides the persisted state; a
  data gap invalidates the baseline rather than alerting on a bogus
  jump across it);
- `quantile`   — one t-digest quantile of a histogram/timer row;
- `cardinality`— the packed-HLL set estimate.

A selector that matches several series reduces host-side to the
WORST-OF value for the predicate direction (max for `>`/`>=`, min for
`<`/`<=`): a prefix watch over a fleet fires when any member breaches,
without N per-member registrations.

Registration dicts and state dicts are built with a fixed key
insertion order so the persistence sidecar chunk (JSON) is
byte-reproducible: snapshot → restore → snapshot is the identity.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

WATCH_KINDS = ("threshold", "delta", "quantile", "cardinality")
OPS = (">", ">=", "<", "<=")
STATUSES = ("OK", "ALERT", "NO_DATA")

# metric kinds a scalar (threshold/delta) watch may select over, and
# the full set the query tier knows (histogram/timer share the histo
# device table; set rides cardinality; see query/engine.py KINDS)
_SCALAR_METRIC_KINDS = ("counter", "gauge", "status")
_HISTO_METRIC_KINDS = ("histogram", "timer")

_MAX_FOR_INTERVALS = 1000
_MAX_DESCRIPTION = 256


class WatchError(ValueError):
    """Client error in a watch registration body (HTTP 400)."""


class WatchLimitError(WatchError):
    """watch_max_active reached (HTTP 429) — a registration storm must
    not grow the packed evaluation past the configured ceiling."""


def _num(v, what: str) -> float:
    try:
        f = float(v)
    except (TypeError, ValueError):
        raise WatchError(f"{what} must be a number")
    if not math.isfinite(f):
        raise WatchError(f"{what} must be finite")
    return f


def parse_watch(body) -> dict:
    """Validated canonical registration dict from a client body. The
    returned dict uses a FIXED key order (see module docstring)."""
    if not isinstance(body, dict) or not body:
        raise WatchError("watch registration must be a JSON object")
    kind = body.get("kind", "threshold")
    if kind not in WATCH_KINDS:
        raise WatchError(f"kind must be one of {WATCH_KINDS}")
    modes = [k for k in ("name", "prefix", "match") if k in body]
    if len(modes) != 1:
        raise WatchError("a watch needs exactly one of name/prefix/match")
    mode = modes[0]
    arg = body[mode]
    if not isinstance(arg, str) or not arg:
        raise WatchError(f"{mode} must be a non-empty string")
    op = body.get("op", ">")
    if op not in OPS:
        raise WatchError(f"op must be one of {OPS}")
    if "threshold" not in body:
        raise WatchError("threshold is required")
    threshold = _num(body["threshold"], "threshold")
    hysteresis = _num(body.get("hysteresis", 0.0), "hysteresis")
    if hysteresis < 0:
        raise WatchError("hysteresis must be >= 0")
    try:
        for_intervals = int(body.get("for_intervals", 1))
        no_data_intervals = int(body.get("no_data_intervals", 0))
    except (TypeError, ValueError):
        raise WatchError("for_intervals/no_data_intervals must be integers")
    if not 1 <= for_intervals <= _MAX_FOR_INTERVALS:
        raise WatchError(
            f"for_intervals must be in 1..{_MAX_FOR_INTERVALS}")
    if no_data_intervals < 0:
        raise WatchError("no_data_intervals must be >= 0")
    metric_kinds = body.get("metric_kinds")
    if metric_kinds is not None:
        allowed = (_HISTO_METRIC_KINDS if kind == "quantile"
                   else _SCALAR_METRIC_KINDS if kind in ("threshold",
                                                         "delta")
                   else ("set",))
        if (not isinstance(metric_kinds, (list, tuple)) or not metric_kinds
                or any(k not in allowed for k in metric_kinds)):
            raise WatchError(
                f"metric_kinds for a {kind} watch must be drawn "
                f"from {allowed}")
        metric_kinds = list(metric_kinds)
    tags = body.get("tags")
    if tags is not None:
        if not isinstance(tags, (list, tuple)) \
                or any(not isinstance(t, str) for t in tags):
            raise WatchError("tags must be a list of strings")
        tags = list(tags)
    quantile = None
    if kind == "quantile":
        quantile = _num(body.get("quantile", 0.99), "quantile")
        if not 0.0 <= quantile <= 1.0:
            raise WatchError("quantile must lie in [0, 1]")
    elif "quantile" in body:
        raise WatchError("quantile only applies to quantile watches")
    description = body.get("description", "")
    if not isinstance(description, str) \
            or len(description) > _MAX_DESCRIPTION:
        raise WatchError(
            f"description must be a string of <= {_MAX_DESCRIPTION} chars")
    # FIXED key order — the persistence chunk serializes this dict
    out = {"kind": kind, mode: arg, "op": op, "threshold": threshold,
           "hysteresis": hysteresis, "for_intervals": for_intervals,
           "no_data_intervals": no_data_intervals}
    if metric_kinds is not None:
        out["metric_kinds"] = metric_kinds
    if tags is not None:
        out["tags"] = tags
    if quantile is not None:
        out["quantile"] = quantile
    if description:
        out["description"] = description
    return out


def _breach(op: str, value: float, threshold: float) -> bool:
    if op == ">":
        return value > threshold
    if op == ">=":
        return value >= threshold
    if op == "<":
        return value < threshold
    return value <= threshold


def _recovered(op: str, value: float, threshold: float,
               hysteresis: float) -> bool:
    """ALERT -> OK requires leaving the hysteresis band, not merely
    un-breaching: an up-watch recovers at threshold − hysteresis."""
    if hysteresis <= 0:
        return not _breach(op, value, threshold)
    if op in (">", ">="):
        return value <= threshold - hysteresis
    return value >= threshold + hysteresis


# sentinel distinguishing "no override passed" from an explicit None
# baseline (ring window absent) in Watch.observe
_UNSET = object()


class Watch:
    """One registration + its alert state. Mutated only on the watch
    engine thread (register/delete/restore swap whole dicts under the
    engine lock), so steps never race."""

    __slots__ = ("wid", "kind", "mode", "arg", "op", "threshold",
                 "hysteresis", "for_intervals", "no_data_intervals",
                 "metric_kinds", "tags", "quantile", "description",
                 "status", "streak", "empty_streak", "last_value",
                 "value", "last_change_ts")

    def __init__(self, wid: int, spec: dict) -> None:
        self.wid = int(wid)
        self.kind = spec["kind"]
        self.mode = next(k for k in ("name", "prefix", "match")
                         if k in spec)
        self.arg = spec[self.mode]
        self.op = spec["op"]
        self.threshold = float(spec["threshold"])
        self.hysteresis = float(spec["hysteresis"])
        self.for_intervals = int(spec["for_intervals"])
        self.no_data_intervals = int(spec["no_data_intervals"])
        mk = spec.get("metric_kinds")
        self.metric_kinds = tuple(mk) if mk else None
        tags = spec.get("tags")
        self.tags = tuple(tags) if tags is not None else None
        self.quantile = spec.get("quantile")
        self.description = spec.get("description", "")
        # alert state
        self.status = "OK"
        self.streak = 0          # consecutive breaching intervals
        self.empty_streak = 0    # consecutive no-match intervals
        self.last_value = None   # delta baseline (previous raw value)
        self.value = None        # last evaluated value (for listings)
        self.last_change_ts = 0  # interval ts of the last transition

    # -- evaluation ----------------------------------------------------------
    def reduce(self, values: List[float]) -> Optional[float]:
        """Worst-of reduction across a multi-match selector."""
        if not values:
            return None
        return max(values) if self.op in (">", ">=") else min(values)

    def observe(self, raw: Optional[float], ts: int, prev_override=_UNSET
                ) -> Tuple[Optional[Tuple[str, str]], bool]:
        """Advance one evaluated interval. Returns `(transition,
        suppressed)`: transition is `(old_status, new_status)` or None;
        suppressed is True when the predicate breached without causing
        a transition (debounce pending, or already ALERT inside the
        hysteresis hold). Exactly one of fired (a transition into
        ALERT) / suppressed is possible per breaching interval, which
        is the accounting invariant the storm tests pin.

        `prev_override` (delta watches): the previous interval's value
        as read back from the HISTORY RING (engine._delta_baselines) —
        the ring, not privately retained Python state, is the baseline
        of record when the history tier is on. None means the ring has
        no resident previous window (gap semantics, same as a lost
        baseline). Without the override the pre-history behavior is
        unchanged."""
        ts = int(ts)
        if raw is not None:
            # canonicalize to float so the persisted state (the delta
            # baseline in particular) serializes identically before and
            # after a checkpoint round trip
            raw = float(raw)
            if not math.isfinite(raw):
                raw = None
        if raw is None:
            self.empty_streak += 1
            self.streak = 0
            self.value = None
            if self.kind == "delta":
                self.last_value = None  # a gap invalidates the baseline
            if (self.no_data_intervals > 0
                    and self.empty_streak >= self.no_data_intervals
                    and self.status != "NO_DATA"):
                old, self.status = self.status, "NO_DATA"
                self.last_change_ts = ts
                return (old, "NO_DATA"), False
            return None, False
        self.empty_streak = 0
        if self.kind == "delta":
            if prev_override is _UNSET:
                prev, self.last_value = self.last_value, raw
            else:
                # ring-sourced baseline; keep last_value maintained so
                # the persisted state (and any history-off fallback
                # interval) stays coherent
                prev = prev_override
                self.last_value = raw
            if prev is None:
                # first datapoint primes the baseline; nothing to compare
                self.value = None
                self.streak = 0
                if self.status == "NO_DATA":
                    self.status = "OK"
                    self.last_change_ts = ts
                    return ("NO_DATA", "OK"), False
                return None, False
            value = raw - prev
        else:
            value = raw
        self.value = value
        breach = _breach(self.op, value, self.threshold)
        if self.status == "ALERT":
            if _recovered(self.op, value, self.threshold, self.hysteresis):
                self.status = "OK"
                self.streak = 0
                self.last_change_ts = ts
                return ("ALERT", "OK"), False
            # holding: a breach (or an in-band value) with no transition
            return None, breach
        was_no_data = self.status == "NO_DATA"
        if breach:
            self.streak += 1
            if self.streak >= self.for_intervals:
                old, self.status = self.status, "ALERT"
                self.last_change_ts = ts
                return (old, "ALERT"), False
            if was_no_data:
                self.status = "OK"
                self.last_change_ts = ts
                return ("NO_DATA", "OK"), True   # breach, debounce pending
            return None, True
        self.streak = 0
        if was_no_data:
            self.status = "OK"
            self.last_change_ts = ts
            return ("NO_DATA", "OK"), False
        return None, False

    # -- persistence ---------------------------------------------------------
    def to_dict(self) -> dict:
        """Registration view (FIXED key order — serialized into the
        checkpoint sidecar chunk)."""
        d = {"id": self.wid, "kind": self.kind, self.mode: self.arg,
             "op": self.op, "threshold": self.threshold,
             "hysteresis": self.hysteresis,
             "for_intervals": self.for_intervals,
             "no_data_intervals": self.no_data_intervals}
        if self.metric_kinds is not None:
            d["metric_kinds"] = list(self.metric_kinds)
        if self.tags is not None:
            d["tags"] = list(self.tags)
        if self.quantile is not None:
            d["quantile"] = self.quantile
        if self.description:
            d["description"] = self.description
        return d

    def state_dict(self) -> dict:
        """Firing state (FIXED key order, JSON-exact value types)."""
        return {"status": self.status, "streak": int(self.streak),
                "empty_streak": int(self.empty_streak),
                "last_value": self.last_value,
                "last_change_ts": int(self.last_change_ts)}

    def load_state(self, st: dict) -> None:
        status = st.get("status", "OK")
        if status not in STATUSES:
            raise WatchError(f"bad persisted status {status!r}")
        self.status = status
        self.streak = int(st.get("streak", 0))
        self.empty_streak = int(st.get("empty_streak", 0))
        lv = st.get("last_value")
        self.last_value = None if lv is None else float(lv)
        self.last_change_ts = int(st.get("last_change_ts", 0))

    def describe(self) -> dict:
        """Live listing view: registration + current state + last
        evaluated value (NOT persisted — `value` is derivable)."""
        d = self.to_dict()
        d["status"] = self.status
        d["streak"] = self.streak
        if self.value is not None:
            d["value"] = self.value
        d["last_change_ts"] = self.last_change_ts
        return d
