"""Multi-tenant fairness: identity, weighted admission, quarantine mirror.

Tenant identity is a configurable tag (default ``tenant:``) extracted
from the raw datagram BEFORE parsing — admission must not pay a parse
for traffic it is about to shed, and the per-tenant shed count must
land on the same identity the fairness decision used. The extraction
here is the byte-exact Python mirror of the C++ ring-boundary
extractor (the port's native/dogstatsd.cpp tenant_extract);
tests/test_torch_tenancy.py pins the parity over a corpus of malformed
datagrams, against the engine and the JAX package's mirror. Every anomaly —
missing tag, tag split across a truncated datagram, empty / oversized /
invalid-UTF-8 value — maps to the DEFAULT tenant, never to a drop: the
datagram is still admitted-and-accounted under ``default``.

Fairness is a weighted token bucket per tenant (rate = base_rate *
weight), layered UNDER the per-class admission ladder at SHEDDING+ by
OverloadController.admit and by the C++ rings (admit_datagram2): a
tenant over its fair share is throttled to its own bucket while
isolated tenants keep their full budget. Buckets are host-wide, not
per ring — SO_REUSEPORT flow hashing can concentrate one tenant on one
ring, and placement must not decide fair share.

Quarantine (the tag-explosion detector) lives in the native engine:
per-tenant distinct-key counters with geometric decay (the additive-
error end of the arXiv:2004.10332 counter family) demote a runaway
tenant to aggregate-only rollup rows, SALSA-style bounded degradation
(arXiv:2102.12531) — measured, not dropped. This module mirrors that
state for telemetry/health and carries it through checkpoint/restore;
the pure-Python parse path does not demote.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

DEFAULT_TENANT = "default"

# mirror of dogstatsd.cpp kTenantValueMax: longer values -> default
TENANT_VALUE_MAX = 64


def _utf8_valid(b: bytes) -> bool:
    """Byte-exact mirror of the C++ validator (dogstatsd.cpp
    utf8_valid): lead-byte ranges and continuation count only — NOT
    full strict UTF-8 (it deliberately stays cheap on the admission
    path), so `bytes.decode` would diverge on e.g. overlong 3-byte
    forms. Parity with the ring boundary matters more than strictness:
    both sides must map the same values to the same tenant."""
    i, n = 0, len(b)
    while i < n:
        c = b[i]
        if c < 0x80:
            i += 1
            continue
        if (c & 0xE0) == 0xC0:
            if c < 0xC2:
                return False
            need = 1
        elif (c & 0xF0) == 0xE0:
            need = 2
        elif (c & 0xF8) == 0xF0:
            if c > 0xF4:
                return False
            need = 3
        else:
            return False
        if i + need >= n:
            return False
        for k in range(1, need + 1):
            if (b[i + k] & 0xC0) != 0x80:
                return False
        i += need + 1
    return True


def extract_tenant(tag: str, data: bytes) -> Optional[str]:
    """The tenant value of the first well-formed `tag` occurrence in a
    raw datagram, or None for every default-tenant outcome. Mirror of
    dogstatsd.cpp tenant_extract: the occurrence must follow '#' or ','
    (i.e. sit in a tag section), the value runs to ','/'|'/newline, and
    empty, oversized, or invalid-UTF-8 values all resolve to None."""
    tag_b = tag.encode("utf-8", "surrogateescape")
    if not tag_b or len(data) <= len(tag_b):
        return None
    start = 0
    while True:
        hit = data.find(tag_b, start)
        if hit < 0:
            return None
        if hit > 0 and data[hit - 1:hit] in (b"#", b","):
            val_start = hit + len(tag_b)
            end = val_start
            while end < len(data) and data[end:end + 1] not in (
                    b",", b"|", b"\n"):
                end += 1
            val = data[val_start:end]
            if not val or len(val) > TENANT_VALUE_MAX \
                    or not _utf8_valid(val):
                return None
            return val.decode("utf-8", "surrogateescape")
        start = hit + 1


class TenantFairness:
    """Host-wide tenant state: weighted admission buckets (the Python
    fallback path's twin of the C++ per-tenant buckets), exact
    per-(tenant, class) admitted/shed counters that both admission
    sites fold into, and the quarantine mirror fed from the native
    engine's tenant table. All public methods are thread-safe — counts
    arrive from the pipeline thread, the controller poll thread, and
    (native fold) the flush path."""

    def __init__(self, *,
                 tag: str = "tenant:",
                 weights: Optional[Dict[str, float]] = None,
                 base_rate: float = 0.0,
                 burst_mult: float = 2.0,
                 quarantine_max_keys: int = 0,
                 quarantine_decay: float = 0.5,
                 quarantine_readmit_frac: float = 0.5,
                 clock: Callable[[], float] = time.monotonic):
        self.tag = tag
        self.weights = dict(weights or {})
        self.base_rate = float(base_rate)
        self.burst_mult = float(burst_mult) if burst_mult > 0 else 2.0
        self.quarantine_max_keys = int(quarantine_max_keys)
        self.quarantine_decay = float(quarantine_decay)
        self.quarantine_readmit_frac = float(quarantine_readmit_frac)
        self._clock = clock
        self._lock = threading.Lock()
        # tenant -> (tokens, last); weighted bucket state (Python path)
        self._buckets: Dict[str, Tuple[float, float]] = {}
        # exact accounting: tenant -> {class: n}
        self.admitted: Dict[str, Dict[str, int]] = {}
        self.shed: Dict[str, Dict[str, int]] = {}
        self.demoted_rows: Dict[str, int] = {}
        # quarantine mirror, refreshed from the engine table each poll:
        # tenant -> {"demoted": bool, "key_est": float}
        self.table: Dict[str, dict] = {}

    # -- identity ------------------------------------------------------------
    def resolve(self, data: bytes) -> str:
        return extract_tenant(self.tag, data) or DEFAULT_TENANT

    def weight(self, tenant: str) -> float:
        return float(self.weights.get(tenant, 1.0))

    # -- weighted admission (Python-parser fallback path) --------------------
    def allow(self, tenant: str) -> bool:
        """Weighted token bucket, mirror of dogstatsd.cpp tenant_allow:
        rate = base_rate * weight, burst = rate * burst_mult (floor 1).
        rate <= 0 disables the bucket (always admit)."""
        rate = self.base_rate * self.weight(tenant)
        if rate <= 0.0:
            return True
        burst = max(rate * self.burst_mult, 1.0)
        now = self._clock()
        with self._lock:
            tokens, last = self._buckets.get(tenant, (burst, now))
            tokens = min(burst, tokens + (now - last) * rate)
            if tokens >= 1.0:
                self._buckets[tenant] = (tokens - 1.0, now)
                return True
            self._buckets[tenant] = (tokens, now)
            return False

    # -- exact accounting ----------------------------------------------------
    def count(self, tenant: str, cls: str, admitted: bool,
              n: int = 1) -> None:
        with self._lock:
            d = self.admitted if admitted else self.shed
            per = d.setdefault(tenant, {})
            per[cls] = per.get(cls, 0) + n

    def fold_native(self, tenants: Dict[str, dict]) -> None:
        """Fold one host-wide per-tenant drain (the "tenants" sub-dict
        of NativeIngest.admission_drain / ring_admission_drain_one,
        already summed across rings by the caller's fold) into the same
        counters the Python admit path feeds — per-tenant
        sent == admitted + shed stays exact across both sites."""
        with self._lock:
            for tenant, ent in tenants.items():
                for side, dst in (("admitted", self.admitted),
                                  ("shed", self.shed)):
                    for cls, n in ent.get(side, {}).items():
                        if n:
                            per = dst.setdefault(tenant, {})
                            per[cls] = per.get(cls, 0) + int(n)
                rows = ent.get("demoted_rows", 0)
                if rows:
                    self.demoted_rows[tenant] = \
                        self.demoted_rows.get(tenant, 0) + int(rows)

    # -- quarantine mirror / checkpoint --------------------------------------
    def update_table(self, table: Dict[str, dict]) -> None:
        """Refresh the quarantine mirror from the engine's
        non-destructive tenant_table() snapshot."""
        with self._lock:
            self.table = {name: dict(ent) for name, ent in table.items()}

    def quarantined_tenants(self) -> List[str]:
        with self._lock:
            return sorted(name for name, ent in self.table.items()
                          if ent.get("demoted"))

    def snapshot_state(self) -> dict:
        """Checkpoint sidecar payload: the engine table in a stable
        order (id order is not recoverable here; name order restores
        deterministically on both ends) plus the exact demoted-row
        totals so restored telemetry is monotonic across a restart."""
        with self._lock:
            return {
                "table": [
                    [name, bool(ent.get("demoted")),
                     float(ent.get("key_est", 0.0))]
                    for name, ent in sorted(self.table.items())],
                "demoted_rows": dict(self.demoted_rows),
            }

    def restore_state(self, snap: dict) -> List[tuple]:
        """Apply a checkpoint sidecar: seeds the mirror and the
        monotonic demoted-row totals, and returns the (name, demoted,
        key_est) entries for push-down into the engine
        (NativeIngest.tenant_restore)."""
        entries = [(str(name), bool(dem), float(est))
                   for name, dem, est in snap.get("table", [])]
        with self._lock:
            self.table = {name: {"demoted": dem, "key_est": est}
                          for name, dem, est in entries}
            for tenant, n in snap.get("demoted_rows", {}).items():
                self.demoted_rows[tenant] = \
                    self.demoted_rows.get(tenant, 0) + int(n)
        return entries

    # -- telemetry snapshots (registry callback shapes) ----------------------
    def _labeled_totals(self, d: Dict[str, Dict[str, int]]
                        ) -> List[Tuple[Tuple[str], int]]:
        return [((tenant,), sum(per.values()))
                for tenant, per in sorted(d.items())]

    def admitted_snapshot(self) -> List[Tuple[Tuple[str], int]]:
        with self._lock:
            return self._labeled_totals(self.admitted)

    def shed_snapshot(self) -> List[Tuple[Tuple[str], int]]:
        with self._lock:
            return self._labeled_totals(self.shed)

    def demoted_rows_snapshot(self) -> List[Tuple[Tuple[str], int]]:
        with self._lock:
            return [((tenant,), n)
                    for tenant, n in sorted(self.demoted_rows.items())]

    def quarantined_snapshot(self) -> List[Tuple[Tuple[str], int]]:
        """0/1 gauge per tenant currently known to the engine table."""
        with self._lock:
            return [((name,), 1 if ent.get("demoted") else 0)
                    for name, ent in sorted(self.table.items())]

    # -- native push-down ----------------------------------------------------
    def native_config(self) -> dict:
        """kwargs for NativeIngest.tenant_config (pre-rings, once)."""
        return {
            "enabled": True,
            "tag": self.tag,
            "burst_mult": self.burst_mult,
            "q_max_keys": self.quarantine_max_keys,
            "q_decay": self.quarantine_decay,
            "q_readmit_frac": self.quarantine_readmit_frac,
        }

    def native_params(self) -> tuple:
        """(base_rate, weights) snapshot for the per-poll push
        (NativeIngest.tenant_params)."""
        with self._lock:
            return self.base_rate, dict(self.weights)
