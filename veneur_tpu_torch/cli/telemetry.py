"""veneur-tpu-telemetry: one-shot operator view of a running server's
telemetry registry (README §Observability).

Scrapes GET /metrics once (the server must run with
prometheus_metrics_enabled: true) and prints every series as one
sorted `name{labels} value` line — grep-friendly, diff-friendly, no
Prometheus required. `--json` emits the same series as a list of
{name, labels, value, type} objects.

  python -m veneur_tpu_torch.cli.telemetry http://127.0.0.1:8127/metrics
  python -m veneur_tpu_torch.cli.telemetry --json | jq '.[].name'
"""

from __future__ import annotations

import argparse
import json
import logging
import sys

from veneur_tpu_torch.cli.prometheus import make_fetcher, parse_exposition

log = logging.getLogger("veneur_tpu_torch.cli.telemetry")

DEFAULT_URL = "http://127.0.0.1:8127/metrics"


def _format_series(name: str, labels: dict) -> str:
    if not labels:
        return name
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return f"{name}{{{inner}}}"


def ring_table(samples) -> list:
    """Render the multi-ring ingest family (veneur.ring.per_ring_*,
    ring=<i> label) as one aligned row per ring — the operator's at-a-
    glance skew check (one cold ring = a mis-pinned core or a kernel
    flow-hash imbalance). Empty outside multi-ring mode."""
    per_ring: dict = {}
    cols: list = []
    for name, labels, value in samples:
        if "per_ring_" not in name or "ring" not in labels:
            continue
        stat = name.split("per_ring_", 1)[1]
        if stat not in cols:
            cols.append(stat)
        per_ring.setdefault(labels["ring"], {})[stat] = value
    if not per_ring:
        return []
    rows = [["ring"] + cols]
    for ring in sorted(per_ring, key=lambda r: (len(r), r)):
        rows.append([ring] + [f"{per_ring[ring].get(c, 0):g}"
                              for c in cols])
    widths = [max(len(r[i]) for r in rows) for i in range(len(rows[0]))]
    return ["  ".join(f"{cell:>{w}}" for cell, w in zip(r, widths))
            for r in rows]


def watch_table(samples) -> list:
    """Render the streaming watch tier family (veneur.watch.*,
    kind=<watch kind> label) as one aligned row per watch kind — the
    operator's firing/suppression/drop balance sheet (README §Watches).
    Empty when the watch tier is off or has no registrations."""
    per_kind: dict = {}
    cols: list = []
    for name, labels, value in samples:
        # exposition names arrive underscore-mangled (veneur_watch_*)
        if not name.startswith("veneur_watch_") or "kind" not in labels:
            continue
        stat = name[len("veneur_watch_"):]
        if stat.endswith("_total"):
            stat = stat[:-len("_total")]
        if stat not in cols:
            cols.append(stat)
        per_kind.setdefault(labels["kind"], {})[stat] = value
    if not per_kind:
        return []
    rows = [["kind"] + cols]
    for kind in sorted(per_kind):
        rows.append([kind] + [f"{per_kind[kind].get(c, 0):g}"
                              for c in cols])
    widths = [max(len(r[i]) for r in rows) for i in range(len(rows[0]))]
    return ["  ".join(f"{cell:>{w}}" for cell, w in zip(r, widths))
            for r in rows]


def tenant_table(samples) -> list:
    """Render the multi-tenant fairness family (veneur.tenant.*,
    tenant=<name> label) as one aligned row per tenant — the operator's
    noisy-neighbor balance sheet: admitted vs shed per tenant, plus the
    quarantine flag and demoted-row total (README §Multi-tenancy).
    Empty when tenancy is off."""
    per_tenant: dict = {}
    cols: list = []
    for name, labels, value in samples:
        # exposition names arrive underscore-mangled (veneur_tenant_*)
        if not name.startswith("veneur_tenant_") or "tenant" not in labels:
            continue
        stat = name[len("veneur_tenant_"):]
        if stat.endswith("_total"):
            stat = stat[:-len("_total")]
        if stat not in cols:
            cols.append(stat)
        per_tenant.setdefault(labels["tenant"], {})[stat] = value
    if not per_tenant:
        return []
    rows = [["tenant"] + cols]
    for tenant in sorted(per_tenant):
        rows.append([tenant] + [f"{per_tenant[tenant].get(c, 0):g}"
                                for c in cols])
    widths = [max(len(r[i]) for r in rows) for i in range(len(rows[0]))]
    return ["  ".join(f"{cell:>{w}}" for cell, w in zip(r, widths))
            for r in rows]


def keytable_table(samples) -> list:
    """Render the self-adjusting key-table family (veneur.table.*,
    kind=<table kind> label) as one aligned row per kind — the
    operator's capacity/pressure balance sheet: current capacity, grow
    count, and the exact evicted/merged/demoted accounting that proves
    no row was lost silently (README §Key tables). Empty when growth
    is off."""
    per_kind: dict = {}
    cols: list = []
    for name, labels, value in samples:
        # exposition names arrive underscore-mangled (veneur_table_*)
        if not name.startswith("veneur_table_") or "kind" not in labels:
            continue
        stat = name[len("veneur_table_"):]
        if stat.endswith("_total"):
            stat = stat[:-len("_total")]
        if stat not in cols:
            cols.append(stat)
        per_kind.setdefault(labels["kind"], {})[stat] = value
    if not per_kind:
        return []
    rows = [["kind"] + cols]
    for kind in sorted(per_kind):
        rows.append([kind] + [f"{per_kind[kind].get(c, 0):g}"
                              for c in cols])
    widths = [max(len(r[i]) for r in rows) for i in range(len(rows[0]))]
    return ["  ".join(f"{cell:>{w}}" for cell, w in zip(r, widths))
            for r in rows]


def dump_once(fetch, as_json: bool, out=None) -> int:
    """One scrape → sorted text (or JSON) on `out`. Returns an exit
    code: 1 on fetch failure, 0 otherwise (an empty exposition is a
    valid — if suspicious — answer, reported as such)."""
    out = out if out is not None else sys.stdout
    try:
        text = fetch()
    except Exception as e:
        print(f"scrape failed: {e}", file=sys.stderr)
        return 1
    types, samples = parse_exposition(text)
    rows = sorted((_format_series(n, lb), v, types.get(n, ""))
                  for n, lb, v in samples)
    if as_json:
        print(json.dumps([{"series": s, "value": v, "type": t}
                          for s, v, t in rows], indent=1), file=out)
        return 0
    if not rows:
        print("(empty exposition — is prometheus_metrics_enabled on?)",
              file=out)
        return 0
    width = max(len(s) for s, _, _ in rows)
    for series, value, _ in rows:
        print(f"{series:<{width}}  {value:g}", file=out)
    table = ring_table(samples)
    if table:
        print("", file=out)
        print("native ingest rings:", file=out)
        for line in table:
            print(f"  {line}", file=out)
    table = watch_table(samples)
    if table:
        print("", file=out)
        print("standing watches:", file=out)
        for line in table:
            print(f"  {line}", file=out)
    table = tenant_table(samples)
    if table:
        print("", file=out)
        print("tenants:", file=out)
        for line in table:
            print(f"  {line}", file=out)
    table = keytable_table(samples)
    if table:
        print("", file=out)
        print("key tables:", file=out)
        for line in table:
            print(f"  {line}", file=out)
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(prog="veneur-tpu-telemetry")
    ap.add_argument("url", nargs="?", default=DEFAULT_URL,
                    help=f"the server's /metrics URL "
                         f"(default {DEFAULT_URL})")
    ap.add_argument("--socket", default=None,
                    help="scrape over a unix socket instead of TCP")
    ap.add_argument("--timeout", type=float, default=10.0)
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable output")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.WARNING)
    fetch = make_fetcher(args.url, socket_path=args.socket,
                         timeout=args.timeout)
    return dump_once(fetch, args.as_json)


if __name__ == "__main__":
    sys.exit(main())
