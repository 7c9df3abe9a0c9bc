"""veneur-tpu-torch-query: one-shot client for the on-device query tier
(README §Query tier).

POSTs one query to a running server's /query endpoint (the server
must run with query_enabled: true) and prints each match as a
grep-friendly line; `--json` emits the raw response body.

  python -m veneur_tpu_torch.cli.query page.latency -q 0.5 -q 0.99
  python -m veneur_tpu_torch.cli.query --prefix api. --kind counter
  python -m veneur_tpu_torch.cli.query --match 'api.*.errors' --json

Range queries (server must also run with history_enabled: true) read
the on-device history ring instead of the live interval — one point
per step, oldest first (README §History):

  python -m veneur_tpu_torch.cli.query api.hits --range 15m --step 1m
  python -m veneur_tpu_torch.cli.query page.latency --range 1h \\
      --window 5m --step 1m -q 0.99 --json

--range/--window/--step accept seconds or 30s/15m/2h/1d suffixes.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import urllib.error
import urllib.request

log = logging.getLogger("veneur_tpu_torch.cli.query")

DEFAULT_URL = "http://127.0.0.1:8127/query"

_DUR_SUFFIX = {"s": 1.0, "m": 60.0, "h": 3600.0, "d": 86400.0}


def parse_duration(text: str) -> float:
    """'90', '90s', '15m', '2h', '1d' -> seconds (float, > 0)."""
    text = str(text).strip()
    mult = 1.0
    if text and text[-1].lower() in _DUR_SUFFIX:
        mult = _DUR_SUFFIX[text[-1].lower()]
        text = text[:-1]
    try:
        v = float(text) * mult
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"bad duration {text!r} (use seconds or 30s/15m/2h/1d)")
    if not v > 0:
        raise argparse.ArgumentTypeError("duration must be positive")
    return v


def build_query(args) -> dict:
    q: dict = {}
    if args.prefix is not None:
        q["prefix"] = args.prefix
    elif args.match is not None:
        q["match"] = args.match
    elif args.name is not None:
        q["name"] = args.name
    else:
        raise SystemExit("need a metric name, --prefix, or --match")
    if args.kind:
        q["kinds"] = args.kind
    if args.quantile:
        q["quantiles"] = args.quantile
    if args.tag:
        q["tags"] = args.tag
    if getattr(args, "range", None) is not None:
        q["range"] = args.range
        if args.window is not None:
            q["window"] = args.window
        if args.step is not None:
            q["step"] = args.step
    elif args.window is not None or args.step is not None:
        raise SystemExit("--window/--step only apply with --range")
    return q


def post_query(url: str, body: dict, timeout: float) -> dict:
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def _fields(m: dict) -> str:
    """Everything after name/kind/tags, stable order, `k=v` pairs;
    quantiles inline as q<p>=v."""
    parts = []
    for k in ("value", "rate", "delta", "estimate", "message", "count",
              "sum", "avg", "hmean", "median", "min", "max"):
        if k in m and m[k] is not None:
            v = m[k]
            parts.append(f"{k}={v:g}" if isinstance(v, float) else
                         f"{k}={v}")
    for p, v in sorted(m.get("quantiles", {}).items(),
                       key=lambda kv: float(kv[0])):
        if v is not None:
            parts.append(f"q{p}={v:g}")
    return "  ".join(parts)


def _render_points(m: dict, dest) -> None:
    """One line per range point, oldest first: timestamp, seq span, the
    point's fields, and (incomplete) when part of the span fell off
    retention."""
    for p in m.get("points", []):
        span = p.get("seq") or ["?", "?"]
        mark = "" if p.get("complete") else "  (incomplete)"
        print(f"  {p.get('ts', 0):.0f}  seq[{span[0]}..{span[1]}]  "
              f"{_fields(p)}{mark}", file=dest)


def render(out: dict, dest=None) -> None:
    dest = dest if dest is not None else sys.stdout
    for res in out.get("results", []):
        for m in res.get("matches", []):
            tags = ",".join(m.get("tags", []))
            series = m["name"] + (f"{{{tags}}}" if tags else "")
            if res.get("range"):
                print(f"{series}  [{m['kind']}]", file=dest)
                _render_points(m, dest)
            else:
                print(f"{series}  [{m['kind']}]  {_fields(m)}", file=dest)
        if res.get("truncated"):
            print("(match list truncated)", file=dest)
    if not any(r.get("matches") for r in out.get("results", [])):
        print("(no matches)", file=dest)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="veneur-tpu-torch-query")
    ap.add_argument("name", nargs="?", default=None,
                    help="exact metric name (all tag variants)")
    ap.add_argument("--prefix", default=None,
                    help="every metric whose name starts with this")
    ap.add_argument("--match", default=None,
                    help="fnmatch-style wildcard pattern")
    ap.add_argument("--kind", action="append", default=[],
                    choices=["counter", "gauge", "status", "set",
                             "histogram", "timer"],
                    help="restrict to kind(s); repeatable")
    ap.add_argument("-q", "--quantile", action="append", type=float,
                    default=[], metavar="P",
                    help="quantile in [0,1] for histos/timers; repeatable")
    ap.add_argument("--tag", action="append", default=[], metavar="K:V",
                    help="exact tag-set filter; repeat for each tag")
    ap.add_argument("--range", type=parse_duration, default=None,
                    metavar="DUR",
                    help="history lookback (e.g. 900, 15m, 1h) — answers "
                         "from the on-device history ring")
    ap.add_argument("--window", type=parse_duration, default=None,
                    metavar="DUR",
                    help="sliding aggregation window per point "
                         "(default: one step)")
    ap.add_argument("--step", type=parse_duration, default=None,
                    metavar="DUR",
                    help="stride between points (default: the whole range "
                         "as one point)")
    ap.add_argument("--url", default=DEFAULT_URL,
                    help=f"the server's /query URL (default {DEFAULT_URL})")
    ap.add_argument("--timeout", type=float, default=30.0)
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="print the raw response body")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.WARNING)
    body = {"queries": [build_query(args)]}
    try:
        out = post_query(args.url, body, args.timeout)
    except urllib.error.HTTPError as e:
        print(f"query failed: HTTP {e.code}: "
              f"{e.read().decode(errors='replace')}", file=sys.stderr)
        return 1
    except Exception as e:
        print(f"query failed: {e}", file=sys.stderr)
        return 1
    if args.as_json:
        print(json.dumps(out, indent=1))
    else:
        render(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
