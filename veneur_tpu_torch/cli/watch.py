"""veneur-tpu-torch-watch: operator tool for the streaming watch tier
(README §Watches).

Registers, lists, deletes and tails standing monitors on a running
server (which must run with watch_enabled: true):

  python -m veneur_tpu_torch.cli.watch register page.latency \\
      --kind quantile -q 0.99 --op '>' --threshold 250 \\
      --hysteresis 25 --for-intervals 3
  python -m veneur_tpu_torch.cli.watch register --prefix api. \\
      --threshold 1000 --json
  python -m veneur_tpu_torch.cli.watch list
  python -m veneur_tpu_torch.cli.watch delete 7
  python -m veneur_tpu_torch.cli.watch tail --json

`tail` follows GET /watch/stream (SSE) and prints one line per state
transition until interrupted; `--json` emits raw event bodies.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import urllib.error
import urllib.request

log = logging.getLogger("veneur_tpu_torch.cli.watch")

DEFAULT_URL = "http://127.0.0.1:8127"


def build_registration(args) -> dict:
    body: dict = {"kind": args.kind}
    if args.prefix is not None:
        body["prefix"] = args.prefix
    elif args.match is not None:
        body["match"] = args.match
    elif args.name is not None:
        body["name"] = args.name
    else:
        raise SystemExit("need a metric name, --prefix, or --match")
    body["op"] = args.op
    if args.threshold is None:
        raise SystemExit("--threshold is required")
    body["threshold"] = args.threshold
    if args.hysteresis:
        body["hysteresis"] = args.hysteresis
    if args.for_intervals != 1:
        body["for_intervals"] = args.for_intervals
    if args.no_data_intervals:
        body["no_data_intervals"] = args.no_data_intervals
    if args.kind == "quantile" and args.quantile is not None:
        body["quantile"] = args.quantile
    if args.metric_kind:
        body["metric_kinds"] = args.metric_kind
    if args.tag:
        body["tags"] = args.tag
    if args.description:
        body["description"] = args.description
    return body


def _request(url: str, timeout: float, method: str = "GET",
             body: dict | None = None):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(
        url, data=data, method=method,
        headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=timeout)


def _watch_line(w: dict) -> str:
    sel = next((f"{m}={w[m]}" for m in ("name", "prefix", "match")
                if m in w), "?")
    parts = [f"#{w['id']}", w.get("status", "?"), w["kind"], sel,
             f"{w['op']} {w['threshold']:g}"]
    if w.get("hysteresis"):
        parts.append(f"hyst={w['hysteresis']:g}")
    if w.get("for_intervals", 1) != 1:
        parts.append(f"for={w['for_intervals']}")
    if "value" in w:
        parts.append(f"value={w['value']:g}")
    return "  ".join(parts)


def _event_line(ev: dict) -> str:
    sel = next((ev[m] for m in ("name", "prefix", "match") if m in ev),
               "?")
    line = (f"watch #{ev['id']} [{ev['kind']}] {sel}: "
            f"{ev['from']} -> {ev['to']} @ {ev['ts']}")
    if "value" in ev:
        line += f" (value={ev['value']:g}, threshold={ev['threshold']:g})"
    if ev.get("stale_bounded"):
        line += " [stale-bounded]"
    return line


def cmd_register(args) -> int:
    with _request(f"{args.url}/watch", args.timeout, "POST",
                  build_registration(args)) as resp:
        out = json.loads(resp.read())
    if args.as_json:
        print(json.dumps(out, indent=1))
    else:
        print(f"registered watch #{out['id']}")
    return 0


def cmd_list(args) -> int:
    with _request(f"{args.url}/watch", args.timeout) as resp:
        out = json.loads(resp.read())
    if args.as_json:
        print(json.dumps(out, indent=1))
        return 0
    for w in out.get("watches", []):
        print(_watch_line(w))
    if not out.get("watches"):
        print("(no watches registered)")
    return 0


def cmd_delete(args) -> int:
    with _request(f"{args.url}/watch/{args.id}", args.timeout,
                  "DELETE") as resp:
        out = json.loads(resp.read())
    if args.as_json:
        print(json.dumps(out, indent=1))
    else:
        print(f"deleted watch #{out['deleted']}")
    return 0


def tail_events(resp, limit: int | None = None):
    """Yield parsed event dicts from an open SSE response; SSE comment
    lines (keepalives) are skipped. Stops after `limit` events (tests)
    or when the server closes the stream."""
    n = 0
    for raw in resp:
        line = raw.strip()
        if not line.startswith(b"data: "):
            continue   # comment/keepalive or blank separator
        yield json.loads(line[len(b"data: "):])
        n += 1
        if limit is not None and n >= limit:
            return


def cmd_tail(args) -> int:
    # no read timeout on purpose: keepalive comments arrive every
    # second, so a dead server surfaces quickly anyway
    resp = _request(f"{args.url}/watch/stream", args.timeout)
    with resp:
        try:
            for ev in tail_events(resp, limit=args.limit or None):
                if args.as_json:
                    print(json.dumps(ev))
                else:
                    print(_event_line(ev))
                sys.stdout.flush()
        except KeyboardInterrupt:
            pass
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(prog="veneur-tpu-torch-watch")
    ap.add_argument("--url", default=DEFAULT_URL,
                    help=f"server base URL (default {DEFAULT_URL})")
    ap.add_argument("--timeout", type=float, default=30.0)
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="print raw response bodies")
    sub = ap.add_subparsers(dest="command", required=True)

    reg = sub.add_parser("register", help="register one watch")
    reg.add_argument("name", nargs="?", default=None,
                     help="exact metric name (all tag variants)")
    reg.add_argument("--prefix", default=None,
                     help="every metric whose name starts with this")
    reg.add_argument("--match", default=None,
                     help="fnmatch-style wildcard pattern")
    reg.add_argument("--kind", default="threshold",
                     choices=["threshold", "delta", "quantile",
                              "cardinality"])
    reg.add_argument("--op", default=">",
                     choices=[">", ">=", "<", "<="])
    reg.add_argument("--threshold", type=float, default=None)
    reg.add_argument("--hysteresis", type=float, default=0.0)
    reg.add_argument("--for-intervals", type=int, default=1,
                     dest="for_intervals")
    reg.add_argument("--no-data-intervals", type=int, default=0,
                     dest="no_data_intervals")
    reg.add_argument("-q", "--quantile", type=float, default=None,
                     metavar="P", help="quantile for --kind quantile")
    reg.add_argument("--metric-kind", action="append", default=[],
                     dest="metric_kind",
                     help="restrict the selector's metric kinds")
    reg.add_argument("--tag", action="append", default=[],
                     metavar="K:V", help="exact tag-set filter")
    reg.add_argument("--description", default="")
    reg.set_defaults(fn=cmd_register)

    lst = sub.add_parser("list", help="list registered watches")
    lst.set_defaults(fn=cmd_list)

    dele = sub.add_parser("delete", help="delete one watch by id")
    dele.add_argument("id", type=int)
    dele.set_defaults(fn=cmd_delete)

    tail = sub.add_parser("tail", help="follow /watch/stream")
    tail.add_argument("--limit", type=int, default=0,
                      help="stop after N events (0 = forever)")
    tail.set_defaults(fn=cmd_tail)

    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.WARNING)
    try:
        return args.fn(args)
    except urllib.error.HTTPError as e:
        print(f"watch {args.command} failed: HTTP {e.code}: "
              f"{e.read().decode(errors='replace')}", file=sys.stderr)
        return 1
    except Exception as e:
        print(f"watch {args.command} failed: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
