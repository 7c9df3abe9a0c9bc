"""veneur-emit: CLI metric/event/service-check emitter and workload
generator (reference cmd/veneur-emit/main.go). Supports statsd packet
output over udp/tcp/unix, `-command` subprocess timing, and a `-replay`
benchmark mode (the traffic generator for BASELINE configs).
"""

from __future__ import annotations

import argparse
import os
import random
import socket
import subprocess
import sys
import time


def build_metric_packet(name, value, mtype, rate=1.0, tags=()):
    parts = [f"{name}:{value}|{mtype}"]
    if rate != 1.0:
        parts.append(f"@{rate}")
    if tags:
        parts.append("#" + ",".join(tags))
    return "|".join(parts).encode()


def build_event_packet(title, text, tags=(), **fields):
    """reference cmd/veneur-emit/main.go:650 buildEventPacket. Lengths are
    BYTE lengths (the parser validates UTF-8 byte counts)."""
    body = (f"_e{{{len(title.encode())},{len(text.encode())}}}:"
            f"{title}|{text}")
    for k, v in fields.items():
        if v:
            body += f"|{k}:{v}"
    if tags:
        body += "|#" + ",".join(tags)
    return body.encode()


def build_service_check_packet(name, status, tags=(), message="",
                               timestamp="", hostname=""):
    """reference cmd/veneur-emit/main.go:715 (field order: d:, h:, then
    #tags, m: last — the parser requires the message field terminal)."""
    body = f"_sc|{name}|{status}"
    if timestamp:
        body += f"|d:{timestamp}"
    if hostname:
        body += f"|h:{hostname}"
    if tags:
        body += "|#" + ",".join(tags)
    if message:
        body += f"|m:{message}"
    return body.encode()


def open_sink(hostport: str):
    """unix:// is SOCK_STREAM on both the statsd (newline framing) and
    SSF (length framing) listeners; unixgram:// is a datagram socket.
    '@name' targets the Linux abstract namespace."""
    from veneur_tpu_torch.server.server import resolve_addr, unix_bind_address
    kind, target = resolve_addr(hostport)
    if isinstance(target, str):
        target = unix_bind_address(target)
    if kind == "udp":
        sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        sock.connect(target)
    elif kind in ("tcp", "unix"):
        sock = socket.socket(
            socket.AF_INET if kind == "tcp" else socket.AF_UNIX,
            socket.SOCK_STREAM)
        sock.connect(target)
    else:
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_DGRAM)
        sock.connect(target)
    return kind, sock


def main(argv=None):
    ap = argparse.ArgumentParser(prog="veneur-emit")
    ap.add_argument("-hostport", default="udp://127.0.0.1:8126")
    ap.add_argument("-name", default="")
    ap.add_argument("-count", type=float, default=None)
    ap.add_argument("-gauge", type=float, default=None)
    ap.add_argument("-timing", default=None, help="duration like 3ms")
    ap.add_argument("-set", dest="set_", default=None)
    ap.add_argument("-tag", default="", help="comma-separated k:v tags")
    ap.add_argument("-sample_rate", type=float, default=1.0)
    ap.add_argument("-mode", default="metric",
                    choices=["metric", "event", "sc"],
                    help="payload kind (reference -mode; event/sc fields "
                         "also imply their mode)")
    ap.add_argument("-debug", action="store_true")
    # events: reference flag names are e_*; the long spellings are kept
    # as aliases
    ap.add_argument("-e_title", "-event_title", dest="event_title",
                    default="")
    ap.add_argument("-e_text", "-event_text", dest="event_text", default="")
    ap.add_argument("-e_time", default="", help="event timestamp (d:)")
    ap.add_argument("-e_hostname", default="")
    ap.add_argument("-e_aggr_key", default="")
    ap.add_argument("-e_priority", default="", help="normal|low")
    ap.add_argument("-e_source_type", default="")
    ap.add_argument("-e_alert_type", default="",
                    help="error|warning|info|success")
    ap.add_argument("-e_event_tags", default="",
                    help="comma-separated tags for the event only")
    # service checks
    ap.add_argument("-sc_name", default="")
    ap.add_argument("-sc_status", type=int, default=0)
    ap.add_argument("-sc_msg", default="")
    ap.add_argument("-sc_time", default="", help="check timestamp (d:)")
    ap.add_argument("-sc_hostname", default="")
    ap.add_argument("-sc_tags", default="",
                    help="comma-separated tags for the check only")
    # span identity (SSF mode)
    ap.add_argument("-trace_id", type=int, default=0)
    ap.add_argument("-parent_span_id", type=int, default=0)
    ap.add_argument("-span_service", default="",
                    help="alias for -service (reference flag name)")
    ap.add_argument("-span_starttime", default="")
    ap.add_argument("-span_endtime", default="")
    ap.add_argument("-error", action="store_true",
                    help="mark the emitted span as errored")
    ap.add_argument("-ssf", action="store_true",
                    help="emit SSF protobuf instead of statsd text "
                         "(reference veneur-emit -ssf)")
    ap.add_argument("-service", default="veneur-emit")
    ap.add_argument("-indicator", action="store_true")
    ap.add_argument("-command", nargs=argparse.REMAINDER, default=None,
                    help="run command, emit its wall time as a timer "
                         "(with -ssf: as a full span)")
    ap.add_argument("-replay", type=int, default=0,
                    help="benchmark mode: send N random counter packets")
    ap.add_argument("-replay_names", type=int, default=10000)
    args = ap.parse_args(argv)

    tags = [t for t in args.tag.split(",") if t]
    if args.ssf and (args.event_title or args.sc_name
                     or args.sample_rate != 1.0 or args.replay):
        print("-ssf mode does not support events, service checks, sample "
              "rates, or -replay (reference veneur-emit rejects these too)",
              file=sys.stderr)
        return 2
    # a selected mode must carry its required field — the parser on the
    # receiving end rejects nameless events/checks, so emitting one
    # would silently drop
    if ((args.mode == "event" or args.event_title or args.event_text)
            and not (args.event_title and args.event_text)):
        print("events require both -e_title and -e_text (the receiving "
              "parser rejects zero-length fields)", file=sys.stderr)
        return 2
    if args.mode == "sc" and not args.sc_name:
        print("-mode sc requires -sc_name", file=sys.stderr)
        return 2
    kind, sock = open_sink(args.hostport)
    # stream transports need the newline frame delimiter
    nl = b"\n" if kind in ("tcp", "unix") and not args.ssf else b""
    packets = []

    if args.ssf:
        return _emit_ssf(args, tags, kind, sock)

    if args.command:
        t0 = time.perf_counter()
        rc = subprocess.call(args.command)
        ms = (time.perf_counter() - t0) * 1000.0
        name = args.name or "veneur_emit.command"
        packets.append(build_metric_packet(
            name, f"{ms:.3f}", "ms", tags=tags + [f"exit_status:{rc}"]))
    elif args.replay:
        rng = random.Random(0)
        sent = 0
        t0 = time.perf_counter()
        while sent < args.replay:
            n = rng.randrange(args.replay_names)
            sock.send(build_metric_packet(
                f"replay.counter.{n}", 1, "c", tags=tags) + nl)
            sent += 1
        dt = time.perf_counter() - t0
        print(f"sent {sent} packets in {dt:.3f}s ({sent / dt:.0f}/s)")
        return 0
    else:
        if args.count is not None:
            packets.append(build_metric_packet(
                args.name, args.count, "c", args.sample_rate, tags))
        if args.gauge is not None:
            packets.append(build_metric_packet(
                args.name, args.gauge, "g", tags=tags))
        if args.timing is not None:
            from veneur_tpu_torch.config import parse_duration
            try:
                ms = parse_duration(args.timing) * 1000.0
            except ValueError:
                print(f"-timing must be a Go duration (got "
                      f"{args.timing!r})", file=sys.stderr)
                sock.close()
                return 2
            packets.append(build_metric_packet(
                args.name, f"{ms:.3f}", "ms", args.sample_rate, tags))
        if args.set_ is not None:
            packets.append(build_metric_packet(
                args.name, args.set_, "s", tags=tags))
        if args.event_title or args.mode == "event":
            etags = tags + [t for t in args.e_event_tags.split(",") if t]
            packets.append(build_event_packet(
                args.event_title, args.event_text, etags,
                d=args.e_time, h=args.e_hostname, k=args.e_aggr_key,
                p=args.e_priority, s=args.e_source_type,
                t=args.e_alert_type))
        if args.sc_name or args.mode == "sc":
            sctags = tags + [t for t in args.sc_tags.split(",") if t]
            packets.append(build_service_check_packet(
                args.sc_name, args.sc_status, sctags, args.sc_msg,
                timestamp=args.sc_time, hostname=args.sc_hostname))

    for p in packets:
        if args.debug:
            print(f"sending {p!r}", file=sys.stderr)
        sock.send(p + nl)
    sock.close()
    return 0


def _emit_ssf(args, tags, kind, sock):
    """SSF output mode (reference cmd/veneur-emit -ssf: metrics ride a
    carrier span; -command emits a real timed span, main.go:440
    timeCommand)."""
    from veneur_tpu_torch.proto import ssf_pb2
    from veneur_tpu_torch.protocol.wire import write_ssf
    from veneur_tpu_torch.samplers import ssf_samples
    from veneur_tpu_torch.trace.tracer import Span

    # flags unset -> trace identity is inferred from the environment
    # (main.go:146,401 inferTraceIDInt): how nested `-command` spans in a
    # shell pipeline join their parent's trace. 0 means unset exactly as
    # the reference's `if existingID != 0` does (an explicit `-trace_id 0`
    # is indistinguishable there too), and the accepted integer forms
    # match Go's ParseInt — no underscores, whitespace, or leading '+'.
    # A malformed env value errors ONLY when the flag didn't decide,
    # following the module error contract: stderr + close + rc 2.
    import re

    def infer_id(existing: int, env_key: str) -> int:
        if existing:
            return existing
        raw = os.environ.get(env_key)
        if raw is None:
            return 0
        if not re.fullmatch(r"-?[0-9]+", raw):
            raise ValueError(
                f"bad integer in ${env_key}: {raw!r}")
        return int(raw)

    try:
        args.trace_id = infer_id(args.trace_id, "VENEUR_EMIT_TRACE_ID")
        args.parent_span_id = infer_id(args.parent_span_id,
                                       "VENEUR_EMIT_PARENT_SPAN_ID")
    except ValueError as e:
        print(f"veneur-emit: {e}", file=sys.stderr)
        sock.close()
        return 2

    tag_map = dict(t.split(":", 1) if ":" in t else (t, "")
                   for t in tags)
    service = args.span_service or args.service
    rc = 0
    if args.command:
        span = Span(args.name or " ".join(args.command),
                    service=service, indicator=args.indicator,
                    tags=tag_map)
        if args.trace_id:
            span.trace_id = args.trace_id
        if args.parent_span_id:
            span.parent_id = args.parent_span_id
        rc = subprocess.call(args.command)
        span.error = args.error or rc != 0
        ssf_span = span.finish()
    else:
        ssf_span = ssf_pb2.SSFSpan()
        # span descriptors apply to the carrier whether or not it has a
        # trace identity (-error/-span_service/-name must never be
        # silently dropped); -trace_id/-parent_span_id upgrade it to a
        # real trace span
        ssf_span.version = 0
        ssf_span.service = service
        ssf_span.name = args.name or "veneur-emit"
        ssf_span.indicator = args.indicator
        ssf_span.error = args.error
        ssf_span.parent_id = args.parent_span_id
        for k, v in tag_map.items():
            ssf_span.tags[k] = v
        if args.trace_id:
            from veneur_tpu_torch.trace.tracer import _new_id
            ssf_span.trace_id = args.trace_id
            ssf_span.id = _new_id()
        now = time.time()
        from veneur_tpu_torch.config import parse_duration
        import math

        def ts(flag, raw, default):
            """Unix seconds, or a Go duration meaning 'that long ago'.
            Raises ValueError with a usage message (caught below — the
            socket must be closed and rc returned, not SystemExit'd out
            of a programmatic main() call)."""
            if not raw:
                return int(default * 1e9)
            try:
                v = float(raw)
                if math.isfinite(v):
                    return int(v * 1e9)
            except ValueError:
                pass
            try:
                return int((now - parse_duration(raw)) * 1e9)
            except ValueError:
                raise ValueError(
                    f"{flag} must be unix seconds or a Go duration "
                    f"(got {raw!r})")
        try:
            ssf_span.start_timestamp = ts("-span_starttime",
                                          args.span_starttime, now)
            ssf_span.end_timestamp = ts("-span_endtime",
                                        args.span_endtime, now)
        except ValueError as e:
            print(str(e), file=sys.stderr)
            sock.close()
            return 2
        samples = []
        if args.count is not None:
            samples.append(ssf_samples.count(args.name, args.count, tag_map))
        if args.gauge is not None:
            samples.append(ssf_samples.gauge(args.name, args.gauge, tag_map))
        if args.timing is not None:
            try:
                secs = parse_duration(args.timing)
            except ValueError:
                print(f"-timing must be a Go duration (got "
                      f"{args.timing!r})", file=sys.stderr)
                sock.close()
                return 2
            samples.append(ssf_samples.timing(args.name, secs, tag_map))
        if args.set_ is not None:
            samples.append(ssf_samples.set_(args.name, args.set_, tag_map))
        for s in samples:
            ssf_span.metrics.append(s)

    if args.debug:
        print(f"sending span {ssf_span!r}".replace("\n", " "),
              file=sys.stderr)
    if kind in ("tcp", "unix"):
        f = sock.makefile("wb")
        write_ssf(f, ssf_span)
        f.flush()
    else:
        sock.send(ssf_span.SerializeToString())
    sock.close()
    return rc


if __name__ == "__main__":
    sys.exit(main())
