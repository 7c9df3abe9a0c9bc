"""Prometheus text-exposition renderer for a TelemetryRegistry.

Implements the text format version 0.0.4 the reference's
cmd/veneur-prometheus poller consumes (and our cli/prometheus.py
re-implements): `# HELP` / `# TYPE` header lines per family, label
values escaped (`\\` `\"` `\n`), counters/gauges as single samples,
Timers as `summary` families — one `{quantile="..."}` line per exported
quantile plus the exact `_sum` / `_count` series.

Metric names keep veneur's dotted convention internally; dots (and any
other character outside [a-zA-Z0-9_:]) become underscores on the wire,
the same mapping every statsd→prometheus bridge applies in reverse.
"""

from __future__ import annotations

import math
import re

from veneur_tpu_torch.observability.registry import TelemetryRegistry, Timer

_NAME_OK = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*$")
_NAME_BAD_CHARS = re.compile(r"[^a-zA-Z0-9_:]")
_LABEL_BAD_CHARS = re.compile(r"[^a-zA-Z0-9_]")


def sanitize_name(name: str) -> str:
    out = _NAME_BAD_CHARS.sub("_", name)
    if not out or not _NAME_OK.match(out):
        out = "_" + out
    return out


def sanitize_label_name(name: str) -> str:
    out = _LABEL_BAD_CHARS.sub("_", name)
    if not out or out[0].isdigit():
        out = "_" + out
    return out


def escape_label_value(v: str) -> str:
    return (str(v).replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def escape_help(text: str) -> str:
    return str(text).replace("\\", "\\\\").replace("\n", "\\n")


def _fmt_value(v: float) -> str:
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _labels(labelnames, labelvalues, extra=()) -> str:
    pairs = [(sanitize_label_name(k), escape_label_value(v))
             for k, v in zip(labelnames, labelvalues)]
    pairs.extend((k, escape_label_value(v)) for k, v in extra)
    if not pairs:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in pairs) + "}"


def render_prometheus(registry: TelemetryRegistry) -> str:
    lines = []
    for m in registry.collect():
        pname = sanitize_name(m.name)
        if m.help:
            lines.append(f"# HELP {pname} {escape_help(m.help)}")
        lines.append(f"# TYPE {pname} {m.kind}")
        if isinstance(m, Timer):
            for lv, stat in m.samples():
                for q, v in sorted(stat.quantiles.items()):
                    lines.append(
                        f"{pname}"
                        f"{_labels(m.labelnames, lv, [('quantile', repr(float(q)))])}"
                        f" {_fmt_value(v)}")
                base = _labels(m.labelnames, lv)
                lines.append(f"{pname}_sum{base} {_fmt_value(stat.sum)}")
                lines.append(f"{pname}_count{base} {stat.count}")
        else:
            for lv, v in m.samples():
                lines.append(f"{pname}{_labels(m.labelnames, lv)} "
                             f"{_fmt_value(v)}")
    return "\n".join(lines) + "\n"
