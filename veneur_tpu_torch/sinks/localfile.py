"""Flush-to-file plugin (reference plugins/localfile/localfile.go: TSV
append of every final InterMetric batch) and the CSV encoding shared with
the S3 plugin (reference plugins/s3/csv.go EncodeInterMetricCSV) —
byte-compatible with the reference's rows so existing Redshift/S3
loaders keep working."""

from __future__ import annotations

import csv
import gzip
import io
import logging
import time

import numpy as np

from veneur_tpu_torch.samplers.intermetric import COUNTER, GAUGE, InterMetric

log = logging.getLogger("veneur_tpu_torch.localfile")

# column order mirrors reference plugins/s3/csv.go tsvSchema
COLUMNS = ["Name", "Tags", "MetricType", "VeneurHostname", "Interval",
           "Timestamp", "Value", "Partition"]


def _fmt_value(v: float) -> str:
    """Go strconv.FormatFloat(v, 'f', -1, 64): shortest round-tripping
    decimal, never exponent notation — including Go's spellings for the
    non-finite values (NaN/+Inf/-Inf, not Python's nan/inf)."""
    v = float(v)
    if v != v:
        return "NaN"
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    return np.format_float_positional(v, trim="-")


def encode_row(m: InterMetric, hostname: str, interval_s: int,
               partition_ts: float):
    """One reference-identical TSV row (csv.go:56 EncodeInterMetricCSV):
    tags braced, counters written as `rate` divided by the interval, the
    Redshift timestamp in the reference's quirky 12-HOUR clock (its Go
    layout uses `03` without AM/PM — replicated for byte parity), and
    the partition from the FLUSH date, not the metric timestamp."""
    if m.type == COUNTER:
        mtype, value = "rate", m.value / interval_s
    elif m.type == GAUGE:
        mtype, value = "gauge", m.value
    else:
        raise ValueError(f"unknown metric type {m.type!r} for CSV")
    ts = time.strftime("%Y-%m-%d %I:%M:%S", time.gmtime(m.timestamp))
    partition = time.strftime("%Y%m%d", time.gmtime(partition_ts))
    return [m.name, "{" + ",".join(m.tags) + "}", mtype, hostname,
            str(int(interval_s)), ts, _fmt_value(value), partition]


def encode_intermetrics_csv(metrics, hostname: str, interval_s: int,
                            delimiter: str = "\t", compress: bool = False,
                            partition_ts: float = None,
                            headers: bool = False) -> bytes:
    """`headers` mirrors the reference's includeHeaders (s3.go
    EncodeInterMetricsCSV): one schema row before the data."""
    if partition_ts is None:
        partition_ts = time.time()
    # sub-second intervals truncate to 0 (factory passes int(seconds));
    # a zero divisor would abort the whole flush on the first counter —
    # clamp to 1s so rates stay finite and every row still lands
    interval_s = int(interval_s) or 1
    buf = io.StringIO()
    w = csv.writer(buf, delimiter=delimiter, lineterminator="\n")
    if headers:
        w.writerow(COLUMNS)
    skipped = 0
    for m in metrics:
        try:
            w.writerow(encode_row(m, hostname, interval_s, partition_ts))
        except ValueError:
            # deliberate deviation: the reference ABORTS the whole flush
            # on the first non-counter/gauge row (csv.go:72 returns err);
            # one status check wiping the interval's S3 object is a
            # failure mode, not a contract — skip-and-count instead
            skipped += 1
    if skipped:
        log.warning("CSV flush skipped %d non-counter/gauge metrics",
                    skipped)
    data = buf.getvalue().encode()
    if compress:
        data = gzip.compress(data)
    return data


class LocalFilePlugin:
    """reference plugins/localfile/localfile.go:32 — appends TSV rows on
    every flush. Registered as a post-flush plugin (plugins/plugins.go:16)."""
    name = "localfile"

    def __init__(self, path: str, hostname: str, interval_s: int = 10,
                 delimiter: str = "\t"):
        self.path = path
        self.hostname = hostname
        self.interval_s = interval_s
        self.delimiter = delimiter

    def flush(self, metrics):
        data = encode_intermetrics_csv(metrics, self.hostname,
                                       self.interval_s, self.delimiter)
        # atomic append: a crash mid-flush must never leave a torn TSV
        # row for downstream loaders (same temp-file + rename discipline
        # as the checkpoint codec; README §Durability)
        from veneur_tpu_torch.utils.atomicio import atomic_append_bytes
        atomic_append_bytes(self.path, data)

    # Plugins are file-bound and low-volume tiers: materializing is fine,
    # but declaring frame support keeps the server's columnar fast path
    # available when this plugin is configured alongside frame sinks.
    accepts_frames = True

    def flush_frame(self, frame):
        self.flush(frame.intermetrics())
