"""Digest compaction (compact_core -> ops/tdigest.py compress_rows): the
device time of the work launched inside the harness's `step.compact`
range, as a share of the traced slice."""


def read(ctx):
    s = ctx["slice"]
    if s is None or not s.device:
        return None
    t = s.device_s(in_range="step.compact")
    if t == 0.0:
        return None
    return 100.0 * t / s.window_s
