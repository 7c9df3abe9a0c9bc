"""The card: the share of the traced slice in which no kernel, copy or
memset ran (the union of their intervals from the profiler's trace)."""


def read(ctx):
    s = ctx["slice"]
    if s is None or not s.device:
        return None
    return 100.0 * max(0.0, 1.0 - s.busy_s / s.window_s)
