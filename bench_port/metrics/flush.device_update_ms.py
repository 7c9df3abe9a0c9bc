"""Flush phase `device_update`: the flush worker's
compute_flush (gather, K2, two-float, copy to the host). The Server's
veneur.flush.phase_duration_ns{phase=device_update} over the window, a flush
(sum over count)."""


def read(ctx):
    count, total_ns = ctx["delta"]["phases"].get("device_update", (0, 0))
    if not count:
        return None
    return total_ns / count / 1e6
