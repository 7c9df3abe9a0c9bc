"""Flush phase `ingest_drain`: the swap on the pipeline thread
(NativeAggregator.swap: emit, key-table finalize). The Server's
veneur.flush.phase_duration_ns{phase=ingest_drain} over the window, a flush
(sum over count)."""


def read(ctx):
    count, total_ns = ctx["delta"]["phases"].get("ingest_drain", (0, 0))
    if not count:
        return None
    return total_ns / count / 1e6
