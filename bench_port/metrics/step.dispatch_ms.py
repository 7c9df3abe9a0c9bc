"""Host step launches (aggregation/step.py packed_step_core: prologue,
K1, fold, compaction): the aggregator's `dispatch_ns` over its steps,
both as deltas across the window."""


def read(ctx):
    d = ctx["delta"]
    if not d["steps"]:
        return None
    return d["dispatch_ns"] / d["steps"] / 1e6
