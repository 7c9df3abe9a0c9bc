"""The Server on the host's wall clock: the mean time from the pipeline
thread reaching a flush request to the capture sink's return."""


def read(ctx):
    return ctx["wall"].get("flush_ms") or None
