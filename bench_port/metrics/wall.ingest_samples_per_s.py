"""The Server on the host's wall clock: samples of the window's whole
intervals over the window, from its start to its last flush's return."""


def read(ctx):
    return ctx["wall"].get("ingest_samples_per_s")
