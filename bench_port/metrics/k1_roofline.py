"""K1, the fused ingest kernel (ops/cuda_ingest.py, csrc/fused_ingest.cu):
the mean least time of the slice's launches (peaks.bound_s over the
work each launch's streams need) over the mean device time of a K1
kernel in the trace."""

from bench_port import peaks


def read(ctx):
    s = ctx["slice"]
    work = ctx["k1"]
    if s is None or not work:
        return None
    runs = s.kernels("fused_ingest_kernel")
    if not runs:
        return None
    bound = sum(peaks.bound_s(b, o, c) for b, o, c in work) / len(work)
    took = sum(t for _a, t, _args in runs) / len(runs)
    return 100.0 * bound / took
