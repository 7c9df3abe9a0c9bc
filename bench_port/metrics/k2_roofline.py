"""K2, the digest quantiles kernel (ops/cuda_digest.py,
csrc/digest_quantiles.cu), at the flush: the bytes of the flush's rows
at HBM bandwidth over the device time of those launches. A flush's
launches are told from the registry's small ones by their grid (one
block of four warps per four rows)."""

import math

from bench_port import peaks


def read(ctx):
    s = ctx["slice"]
    calls = ctx["k2"]
    if s is None or not calls:
        return None
    runs = s.kernels("digest_quantiles")
    bound = took = 0.0
    i = 0
    for rows, cells, q in calls:
        blocks = math.ceil(rows / 4)
        while i < len(runs) and (runs[i][2].get("grid") or [None])[0] \
                != blocks:
            i += 1
        if i == len(runs):
            return None
        bound += peaks.k2_bytes(rows, cells, q) / peaks.HBM_BYTES_PER_S
        took += runs[i][1]
        i += 1
    return 100.0 * bound / took
