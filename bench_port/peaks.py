"""The card's peaks and the kernels' work arithmetic: the yardstick of
every roofline share, frozen here so that no change to the program
moves it.

Peaks are NVIDIA's data sheet for the H100 SXM at its full 700 W power
limit (dense, no sparsity). A kernel's bound is the larger of its bytes
over HBM bandwidth and its fp32 operations over the fp32 peak; K1 also
takes its longest ordered f32 chain at 4 cycles a dependent add over
the maximum SM clock.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12      # HBM3
FP32_OPS_PER_S = 67e12         # fp32 outside the tensor cores
SM_CLOCK_HZ = 1.98e9           # maximum SM clock
K1_BIG = 1 << 30               # K1's sentinel slot of a dropped row


def bound_s(nbytes: float, ops: float, chain: int = 0) -> float:
    """The least time the card could take for this work, in seconds."""
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S,
               chain * 4 / SM_CLOCK_HZ)


def k1_work(streams, hll_words: int, total_cells: int):
    """(bytes, operations, longest chain) that one fused-ingest launch
    must move and do for these sorted streams: every stream read once,
    each touched state element read and written once (gauge and status
    values and stamps written only), and the longest counter or
    histogram slot run as its ordered chain."""
    import torch

    def valid(slot):
        return (slot >= 0) & (slot < K1_BIG)

    def n_unique(x):
        return int(torch.unique(x).numel())

    def max_run(slot):
        s = slot[valid(slot)]
        if s.numel() == 0:
            return 0
        return int(torch.unique_consecutive(s, return_counts=True)[1].max())

    nbytes = sum(t.numel() * t.element_size() for t in streams)
    cv, gv, sv, hv = (valid(streams.c_slot), valid(streams.g_slot),
                      valid(streams.s_slot), valid(streams.h_slot))
    stv = valid(streams.st_slot)
    nbytes += n_unique(streams.c_slot[cv]) * 4 * 2
    nbytes += n_unique(streams.g_slot[gv]) * 5
    nbytes += n_unique(streams.st_slot[stv]) * 5
    s = streams.s_slot[sv].long()
    bit = 6 * streams.s_reg[sv].long()
    word = s * hll_words + (bit >> 5)
    straddle = (bit & 31) > 26
    nbytes += n_unique(torch.cat([word, word[straddle] + 1])) * 4 * 2
    h = streams.h_slot[hv].long()
    nbytes += n_unique(h * total_cells + streams.h_cell[hv].long()) * 16
    nbytes += n_unique(h) * 6 * 4 * 2
    ops = int(cv.sum()) + 10 * int(sv.sum()) + 8 * int(hv.sum())
    chain = max(max_run(streams.c_slot), max_run(streams.h_slot))
    return nbytes, ops, chain


def k2_bytes(rows: int, cells: int, q: int) -> int:
    """Bytes one digest-quantiles launch must move: the rows' means and
    weights, their min and max, the quantiles, and the answers."""
    return rows * cells * 8 + rows * 8 + q * 4 + rows * q * 4
