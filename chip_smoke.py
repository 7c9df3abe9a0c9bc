#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card, end to end.

    python3 chip_smoke.py

Phases, each of which must pass (the script exits non-zero otherwise):

1. device: CUDA must be present; prints the card's name and power limit
   as nvidia-smi reports them;
2. build: compiles the kernels from veneur_tpu_torch/csrc and prints
   ptxas's register, shared-memory and spill lines;
3. kernels, at the shapes the main path gives them:
   - fused ingest (K1) against its plain version run on a CPU copy of the
     same state and streams: byte-exact on all 14 state leaves, on the
     main path's Zipf batch and on a hot batch (one key owns the whole
     histogram lane, one the whole set lane), each with its longest runs;
   - digest quantiles (K2) against its plain version over 16384 and
     131072 synthetic rows x 472 cells (~60% live) and over 1024 rows x
     32 cells, Q=4, empty and duplicate-key rows included, and (after
     phase 5) on the very tensors the phase 4 and phase 5 flushes hand
     it, captured from a repeat of each flush, with each capture's
     live cells per row (p50, p99, max): within rtol/atol 2e-5, the same
     NaN pattern; timed at the host's pace and on the card alone, beside
     a stable torch.sort of the same rows' keys;
   - K2 on the card alone against live cells per row (0 to 472 of 472,
     131072 rows), each case held to the same tolerance;
   - masked window merge (K3) against its plain version on the same
     card tensors over 256 set rows x 360 ring columns x 3072 words
     (p=14) and 32 steps (tier-0 columns, decimated-tier covers, every
     column, none), and in its row-index form (200 picks of those rows,
     repeated and clamped ones included): byte-exact;
   - the wide-row paths (C-1): K1 with rows walked in place, byte-exact
     as above on the default-shaped and the hot batch, at compression
     2,400 and hll_precision 16 (3,928 cells, 12,288 words a row); K2's
     wide-row kernel over 16384 rows of 3,928 and of 2,056 cells with a
     flush's live counts (most rows sparse, 1% >= 60% live), held as K2
     is held;
   (K3's row-index form and the wide-row paths run after phase 6, with
   phase 7)
   each with its time (CUDA events over launches at the host's pace, and
   on the card alone), the plain version's time and its
   bound (the least time the card could take: bytes over 3.35 TB/s or
   operations over 67 TFLOP/s of fp32, whichever is larger; K2's
   operations are those its rows' live cells need; for K1 also its
   longest ordered f32 chain at 4 cycles an add over the maximum SM
   clock);
4. the main path at the server's default widths: ~200k DogStatsD lines
   parsed, keyed and ingested by Aggregator(device="cuda"), a flush
   with [0.5, 0.9, 0.99] and generate_intermetrics; counters exact
   against an f64 oracle, gauges last-write, p50 within 6% and p99
   within 1% per key with >= 24 samples, set estimates within 5% per
   key with >= 100 members; both
   kernels launched by that run;
5. the same path at the 1M-key table spec, staged in bulk, with the same
   oracles;
6. the history tier at the default widths and the default ring (90
   windows, 3 tiers: 3,210,117,120 bytes on the card): 16 intervals of
   phase 4's traffic, each flushed with the ring write fused in, then
   one range batch (all counters and gauges and every set row, 16
   one-interval steps and one over everything; 1,024 timers in 4-interval
   windows every 2 intervals). Gates: the fused ring is bit-identical to
   a replay of the archived frames; range counters are the exact sums of
   the flushed counters and gauges the last flushed value; K3's merged
   words equal numpy's; the batch over a CPU copy of the ring (plain
   versions) agrees byte-exactly, set estimates within rtol 1e-6 and
   quantiles within rtol/atol 2e-5; the batch launched K2 once (every
   step's digests in one call) and K3 once. K2's share of the batch
   (its calls captured from one more batch) is held to its plain version
   and timed on both timers. K3 reads the set rows through the batch's
   row index; it is timed as the program calls it, on the gathered rows,
   and beside the set-row gather alone (which the program no longer
   makes, since K3 takes the index);
7. the wide widths: 100k lines of phase 4's mix through Aggregator at
   compression 2,400 and hll_precision 16 (the default capacities; 0.72
   GB of state) on the card, flushed, held to phase 4's oracles, and
   compared with the same run on the CPU (InterMetric names and types
   equal, percentiles within 1e-2, set estimates within 1e-5, the rest
   exact); every launch of that run is of the in-place K1 and the
   wide-row K2.
8. (run right after phase 4) the native path, the default config's
   ingest: phase 4's lines in ~1,400-byte datagrams through
   NativeAggregator on the card (the port's C++ engine, built with g++
   beside the kernels in phase 2) by three routes: `feed`; a loopback
   UDP socket read by the C++ reader and drained by pump(20), sent in
   paced bursts so that no datagram is lost; and four rings through
   rings_inject, each name's lines on one ring, in waves of 10k lines
   (a single-ring step's). Each run is flushed and held to phase 4's
   oracles; K1 launches on every step (on each of the four rows of a
   ring step), K2 in the flush, and `processed` is every line sent;
   `feed` flushes the InterMetrics of phase 4's Python path, and `udp`
   those of `feed` (percentiles within rtol/atol 2e-5, the rest equal).
   A fourth run deals every key over the four rings and reports its
   p50/p99 errors without holding them. Prints samples/s, step_ms,
   flush_ms and h2d_bytes beside phase 4's, and how the ingest time
   splits between the engine's parse (`feed` only), its packed emit, the
   host's step launches and the rest.
9. (run right after phase 8) the Server, as the default config runs it
   at the default widths: `Server(Config(...))` with native ingest, the
   C++ reader on one ring, a loopback UDP listener, the HTTP API and a
   debug sink. Phase 8's datagrams, paced as phase 8 paces them, then
   one manual flush: it must pass phase 4's oracles and flush phase 8's
   `udp` InterMetrics, with every datagram received and none dropped,
   K1 on every step and K2 in the flush. A second, smaller interval
   flushes only its own metrics. GET /healthcheck, /healthz, /readyz,
   /stats and /metrics answer 200, and /metrics' veneur.device.hbm_*
   agree with torch.cuda.memory_allocated and mem_get_info. A third
   interval, 20k-line waves sent until GET /debug/profile?seconds=1
   (torch.profiler with CUDA activity) replies: the trace must hold K1's
   symbol; its kernel events give the card's busy share of the window.
   shutdown() must return with the threads joined. Then the CLI daemon
   (`python -m veneur_tpu_torch.cli.server -f cfg.yaml`, 2 s interval,
   the local-file plugin) in a process of its own: lines until the
   ticker writes them to the TSV, then SIGTERM, exit code 0. Prints
   samples/s, the flush's wall and phase ms, launches and datagram
   counts; the kernels line carries phase 9's K1 and K2 launches (and
   each phase's).

The last two lines of output are one JSON object listing each kernel,
then {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
FP32_OPS_PER_S = 67e12         # H100 SXM fp32 outside the tensor cores
PERCENTILES = [0.5, 0.9, 0.99]
AGGREGATES = ["min", "max", "median", "avg", "count", "sum", "hmean"]


def _fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def _check(cond, msg: str) -> None:
    if not cond:
        _fail(msg)


def _time_ms(fn, device, reps: int, warmup: int = 2) -> float:
    """Mean time of fn over reps runs: CUDA events on the card (after a
    warm-up), the host clock elsewhere."""
    import torch
    for _ in range(warmup):
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _device_ms(fn, reps: int, clock_hz: float, warmup: int = 2) -> float:
    """Device time of fn, for a kernel whose launch costs the host more
    than the card's run: the card first spins (torch.cuda._sleep) for
    40 ms at its maximum clock, longer at a lower one, while the host
    queues every launch between two CUDA events, so the events see the
    launches back to back and not the host's pace."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(clock_hz * 0.04))
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    queued_s = time.perf_counter() - t0
    end.synchronize()
    _check(queued_s < 0.04, f"queueing {reps} launches took {queued_s:.3f} "
           "s, longer than the card's spin")
    return start.elapsed_time(end) / reps


def _bound(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def midpoint_quantile_rows(vals: np.ndarray, q: float) -> np.ndarray:
    """Quantile of each row of raw samples under the t-digest midpoint
    convention (what a digest with one centroid per sample returns)."""
    v = np.sort(np.asarray(vals, np.float64), axis=-1)
    n = v.shape[-1]
    x = q * n - 0.5                      # position among the midpoints
    if x <= 0:
        return v[..., 0]
    if x >= n - 1:
        return v[..., -1]
    i = int(math.floor(x))
    f = x - i
    return v[..., i] * (1 - f) + v[..., i + 1] * f


# -- phase 1/2 ----------------------------------------------------------------

def device_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    _check(res.returncode == 0, f"nvidia-smi: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def build_kernels() -> float:
    """The CUDA kernels (nvcc, one process a source) and, beside them on
    another thread, the native ingest engine (g++)."""
    import threading
    from veneur_tpu_torch import native
    from veneur_tpu_torch.ops import _build
    t0 = time.perf_counter()
    engine = {}

    def build_engine():
        try:
            engine["path"] = native.build()
        except BaseException as e:      # re-raised below, on this thread
            engine["error"] = e
        engine["s"] = time.perf_counter() - t0
    th = threading.Thread(target=build_engine)
    th.start()
    _path, log = _build.build()
    _build.load()
    th.join()
    if "error" in engine:
        raise engine["error"]
    native.load()
    print(f"build: native engine {engine['path'].name} in "
          f"{engine['s']:.1f} s")
    dt = time.perf_counter() - t0
    for line in log.splitlines():
        if any(k in line for k in ("registers", "spill", "Compiling entry",
                                   "==")):
            print("ptxas:", line.strip())
    print(f"build: {dt:.1f} s")
    return dt


# -- phase 3: kernels at the main path's shapes --------------------------------

def _default_spec():
    from veneur_tpu_torch.aggregation.state import TableSpec
    return TableSpec(counter_capacity=1 << 17, gauge_capacity=1 << 15,
                     status_capacity=1 << 10, set_capacity=1 << 12,
                     histo_capacity=1 << 14)


def _kernel_1m_spec():
    from veneur_tpu_torch.aggregation.state import TableSpec
    return TableSpec(counter_capacity=1 << 19, gauge_capacity=1 << 18,
                     status_capacity=1 << 10, set_capacity=1 << 14,
                     histo_capacity=1 << 17)


def _wide_spec():
    """The default table at the widths the wide-row kernels serve: digest
    compression 2,400 (3,928 cells a row; h_w and h_wm 2 x 2^14 x 3,928 x
    4 B = 0.51 GB) and hll_precision 16 (12,288 words a set row)."""
    from veneur_tpu_torch.aggregation.state import TableSpec
    return TableSpec(counter_capacity=1 << 17, gauge_capacity=1 << 15,
                     status_capacity=1 << 10, set_capacity=1 << 12,
                     histo_capacity=1 << 14, compression=2400.0,
                     hll_precision=16)


def _main_path_batch(rng, spec, bspec):
    """One padded batch shaped like the main path's: counters over 10k
    names, Zipf-hot timers over 10k, 1k gauges, Zipf sets over 1k names."""
    from veneur_tpu_torch.aggregation.step import Batch
    from veneur_tpu_torch.ops import hll
    hashes = rng.integers(0, 2 ** 63, bspec.set, dtype=np.int64)
    reg, rho = hll.split_hash(hashes.astype(np.uint64) * 2 + 1,
                              spec.hll_precision)
    return Batch(
        counter_slot=rng.integers(0, 10_000, bspec.counter).astype(np.int32),
        counter_inc=rng.integers(1, 9, bspec.counter).astype(np.float32),
        gauge_slot=rng.integers(0, 1000, bspec.gauge).astype(np.int32),
        gauge_val=rng.normal(size=bspec.gauge).astype(np.float32),
        status_slot=np.full(bspec.status, spec.status_capacity, np.int32),
        status_val=np.zeros(bspec.status, np.float32),
        set_slot=((rng.zipf(1.2, bspec.set) - 1) % 1000).astype(np.int32),
        set_reg=reg, set_rho=rho,
        histo_slot=((rng.zipf(1.2, bspec.histo) - 1) % 10_000
                    ).astype(np.int32),
        histo_val=rng.lognormal(3.0, 1.0, bspec.histo).astype(np.float32),
        histo_wt=np.ones(bspec.histo, np.float32))


def _ingest_work(streams, spec):
    """(bytes, operations) the fused ingest must move and do for these
    streams: every stream read once; each touched state element read and
    written once (gauge/status values and stamps written only)."""
    import torch
    from veneur_tpu_torch.ops.cuda_ingest import BIG

    def valid(slot):
        return (slot >= 0) & (slot < BIG)

    def n_unique(x):
        return int(torch.unique(x).numel())

    nbytes = sum(t.numel() * t.element_size() for t in streams)
    cv, gv, sv, hv = (valid(streams.c_slot), valid(streams.g_slot),
                      valid(streams.s_slot), valid(streams.h_slot))
    stv = valid(streams.st_slot)
    nbytes += n_unique(streams.c_slot[cv]) * 4 * 2
    nbytes += n_unique(streams.g_slot[gv]) * 5
    nbytes += n_unique(streams.st_slot[stv]) * 5
    s = streams.s_slot[sv].long()
    bit = 6 * streams.s_reg[sv].long()
    word = s * spec.hll_words + (bit >> 5)
    straddle = (bit & 31) > 26
    nbytes += n_unique(torch.cat([word, word[straddle] + 1])) * 4 * 2
    h = streams.h_slot[hv].long()
    nbytes += n_unique(h * spec.total_cells + streams.h_cell[hv].long()) * 16
    nbytes += n_unique(h) * 6 * 4 * 2
    ops = (int(cv.sum()) + 10 * int(sv.sum()) + 8 * int(hv.sum()))
    return nbytes, ops


def _max_run(slot) -> int:
    import torch
    from veneur_tpu_torch.ops.cuda_ingest import BIG
    s = slot[(slot >= 0) & (slot < BIG)]
    if s.numel() == 0:
        return 0
    return int(torch.unique_consecutive(s, return_counts=True)[1].max())


def sm_clock_hz() -> float:
    """The card's maximum SM clock, as nvidia-smi reports it."""
    res = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    _check(res.returncode == 0, f"nvidia-smi: {res.stderr.strip()}")
    return float(res.stdout.strip().splitlines()[0]) * 1e6


def _hot_batch(rng, spec, bspec):
    """The main path's batch with one timer key owning the whole
    histogram lane and one set key the whole set lane."""
    return _main_path_batch(rng, spec, bspec)._replace(
        histo_slot=np.full(bspec.histo, 17, np.int32),
        set_slot=np.full(bspec.set, 5, np.int32))


def _ingest_case(state, batch, spec, device, clock_hz, plain_reps) -> dict:
    """K1 on one batch: byte-exact against the plain version on a CPU copy
    of the same state and streams, then timed three ways: `ms` with CUDA
    events over launches at the host's pace (`_time_ms`, as K2 and K3 are
    timed: the wrapper's checks and the launch, as the main path calls
    it), `device_ms` on the card alone (`_device_ms`), and `checks_ms`,
    the host time of the wrapper's argument checks alone. The bound
    is the largest of three times: bytes over HBM, fp32 operations over
    the fp32 peak, and the longest ordered f32 chain (the longest counter
    or histogram slot run) at 4 cycles a dependent add over the maximum
    SM clock; a chain is dependent operations, so bound_by names it
    "operations"."""
    import torch
    from veneur_tpu_torch import convert
    from veneur_tpu_torch.aggregation.step import build_streams
    from veneur_tpu_torch.ops import cuda_ingest

    streams = build_streams(state, batch, spec)
    cpu_state = convert.state_from_numpy(convert.state_to_numpy(state), "cpu")
    cpu_streams = cuda_ingest.IngestStreams(*(t.cpu() for t in streams))
    cuda_ingest.fused_ingest(state, streams, spec)
    cuda_ingest.fused_ingest_plain(cpu_state, cpu_streams, spec)
    got, want = convert.state_to_numpy(state), convert.state_to_numpy(
        cpu_state)
    err = 0.0
    for name in cuda_ingest.STATE_LEAVES:
        _check(got[name].tobytes() == want[name].tobytes(),
               f"fused_ingest leaf {name} differs from the plain version")
        if got[name].dtype == np.float32:
            with np.errstate(invalid="ignore"):     # inf - inf rows
                d = np.abs(got[name].astype(np.float64) - want[name])
            d[got[name] == want[name]] = 0.0
            err = max(err, float(np.nanmax(d, initial=0.0)))

    def run():
        cuda_ingest.fused_ingest(state, streams, spec)
    ms = _time_ms(run, device, 50)
    device_ms = _device_ms(run, 50, clock_hz)
    on = state.counter_acc.device       # cuda:0, as the wrapper sees it
    t0 = time.perf_counter()
    for _ in range(200):
        cuda_ingest._validate(state, streams, spec, on)
    checks_ms = (time.perf_counter() - t0) * 1e3 / 200
    plain_ms = _time_ms(lambda: cuda_ingest.fused_ingest_plain(
        state, streams, spec), device, plain_reps, warmup=1)
    nbytes, ops = _ingest_work(streams, spec)
    runs = {"counter": _max_run(streams.c_slot),
            "histogram": _max_run(streams.h_slot),
            "set": _max_run(streams.s_slot)}
    chain_ms = max(runs["counter"], runs["histogram"]) * 4 / clock_hz * 1e3
    bytes_ms, ops_ms = (nbytes / HBM_BYTES_PER_S * 1e3,
                        ops / FP32_OPS_PER_S * 1e3)
    bound_ms, bound_by = _bound(nbytes, ops)
    if chain_ms > bound_ms:
        bound_ms, bound_by = chain_ms, "operations"
    return dict(max_abs_err=err, ms=ms, device_ms=device_ms,
                checks_ms=checks_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, bytes_ms=bytes_ms, ops_ms=ops_ms,
                chain_ms=chain_ms, bytes=nbytes, ops=ops,
                rows=sum(s.numel() for s in (streams.c_slot, streams.g_slot,
                                              streams.st_slot, streams.s_slot,
                                              streams.h_slot)),
                max_run=runs)


def warm_ingest_state(device, spec=None):
    """The default table (or `spec`) after 8 of the main path's batches
    (digests warm, one compaction): (spec, bspec, rng, state, last batch,
    its packed buffer)."""
    import torch
    from veneur_tpu_torch.aggregation.host import BatchSpec
    from veneur_tpu_torch.aggregation.state import empty_state
    from veneur_tpu_torch.aggregation.step import (
        batch_sizes, pack_batch, packed_step_core)

    spec, bspec = spec or _default_spec(), BatchSpec()
    rng = np.random.default_rng(1)
    state = empty_state(spec, device)
    for step in range(1, 9):
        batch = _main_path_batch(rng, spec, bspec)
        flat = torch.from_numpy(pack_batch(batch, step == 8)).to(device)
        packed_step_core(state, flat, spec=spec, sizes=batch_sizes(batch),
                         do_compact=step == 8)
    return spec, bspec, rng, state, batch, flat


def kernel_ingest(device, clock_hz, spec=None) -> dict:
    """K1 at the default table and batch widths (or the table `spec`) on a
    warm state: the main path's Zipf batch, then the hot batch (one key
    per histogram and set lane)."""
    import torch
    from veneur_tpu_torch.aggregation.step import (
        Batch, batch_sizes, packed_step_core)

    spec, bspec, rng, state, batch, flat = warm_ingest_state(device, spec)
    sizes = batch_sizes(batch)
    step_ms = _time_ms(lambda: packed_step_core(
        state, flat, spec=spec, sizes=sizes, do_compact=False), device, 10)
    compact_ms = _time_ms(lambda: packed_step_core(
        state, flat, spec=spec, sizes=sizes, do_compact=True), device, 3)

    def on_card(b):
        return Batch(*(None if a is None else torch.from_numpy(a).to(device)
                       for a in b))
    out = _ingest_case(state, on_card(_main_path_batch(rng, spec, bspec)),
                       spec, device, clock_hz, plain_reps=2)
    out["hot"] = _ingest_case(state, on_card(_hot_batch(rng, spec, bspec)),
                              spec, device, clock_hz, plain_reps=1)
    out.update(step_ms=step_ms, compact_ms=compact_ms)
    return out


def _digest_rows(rng, r, c):
    mean = rng.lognormal(3.0, 1.0, (r, c)).astype(np.float32)
    weight = rng.integers(1, 4, (r, c)).astype(np.float32)
    weight[rng.uniform(size=(r, c)) < 0.4] = 0.0
    weight[::97] = 0.0                            # empty rows -> NaN
    dup = rng.choice(np.asarray([1.0, 2.0, 2.0, 5.0], np.float32), (r, c))
    mean[1::89] = dup[1::89]                      # duplicate-key rows
    live = weight > 0
    any_live = live.any(-1)
    mn = np.where(any_live, np.where(live, mean, np.inf).min(-1), np.inf)
    mx = np.where(any_live, np.where(live, mean, -np.inf).max(-1), -np.inf)
    return mean, weight, mn.astype(np.float32), mx.astype(np.float32)


def _digest_case(device, args, clock_hz) -> dict:
    """K2 on one set of card tensors (mean, weight, mn, mx, qs): within
    rtol/atol 2e-5 of the plain version with the same NaN pattern, then
    timed at the host's pace (`ms`, `_time_ms`) and on the card alone
    (`device_ms`, `_device_ms`), beside the plain version, a stable
    `torch.sort` of the same rows' keys (`sort_ms`: a yardstick for the
    sort alone, not K2's function) and the bound. The bound counts the
    operations these rows' live cells need: per row of n live cells, a
    comparison sort (n * ceil(log2 n) compare-exchanges of 4 operations),
    the prefix sum (2n) and each quantile's binary search (ceil(log2 n)
    + 6); an empty row needs only its NaNs (Q)."""
    import torch
    from veneur_tpu_torch.ops import cuda_digest

    got = cuda_digest.quantiles_rows(*args)
    want = cuda_digest.quantiles_rows_plain(*args)
    g, w = got.cpu().numpy(), want.cpu().numpy()
    _check(np.array_equal(np.isnan(g), np.isnan(w)),
           "quantiles_rows NaN pattern differs from the plain version")
    ok = ~np.isnan(w)
    _check(np.allclose(g[ok], w[ok], rtol=2e-5, atol=2e-5),
           "quantiles_rows differs from the plain version beyond 2e-5")
    err = float(np.abs(g[ok].astype(np.float64) - w[ok]).max(initial=0.0))
    mean, weight = args[0], args[1]
    rows, c = mean.shape
    live = (weight > 0).sum(-1).float()
    keys = torch.where(weight > 0, mean, math.inf)

    def run():
        cuda_digest.quantiles_rows(*args)
    ms = _time_ms(run, device, 20)
    device_ms = _device_ms(run, 50, clock_hz)
    plain_ms = _time_ms(lambda: cuda_digest.quantiles_rows_plain(*args),
                        device, 5)
    sort_ms = _time_ms(lambda: torch.sort(keys, dim=-1, stable=True),
                       device, 5)
    q = args[4].shape[0]
    n = live.double()
    lg = torch.ceil(torch.log2(n.clamp(min=1)))
    nbytes = rows * c * 8 + rows * 8 + q * 4 + rows * q * 4
    ops = float(torch.where(n > 0, 4 * n * lg + 2 * n + q * (lg + 6),
                            q).sum())
    bound_ms, bound_by = _bound(nbytes, ops)
    return dict(rows=rows, cells=c, q=q, max_abs_err=err, ms=ms,
                device_ms=device_ms, plain_ms=plain_ms, sort_ms=sort_ms,
                bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes, ops=ops,
                live_p50=float(live.quantile(0.5)),
                live_p99=float(live.quantile(0.99)),
                live_max=int(live.max()), library_ms=None)


def kernel_digest(device, clock_hz, rows: int, c: int | None = None) -> dict:
    """K2 on `rows` synthetic digest rows of `c` cells (the live table's
    472 unless given), ~60% live, empty and duplicate-key rows included,
    Q=4."""
    import torch
    from veneur_tpu_torch.ops import cuda_digest

    c = c or _default_spec().total_cells
    rng = np.random.default_rng(rows)
    qs = np.asarray([0.5, 0.9, 0.99, 0.5], np.float32)   # + median column
    args = [torch.from_numpy(a).to(device)
            for a in (*_digest_rows(rng, rows, c), qs)]
    got = cuda_digest.quantiles_rows(*args).cpu().numpy()
    _check(np.isnan(got[::97]).all(), "empty digest rows must give NaN")
    return _digest_case(device, args, clock_hz)


def kernel_digest_wide(device, clock_hz, c: int, rows: int = 1 << 14) -> dict:
    """K2's wide-row kernel on `rows` rows of `c` cells (2,056 at
    compression 1,279; 3,928 at 2,400) with a flush's live counts: most
    rows 1-8 live cells, 9% tens to hundreds, 1% 60-100% live, every 97th
    empty; Q=4. Held and timed as `_digest_case` holds and times K2."""
    import torch
    from veneur_tpu_torch.ops import cuda_digest

    gen = torch.Generator(device=device)
    gen.manual_seed(c)
    u = torch.rand(rows, device=device, generator=gen)
    n = torch.randint(1, 9, (rows,), device=device, generator=gen).float()
    n = torch.where(u < 0.09, torch.randint(10, 400, (rows,), device=device,
                                            generator=gen).float(), n)
    n = torch.where(u > 0.99, (0.6 + 0.4 * torch.rand(
        rows, device=device, generator=gen)) * c, n)
    n[::97] = 0.0
    mean = torch.empty((rows, c), device=device).log_normal_(
        3.0, 1.0, generator=gen)
    on = torch.rand((rows, c), device=device, generator=gen) < (n / c)[:, None]
    weight = on * torch.randint(1, 4, (rows, c), device=device,
                                generator=gen).float()
    args = (mean, weight, torch.where(on, mean, math.inf).amin(-1),
            torch.where(on, mean, -math.inf).amax(-1),
            torch.tensor([0.5, 0.9, 0.99, 0.5], device=device))
    _check(c > cuda_digest.SMEM_CELLS, f"{c} cells is not a wide row")
    return _digest_case(device, args, clock_hz)


def digest_live_sweep(device, clock_hz, rows: int = 1 << 17,
                      live=(0, 4, 32, 64, 128, 256, 472)) -> dict:
    """K2's time on the card alone against the live cells per row: `rows`
    rows of the live table's 472 cells, each with exactly n live cells at
    random positions, Q=4; each case within rtol/atol 2e-5 of the plain
    version with the same NaN pattern. Returns {n: device ms}."""
    import torch
    from veneur_tpu_torch.ops import cuda_digest

    c = _default_spec().total_cells
    gen = torch.Generator(device=device)
    gen.manual_seed(11)
    mean = torch.empty((rows, c), device=device).log_normal_(
        3.0, 1.0, generator=gen)
    qs = torch.tensor([0.5, 0.9, 0.99, 0.5], device=device)
    out = {}
    for n in live:
        key = torch.rand((rows, c), device=device, generator=gen)
        kth = key.kthvalue(max(n, 1), dim=-1, keepdim=True).values
        weight = (key <= kth).float() * (n > 0)
        on = weight > 0
        args = (mean, weight, torch.where(on, mean, math.inf).amin(-1),
                torch.where(on, mean, -math.inf).amax(-1), qs)
        got = cuda_digest.quantiles_rows(*args)
        want = cuda_digest.quantiles_rows_plain(*args)
        _check(torch.equal(got.isnan(), want.isnan()) and torch.allclose(
            got.nan_to_num(), want.nan_to_num(), rtol=2e-5, atol=2e-5),
            f"quantiles_rows differs from the plain version at {n} live")
        out[n] = _device_ms(lambda: cuda_digest.quantiles_rows(*args), 20,
                            clock_hz)
    return out


def _digest_sequence(device, calls, clock_hz) -> dict:
    """K2's share of a range batch: every captured call held to its plain
    version (as _digest_case does), then all of them made back to back,
    timed at the host's pace and on the card alone."""
    from veneur_tpu_torch.ops import cuda_digest
    cases = [_digest_case(device, args, clock_hz) for args in calls]

    def run():
        for args in calls:
            cuda_digest.quantiles_rows(*args)
    return dict(calls=len(calls), rows=[c["rows"] for c in cases][:4],
                cells=cases[0]["cells"],
                max_abs_err=max(c["max_abs_err"] for c in cases),
                ms=_time_ms(run, device, 20),
                device_ms=_device_ms(run, 20, clock_hz),
                bound_ms=sum(c["bound_ms"] for c in cases))


@contextlib.contextmanager
def digest_calls():
    """Yields a list that gathers the arguments of every K2 call made
    inside the block, by wrapping cuda_digest.quantiles_rows
    (tdigest.quantiles looks it up at each call); restores it after."""
    from veneur_tpu_torch.ops import cuda_digest
    calls, orig = [], cuda_digest.quantiles_rows

    def record(*args):
        calls.append(args)
        return orig(*args)
    cuda_digest.quantiles_rows = record
    try:
        yield calls
    finally:
        cuda_digest.quantiles_rows = orig


def _recapture_flush(agg, state, table, res, label):
    """Run the flush once more on the same swapped state, with K2's inputs
    captured, and check that it answers byte for byte as the timed flush
    did (so the captured tensors are the ones that flush handed K2). The
    timed flush itself runs unwrapped."""
    with digest_calls() as calls:
        again, _table = agg.compute_flush(state, table, PERCENTILES)
    _check(all(np.asarray(again[k]).tobytes() == np.asarray(res[k]).tobytes()
               for k in res), f"{label}: the repeated flush differs")
    _check(len(calls) >= 1, f"{label}: the flush never called K2")
    return calls


def _merge_work(n: int, sel: np.ndarray, nw: int):
    """(bytes, operations) of one window merge: every column that some
    step selects is read once per row, the output written once; the
    16 shift/mask/max per 3 words are counted as operations."""
    cols = int((sel > 0).any(axis=0).sum())
    words_in = n * cols * nw
    words_out = n * sel.shape[0] * nw
    ops = int((sel > 0).sum()) * n * nw // 3 * 16 * 3 + words_out // 3 * 32
    return (words_in + words_out) * 4, ops


def _k3_sel(windows: int, tiers: int, steps: int = 32) -> np.ndarray:
    """Step masks over a full ring: 16 tier-0 single columns, covers
    that mix a tier-0 column with decimated tier 1-3 columns, one step
    over every column and one over none."""
    w = windows * (tiers + 1)
    sel = np.zeros((steps, w), np.float32)
    for i in range(16):
        sel[i, i] = 1.0
    for j in range(steps - 18):
        sel[16 + j, [20 + j] + [t * windows + j for t in range(1, tiers + 1)]
            ] = 1.0
    sel[steps - 2] = 1.0
    return sel


def _k3_rows(device, p, n, windows, tiers):
    """The default ring's full set shape: n rows x windows * (tiers + 1)
    columns of packed registers 0..61 (p), some all-zero rows and
    columns."""
    import torch
    from veneur_tpu_torch.ops import hll

    w, nw = windows * (tiers + 1), hll.packed_words(p)
    gen = torch.Generator(device=device)
    gen.manual_seed(3)
    rows = torch.empty((n, w, nw), dtype=torch.int32, device=device)
    for c in range(w):
        regs = torch.randint(0, 62, (n, hll.num_registers(p)), generator=gen,
                             dtype=torch.uint8, device=device)
        rows[:, c] = hll.pack_registers(regs, precision=p)
    rows[::37] = 0
    rows[:, ::41] = 0
    return rows


def kernel_merge_windows(device, clock_hz, p=14, n=256, windows=90,
                         tiers=3) -> dict:
    """K3 at the default ring's full set shape: 256 rows x 360 columns
    x 3072 words (p=14) and 32 steps (`_k3_sel`): byte-exact against its
    plain version, timed at the host's pace and on the card alone."""
    import torch
    from veneur_tpu_torch.ops import cuda_history

    rows = _k3_rows(device, p, n, windows, tiers)
    nw = rows.shape[2]
    sel_np = _k3_sel(windows, tiers)
    sel = torch.from_numpy(sel_np).to(device)
    got = cuda_history.merge_windows_packed(rows, sel, precision=p)
    want = cuda_history.merge_windows_packed_plain(rows, sel, precision=p)
    torch.cuda.synchronize()
    _check(torch.equal(got, want),
           "merge_windows differs from the plain version")
    _check(not got[:, -1].any() and bool(got[1:, -2].any()),
           "merge_windows: empty / all-column step wrong")
    err = float((got.long() - want.long()).abs().max())
    del want, got

    def run():
        cuda_history.merge_windows_packed(rows, sel, precision=p)
    ms = _time_ms(run, device, 20)
    device_ms = _device_ms(run, 20, clock_hz)
    plain_ms = _time_ms(lambda: cuda_history.merge_windows_packed_plain(
        rows, sel, precision=p), device, 2, warmup=1)
    nbytes, ops = _merge_work(n, sel_np, nw)
    bound_ms, bound_by = _bound(nbytes, ops)
    return dict(rows=n, cols=rows.shape[1], words=nw, steps=sel_np.shape[0],
                max_abs_err=err, ms=ms, device_ms=device_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                bytes=nbytes, ops=ops)


def kernel_merge_windows_idx(device, clock_hz, p=14, n=256, windows=90,
                             tiers=3) -> dict:
    """K3's row-index form over the full set shape as a ring of 256 rows:
    200 picks, repeated ones and ones below 0 and past the ring (clamped)
    included, `_k3_sel`'s 32 steps: byte-exact against its plain version,
    timed at the host's pace and on the card alone."""
    import torch
    from veneur_tpu_torch.ops import cuda_history

    rows = _k3_rows(device, p, n, windows, tiers)
    sel_np = _k3_sel(windows, tiers)
    sel = torch.from_numpy(sel_np).to(device)
    pick = np.random.default_rng(4).permutation(n)[:200]
    pick[::50] = pick[1::50]                           # repeated rows
    pick[7], pick[8] = -4, n + 9                       # clamped
    idx = torch.from_numpy(pick.astype(np.int32)).to(device)
    got = cuda_history.merge_windows_packed(rows, sel, precision=p, idx=idx)
    want = cuda_history.merge_windows_packed_plain(rows, sel, precision=p,
                                                   idx=idx)
    torch.cuda.synchronize()
    _check(torch.equal(got, want),
           "merge_windows (row index) differs from the plain version")
    del got, want

    def run():
        cuda_history.merge_windows_packed(rows, sel, precision=p, idx=idx)
    nbytes, ops = _merge_work(idx.numel(), sel_np, rows.shape[2])
    bound_ms, bound_by = _bound(nbytes, ops)
    return dict(picks=idx.numel(), ring_rows=n, max_abs_err=0.0,
                ms=_time_ms(run, device, 20),
                device_ms=_device_ms(run, 20, clock_hz), bound_ms=bound_ms,
                bound_by=bound_by)


# -- phase 4: the main path at the default widths ------------------------------

def make_lines(rng, n: int):
    """DogStatsD lines: 35% counters over 10k names (a third tagged, some
    with @0.5/@0.25), 35% Zipf-hot timers over 10k names (half tagged),
    20% gauges over 1k names, 10% Zipf sets over 1k names drawing
    members from 100k uids. The gauge lane fills first, every ~10k
    lines."""
    kind = rng.choice(4, n, p=[0.35, 0.35, 0.2, 0.1])
    c_name = rng.integers(0, 10_000, n)
    c_val = rng.integers(1, 9, n)
    rates = np.asarray([b"", b"|@0.5", b"|@0.25"])[rng.choice(3, n,
                                                            p=[.6, .2, .2])]
    t_name = (rng.zipf(1.2, n) - 1) % 10_000
    t_val = rng.lognormal(3.0, 0.5, n)
    g_name = rng.integers(0, 1000, n)
    g_val = rng.normal(size=n)
    s_name = (rng.zipf(1.3, n) - 1) % 1000
    s_uid = rng.integers(0, 100_000, n)
    out = []
    for i in range(n):
        k = kind[i]
        if k == 0:
            tags = b"|#env:prod,team:%d" % (c_name[i] % 7) \
                if c_name[i] % 3 == 0 else b""
            out.append(b"api.requests.%d:%d|c%s%s" % (
                c_name[i], c_val[i], rates[i], tags))
        elif k == 1:
            tags = b"|#route:r%d" % (t_name[i] % 5) \
                if t_name[i] % 2 == 0 else b""
            out.append(b"api.latency.%d:%.4f|ms%s" % (t_name[i], t_val[i],
                                                      tags))
        elif k == 2:
            out.append(b"queue.depth.%d:%.4f|g" % (g_name[i], g_val[i]))
        else:
            out.append(b"users.active.%d:uid-%d|s" % (s_name[i], s_uid[i]))
    return out


def _oracle(lines):
    """Exact answers from the raw lines, keyed by (name, joined tags)."""
    counters, gauges, timers, sets = {}, {}, {}, {}
    for line in lines:
        head, *rest = line.split(b"|")
        name, value = head.split(b":", 1)
        mtype = rest[0]
        rate, tags = 1.0, b""
        for part in rest[1:]:
            if part.startswith(b"@"):
                rate = float(part[1:])
            else:
                tags = b",".join(sorted(part[1:].split(b",")))
        key = (name.decode(), tags.decode())
        if mtype == b"c":
            counters[key] = counters.get(key, 0.0) + float(
                np.float32(float(value) * (1.0 / rate)))
        elif mtype == b"g":
            gauges[key] = float(np.float32(float(value)))
        elif mtype == b"ms":
            timers.setdefault(key, []).append(float(np.float32(float(value))))
        else:
            sets.setdefault(key, set()).add(value)
    return counters, gauges, timers, sets


def _check_flush(res, table, counters, gauges, timers, sets, label,
                 gate_quantiles=True):
    """Hold one flush to the exact oracles; returns what was checked.
    Without gate_quantiles the p50/p99 errors are measured, not held."""
    def rows(kind):
        return [(m.name, m.joined_tags or "") for _s, m in
                table.get_meta(kind)]

    c_keys = rows("counter")
    _check(len(c_keys) == len(counters), f"{label}: counter keys")
    got = np.asarray(res["counter"], np.float64)
    want = np.asarray([counters[k] for k in c_keys], np.float64)
    _check(np.array_equal(got, want),
           f"{label}: counters differ from the f64 oracle "
           f"(max |err| {np.abs(got - want).max()})")
    g_keys = rows("gauge")
    _check(len(g_keys) == len(gauges), f"{label}: gauge keys")
    _check(np.array_equal(np.asarray(res["gauge"], np.float64),
                          [gauges[k] for k in g_keys]),
           f"{label}: gauges are not the last write")
    h_keys = rows("histogram")
    _check(len(h_keys) == len(timers), f"{label}: timer keys")
    hq = np.asarray(res["histo_quantiles"])
    _check(hq.shape == (len(h_keys), len(PERCENTILES))
           and np.isfinite(hq).all(), f"{label}: quantiles not finite")
    by_len = {}
    for i, k in enumerate(h_keys):
        if len(timers[k]) >= 24:
            by_len.setdefault(len(timers[k]), []).append(i)
    worst = {0.5: 0.0, 0.99: 0.0}
    checked = 0
    for n, idx in by_len.items():
        vals = np.asarray([timers[h_keys[i]] for i in idx])
        for qi, q, tol in ((0, 0.5, 0.06), (2, 0.99, 0.01)):
            exact = midpoint_quantile_rows(vals, q)
            rel = np.abs(hq[idx, qi] - exact) / np.maximum(np.abs(exact),
                                                           1e-9)
            worst[q] = max(worst[q], float(rel.max()))
            _check(not gate_quantiles or (rel < tol).all(),
                   f"{label}: p{int(q * 100)} off by "
                   f"{rel.max():.4f} on a {n}-sample key")
        checked += len(idx)
    _check(checked >= 8, f"{label}: quantile oracle checked {checked} keys")
    s_keys = rows("set")
    _check(len(s_keys) == len(sets), f"{label}: set keys")
    est = np.asarray(res["set_estimate"], np.float64)
    exact = np.asarray([len(sets[k]) for k in s_keys], np.float64)
    # below ~100 members one register collision alone costs 1/n
    big = exact >= 100
    rel = np.abs(est[big] - exact[big]) / exact[big]
    _check(big.sum() >= 8 and (rel < 0.05).all(),
           f"{label}: HLL off by {rel.max():.4f}")
    return dict(counters=len(c_keys), gauges=len(g_keys),
                timers=len(h_keys), sets=len(s_keys),
                quantile_keys_checked=checked,
                worst_p50_rel=worst[0.5], worst_p99_rel=worst[0.99],
                worst_hll_rel=float(rel.max()))


def main_path(device, lines) -> dict:
    """Parse, key and ingest the lines through Aggregator on `device`,
    flush and label; returns timings, launch counts and oracle results."""
    import torch
    from veneur_tpu_torch.aggregation.host import BatchSpec
    from veneur_tpu_torch.ops import cuda_digest, cuda_history, cuda_ingest
    from veneur_tpu_torch.samplers.parser import parse_metric
    from veneur_tpu_torch.server.aggregator import Aggregator
    from veneur_tpu_torch.server.flusher import generate_intermetrics

    agg = Aggregator(_default_spec(), BatchSpec(), device=device)
    cuda_ingest.launches = cuda_digest.launches = cuda_history.launches = 0
    t0 = time.perf_counter()
    for line in lines:
        agg.process_metric(parse_metric(line))
    state, table = agg.swap()
    if device.type == "cuda":
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    res, table = agg.compute_flush(state, table, PERCENTILES)
    t2 = time.perf_counter()
    ims = generate_intermetrics(res, table, percentiles=PERCENTILES,
                                aggregates=AGGREGATES, is_local=False,
                                timestamp=int(time.time()))
    t3 = time.perf_counter()
    launches = {"fused_ingest": cuda_ingest.launches,
                "digest_quantiles": cuda_digest.launches,
                "merge_windows": cuda_history.launches}
    captured = _recapture_flush(agg, state, table, res, "default")
    checked = _check_flush(res, table, *_oracle(lines), label="default")
    n_h = checked["timers"]
    want_ims = (checked["counters"] + checked["gauges"] + checked["sets"]
                + n_h * (len(AGGREGATES) + len(PERCENTILES)))
    _check(len(ims) == want_ims, f"{len(ims)} InterMetrics, want {want_ims}")
    _check(all(math.isfinite(m.value) for m in ims),
           "non-finite InterMetric value")
    return dict(lines=len(lines), steps=agg.steps_total,
                launches=launches, ingest_s=t1 - t0,
                samples_per_s=len(lines) / (t1 - t0),
                **_step_times(agg), flush_ms=(t2 - t1) * 1e3,
                label_ms=(t3 - t2) * 1e3, intermetrics=len(ims),
                h2d_bytes=agg.h2d_bytes, **checked), captured, ims


def _step_times(agg) -> dict:
    """The aggregator's step accounting: `steps_host_s`, the host's time
    enqueueing every ingest step (the torch prologue's launches, K1's,
    the fold's, compaction's); `step_ms`, that per step; `synced_ms`, the
    host's waits for the card at the sampled steps (every 64th, with their
    dispatch) and at the swap, over `steps_synced` samples."""
    return dict(steps_host_s=agg.dispatch_ns / 1e9,
                step_ms=agg.dispatch_ns / 1e6 / max(agg.steps_total, 1),
                synced_ms=agg.step_ns / 1e6, steps_synced=agg.steps_synced)


# -- phase 8: the native path at the default widths ---------------------------

def _datagrams(lines, size: int = 1400):
    """Lines joined by newlines into datagrams of at most ~`size` bytes."""
    out, cur, n = [], [], 0
    for line in lines:
        if cur and n + len(line) + 1 > size:
            out.append(b"\n".join(cur))
            cur, n = [], 0
        cur.append(line)
        n += len(line) + 1
    if cur:
        out.append(b"\n".join(cur))
    return out


def _lines_seen(agg) -> int:
    """Lines the engine has parsed: processed, refused or dropped."""
    st = agg.eng.stats()
    return st["processed"] + st["parse_errors"] + st["dropped"]


def _wait_lines(agg, n: int, label: str, timeout_s: float = 120.0,
                failed=()) -> None:
    """pump(20), the server's packet loop, until the engine has parsed
    `n` lines (or a sender thread has put its error in `failed`)."""
    t0 = time.perf_counter()
    while _lines_seen(agg) < n:
        _check(not failed, f"{label}: sender failed: {list(failed)}")
        _check(time.perf_counter() - t0 < timeout_s,
               f"{label}: {_lines_seen(agg)} of {n} lines parsed after "
               f"{timeout_s:.0f} s")
        agg.pump(20)


def _udp_route(agg, datagrams, n_lines: int) -> None:
    """The default config's route: one C++ recvmmsg reader on a loopback
    socket, fed by a sender thread that sends 64 datagrams at a time and
    waits until the reader has them all (so that none is lost in the
    socket), while this thread runs pump(20)."""
    import socket
    import threading
    rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rx.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 1 << 22)
    rx.bind(("127.0.0.1", 0))
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    addr = rx.getsockname()
    agg.readers_start([rx.fileno()])
    failed = []

    def send():
        try:
            for i in range(0, len(datagrams), 64):
                for d in datagrams[i:i + 64]:
                    tx.sendto(d, addr)
                sent = min(i + 64, len(datagrams))
                t0 = time.perf_counter()
                while agg.reader_counters()["datagrams"] < sent:
                    if time.perf_counter() - t0 > 30:
                        raise TimeoutError(f"reader has not taken datagram "
                                           f"{sent} after 30 s")
                    time.sleep(0.0002)
        except BaseException as e:      # reported on the main thread
            failed.append(e)
    th = threading.Thread(target=send)
    th.start()
    try:
        _wait_lines(agg, n_lines, "native udp", failed=failed)
    finally:
        th.join()
        rx.close()
        tx.close()
    _check(not failed, f"native udp: sender failed: {failed}")


def _ring_waves(lines, rings: int, spread: bool, wave: int = 10_000):
    """The rings route's traffic, made before it is timed: waves of
    `wave` lines (the lines a single-ring step carries at the default
    widths, where the gauge lane fills), each a list of (ring, datagram)
    in injection order, and the lines in it. A line's ring is picked by
    its name, as when each key comes from one sender, whose datagrams
    SO_REUSEPORT keeps on one socket; with `spread`, the lines are dealt
    over the rings in turn, as when many senders share the keys, and
    only a gauge's lines stay on its name's ring (so that its last write
    is the oracle's; across rings it would follow the threads' timing).
    Waves keep a step's lines, and so the lines between two compactions,
    those of phase 4: unpaced, a ring step carries up to four single-ring
    steps' lines (PERF.md §6, PR 7)."""
    import zlib
    out = []
    for w in range(0, len(lines), wave):
        per = [[] for _ in range(rings)]
        for i, line in enumerate(lines[w:w + wave]):
            head, kind = line.split(b"|", 2)[:2]
            r = i if spread and kind != b"g" else zlib.crc32(
                head.split(b":", 1)[0])
            per[r % rings].append(line)
        grams = [_datagrams(p) for p in per]
        out.append(([(r, grams[r][i]) for i in range(max(map(len, grams)))
                     for r in range(rings) if i < len(grams[r])],
                    sum(map(len, per))))
    return out


def _rings_route(agg, waves, rings: int) -> None:
    """rings_start(rings), then per wave: every datagram through
    rings_inject, a wait until the ring workers have parsed the whole
    wave, and one pump(0), which runs its step."""
    from veneur_tpu_torch.native import INJECT_OK
    agg.rings_start(rings)
    sent = 0
    for grams, n_lines in waves:
        for r, d in grams:
            v = agg.eng.rings_inject(r, d)
            _check(v == INJECT_OK, f"native rings: inject verdict {v}")
        sent += n_lines
        t0 = time.perf_counter()
        while _lines_seen(agg) < sent:
            _check(time.perf_counter() - t0 < 60,
                   f"native rings: {_lines_seen(agg)} of {sent} lines "
                   "parsed after 60 s")
            time.sleep(0.0002)
        agg.pump(0)


def _same_intermetrics(got, want, label, by_key: bool = False) -> float:
    """Two flushes of the same lines: the same names, tags and types in
    the same order (sorted by key with `by_key`, for flushes that order
    their rows differently), percentiles and medians within rtol/atol
    2e-5, every other value equal. Returns the worst percentile gap."""
    def key(m):
        return (m.name, tuple(m.tags))
    if by_key:
        got, want = sorted(got, key=key), sorted(want, key=key)
    _check([(m.name, m.tags, m.type) for m in got]
           == [(m.name, m.tags, m.type) for m in want],
           f"{label}: InterMetric names, tags or types differ")
    worst = 0.0
    for g, w in zip(got, want):
        tail = g.name.rsplit(".", 1)[-1]
        if tail.endswith("percentile") or tail == "median":
            d = abs(g.value - w.value)
            _check(d <= 2e-5 + 2e-5 * abs(w.value),
                   f"{label}: {g.name} {g.value} vs {w.value}")
            worst = max(worst, d)
        else:
            _check(g.value == w.value,
                   f"{label}: {g.name} {g.value} vs {w.value}")
    return worst


def native_path(device, lines, python_ims) -> dict:
    """Phase 4's lines through NativeAggregator on the card, the default
    config's ingest path, by three routes: `feed` (datagrams handed to
    the engine), `udp` (a loopback socket, the C++ reader and pump(20))
    and `rings` (four rings, rings_inject, each name on one ring). Each
    run is flushed, held to phase 4's oracles, and must launch K1 on
    every step (on every ring of every step with rings) and K2 in its
    flush; `feed` must flush phase 4's Python-path InterMetrics, and
    `udp` what `feed` flushes. A fourth run, `rings_spread`, deals every
    key over the four rings: it is held to the same gates but for the
    quantile tolerances, whose errors it reports (PERF.md §6, PR 7)."""
    import torch
    from veneur_tpu_torch.aggregation.host import BatchSpec
    from veneur_tpu_torch.ops import cuda_digest, cuda_history, cuda_ingest
    from veneur_tpu_torch.server.flusher import generate_intermetrics
    from veneur_tpu_torch.server.native_aggregator import NativeAggregator

    datagrams = _datagrams(lines)
    waves = {"rings": _ring_waves(lines, 4, spread=False),
             "rings_spread": _ring_waves(lines, 4, spread=True)}
    oracle = _oracle(lines)
    out, ims_by = {}, {}
    for route in ("feed", "udp", "rings", "rings_spread"):
        agg = NativeAggregator(_default_spec(), BatchSpec(), device=device)
        acc = {"parse": 0, "emit": 0}
        if route == "feed":
            # the engine's own calls on this thread, timed in place
            for name, key in (("feed", "parse"), ("emit_packed", "emit")):
                def timed(*a, _fn=getattr(agg.eng, name), _key=key):
                    t = time.perf_counter_ns()
                    r = _fn(*a)
                    acc[_key] += time.perf_counter_ns() - t
                    return r
                setattr(agg.eng, name, timed)
        cuda_ingest.launches = cuda_digest.launches = 0
        cuda_history.launches = 0
        t0 = time.perf_counter()
        try:
            sent = len(datagrams)
            if route == "feed":
                for d in datagrams:
                    agg.feed(d)
            elif route == "udp":
                _udp_route(agg, datagrams, len(lines))
            else:
                _rings_route(agg, waves[route], 4)
                sent = sum(len(g) for g, _n in waves[route])
            state, table = agg.swap()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            rings = agg.ring_stats()
            readers = agg.reader_counters()
            # the ring parsers' counts are the engine's only while the
            # rings run
            counts = (agg.processed, agg.dropped_capacity,
                      agg.extra_parse_errors())
        finally:
            agg.readers_stop()
        res, table = agg.compute_flush(state, table, PERCENTILES)
        t2 = time.perf_counter()
        ims_by[route] = generate_intermetrics(
            res, table, percentiles=PERCENTILES, aggregates=AGGREGATES,
            is_local=False, timestamp=int(time.time()))
        launches = {"fused_ingest": cuda_ingest.launches,
                    "digest_quantiles": cuda_digest.launches,
                    "merge_windows": cuda_history.launches}
        label = f"native {route}"
        per_step = 4 if route.startswith("rings") else 1
        _check(launches["fused_ingest"] == per_step * agg.steps_total > 0,
               f"{label}: {launches['fused_ingest']} K1 launches for "
               f"{agg.steps_total} steps")
        _check(launches["digest_quantiles"] >= 1,
               f"{label}: K2 never launched by the flush")
        _check(counts == (len(lines), 0, 0),
               f"{label}: (processed, dropped, parse errors) {counts} for "
               f"{len(lines)} lines")
        if route == "udp":
            _check(readers["datagrams"] == len(datagrams)
                   and readers["ring_dropped"] == 0
                   and readers["toolong"] == 0,
                   f"{label}: reader counters {readers}")
        emit_s = (acc["emit"] if route == "feed"
                  else rings["emit_packed_ns"]) / 1e9
        r = dict(lines=len(lines), datagrams=sent,
                 steps=agg.steps_total, launches=launches,
                 ingest_s=t1 - t0, samples_per_s=len(lines) / (t1 - t0),
                 **_step_times(agg), flush_ms=(t2 - t1) * 1e3,
                 h2d_bytes=agg.h2d_bytes, emit_packed_s=emit_s,
                 parse_s=acc["parse"] / 1e9 if route == "feed" else None)
        # what is left of the ingest wall: Python, waits, and (feed) the
        # copies; with readers the parse runs on C++ threads beside it
        r["other_s"] = r["ingest_s"] - r["steps_host_s"] - emit_s - (
            r["parse_s"] or 0.0)
        print(f"native path, {route} (default widths):", json.dumps(r),
              flush=True)
        r.update(_check_flush(res, table, *oracle, label=label,
                              gate_quantiles=route != "rings_spread"))
        out[route] = r
        del agg, state, res
        torch.cuda.empty_cache()
    out["feed"]["worst_percentile_gap_vs_python"] = _same_intermetrics(
        ims_by["feed"], python_ims, "native feed vs the Python path")
    out["udp"]["worst_percentile_gap_vs_feed"] = _same_intermetrics(
        ims_by["udp"], ims_by["feed"], "native udp vs feed")
    return out, ims_by["udp"]


# -- phase 9: the Server on the card --------------------------------------------

def _server_config(**kw):
    """The default config's Server at the default widths (the `tpu_*`
    defaults: the phase 4 cell's ~114 MB of state): native ingest with
    the C++ readers on one ring, a UDP listener and the HTTP API on
    ports the kernel picks. The interval is an hour, so that every flush
    of the phase is one it asks for."""
    from veneur_tpu_torch.config import Config
    base = dict(interval="3600s", hostname="", metric_max_length=4096,
                read_buffer_size_bytes=1 << 22, percentiles=PERCENTILES,
                aggregates=AGGREGATES, native_ingest=True,
                native_udp_readers=True, reader_rings=1,
                statsd_listen_addresses=["udp://127.0.0.1:0"],
                http_address="127.0.0.1:0", prometheus_metrics_enabled=True,
                profile_capture_enabled=True)
    base.update(kw)
    return Config(**base)


def _send_paced(srv, datagrams, label: str) -> float:
    """Phase 8's pacing through the Server's listener: 64 datagrams at a
    time, then a wait until the C++ reader has taken them all, so that
    none is lost in the socket. Returns the seconds it took."""
    import socket
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    base = srv.packets_received
    t0 = time.perf_counter()
    try:
        for i in range(0, len(datagrams), 64):
            for d in datagrams[i:i + 64]:
                tx.sendto(d, srv.local_addr())
            sent = min(i + 64, len(datagrams))
            t1 = time.perf_counter()
            while srv.packets_received - base < sent:
                _check(time.perf_counter() - t1 < 30,
                       f"{label}: the reader has not taken datagram {sent} "
                       "after 30 s")
                time.sleep(0.0002)
    finally:
        tx.close()
    return time.perf_counter() - t0


def _wait_seen(srv, base: int, n: int, label: str) -> None:
    """Until the engine has parsed `n` wire lines since `base` (its own
    count: the server's self-metrics, which re-enter through the Python
    path, are not in it)."""
    t0 = time.perf_counter()
    while _lines_seen(srv.aggregator) - base < n:
        _check(time.perf_counter() - t0 < 120,
               f"{label}: {_lines_seen(srv.aggregator) - base} of {n} lines "
               "parsed after 120 s")
        time.sleep(0.0005)


def _phase_sums(srv) -> dict:
    """veneur.flush.phase_duration_ns sums by phase, in ns."""
    t = srv.metrics.get("veneur.flush.phase_duration_ns")
    return {lv[0]: st.sum for lv, st in t.snapshot(qs=())}


def _flush_interval(srv, label: str) -> tuple:
    """One manual flush: its wall ms, each flush phase's ms (the phase
    timer's growth), and the flush's own compute_flush outputs, captured
    by a wrapper around the aggregator's."""
    agg = srv.aggregator
    captured = []
    orig = agg.compute_flush

    def capture(state, table, percentiles, **kw):
        res, table = orig(state, table, percentiles, **kw)
        captured.append((res, table))
        return res, table
    agg.compute_flush = capture
    before = _phase_sums(srv)
    t0 = time.perf_counter()
    try:
        _check(srv.trigger_flush(timeout=300), f"{label}: flush failed")
    finally:
        del agg.compute_flush
    wall_ms = (time.perf_counter() - t0) * 1e3
    after = _phase_sums(srv)
    _check(len(captured) == 1, f"{label}: {len(captured)} compute_flush calls")
    phases = {k: (v - before.get(k, 0.0)) / 1e6 for k, v in after.items()}
    return wall_ms, phases, captured[0]


class _AppTable:
    """The key table of a server flush less the server's own keys
    (veneur.* self-metrics and span-name sets that its self-telemetry
    feeds back from earlier flushes), with its flush rows to match: what
    _check_flush holds to the oracle of the lines sent."""

    ROWS = {"counter": ("counter",), "gauge": ("gauge",),
            "set": ("set_estimate",), "histogram": ("histo_quantiles",)}

    def __init__(self, res, table):
        self.metas, self.res = {}, {}
        for kind, keys in self.ROWS.items():
            metas = table.get_meta(kind)
            keep = [i for i, (_s, m) in enumerate(metas)
                    if not m.name.startswith(("veneur.", "ssf."))]
            self.metas[kind] = [metas[i] for i in keep]
            for key in keys:
                self.res[key] = np.asarray(res[key])[keep]

    def get_meta(self, kind):
        return self.metas[kind]


def _check_server_flush(res, table, lines, label) -> dict:
    app = _AppTable(res, table)
    return _check_flush(app.res, app, *_oracle(lines), label=label)


def _app_ims(sink):
    """The flushed InterMetrics that are not self-telemetry, by key."""
    return sorted((m for m in sink.flushed
                   if not m.name.startswith("veneur.")
                   and m.name != "ssf.names_unique"),
                  key=lambda m: (m.name, tuple(m.tags)))


def _http(port: int, path: str):
    import urllib.request
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=120) as r:
        return r.status, r.read()


def _hbm_series(exposition: str, name: str) -> dict:
    import re
    pat = re.compile(r'^%s\{device="([^"]+)"\} (\S+)$' % name)
    out = {}
    for line in exposition.splitlines():
        m = pat.match(line)
        if m:
            out[m.group(1)] = float(m.group(2))
    return out


def _trace_kernels(trace_dir: str, window_s: float) -> dict:
    """Kernel events of a torch.profiler Chrome trace: their count, their
    names, and the card's busy share of the capture window (the union of
    kernel intervals over the window)."""
    import os
    with open(os.path.join(trace_dir, "trace.json")) as f:
        events = json.load(f).get("traceEvents", [])
    kern = sorted((e["ts"], e["ts"] + e.get("dur", 0), e["name"])
                  for e in events if e.get("cat") == "kernel")
    busy, end = 0.0, -math.inf
    for t0, t1, _n in kern:
        if t1 > end:
            busy += t1 - max(t0, end)
            end = t1
    return dict(kernel_events=len(kern),
                names=sorted({n for _a, _b, n in kern}),
                busy_us=busy, busy_share=busy / (window_s * 1e6))


def _cli_daemon(lines) -> dict:
    """The CLI as a user starts it, in a process of its own on the card:
    `python -m veneur_tpu_torch.cli.server -f cfg.yaml` with a 2 s
    interval and the local-file plugin. Lines are sent until the ticker
    writes them to the TSV; SIGTERM must end it with exit code 0."""
    import os
    import signal
    import socket
    import tempfile
    root = os.path.dirname(os.path.abspath(__file__))
    work = tempfile.mkdtemp(prefix="chip-smoke-cli-")
    probe = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    cfg = os.path.join(work, "cfg.yaml")
    tsv = os.path.join(work, "out.tsv")
    with open(cfg, "w") as f:
        f.write('interval: "2s"\n'
                f'statsd_listen_addresses: ["udp://127.0.0.1:{port}"]\n'
                'percentiles: [0.5, 0.99]\naggregates: ["count"]\n'
                f'flush_file: "{tsv}"\n')
    env = dict(os.environ, PYTHONPATH=root)
    log_path = os.path.join(work, "daemon.log")
    payload = _datagrams(lines[:300])
    t0 = time.perf_counter()
    with open(log_path, "w") as log_f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "veneur_tpu_torch.cli.server", "-f", cfg],
            cwd=root, env=env, stdout=log_f, stderr=subprocess.STDOUT)
        tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            flushed_s = None
            while time.perf_counter() - t0 < 180:
                if proc.poll() is not None:
                    break
                for d in payload:
                    tx.sendto(d, ("127.0.0.1", port))
                if os.path.exists(tsv):
                    with open(tsv) as f:
                        if "api." in f.read():
                            flushed_s = time.perf_counter() - t0
                            break
                time.sleep(0.5)
            alive = proc.poll() is None
            if alive:
                proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=120)
        finally:
            tx.close()
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
    with open(log_path) as f:
        tail = f.read()[-3000:]
    _check(alive, f"cli: the daemon exited early (rc {proc.returncode}):\n"
           + tail)
    _check(flushed_s is not None,
           "cli: the ticker never wrote a sent line to the TSV:\n" + tail)
    _check(rc == 0, f"cli: exit code {rc} after SIGTERM:\n" + tail)
    with open(tsv) as f:
        rows = sum(1 for _ in f)
    return dict(first_flush_s=flushed_s, tsv_rows=rows, exit_code=rc)


def server_path(device, lines, udp_ims) -> dict:
    """The Server on `device` at the default widths, the way the default
    config runs it: phase 4's lines in phase 8's datagrams through its
    UDP listener (the C++ reader, the pipeline thread's pump(20), K1 on
    every step), one manual flush (the flush worker: K2 in compute_flush,
    generate_frame, the debug sink), then a second, smaller interval and
    a third during a profile capture; the HTTP API; shutdown; and the
    CLI daemon in a process of its own. The first flush must equal phase
    8's `udp` InterMetrics and pass phase 4's oracles, with every
    datagram received and none dropped; the second must hold only the
    second batch's metrics."""
    import threading
    import torch
    from veneur_tpu_torch.ops import cuda_digest, cuda_history, cuda_ingest
    from veneur_tpu_torch.server.server import Server
    from veneur_tpu_torch.sinks.debug import DebugMetricSink

    sink = DebugMetricSink()
    t0 = time.perf_counter()
    srv = Server(_server_config(), metric_sinks=[sink], device=device)
    srv.start()
    out = dict(setup_s=time.perf_counter() - t0)
    try:
        agg = srv.aggregator
        _check(srv._native_readers_active, "server: native readers off")
        # interval 1: phase 4's lines as phase 8's datagrams
        datagrams = _datagrams(lines)
        cuda_ingest.launches = cuda_digest.launches = 0
        cuda_history.launches = 0
        steps0 = agg.steps_total
        base = _lines_seen(agg)
        t1 = time.perf_counter()
        send_s = _send_paced(srv, datagrams, "server")
        _wait_seen(srv, base, len(lines), "server")
        ingest_s = time.perf_counter() - t1
        flush_ms, phases, (res, table) = _flush_interval(srv, "server")
        launches = {"fused_ingest": cuda_ingest.launches,
                    "digest_quantiles": cuda_digest.launches,
                    "merge_windows": cuda_history.launches}
        steps = agg.steps_total - steps0
        received, dropped = srv.packets_received, srv.packets_dropped
        _check(received == len(datagrams) and dropped == 0
               and srv.packets_toolong == 0,
               f"server: {received} datagrams received of "
               f"{len(datagrams)}, {dropped} dropped")
        _check(launches["fused_ingest"] == steps > 0,
               f"server: {launches['fused_ingest']} K1 launches for "
               f"{steps} steps")
        _check(launches["digest_quantiles"] >= 1,
               "server: K2 never launched by the flush")
        checked = _check_server_flush(res, table, lines, "server")
        ims = _app_ims(sink)
        # the server's sink takes a columnar frame, whose rows are
        # grouped by kind and aggregate: compare by key
        gap = _same_intermetrics(ims, udp_ims, "server vs native udp",
                                 by_key=True)
        out.update(lines=len(lines), datagrams_sent=len(datagrams),
                   datagrams_received=received, datagrams_dropped=dropped,
                   steps=steps, launches=launches, send_s=send_s,
                   ingest_s=ingest_s, samples_per_s=len(lines) / ingest_s,
                   flush_ms=flush_ms,
                   device_update_ms=phases.get("device_update"),
                   label_ms=phases.get("frame_build"),
                   sink_fanout_ms=phases.get("sink_fanout"),
                   ingest_drain_ms=phases.get("ingest_drain"),
                   intermetrics=len(ims),
                   worst_percentile_gap_vs_udp=gap, **checked)
        print("server path (default widths):", json.dumps(out), flush=True)

        # interval 2: a smaller batch; only its metrics come out
        second = make_lines(np.random.default_rng(5), 80_000)
        sink.flushed.clear()
        base = _lines_seen(agg)
        _send_paced(srv, _datagrams(second), "server interval 2")
        _wait_seen(srv, base, len(second), "server interval 2")
        flush2_ms, _ph, (res2, table2) = _flush_interval(
            srv, "server interval 2")
        # the table holds the second batch's keys alone (_check_flush
        # counts them against its oracle), and so does the flush
        checked2 = _check_server_flush(res2, table2, second,
                                       "server interval 2")
        want2 = (checked2["counters"] + checked2["gauges"]
                 + checked2["sets"] + checked2["timers"]
                 * (len(AGGREGATES) + len(PERCENTILES)))
        _check(len(_app_ims(sink)) == want2,
               f"server interval 2: {len(_app_ims(sink))} app "
               f"InterMetrics, want {want2}")
        out.update(interval2=dict(lines=len(second), flush_ms=flush2_ms,
                                  counters=checked2["counters"],
                                  timers=checked2["timers"]))

        # the HTTP API
        port = srv.http_port
        for path in ("/healthcheck", "/healthz", "/readyz", "/stats",
                     "/metrics"):
            code, body = _http(port, path)
            _check(code == 200, f"server: GET {path} answered {code}")
        expo = body.decode()
        torch.cuda.synchronize()
        allocated = torch.cuda.memory_allocated(device)
        free, total = torch.cuda.mem_get_info(device)
        in_use = _hbm_series(expo, "veneur_device_hbm_bytes_in_use")
        peak = _hbm_series(expo, "veneur_device_hbm_bytes_peak")
        label = f"cuda:{torch.cuda.current_device()}"
        _check(label in in_use and label in peak,
               f"server: /metrics has no veneur.device.hbm_* for {label}")
        _check(abs(in_use[label] - allocated) <= 64 << 20
               and in_use[label] <= peak[label]
               and in_use[label] <= total - free,
               f"server: hbm_bytes_in_use {in_use[label]:.0f} against "
               f"memory_allocated {allocated}, peak {peak[label]:.0f}, "
               f"in use on the card by mem_get_info {total - free}")
        stats = json.loads(_http(port, "/stats")[1])
        out.update(hbm=dict(in_use=in_use[label], peak=peak[label],
                            memory_allocated=allocated,
                            device_used=total - free, total=total),
                   stats_processed=stats["processed"])

        # interval 3 under a one-second profile capture: 20k-line waves
        # (two ingest steps each) until the capture has replied
        third = _datagrams(make_lines(np.random.default_rng(6), 20_000))
        got = {}

        def capture():
            try:
                got["reply"] = _http(port, "/debug/profile?seconds=1")
            except BaseException as e:      # reported on this thread
                got["error"] = e
        th = threading.Thread(target=capture)
        base = _lines_seen(agg)
        waves = 0
        th.start()
        while th.is_alive() and waves < 100:
            _send_paced(srv, third, "server interval 3")
            waves += 1
            _wait_seen(srv, base, waves * 20_000, "server interval 3")
        th.join(timeout=120)
        _check("reply" in got and got["reply"][0] == 200,
               f"server: GET /debug/profile: {got}")
        prof = _trace_kernels(json.loads(got["reply"][1])["trace_dir"], 1.0)
        k1 = [n for n in prof["names"] if "fused_ingest" in n]
        _check(prof["kernel_events"] > 0 and k1,
               f"server: the profile holds {prof['kernel_events']} kernel "
               f"events and no K1 symbol: {prof['names'][:20]}")
        out.update(profile=dict(waves=waves,
                                kernel_events=prof["kernel_events"],
                                k1_symbol=k1[0],
                                kernel_names=len(prof["names"]),
                                busy_us=prof["busy_us"],
                                busy_share=prof["busy_share"]))
        print(f"server profile: {prof['kernel_events']} CUDA kernel events "
              f"in 1 s, K1 symbol {k1[0]!r} among them; the card busy "
              f"{prof['busy_share'] * 100:.2f}% of the window", flush=True)
        _check(srv.trigger_flush(timeout=300), "server: flush 3 failed")
    finally:
        t2 = time.perf_counter()
        srv.shutdown()
        out["shutdown_s"] = time.perf_counter() - t2
    _check(not srv._pipeline_thread.is_alive()
           and not srv._flush_thread.is_alive(),
           "server: shutdown left the pipeline or flush thread running")
    del srv, agg, res, table, res2, table2
    torch.cuda.empty_cache()
    out["cli"] = _cli_daemon(lines)
    return out


# -- phase 5: the 1M-key table, staged in bulk ---------------------------------

def million_keys(device) -> dict:
    """Every slot of the kernel_1m spec gets a key (counters 2^19, gauges
    2^18, sets 2^14, histograms 2^17: 933,888 keys); samples are staged
    through the Batcher's bulk adders, then one flush."""
    import torch
    from veneur_tpu_torch.aggregation.host import BatchSpec
    from veneur_tpu_torch.ops import cuda_digest, cuda_ingest, hll
    from veneur_tpu_torch.server.aggregator import Aggregator

    spec = _kernel_1m_spec()
    agg = Aggregator(spec, BatchSpec(), device=device)
    rng = np.random.default_rng(7)
    t0 = time.perf_counter()
    keys = {}
    for kind, cap in (("counter", spec.counter_capacity),
                      ("gauge", spec.gauge_capacity),
                      ("set", spec.set_capacity),
                      ("histogram", spec.histo_capacity)):
        slots = [agg.table.slot_for(kind, f"{kind}.{i}", (), 0, i)
                 for i in range(cap)]
        _check(None not in slots, f"1M: {kind} table full early")
        keys[kind] = np.asarray(slots, np.int32)
    alloc_s = time.perf_counter() - t0

    # samples: 2 per counter, 1 per gauge, 256 members for the first 1024
    # sets and 8 for the rest, 32 per histogram for the first 4096 keys
    # and 4 for the rest
    c_slot = np.repeat(keys["counter"], 2)
    c_inc = rng.integers(1, 9, c_slot.size).astype(np.float32)
    g_slot = keys["gauge"]
    g_val = rng.normal(size=g_slot.size).astype(np.float32)
    s_slot = np.repeat(keys["set"], np.where(
        np.arange(spec.set_capacity) < 1024, 256, 8))
    hashes = rng.integers(0, 2 ** 62, s_slot.size, dtype=np.int64)
    s_reg, s_rho = hll.split_hash(hashes.astype(np.uint64) * 3 + 1,
                                  spec.hll_precision)
    reps = np.where(np.arange(spec.histo_capacity) < 4096, 32, 4)
    h_slot = np.repeat(keys["histogram"], reps)
    h_val = rng.lognormal(3.0, 1.0, h_slot.size).astype(np.float32)
    order = rng.permutation(h_slot.size)
    h_slot, h_val = h_slot[order], h_val[order]

    cuda_ingest.launches = 0
    cuda_digest.launches = 0
    t1 = time.perf_counter()
    b = agg.batcher
    n_chunks = 64
    for i in range(n_chunks):
        def part(a):
            return np.array_split(a, n_chunks)[i]
        b.add_counters_bulk(part(c_slot), part(c_inc))
        b.add_gauges_bulk(part(g_slot), part(g_val))
        b.add_sets_bulk(part(s_slot), part(s_reg), part(s_rho))
        b.add_histos_bulk(part(h_slot), part(h_val),
                          np.ones(part(h_slot).size, np.float32))
    state, table = agg.swap()
    if device.type == "cuda":
        torch.cuda.synchronize()
    t2 = time.perf_counter()
    res, table = agg.compute_flush(state, table, PERCENTILES)
    t3 = time.perf_counter()
    launches = {"fused_ingest": cuda_ingest.launches,
                "digest_quantiles": cuda_digest.launches}
    captured = _recapture_flush(agg, state, table, res, "1M")

    counters = {}
    sums = np.bincount(c_slot, weights=c_inc.astype(np.float64),
                       minlength=spec.counter_capacity)
    for slot, m in table.get_meta("counter"):
        counters[(m.name, "")] = float(sums[slot])
    gauges = {(m.name, ""): float(g_val[i]) for i, (_s, m) in
              enumerate(table.get_meta("gauge"))}
    by_slot = [[] for _ in range(spec.histo_capacity)]
    for s, v in zip(h_slot.tolist(), h_val.tolist()):
        by_slot[s].append(v)
    timers = {(m.name, ""): by_slot[slot]
              for slot, m in table.get_meta("histogram")}
    sets = {}
    for slot, m in table.get_meta("set"):
        sets[(m.name, "")] = set()
    names = {slot: m.name for slot, m in table.get_meta("set")}
    for s, h in zip(s_slot.tolist(), hashes.tolist()):
        sets[(names[s], "")].add(h)
    checked = _check_flush(res, table, counters, gauges, timers, sets,
                           label="1M")
    return dict(keys=sum(len(v) for v in keys.values()),
                samples=int(c_slot.size + g_slot.size + s_slot.size
                            + h_slot.size),
                steps=agg.steps_total, launches=launches, alloc_s=alloc_s,
                ingest_s=t2 - t1, flush_ms=(t3 - t2) * 1e3,
                state_bytes=sum(t.numel() * t.element_size()
                                for t in state), **checked), captured


# -- phase 6: the history tier at the default widths ---------------------------

HIST_INTERVALS = 16
HIST_RANGES = ((160.0, None, 10.0),     # counters, gauges, sets: per interval
               (160.0, None, None),     # one step over everything
               (160.0, 40.0, 20.0))     # timers: 4-interval windows every 2


def _range_batch(wr, need, device):
    """Plan, pack, copy in, run, copy out and unpack one range batch;
    returns (answers, inputs, host-clock ms per stage)."""
    import torch
    from veneur_tpu_torch.aggregation.step import unpack_flush
    from veneur_tpu_torch.history import merge as hmerge

    t = [time.perf_counter()]
    plans = [wr.plan_range(r, win, st, hmerge.MAX_STEPS)
             for r, win, st in HIST_RANGES]
    sel = np.concatenate([pl.sel for pl in plans])
    steps = [s for pl in plans for s in pl.steps]
    t.append(time.perf_counter())
    flat, n_q, n_steps, buckets, _qcol = hmerge.pack_range_inputs(
        wr.spec, need, sel, plans[0].rank, set(PERCENTILES))
    t.append(time.perf_counter())
    hflat = torch.from_numpy(flat).to(device)
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    hist = wr.acquire_read()
    try:
        packed = hmerge.range_in_packed(hist, hflat, hspec=wr.spec, n_q=n_q,
                                        n_steps=n_steps, buckets=buckets)
    finally:
        wr.release_read()
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    host = packed.cpu().numpy()
    t.append(time.perf_counter())
    res = unpack_flush(host, hmerge.range_shapes(wr.spec, buckets, n_steps,
                                                 n_q))
    t.append(time.perf_counter())
    ms = {name: (b - a) * 1e3 for name, a, b in zip(
        ("plan", "pack", "copy_in", "program", "copy_out", "unpack"),
        t, t[1:])}
    ms["total"] = (t[-1] - t[0]) * 1e3
    inputs = dict(flat=flat, n_q=n_q, n_steps=n_steps, buckets=buckets,
                  sel=np.pad(sel, ((0, n_steps - sel.shape[0]), (0, 0))),
                  steps=steps)
    return res, inputs, ms


def _check_range_sums(res, inputs, need, row_key, frames):
    """Gate (b): per step, each counter is the exact sum of the key's
    flushed counters over the step's intervals, each gauge the last
    flushed value in them (NaN where the key never flushed)."""
    per_iv = []
    for table, out, _raw in frames:
        c = {(m.kind, m.name, m.joined_tags): v for (_s, m), v in
             zip(table.get_meta("counter"), out["counter"])}
        g = {(m.kind, m.name, m.joined_tags): v for (_s, m), v in
             zip(table.get_meta("gauge"), out["gauge"])}
        per_iv.append((c, g))
    chi, clo = res["r_counter_hi"], res["r_counter_lo"]
    gauge = res["r_gauge"]
    for j, st in enumerate(inputs["steps"]):
        span = range(st.seq_lo, st.seq_hi + 1)
        for i, row in enumerate(need[0]):
            key = row_key[(0, row)]
            want = sum(per_iv[s][0].get(key, 0.0) for s in span)
            got = float(chi[i, j]) + float(clo[i, j])
            _check(got == want, f"range counter {key} step {j}: {got} != "
                   f"{want}")
        for i, row in enumerate(need[1]):
            key = row_key[(1, row)]
            vals = [per_iv[s][1][key] for s in span if key in per_iv[s][1]]
            want = np.float32(vals[-1]) if vals else np.float32(np.nan)
            _check(np.array_equal(gauge[i, j], want, equal_nan=True),
                   f"range gauge {key} step {j}: {gauge[i, j]} != {want}")
    pad = slice(len(inputs["steps"]), None)
    _check(not chi[:, pad].any() and np.isnan(gauge[:, pad]).all(),
           "padding steps must be empty")


def _merge_np(rows: np.ndarray, sel: np.ndarray, p: int) -> np.ndarray:
    """Gate (c)'s reference: numpy unpack, register max over each step's
    columns, repack."""
    from veneur_tpu_torch.ops import hll
    regs = {c: hll.unpack_registers_np(rows[:, c], p)
            for c in np.nonzero((sel > 0).any(axis=0))[0]}
    out = np.zeros((rows.shape[0], sel.shape[0], rows.shape[2]), np.int32)
    for s in range(sel.shape[0]):
        cols = np.nonzero(sel[s] > 0)[0]
        if cols.size:
            out[:, s] = hll.pack_registers_np(
                np.max([regs[c] for c in cols], axis=0), p)
    return out


def _compare_range(got, want, label):
    """Test 4's tolerances: set estimates rtol 1e-6, histogram quantiles
    rtol/atol 2e-5, everything else byte-exact. Returns the largest
    difference seen."""
    err = 0.0
    for key in want:
        a, b = got[key], want[key]
        if key in ("r_set_estimate", "r_histo_quantiles"):
            tol = 1e-6 if key == "r_set_estimate" else 2e-5
            _check(np.array_equal(np.isnan(a), np.isnan(b)),
                   f"{label}: {key} NaN pattern differs")
            ok = ~np.isnan(b)
            d = np.abs(a[ok].astype(np.float64) - b[ok])
            lim = tol * np.abs(b[ok]) + (tol if "histo" in key else 0.0)
            _check((d <= lim).all(), f"{label}: {key} off by {d.max()} "
                   f"on {int((d > lim).sum())} entries")
            err = max(err, float(d.max(initial=0.0)))
        else:
            _check(a.tobytes() == b.tobytes(), f"{label}: {key} differs")
    return err


def history_path(device, clock_hz) -> dict:
    """The history tier through the port's entry points: compute_flush
    with the ring write fused in, decimation at each power-of-two
    boundary, then one range batch through range_in_packed. K3 reads the
    ring's set rows through the batch's row index."""
    import torch
    from veneur_tpu_torch import convert
    from veneur_tpu_torch.aggregation.host import BatchSpec
    from veneur_tpu_torch.aggregation.step import _take, unpack_flush
    from veneur_tpu_torch.history import HistorySpec, HistoryWriter
    from veneur_tpu_torch.history import device as hdev
    from veneur_tpu_torch.history import merge as hmerge
    from veneur_tpu_torch.ops import cuda_digest, cuda_history, cuda_ingest
    from veneur_tpu_torch.ops import tdigest as td
    from veneur_tpu_torch.samplers.parser import parse_metric
    from veneur_tpu_torch.server.aggregator import Aggregator

    spec = _default_spec()
    hspec = HistorySpec.for_table(spec, windows=90, tiers=3,
                                  max_keys=1 << 20)
    agg = Aggregator(spec, BatchSpec(), device=device)
    wr = HistoryWriter(hspec, interval_s=10.0, device=device)
    # the bytes the allocator was asked for (its allocated bytes may count
    # a cached block it did not split, up to 1 MiB a tensor)
    torch.cuda.synchronize()
    before = torch.cuda.memory_stats(device)["requested_bytes.all.current"]
    ring = wr.acquire_read()
    wr.release_read()
    torch.cuda.synchronize()
    ring_bytes = sum(t.numel() * t.element_size() for t in ring)
    alloc = (torch.cuda.memory_stats(device)["requested_bytes.all.current"]
             - before)
    _check(hspec.hbm_bytes() == ring_bytes == alloc == 3_210_117_120,
           f"ring: spec {hspec.hbm_bytes()}, tensors {ring_bytes}, "
           f"allocated {alloc} bytes")
    rows = [hspec.rows_for(k) for k in range(5)]
    _check(rows == [131072, 32768, 1024, 256, 16384]
           and hspec.total_cols == 360 and hspec.centroids == 32,
           f"ring geometry {rows} x {hspec.total_cols} x {hspec.centroids}")

    cuda_ingest.launches = cuda_digest.launches = cuda_history.launches = 0
    frames, flush_ms, plain_flush_ms, ingest_s = [], [], [], 0.0
    for i in range(HIST_INTERVALS):
        lines = make_lines(np.random.default_rng(100 + i), 12_500)
        t0 = time.perf_counter()
        for line in lines:
            agg.process_metric(parse_metric(line))
        state, table = agg.swap()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        plain, _t, _r = agg.compute_flush(state, table, PERCENTILES,
                                          want_raw=True)
        t2 = time.perf_counter()
        res, table, raw = agg.compute_flush(state, table, PERCENTILES,
                                            want_raw=True, history=wr)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        _check(all(res[k].tobytes() == plain[k].tobytes() for k in plain),
               f"interval {i}: the fused flush changed the flush outputs")
        ingest_s += t1 - t0
        plain_flush_ms.append((t2 - t1) * 1e3)
        flush_ms.append((t3 - t2) * 1e3)
        frames.append((table, res, raw))
    _check(wr.seq == HIST_INTERVALS, f"writer at seq {wr.seq}")

    need = [[] for _ in range(5)]
    row_key = {}
    for k, key, row in sorted(wr.iter_keys(), key=lambda e: (e[0], e[2])):
        need[k].append(row)
        row_key[(k, row)] = key
    need[2] = []                         # the traffic sends no status checks
    need[4] = need[4][:1024]
    k2, k3 = cuda_digest.launches, cuda_history.launches
    res, inputs, range_ms = _range_batch(wr, need, device)
    range_launches = {"digest_quantiles": cuda_digest.launches - k2,
                      "merge_windows": cuda_history.launches - k3}
    _res2, _inputs2, range_ms_warm = _range_batch(wr, need, device)
    with digest_calls() as range_k2:         # K2's share, timed in main
        _range_batch(wr, need, device)
    launches = {"fused_ingest": cuda_ingest.launches,
                "digest_quantiles": cuda_digest.launches,
                "merge_windows": cuda_history.launches}
    _check(launches["fused_ingest"] == agg.steps_total,
           "history: fused_ingest launches != ingest steps")

    # gate (a): the fused ring is the replay of the archived frames
    replay = HistoryWriter(hspec, interval_s=10.0, device=device)
    for table, out, raw in frames:
        replay.record_frame(table, out, raw)
    a, b = wr.acquire_read(), replay.acquire_read()
    for name, x, y in zip(hdev.HISTORY_FIELDS, a, b):
        _check(torch.equal(x.view(torch.int32), y.view(torch.int32)),
               f"fused ring field {name} differs from the replay")
    wr.release_read()
    replay.release_read()
    del replay, a, b
    torch.cuda.empty_cache()

    _check_range_sums(res, inputs, need, row_key, frames)        # gate (b)

    # gate (c): K3's words for the set rows against numpy
    p = hspec.hll_precision
    hist = wr.acquire_read()
    wr.release_read()
    idx, off = {}, inputs["n_q"]
    for k, nb in enumerate(inputs["buckets"]):      # the program's indices
        idx[k] = torch.from_numpy(
            inputs["flat"][off:off + nb].astype(np.int32)).to(device)
        off += nb
    setidx = idx[3]
    bs = inputs["buckets"][3]
    sel = torch.from_numpy(inputs["sel"]).to(device)
    set_rows = _take(hist.hll, setidx)

    def k3_as_the_program_calls_it():
        return cuda_history.merge_windows_packed(hist.hll, sel, precision=p,
                                                 idx=setidx)
    merged = k3_as_the_program_calls_it()
    _check(np.array_equal(merged.cpu().numpy(), _merge_np(
        set_rows.cpu().numpy(), inputs["sel"], p)),
        "merge_windows differs from numpy on the ring's set rows")

    # gate (d): the same batch over a CPU copy of the ring
    t0 = time.perf_counter()
    cpu_hist = convert.history_from_numpy(convert.history_to_numpy(hist),
                                          "cpu")
    cpu_packed = hmerge.range_in_packed(
        cpu_hist, torch.from_numpy(inputs["flat"]), hspec=hspec,
        n_q=inputs["n_q"], n_steps=inputs["n_steps"],
        buckets=inputs["buckets"])
    cpu_res = unpack_flush(cpu_packed.numpy(), hmerge.range_shapes(
        hspec, inputs["buckets"], inputs["n_steps"], inputs["n_q"]))
    cpu_s = time.perf_counter() - t0
    range_err = _compare_range(res, cpu_res, "range vs CPU plain")
    del cpu_hist
    _check(np.isfinite(res["r_histo_quantiles"][:, :len(inputs["steps"])]
                       ).any() and (res["r_set_estimate"] > 0).any(),
           "range batch answered nothing")

    # the range program's parts, each timed alone on the same inputs: K3
    # as the program calls it, K3 on the gathered set rows, and the
    # set-row gather that a K3 without a row index would need
    k3_ms = _time_ms(k3_as_the_program_calls_it, device, 20)
    k3_device_ms = _device_ms(k3_as_the_program_calls_it, 20, clock_hz)

    def k3_gathered():
        cuda_history.merge_windows_packed(set_rows, sel, precision=p)
    k3_gathered_ms = _time_ms(k3_gathered, device, 20)
    k3_gathered_device_ms = _device_ms(k3_gathered, 20, clock_hz)
    k3_plain_ms = _time_ms(lambda: cuda_history.merge_windows_packed_plain(
        set_rows, sel, precision=p), device, 2, warmup=1)
    k3_bytes, k3_ops = _merge_work(bs, inputs["sel"], hspec.hll_words)
    k3_bound_ms, _by = _bound(k3_bytes, k3_ops)

    def set_gather():
        _take(hist.hll, setidx)
    set_gather_ms = _time_ms(set_gather, device, 10)
    set_gather_device_ms = _device_ms(set_gather, 10, clock_hz)
    del set_rows

    def gathers():        # the row gathers the range program makes
        for name in hdev.HISTORY_FIELDS:
            if name != "hll":
                _take(getattr(hist, name), idx[hdev.FIELD_KIND[name]])
    gather_ms = _time_ms(gathers, device, 5)
    c_hi, c_lo = _take(hist.counter_hi, idx[0]), _take(hist.counter_lo,
                                                       idx[0])
    fold_ms = _time_ms(lambda: hmerge._fold_pair(c_hi, c_lo, sel), device, 3)
    h_mean, h_weight = _take(hist.h_mean, idx[4]), _take(hist.h_weight,
                                                         idx[4])
    bh, w, c = h_mean.shape
    # one step of the histogram loop: the masked W x C cells compressed
    compress_ms = _time_ms(lambda: td.compress_rows(
        h_mean.reshape(bh, w * c),
        (h_weight * sel[0][None, :, None]).reshape(bh, w * c),
        compression=hspec.compression, cells_per_k=hspec.cells_per_k,
        out_c=hspec.centroids, exact_extremes=hspec.exact_extremes),
        device, 5)
    # one decimation merge, recomputing tier-1 column 0 from tier-0
    # columns 0 and 1 (both still resident, so the ring keeps its bytes)
    roll_ms = _time_ms(lambda: hdev.roll_tiers(
        hist, 0, 1, hspec.windows, hspec=hspec), device, 5)
    return dict(
        ring_bytes=ring_bytes, intervals=HIST_INTERVALS,
        lines=HIST_INTERVALS * 12_500, steps=agg.steps_total,
        launches=launches, range_launches=range_launches,
        ingest_s=ingest_s, flush_ms=float(np.mean(flush_ms)),
        flush_ms_without_ring=float(np.mean(plain_flush_ms)),
        flush_ms_each=flush_ms, roll_ms=roll_ms,
        range_rows={k: len(need[i]) for i, k in enumerate(
            ("counters", "gauges", "status", "sets", "timers"))},
        range_steps=len(inputs["steps"]), range_padded_steps=inputs["n_steps"],
        range_ms=range_ms, range_ms_warm=range_ms_warm,
        k3_ms=k3_ms, k3_device_ms=k3_device_ms,
        k3_gathered_ms=k3_gathered_ms,
        k3_gathered_device_ms=k3_gathered_device_ms,
        k3_plain_ms=k3_plain_ms, k3_bound_ms=k3_bound_ms,
        k3_cols=int((inputs["sel"] > 0).any(axis=0).sum()),
        set_gather_ms=set_gather_ms,
        set_gather_device_ms=set_gather_device_ms,
        gather_ms=gather_ms, counter_fold_ms=fold_ms,
        histo_compress_step_ms=compress_ms,
        cpu_range_s=cpu_s, range_max_err=range_err), range_k2


# -- phase 7: the wide widths ---------------------------------------------------

def _compare_intermetrics(got, want, label):
    """The card's InterMetrics against the CPU's, as the card test of the
    slice compares them: the same names and types; percentiles within
    1e-2 relative (the torch prologue's sums round differently on the
    card, so a sample may land one digest cell over), set estimates
    within 1e-5 relative, everything else equal."""
    _check([(m.name, m.type) for m in got] == [(m.name, m.type)
                                               for m in want],
           f"{label}: InterMetric names or types differ")
    worst = 0.0
    for g, c in zip(got, want):
        if g.name.endswith("percentile"):
            d = abs(g.value - c.value)
            _check(d <= 1e-2 * abs(c.value) + 1e-6,
                   f"{label}: {g.name} {g.value} vs {c.value}")
            worst = max(worst, d / max(abs(c.value), 1e-9))
        elif g.name.startswith("users.active"):
            _check(abs(g.value - c.value) <= 1e-5 * c.value,
                   f"{label}: {g.name} {g.value} vs {c.value}")
        else:
            _check(g.value == c.value,
                   f"{label}: {g.name} {g.value} vs {c.value}")
    return worst


def wide_widths(device, lines) -> dict:
    """The slice at compression 2,400 and hll_precision 16 (`_wide_spec`:
    the default capacities, 3,928 digest cells and 12,288 HLL words a
    row), through Aggregator on the card and then on the CPU: the lines
    parsed, keyed and ingested (compaction every 2 steps, so the wide
    digests compact too), one flush and generate_intermetrics. The card's
    flush is held to phase 4's oracles and to the CPU's InterMetrics; its
    launches count the in-place K1 and the wide-row K2, which must be
    every launch it made."""
    import torch
    from veneur_tpu_torch.aggregation.host import BatchSpec
    from veneur_tpu_torch.ops import cuda_digest, cuda_history, cuda_ingest
    from veneur_tpu_torch.samplers.parser import parse_metric
    from veneur_tpu_torch.server.aggregator import Aggregator
    from veneur_tpu_torch.server.flusher import generate_intermetrics

    spec = _wide_spec()
    out, ims_by = {}, []
    for dev in (device, torch.device("cpu")):
        first = not ims_by
        agg = Aggregator(spec, BatchSpec(), device=dev, compact_every=2)
        if first:
            cuda_ingest.launches = cuda_ingest.wide_launches = 0
            cuda_digest.launches = cuda_digest.wide_launches = 0
            cuda_history.launches = 0
        t0 = time.perf_counter()
        for line in lines:
            agg.process_metric(parse_metric(line))
        state, table = agg.swap()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        res, table = agg.compute_flush(state, table, PERCENTILES)
        t2 = time.perf_counter()
        ims_by.append(generate_intermetrics(
            res, table, percentiles=PERCENTILES, aggregates=AGGREGATES,
            is_local=False, timestamp=1))
        if first:
            out["launches"] = {
                "fused_ingest": cuda_ingest.launches,
                "fused_ingest_wide": cuda_ingest.wide_launches,
                "digest_quantiles": cuda_digest.launches,
                "digest_quantiles_wide": cuda_digest.wide_launches,
                "merge_windows": cuda_history.launches}
            out.update(steps=agg.steps_total, ingest_s=t1 - t0,
                       samples_per_s=len(lines) / (t1 - t0),
                       flush_ms=(t2 - t1) * 1e3,
                       state_bytes=sum(t.numel() * t.element_size()
                                       for t in state))
            out.update(_check_flush(res, table, *_oracle(lines),
                                    label="wide"))
        else:
            out.update(cpu_ingest_s=t1 - t0, cpu_flush_ms=(t2 - t1) * 1e3)
        del agg, state, res
        torch.cuda.empty_cache()
    out["worst_percentile_rel_vs_cpu"] = _compare_intermetrics(
        *ims_by, "wide: card vs CPU")
    out.update(lines=len(lines), intermetrics=len(ims_by[0]),
               total_cells=spec.total_cells, hll_words=spec.hll_words)
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the card",
              file=sys.stderr)
        return 2
    try:
        import veneur_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})",
              file=sys.stderr)
        return 2
    device = torch.device("cuda")
    card = device_line()
    print("card:", card)
    build_s = build_kernels()

    clock_hz = sm_clock_hz()
    ingest = kernel_ingest(device, clock_hz)
    print(f"kernel fused_ingest (max SM clock {clock_hz / 1e6:.0f} MHz):",
          json.dumps(ingest))
    digests = [kernel_digest(device, clock_hz, r) for r in (1 << 14, 1 << 17)]
    # one range step's shape: 1,024 timers x 32 centroids (a range batch
    # now hands K2 all its steps' rows in one call)
    digests.append(kernel_digest(device, clock_hz, 1024, 32))
    for d in digests:
        print("kernel digest_quantiles:", json.dumps(d))
    print("kernel digest_quantiles, device ms by live cells per row "
          "(131072 x 472):", json.dumps(digest_live_sweep(device, clock_hz)))
    merge = kernel_merge_windows(device, clock_hz)
    print("kernel merge_windows:", json.dumps(merge))

    lines = make_lines(np.random.default_rng(0), 200_000)
    main, main_k2, main_ims = main_path(device, lines)
    print("main path (default widths):", json.dumps(main))
    _check(main["steps"] >= 16, f"only {main['steps']} ingest steps")
    _check(main["launches"]["fused_ingest"] == main["steps"],
           "fused_ingest launches != ingest steps")
    _check(main["launches"]["digest_quantiles"] >= 1,
           "digest_quantiles never launched by the flush")
    print(f"main path on {card}: {main['samples_per_s']:.0f} samples/s "
          f"(parse + key + stage + ingest, host included), flush "
          f"{main['flush_ms']:.1f} ms")

    # phase 8, right after phase 4: the same lines on the native path
    nat, udp_ims = native_path(device, lines, main_ims)
    del main_ims
    for route, r in nat.items():
        print(f"native path, {route}, oracles:", json.dumps(
            {k: v for k, v in r.items() if k.startswith("worst")
             or k in ("counters", "gauges", "timers", "sets",
                      "quantile_keys_checked")}))
    keys = ("samples_per_s", "step_ms", "flush_ms", "h2d_bytes", "steps")
    print("native path beside the Python path:", json.dumps(
        {"python": {k: main[k] for k in keys},
         **{route: {k: r[k] for k in keys} for route, r in nat.items()}}))
    print(f"native path on {card}: " + ", ".join(
        f"{route} {r['samples_per_s']:.0f} samples/s" for route, r in
        nat.items()) + f" (Python path {main['samples_per_s']:.0f})")

    # phase 9, after phase 8: the Server and the CLI on the card
    srv = server_path(device, lines, udp_ims)
    del udp_ims
    print("server path:", json.dumps(srv))
    print(f"server path on {card}: {srv['samples_per_s']:.0f} samples/s "
          f"(native udp {nat['udp']['samples_per_s']:.0f}); flush "
          f"{srv['flush_ms']:.1f} ms (device_update "
          f"{srv['device_update_ms']:.1f}, label {srv['label_ms']:.1f}, "
          f"sink fan-out {srv['sink_fanout_ms']:.1f}; native udp flush "
          f"{nat['udp']['flush_ms']:.1f}); K1 "
          f"{srv['launches']['fused_ingest']} launches for "
          f"{srv['steps']} steps, K2 "
          f"{srv['launches']['digest_quantiles']}; datagrams "
          f"{srv['datagrams_received']} received of "
          f"{srv['datagrams_sent']}, {srv['datagrams_dropped']} dropped; "
          f"CLI first flush in {srv['cli']['first_flush_s']:.1f} s, exit "
          f"code {srv['cli']['exit_code']}")
    torch.cuda.empty_cache()

    big, big_k2 = million_keys(device)
    print("1M-key phase:", json.dumps(big))
    _check(big["launches"]["fused_ingest"] == big["steps"],
           "1M: fused_ingest launches != ingest steps")
    _check(big["launches"]["digest_quantiles"] >= 1,
           "1M: digest_quantiles never launched")

    # phase 3, continued: K2 on the tensors the two flushes handed it
    for label, calls in (("default flush", main_k2), ("1M flush", big_k2)):
        for i, args in enumerate(calls):
            d = _digest_case(device, args, clock_hz)
            print(f"kernel digest_quantiles ({label}, call {i + 1} of "
                  f"{len(calls)}):", json.dumps(d))
    del main_k2, big_k2
    torch.cuda.empty_cache()

    hist, range_k2 = history_path(device, clock_hz)
    print("history path (default ring):", json.dumps(hist))
    print("kernel digest_quantiles (range batch):",
          json.dumps(_digest_sequence(device, range_k2, clock_hz)))
    _check(hist["range_launches"] == {"digest_quantiles": 1,
                                      "merge_windows": 1},
           f"range batch launches {hist['range_launches']}")   # gate (e)
    _check(all(v >= 1 for v in hist["launches"].values()),
           f"history: a kernel was never launched {hist['launches']}")
    print(f"history path on {card}: flush {hist['flush_ms']:.1f} ms with "
          f"the ring ({hist['flush_ms_without_ring']:.1f} ms without), "
          f"range batch {hist['range_ms_warm']['total']:.1f} ms, K3 "
          f"{hist['k3_ms']:.3f} ms")
    del range_k2
    torch.cuda.empty_cache()

    # phase 3, continued: K3's row-index form and the wide-row paths
    merge_idx = kernel_merge_windows_idx(device, clock_hz)
    print("kernel merge_windows, row index:", json.dumps(merge_idx))
    ingest_wide = kernel_ingest(device, clock_hz, _wide_spec())
    print("kernel fused_ingest, rows in place (compression 2400, "
          "hll_precision 16):", json.dumps(ingest_wide))
    digests_wide = [kernel_digest_wide(device, clock_hz, c)
                    for c in (3928, 2056)]
    for d in digests_wide:
        print("kernel digest_quantiles, wide rows:", json.dumps(d))
    torch.cuda.empty_cache()

    wide = wide_widths(device, make_lines(np.random.default_rng(9),
                                          100_000))
    print("wide widths (compression 2400, hll_precision 16):",
          json.dumps(wide))
    want = {"fused_ingest": 0, "fused_ingest_wide": wide["steps"],
            "digest_quantiles": 0, "merge_windows": 0}
    _check({k: v for k, v in wide["launches"].items()
            if k != "digest_quantiles_wide"} == want
           and wide["launches"]["digest_quantiles_wide"] >= 1,
           f"wide widths: launches {wide['launches']}, want {want} "
           "and digest_quantiles_wide >= 1")

    src = "veneur_tpu_torch/csrc/"
    kernels = [
        dict(name="fused_ingest", route="cuda",
             source=src + "fused_ingest.cu",
             replaces="veneur_tpu/ops/pallas_ingest.py:310",
             launches=srv["launches"]["fused_ingest"],
             launches_by_phase={
                 "4": main["launches"]["fused_ingest"],
                 "8_udp": nat["udp"]["launches"]["fused_ingest"],
                 "9": srv["launches"]["fused_ingest"]},
             max_abs_err=ingest["max_abs_err"], ms=ingest["ms"],
             plain_ms=ingest["plain_ms"], bound_ms=ingest["bound_ms"],
             bound_by=ingest["bound_by"], library_ms=None),
        dict(name="digest_quantiles", route="cuda",
             source=src + "digest_quantiles.cu",
             replaces="veneur_tpu/ops/pallas_digest.py:189",
             launches=srv["launches"]["digest_quantiles"],
             launches_by_phase={
                 "4": main["launches"]["digest_quantiles"],
                 "8_udp": nat["udp"]["launches"]["digest_quantiles"],
                 "9": srv["launches"]["digest_quantiles"]},
             max_abs_err=max(d["max_abs_err"] for d in digests),
             ms=digests[0]["ms"], plain_ms=digests[0]["plain_ms"],
             bound_ms=digests[0]["bound_ms"],
             bound_by=digests[0]["bound_by"], library_ms=None),
        dict(name="merge_windows", route="cuda",
             source=src + "merge_windows.cu",
             replaces="veneur_tpu/ops/pallas_history.py:92",
             launches=hist["launches"]["merge_windows"],
             max_abs_err=merge["max_abs_err"], ms=merge["ms"],
             plain_ms=merge["plain_ms"], bound_ms=merge["bound_ms"],
             bound_by=merge["bound_by"], library_ms=None),
        dict(name="fused_ingest_wide", route="cuda",
             source=src + "fused_ingest.cu",
             replaces="veneur_tpu/ops/pallas_ingest.py:310",
             launches=wide["launches"]["fused_ingest_wide"],
             max_abs_err=max(ingest_wide["max_abs_err"],
                             ingest_wide["hot"]["max_abs_err"]),
             ms=ingest_wide["ms"], plain_ms=ingest_wide["plain_ms"],
             bound_ms=ingest_wide["bound_ms"],
             bound_by=ingest_wide["bound_by"], library_ms=None),
        dict(name="digest_quantiles_wide", route="cuda",
             source=src + "digest_quantiles.cu",
             replaces="veneur_tpu/ops/pallas_digest.py:189",
             launches=wide["launches"]["digest_quantiles_wide"],
             max_abs_err=max(d["max_abs_err"] for d in digests_wide),
             ms=digests_wide[0]["ms"],
             plain_ms=digests_wide[0]["plain_ms"],
             bound_ms=digests_wide[0]["bound_ms"],
             bound_by=digests_wide[0]["bound_by"], library_ms=None),
    ]
    print(f"build {build_s:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
