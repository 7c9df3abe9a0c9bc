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
10. (run right after phase 6, whose ring it frees first) the Server with
   the history, query and watch tiers on, at the default widths and the
   default ring (90 windows, 3 tiers, history_max_keys 2^20: 3.2 GB),
   configured otherwise as phase 9's: phase 6's 16 intervals of 12,500
   lines (plus one line of a watched counter worth the interval's
   number, and three service checks in the last) through the UDP
   listener, each flushed by hand with the ring write fused in. Each
   flush's counters and gauges must equal phase 6's for the interval;
   a counter watch (threshold 12.5) must go OK->ALERT at the 13th flush
   and at no other, its SSE event read back through GET /watch/stream.
   Before the last flush, one instant batch over every kind (counters,
   gauges, sets, timers, service-check status) through POST /query must
   equal the last flush's InterMetrics value for value, and 200 small
   queries give the instant latency through HTTP (p50, p99). Then phase
   6's range batch through POST /query (25 steps: each interval, the
   whole range, 4-interval timer windows): one K2 and one K3 launch;
   each counter point the interval's flushed value (and phase 6's), the
   whole range their exact sum, each gauge point the flushed value; K3's
   words on the Server's own ring equal its plain version's and numpy's,
   the answers' set estimates are those words' estimates, and K2's rows
   agree with its plain version within rtol/atol 2e-5. Prints the
   instant latency, the range batch's HTTP wall (cold and warm) beside
   phase 6's program, the flush wall and device_update with the ring,
   the watch's evaluation time an interval, and the K1, K2 and K3
   launches of the phase, which the kernels line carries (K3's as its
   launches).

11. (run before phase 12) the global tier, BASELINE config 4: 64
   locals, each a
   NativeAggregator `feed` of its own seeded interval (10,000 global
   counters, a hundred of them byte counters whose sums pass 2^24; 1,000
   global gauges; 2,000 timer names under Zipf(1.2) weights, 30k
   samples; 256 set names over 100k uids, 20k members; names and tags
   shared by every local) flushed with want_raw and exported to one
   serialized MetricList each, built before the timer starts. A global
   Server on the card at the default widths (native ingest, gRPC import,
   checkpoint_dir, the watch, history and query tiers on a cut ring of
   8 windows and 2^14 keys) takes the 64 lists through ForwardClient,
   one SendMetrics a local, an instant read of one counter (it must read
   the gRPC imports' exact sum), then a 65th local's interval as a
   JSONMetric POST /import, then a flush. Gates: counters the exact f64
   sum of the exports, gauges the last import, set words the register
   max of the imported sketches and the estimates those words', histogram
   count/min/max exact, import.metrics_total every metric sent with no
   error, K1 on every import step and K2 in the flush, a counter watch
   OK->ALERT at this flush, the checkpoint it writes passing `python -m
   veneur_tpu_torch.cli.checkpoint verify`, and the 65th local's list
   flushing the same over gRPC and as JSONMetrics. Then a range read
   through POST /query, 8 more locals' interval imported and left
   unflushed, and shutdown(), whose tail checkpoint a new card Server
   restores (K1, counters in two steps: the f32 hi parts, then the lo
   residuals) before its listeners start: the watch is still in ALERT,
   the same range read over the restored ring answers the same points
   (K3 launched, its words equal to its plain version's), and its flush
   equals a card Server's that imported the 8 locals alone in counters,
   gauges, set words and histogram count/min/max (quantiles: the gap is
   reported, ROADMAP C-5). The checkpoint restored on the CPU flushes the
   same within 2e-5, and the first 2 locals' lists and the JSONMetric
   batch, replayed on a fresh card Server and on a CPU Server, give the
   same quantiles within rtol/atol 2e-5 (a subset: the CPU's plain
   versions take about a second a list at the default widths). K1 is held
   byte-exact to its plain version on a CPU copy of the fifth import
   step's state and streams (its longest runs reported), and K2 on the
   flushes' own rows. Prints metrics/s and centroids/s through gRPC, the
   import steps' ms, the flush's wall and phase ms, checkpoint write ms
   and bytes, the restore fold's ms and steps, each timer key's p50/p99
   error against the midpoint quantiles of the locals' raw samples
   (reported, not held), and the phase's launches, which the kernels line
   carries.
12. (run after phase 11) the forward tier: four local Servers as phase 9
   configures them (native ingest, the UDP listener), each forwarding
   exactly once (forward_dedup_window 64) to a port ProxyServer over two
   global Servers (gRPC import, dedup window 64), all on the card at the
   default widths; the first local also checkpoints. Each local takes
   its own seed of phase 4's mix, 50,000 lines an interval through its
   listener, with every tenth counter and gauge name global-only, all
   but 100 set names local-only (a unit stays under gRPC's 4 MiB cap),
   and 100 global byte counters whose sums pass 2^24 (the unit one local's
   lines would make with every set name forwarded is measured and
   printed, never sent: past the cap, ROADMAP C-7). Interval 1: each local
   flushes and forwards; the globals fold and flush. Gates: every key on
   one global, never both; counters the exact f64 sums of the lines,
   gauges one of the locals' last writes, set estimates within 5% for
   keys with >= 100 members, timer p50 / p99 within 6% / 1% of the
   midpoint quantiles of the four locals' samples for keys with >= 24;
   every local's unit acked and its spill empty. Interval 2: the second
   global fails at the proxy (FAULTS at PROXY_FORWARD): every local holds
   one unit and veneur.forward.spill_bytes > 0. Interval 3, the fault
   cleared: each held unit is re-sent under its seq and the proxy
   re-attempts only the failed sub-batch; the globals' counters over
   intervals 2 and 3 are the exact sums of their lines. Then the first
   local's next unit is held by the fault again, more lines are left
   unflushed, and it shuts down; a new card Server on its checkpoint_dir
   restores (K1, skip_forwarded), opens the next epoch, and replays both
   old-epoch units: the globals' counters are the exact sums of those
   lines. K1 launches equal the seven Servers' ingest steps and K2
   launches their compute_flush calls (the shutdowns' tail flushes
   included), counted before K2 is held to its plain version on the
   first global flush's rows and timed. Prints each local flush's wall,
   forward and export_metrics ms, each unit's metrics and bytes, the
   time from a local's flush to the globals' fold, the relay's metrics/s
   from the locals' pump to the globals' fold, the globals' import and
   stats-lane steps, the restore's ms and steps and the phase's
   launches, which the kernels line carries.
13. (run after phase 12) the Server under pressure, every Server on the
   card through its normal entry points:
   a. overload and tenancy, BASELINE config 15 (benchmarks/e2e.py
   config15_tenant_storm) at the default widths: two reader rings,
   tenant fairness (fair rate 2,000/s, burst x3), quarantine at 3,500
   keys (decay 0.25, readmit 0.5), native admission, a 0.05 s poll and
   0.3 s hold, shed_priority_tags [tier:gold], the query tier and a
   checkpoint. benchmarks/replay.py at seed 150,150 (numpy only): steady
   10,000 and diurnal 4,000 datagrams, then, with SHEDDING forced
   through the controller's signal source, a flash crowd of 20,000 (acme
   ~5x its share), each key's datagrams on one ring through
   rings_inject. That flush holds blue's, dex's and default's keys to
   the oracle of their lines (counters exact, gauges the last write,
   p50 within 6% and p99 within 1% for >= 24 samples, sets within 5%
   for >= 20 members): they shed nothing, acme is throttled. Then 3,000
   more and 200 tier:gold lines; forced CRITICAL: /readyz 503 (and at
   SHEDDING; 200 again once HEALTHY, /healthz 200 throughout), POST
   /query and POST /import 503; the flush publishes only veneur.* and
   tier:gold rows, counts the rest in shed_total{class=flush}, and
   multiplies its set estimates by 2^set_shift. crux's tag explosion
   (5,000 fresh names) demotes it; 250 more count exactly 250 demoted
   rows. A restart from the shutdown checkpoint keeps crux quarantined
   with its row totals; decay readmits it within 4 flushes. Per tenant,
   sent == admitted + shed exactly across both Servers; K1 launches are
   the step rows (a two-ring step is two), K2 launches in every flush
   with histogram rows.
   b. key-table growth, BASELINE config 6 (config6_cardinality_stress)
   at scale 0.1: 1,000,000 names (600k counters, 250k gauges, 100k
   timers, 50k sets), counters from 2^17 slots, the other kinds at
   config 6's 1.25x headroom, its batch widths. The cardinality march
   grows the counter table at three flushes to 2^20: the first interval
   overshoots, and its drops must equal its over-capacity attempts
   exactly; every other counter flushes its exact sum; then the whole
   population in one interval (every value exact). A tail left
   unflushed goes to the shutdown checkpoint; the restart adopts the
   grown capacities (the "keytables" chunk) before the fold and
   flushes the tail's values (timer quantiles: the gap is reported,
   ROADMAP C-5). Gates: drop fraction under 1%, veneur.table.grows_total
   and veneur.table.capacity, K1 launches equal the steps, K2 in every
   flush. Reports each grow swap's ingest_drain ms beside a plain
   swap's, per key swapped.
   c. K1 past 32-bit offsets (ROADMAP C-8): at set_capacity 2^20 (p =
   14, 12.9 GB of HLL words) and at histo_capacity 4,600,000 (x 472
   cells), the main path's batch with its set and histogram slots at
   the tables' top rows, byte-exact against the plain version run on a
   copy of the state on the card, timed as phase 3 times K1; each state
   freed before the next. The kernels line carries them as
   fused_ingest's `grown_offsets`, and phase 13's launches.

14. (run after phase 13) sharding and the collective global tier, every
   tile on the one card:
   a. BASELINE config 12's Server at tpu_n_shards 4: phase 9's config
   (native ingest, the default widths) takes phase 8's datagrams through
   its UDP listener with the split emit, again with
   native_preshard_enabled, a third time through four reader rings
   (rings_inject, each name's lines on one ring; the pre-sharded ring
   drain) one wave a step: each 10k-line wave injected, parsed, then
   one pipeline visit runs its step (held to step exactly once), so the
   compaction points are fixed; and a fourth time with the same waves
   back to back, where the steps follow thread timing. Each flush holds
   phase 4's oracles (counters exact against the f64 oracle, gauges the
   last write, p50 within 6% and p99 within 1%; on the back-to-back run
   the quantile errors are printed, not held: ROADMAP C-10), equals
   phase 9's single-shard flush in counters, gauges and set estimates,
   and its set words equal the register max of the lines' members
   hashed on the host; K1 launches once a sharded step (the S
   tiles flattened into one launch) and K2 once in the merged flush. K1
   is held byte-exact to its plain version on the second step's state and
   streams (S = 4 tiles, four times a single step's lanes) and K2 on the
   merged flush's rows, each timed as phase 3 times them.
   b. BASELINE config 11's collective tier at (R, S) = (2, 4): phase
   11's 65 locals absorbed co-located by a global Server with
   collective_enabled, the 65th through a local Server with
   collective_attach (its flush hands the interval over), the 64 others'
   flush outputs through absorb_raw. The global's flush must equal phase
   11's gRPC-imported flush of the same locals in counters and histogram
   count/min/max, keep a local's write for every gauge, take no wire
   import, and keep the worst p99 error against the midpoint quantiles
   of the locals' samples within max(1%, 1.5x phase 11's). Prints the
   absorbed rows/s, the tier's stage, all_to_all_route and replica_merge
   phase times and the merged flush's ms.

15. (run after phase 14) live resharding and tag frequency:
   a. BASELINE config 12 (config12_elastic_resize) at scale 1: its
   three seeded segments (2,048 counters, a gauge, 512 timer samples,
   64 sets of 40 members each) through a Server's packet queue at
   tpu_n_shards 4 with config 12's capacities, native ingest and
   overload admission. Three passes under fire (a feeder thread puts
   each segment while the resize runs; POST /query probes every 20 ms):
   static; elastic 4 -> 8 -> 2 with the second resize's first fold
   faulted (RESHARD_FOLD); elastic steady. Two on fixed steps (each
   segment parsed whole before its resize, the Server's own telemetry
   dropped): static and elastic. Gates: every pass's counters, gauges
   and set words byte-exact against the static pass; sent == admitted +
   shed; the faulted transfer replays with a duplicate suppressed;
   every probe 200, marked stale_bounded when a transfer was active
   before and after it and unmarked when none was, and one marked at
   least; the steady transitions within config 12's 10 s interval; on
   the fixed steps el.t's p50 within 6% and p99 within 1% of its
   samples' midpoint quantiles, and the elastic pass's percentiles
   within P15_JAX_TIMER_GAP + 2e-5 of the static pass's (the JAX
   package's gap on the same lines and steps, C-5; measured by
   tests/test_torch_reshard_storm.py); K1 launches equal the passes'
   steps, K2 launches at least their flushes and drained intervals. K1
   is held byte-exact to its plain version on the first migration
   fold's step at S = 8 and at S = 2 and timed.
   b. BASELINE config 5 (config5_span_firehose) at scale 1: 100,000
   spans, half over 20 hot tag values and half over 1,000,000 tail
   values, through a Server's span path with tag_frequency_enabled (top
   K 20, batches of 8,192): the count-min table on the card, top-20
   recall 1.0, no estimate below its true count, every overestimate
   within e/width * N, and the sink's rows reach the metric pipeline
   through the self-telemetry loop-back. Prints spans/s and the update
   ms a batch.

16. (run after phase 15) every sink, the S3 archive and the operator
   CLIs: one Server that factory.new_from_config builds on the card at
   the default widths (native ingest, tpu_n_shards 1, UDP and TCP statsd
   listeners, an SSF listener, /metrics), each sink against a local
   fake: Datadog metrics and traces, SignalFx and Splunk HEC (sample
   rate 1) on local HTTP servers, X-Ray on a UDP socket (100%), Falconer
   and the gRPC span sink on two serve_span_sink servers (in a child
   process, so that answering their ~20,000 calls takes no share of the
   Server's interpreter lock; scripts/grpc_span_rate.py compares the
   two), the debug sink; the Kafka metric and
   span sinks, LightStep and the S3 archive (a staging dir) injected
   with recording clients, the archive's first put failing. An interval
   of a few lines is flushed first: its put fails and leaves a complete
   staged .tsv.gz of that flush's rows. Then phase 8's 4,233 datagrams
   through the UDP listener (paced as phase 9 paces them), `python -m
   veneur_tpu_torch.cli.emit -replay 50000` over TCP, three events and
   three service checks through emit, and 10,000 of phase 15b's spans
   through the span pipeline, a wave of 1,000 at a time, then a flush.
   Gates: K1 launches once a step and K2 at least once a flush;
   Datadog's and SignalFx's columnar bodies from the card's frame decode
   to the series and datapoints their object paths post over the debug
   sink's InterMetrics, the Datadog series hold phase 4's oracles
   (counters exact once the rate is undone, gauges the last write, p50
   6% and p99 1%, sets 5%), the replay counters sum to exactly 50,000,
   and no body passes datadog_flush_max_per_body; Kafka's messages are
   the debug rows one for one; the S3 object is the debug rows' TSV and
   its staged copy is gone; every span id arrives exactly once at
   Datadog, Splunk, X-Ray, Falconer, gRPC, Kafka and LightStep; the
   events reach /intake and SignalFx's events API, the checks check_run.
   Then `python -m veneur_tpu_torch.cli.prometheus -once` polls
   /metrics twice through a recording proxy and sends its statsd back:
   each counter it sends is the difference of the two expositions, and
   the next flush carries it; `python -m veneur_tpu_torch.cli.telemetry
   --json` lists veneur.sink.flush_duration_ns for each metric sink.
   Prints each sink's flush ms, the span sinks' ingest ms, the
   sink_fanout and frame_build phase ms, the flush's wall ms, each
   sink's payload bytes and emit's send rate.

17. (run after phase 16) the port's lint and its sanitized engine:
   `python -m veneur_tpu_torch.analysis --all --json` on this tree in a
   child (ok, 12 passes, no finding), and beside it a child under
   libasan and libubsan (LD_PRELOAD, ASAN_OPTIONS=detect_leaks=0,
   UBSAN_OPTIONS=halt_on_error=1:print_stacktrace=1) that makes no CUDA
   call: VENEUR_NATIVE_SANITIZE=1's engine (built beside phase 2's
   kernels) takes phase 8's datagrams by feed, the intake corpora
   (tests/test_native.py, tests/test_intake_fuzz.py) by feed, and phase
   8's datagrams over loopback UDP through readers_start and pump (on
   gVisor, the engine's recv fallback), writing every packed buffer it
   emits. Gates: no sanitizer report; each buffer equals the plain
   engine's on the same input word for word and is what K1 reads on the
   card; the engine's counts equal; the feed and udp flushes equal phase
   8's feed InterMetrics; K1 launches once a step, K2 in each flush.
   Prints the lint's runtime, the child's wall, the words compared and
   the phase's seconds.

With `--k1-ab TREE ...` the script instead times K1 at the default
shape in each source tree in turn (phase 3's kernel_ingest, a process
each), to compare two commits on one card in one call.

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


def build_kernels(sanitized: bool = False) -> float:
    """The CUDA kernels (nvcc, one process a source) and, beside them on
    other threads, the native ingest engine (g++) and, with `sanitized`,
    its ASan+UBSan build for phase 17 (built, not loaded: only phase 17's
    child loads it)."""
    import threading
    from veneur_tpu_torch import native
    from veneur_tpu_torch.ops import _build
    t0 = time.perf_counter()
    engines = {False: {}, True: {}}

    def build_engine(san):
        try:
            engines[san]["path"] = native.build(sanitize=san)
        except BaseException as e:      # re-raised below, on this thread
            engines[san]["error"] = e
        engines[san]["s"] = time.perf_counter() - t0
    threads = [threading.Thread(target=build_engine, args=(san,))
               for san in ((False, True) if sanitized else (False,))]
    for th in threads:
        th.start()
    _path, log = _build.build()
    _build.load()
    for th in threads:
        th.join()
    for engine in engines.values():
        if "error" in engine:
            raise engine["error"]
    native.load()
    for san, engine in engines.items():
        if "path" in engine:
            print(f"build: native engine{' (sanitized)' if san else ''} "
                  f"{engine['path'].name} in {engine['s']:.1f} s")
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
    from veneur_tpu_torch.aggregation.step import build_streams
    return _ingest_streams_case(state, build_streams(state, batch, spec),
                                spec, device, clock_hz, plain_reps)


def _ingest_streams_case(state, streams, spec, device, clock_hz,
                         plain_reps) -> dict:
    """`_ingest_case` on streams already built (captured from a step)."""
    from veneur_tpu_torch import convert
    from veneur_tpu_torch.ops import cuda_ingest

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


def native_path(device, lines, python_ims, keep=None) -> dict:
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
    if keep is not None:
        keep["feed_ims"] = ims_by["feed"]     # phase 17's reference
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


def _check_server_flush(res, table, lines, label,
                        gate_quantiles: bool = True) -> dict:
    app = _AppTable(res, table)
    return _check_flush(app.res, app, *_oracle(lines), label=label,
                        gate_quantiles=gate_quantiles)


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


def server_path(device, lines, udp_ims, keep=None) -> dict:
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
        if keep is not None:
            keep.update(_kv_rows(res, table))
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
        cpu_range_s=cpu_s, range_max_err=range_err), range_k2, \
        _frame_values(frames)


def _key(meta):
    return (meta.name, ",".join(meta.tags))


def _frame_values(frames):
    """Each interval's flushed counters and gauges by (name, joined
    tags): the oracle phase 10 holds the Server's flushes and its range
    answers to."""
    return [{kind: {_key(m): float(v) for (_s, m), v in
                    zip(table.get_meta(kind), res[kind])}
             for kind in ("counter", "gauge")}
            for table, res, _raw in frames]


# -- phase 10: POST /query, the ring and watches on the Server -----------------

TIER_WATCH_AT = 13                  # the watch's counter crosses here


def _tier_lines(i: int):
    """Interval i (0-based) of phase 10: phase 6's lines, one line of the
    watched counter (worth i + 1), and (last interval) three service
    checks, so the instant batch finds every kind."""
    lines = make_lines(np.random.default_rng(100 + i), 12_500)
    lines.append(b"watch.hits:%d|c" % (i + 1))
    if i == HIST_INTERVALS - 1:
        lines += [b"_sc|svc.check.%d|%d|#zone:a" % (k, k) for k in range(3)]
    return lines


def _post_json(port: int, path: str, body) -> tuple:
    """(status, decoded body, wall ms) of one POST through HTTP."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            code, raw = r.status, r.read()
    except urllib.error.HTTPError as e:
        code, raw = e.code, e.read()
    ms = (time.perf_counter() - t0) * 1e3
    _check(code in (200, 201), f"POST {path}: {code} {raw[:300]!r}")
    return code, json.loads(raw), ms


INSTANT_BATCH = {"queries": [
    {"prefix": "api.requests.12", "kinds": ["counter"]},
    {"prefix": "queue.depth.1", "kinds": ["gauge"]},
    {"prefix": "users.active.1", "kinds": ["set"]},
    {"match": "api.latency.1?", "kinds": ["timer"], "quantiles": PERCENTILES},
    {"prefix": "svc.check.", "kinds": ["status"]},
    {"name": "watch.hits"},
]}


def _check_instant(out, ims, label) -> int:
    """Every instant match equals the next flush's InterMetric for its
    key, value for value."""
    by_key = {(m.name, ",".join(sorted(m.tags))): m.value for m in ims}
    kinds, n = set(), 0
    for res in out["results"]:
        for m in res["matches"]:
            tags = ",".join(sorted(m["tags"]))
            kinds.add(m["kind"])
            if m["kind"] == "set":
                want = {(m["name"], tags): m["estimate"]}
            elif m["kind"] == "timer":
                want = {(f"{m['name']}.{int(q * 100)}percentile", tags):
                        m["quantiles"][str(float(q))] for q in PERCENTILES}
                want.update({(m["name"] + "." + a, tags): m[a]
                             for a in ("min", "max", "count", "sum")})
            else:
                want = {(m["name"], tags): m["value"]}
            for key, v in want.items():
                _check(key in by_key and by_key[key] == v,
                       f"{label}: query {key} = {v}, the flush "
                       f"{by_key.get(key)}")
                n += 1
    _check(kinds == {"counter", "gauge", "set", "timer", "status"},
           f"{label}: the batch found kinds {sorted(kinds)}")
    return n


def _range_batch_body(iv: float) -> dict:
    """Phase 6's batch through POST /query: every interval of 16 as a
    step (counters, gauges, sets), one step over all 16 (counters, sets),
    timers in 4-interval windows every 2 intervals: 25 steps."""
    rng = dict(range=HIST_INTERVALS * iv)
    per = dict(rng, step=iv)
    return {"queries": [
        dict(per, prefix="api.requests.", kinds=["counter"]),
        dict(per, prefix="queue.depth.", kinds=["gauge"]),
        dict(per, prefix="users.active.", kinds=["set"]),
        dict(rng, prefix="api.requests.", kinds=["counter"]),
        dict(rng, prefix="users.active.", kinds=["set"]),
        dict(rng, prefix="api.latency.", kinds=["timer"], window=4 * iv,
             step=2 * iv, quantiles=PERCENTILES)]}


def _check_range_answers(out, flushes, frames, label) -> dict:
    """Counters: each point the interval's flushed value, the whole range
    their exact sum; gauges: each point the interval's flushed value;
    both against the Server's own flushes and phase 6's."""
    res = out["results"]
    n = 0
    for qi, kind in ((0, "counter"), (1, "gauge")):
        _check(res[qi]["matches"], f"{label}: no {kind} matched")
        for m in res[qi]["matches"]:
            key = (m["name"], ",".join(m["tags"]))
            pts = m["points"]
            _check([p["seq"] for p in pts] == [[i, i] for i in range(
                HIST_INTERVALS)], f"{label}: {key} points {len(pts)}")
            # a counter the interval did not flush reads 0, a gauge none
            absent = 0.0 if kind == "counter" else None
            for i, p in enumerate(pts):
                want = flushes[i][kind].get(key, absent)
                _check(p["value"] == want
                       == frames[i][kind].get(key, absent),
                       f"{label}: {kind} {key} interval {i}: {p['value']} "
                       f"vs the flush {want} and phase 6 "
                       f"{frames[i][kind].get(key, absent)}")
                n += 1
    for m in res[3]["matches"]:
        key = (m["name"], ",".join(m["tags"]))
        want = sum(f["counter"].get(key, 0.0) for f in flushes)
        _check(m["points"][0]["value"] == want,
               f"{label}: counter {key} over the range: "
               f"{m['points'][0]['value']} != {want}")
        n += 1
    _check(all(r.get("range") for r in res), f"{label}: not range answers")
    return dict(points_checked=n, truncated=[bool(r.get("truncated"))
                                             for r in res])


@contextlib.contextmanager
def merge_calls():
    """Yields a list that gathers (args, kwargs, output) of every K3 call
    made inside the block, by wrapping cuda_history.merge_windows_packed
    (history.merge looks it up at each call); restores it after."""
    from veneur_tpu_torch.ops import cuda_history
    calls, orig = [], cuda_history.merge_windows_packed

    def record(*args, **kw):
        out = orig(*args, **kw)
        calls.append((args, kw, out))
        return out
    cuda_history.merge_windows_packed = record
    try:
        yield calls
    finally:
        cuda_history.merge_windows_packed = orig


def _sse_reader(port: int, events: list):
    """GET /watch/stream on a thread of its own, gathering each event in
    `events`; returns (thread, response) (close the response to end it)."""
    import threading
    import urllib.request
    from veneur_tpu_torch.cli.watch import tail_events
    resp = urllib.request.urlopen(
        f"http://127.0.0.1:{port}/watch/stream", timeout=600)

    def run():
        try:
            for ev in tail_events(resp):
                events.append((time.time(), ev))
        except (OSError, ValueError):
            pass                    # the response was closed
    th = threading.Thread(target=run, daemon=True)
    th.start()
    return th, resp


def server_tiers_path(device, frames, clock_hz) -> dict:
    """The Server at the default widths with the history, query and
    watch tiers on, as the default config runs it otherwise (native
    ingest, the C++ reader): phase 6's 16 intervals through the UDP
    listener, each flushed by hand with the ring write fused in, a
    counter watch evaluated on every flush, then instant and range
    queries through POST /query."""
    import torch
    from veneur_tpu_torch.aggregation.step import _take
    from veneur_tpu_torch.ops import cuda_digest, cuda_history, cuda_ingest
    from veneur_tpu_torch.ops import hll as hll_ops
    from veneur_tpu_torch.server.server import Server
    from veneur_tpu_torch.sinks.debug import DebugMetricSink

    sink = DebugMetricSink()
    t0 = time.perf_counter()
    srv = Server(_server_config(
        profile_capture_enabled=False, history_enabled=True,
        query_enabled=True, watch_enabled=True, history_windows=90,
        history_decimation_tiers=3, history_max_keys=1 << 20),
        metric_sinks=[sink], device=device)
    srv.start()
    out = dict(setup_s=time.perf_counter() - t0)
    events, reader = [], None
    try:
        port, agg, eng = srv.http_port, srv.aggregator, srv.watch_engine
        iv = srv.interval
        _check(srv.history.spec.hbm_bytes() == 3_210_117_120,
               f"ring of {srv.history.spec.hbm_bytes()} bytes")
        _code, reg, _ms = _post_json(port, "/watch", {
            "name": "watch.hits", "threshold": TIER_WATCH_AT - 0.5})
        reader, resp = _sse_reader(port, events)
        offered = []                    # the last interval handed to watches
        orig_offer = eng.offer

        def offer(*args):
            offered[:] = args
            return orig_offer(*args)
        eng.offer = offer
        cuda_ingest.launches = cuda_digest.launches = 0
        cuda_history.launches = 0
        flushes, flush_ms, phase_ms, fired_at = [], [], [], None
        for i in range(HIST_INTERVALS):
            lines = _tier_lines(i)
            base = _lines_seen(agg)
            _send_paced(srv, _datagrams(lines), f"tiers interval {i}")
            # the engine hands service checks to the Python parser, in
            # the pump call that read them, so it counts the rest
            _wait_seen(srv, base, sum(not ln.startswith(b"_sc")
                                      for ln in lines),
                       f"tiers interval {i}")
            if i == HIST_INTERVALS - 1:
                # the instant batch, then its latency through HTTP, then
                # the flush the batch must equal
                _c, inst, inst_ms = _post_json(port, "/query", INSTANT_BATCH)
                lat = [_post_json(port, "/query", {"queries": [
                    {"name": "api.requests.12", "kinds": ["counter"]},
                    {"name": "api.latency.1", "kinds": ["timer"]}]})[2]
                    for _ in range(200)]
                sink.flushed.clear()
            k2_before = cuda_digest.launches
            wall, phases, (res, table) = _flush_interval(
                srv, f"tiers interval {i}")
            flush_ms.append(wall)
            phase_ms.append({k: v for k, v in phases.items() if v})
            flushes.append({kind: {_key(m): float(v) for (_s, m), v in
                                   zip(table.get_meta(kind), res[kind])}
                            for kind in ("counter", "gauge")})
            app = {k: {key: v for key, v in f.items()
                       if not key[0].startswith(("veneur.", "ssf.",
                                                 "watch."))}
                   for k, f in flushes[-1].items()}
            _check(app == frames[i], f"tiers interval {i}: the Server's "
                   "counters and gauges differ from phase 6's flush")
            t_ev = time.perf_counter()
            while eng.intervals_evaluated + eng.intervals_skipped < i + 1:
                _check(time.perf_counter() - t_ev < 60,
                       f"tiers interval {i}: the watch never evaluated")
                time.sleep(0.002)
            _check(cuda_digest.launches - k2_before >= 2,
                   f"tiers interval {i}: K2 not launched by the flush and "
                   "the watch")
            if i + 1 == TIER_WATCH_AT:
                t_ev = time.perf_counter()
                while not events:
                    _check(time.perf_counter() - t_ev < 30,
                           "the watch's SSE event never came")
                    time.sleep(0.005)
                fired_at = i + 1
            _check(len(events) == (fired_at is not None),
                   f"tiers interval {i}: {len(events)} watch events")
        checked = _check_instant(inst, _app_ims(sink), "tiers instant")
        ev = events[0][1]
        _check(ev["id"] == reg["id"] and ev["from"] == "OK"
               and ev["to"] == "ALERT" and ev["value"] == TIER_WATCH_AT,
               f"watch event {ev}")
        listing = json.loads(_http(port, "/watch")[1])["watches"][0]
        _check(listing["status"] == "ALERT"
               and listing["value"] == HIST_INTERVALS, f"watch {listing}")
        launches_ingest = {"fused_ingest": cuda_ingest.launches,
                           "digest_quantiles": cuda_digest.launches,
                           "merge_windows": cuda_history.launches}
        _check(launches_ingest["fused_ingest"] == agg.steps_total > 0,
               "tiers: K1 launches != ingest steps")
        _check(launches_ingest["merge_windows"] == 0,
               "tiers: K3 launched before any range query")

        # the range batch: cold, then warm; K2's and K3's calls captured
        # from one more, on the Server's own tensors
        body = _range_batch_body(iv)
        k2_0, k3_0 = cuda_digest.launches, cuda_history.launches
        _c, rng_out, cold_ms = _post_json(port, "/query", body)
        batch_launches = {"digest_quantiles": cuda_digest.launches - k2_0,
                          "merge_windows": cuda_history.launches - k3_0}
        _check(batch_launches == {"digest_quantiles": 1, "merge_windows": 1},
               f"tiers: a range batch launched {batch_launches}")
        q_t0 = srv._t_query.snapshot(qs=())[0][1]
        q_sum0, q_n0 = q_t0.sum, q_t0.count
        warm_ms = [_post_json(port, "/query", body)[2] for _ in range(3)]
        q_t1 = srv._t_query.snapshot(qs=())[0][1]
        range_engine_ms = (q_t1.sum - q_sum0) / max(q_t1.count - q_n0, 1) / 1e6
        range_checked = _check_range_answers(rng_out, flushes, frames,
                                             "tiers range")
        plans = []
        orig_plan = srv.query_engine._plan_ranges

        def plan(batch):
            plans.append(orig_plan(batch))
            return plans[-1]
        srv.query_engine._plan_ranges = plan
        try:
            with digest_calls() as k2_calls, merge_calls() as k3_calls:
                _c, again, _ms = _post_json(port, "/query", body)
        finally:
            del srv.query_engine._plan_ranges
        # the phase's launches end here: the calls below compare and time
        launches = {"fused_ingest": cuda_ingest.launches,
                    "digest_quantiles": cuda_digest.launches,
                    "merge_windows": cuda_history.launches}
        _check(json.dumps(again) == json.dumps(rng_out),
               "tiers: a repeated range batch answered otherwise")
        _check(len(k2_calls) == 1 and len(k3_calls) == 1,
               f"tiers: captured {len(k2_calls)} K2, {len(k3_calls)} K3")
        (rows, sel), kw, merged = k3_calls[0]
        p = kw["precision"]
        idx = kw["idx"]
        set_rows = _take(rows, idx)
        plain = cuda_history.merge_windows_packed_plain(set_rows, sel,
                                                        precision=p)
        _check(torch.equal(merged, plain), "tiers: K3 differs from its "
               "plain version on the Server's ring")
        _check(np.array_equal(merged.cpu().numpy(), _merge_np(
            set_rows.cpu().numpy(), sel.cpu().numpy(), p)),
            "tiers: K3 differs from numpy on the Server's ring")
        # the answers' set estimates are the estimates of K3's words
        est = hll_ops.estimate_packed_rows(merged, precision=p).cpu().numpy()
        need_sets = plans[0]["need"][3]
        n_set = 0
        for qi, soff in ((2, 0), (4, HIST_INTERVALS)):
            for m in rng_out["results"][qi]["matches"]:
                key = ("set", m["name"], ",".join(m["tags"]))
                row = srv.history.rows_for_keys(3, [key])[0]
                r = need_sets.index(row)
                for j, pt in enumerate(m["points"][::-1]):
                    want = float(est[r, soff + j])
                    _check(pt["estimate"] == (want if math.isfinite(want)
                                              else None),
                           f"tiers: set {key} step {soff + j}")
                    n_set += 1
        k2 = _digest_case(device, k2_calls[0], clock_hz)
        def k3_as_the_server_calls_it():
            cuda_history.merge_windows_packed(rows, sel, precision=p,
                                              idx=idx)
        k3_ms = _time_ms(k3_as_the_server_calls_it, device, 20)
        k3_device_ms = _device_ms(k3_as_the_server_calls_it, 20, clock_hz)
        k3_plain_ms = _time_ms(lambda: cuda_history.merge_windows_packed_plain(
            set_rows, sel, precision=p), device, 2, warmup=1)
        k3_bytes, k3_ops = _merge_work(idx.numel(), sel.cpu().numpy(),
                                       srv.history.spec.hll_words)
        k3_bound_ms, k3_by = _bound(k3_bytes, k3_ops)
        q_t = srv._t_query.snapshot(qs=())[0][1]
        # one watch evaluation's parts, timed on the idle Server (the
        # flush worker's labelling and sink fan-out run beside the engine
        # thread during a flush): resolution and plan, the launch with its
        # copy back, on the last interval's detached state
        eng.offer = orig_offer
        watch_launches, watch_dispatch_ns = eng.launches_total, eng.dispatch_ns
        state, table = offered[0], offered[1]
        with eng._lock:
            watches = sorted(eng._watches.values(), key=lambda w: w.wid)
        plan_ms, eval_ms = [], []
        for _ in range(5):
            eng._plan_key = None
            t_a = time.perf_counter()
            wplan = eng._index_and_plan(table, watches)
            t_b = time.perf_counter()
            eng._materialize(eng._launch(state, wplan), wplan, 0)
            t_c = time.perf_counter()
            plan_ms.append((t_b - t_a) * 1e3)
            eval_ms.append((t_c - t_b) * 1e3)
        del state, table, offered[:]
        out.update(
            lines=sum(len(_tier_lines(i)) for i in range(HIST_INTERVALS)),
            intervals=HIST_INTERVALS, steps=agg.steps_total,
            launches=launches, launches_before_queries=launches_ingest,
            range_batch_launches=batch_launches,
            flush_ms=float(np.median(flush_ms)), flush_ms_each=flush_ms,
            device_update_ms=float(np.median(
                [ph.get("device_update", 0.0) for ph in phase_ms])),
            flush_phase_ms_each=phase_ms,
            instant_checked=checked,
            instant_ms_p50=float(np.percentile(lat, 50)),
            instant_ms_p99=float(np.percentile(lat, 99)),
            instant_batch_ms=inst_ms,
            range_ms_cold=cold_ms, range_ms_warm=warm_ms,
            range_engine_ms_warm=range_engine_ms,
            range_reply_bytes=len(json.dumps(rng_out)),
            query_requests=srv._c_query_requests.value(),
            query_launches=srv.query_engine.launches_total,
            query_duration_ms_mean=q_t.sum / max(q_t.count, 1) / 1e6,
            watch_fired_at=fired_at,
            watch_eval_ms_mean=srv._c_watch_eval_ns.value()
            / max(eng.intervals_evaluated, 1) / 1e6,
            watch_launches=watch_launches,
            watch_dispatch_ms_mean=watch_dispatch_ns
            / max(watch_launches, 1) / 1e6,
            watch_idle_plan_ms=float(np.median(plan_ms)),
            watch_idle_launch_ms=float(np.median(eval_ms)),
            watch_intervals=eng.intervals_evaluated,
            history_writes=srv._c_history_writes.value(),
            set_points_checked=n_set, **range_checked,
            k2=k2, k3=dict(rows=int(idx.numel()), steps=int(sel.shape[0]),
                           cols=int((sel > 0).any(dim=0).sum()),
                           ms=k3_ms, device_ms=k3_device_ms,
                           plain_ms=k3_plain_ms,
                           bound_ms=k3_bound_ms, bound_by=k3_by,
                           max_abs_err=0.0))
    finally:
        t2 = time.perf_counter()
        srv.shutdown()
        out["shutdown_s"] = time.perf_counter() - t2
        if reader is not None:
            resp.close()
            reader.join(timeout=10)
    _check(not srv._pipeline_thread.is_alive()
           and not srv._flush_thread.is_alive(),
           "tiers: shutdown left the pipeline or flush thread running")
    del srv
    torch.cuda.empty_cache()
    return out


# -- phase 11: the global tier ---------------------------------------------------

# BASELINE config 4: 64 locals forward to one global. Each local's interval
# (names and tags shared by every local, so each global key merges up to 65
# imports): global counters and gauges, timers over Zipf(1.2) name weights,
# and sets over 100k uids. The second interval, imported and then left
# unflushed at shutdown, comes from GLOBAL_TAIL_LOCALS other locals.
GLOBAL_LOCALS = 64
GLOBAL_TAIL_LOCALS = 8
# the locals replayed on a card Server and a CPU Server, held to each other
GLOBAL_REPLAY_LOCALS = 2
GLOBAL_SHAPE = dict(counters=10_000, gauges=1_000, timers=2_000,
                    timer_samples=30_000, sets=256, set_members=20_000,
                    uids=100_000)


def _global_interval(seed: int, shape: dict):
    """One local's interval as DogStatsD lines, and its raw timer samples
    (name index, value as the engine parses it) for the quantile oracle."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(1, 50, shape["counters"])
    # a hundred byte counters: their global sums pass 2^24, where only the
    # two-float accumulators (and the restore's two-step split) are exact
    counts[:100] = rng.integers(1 << 22, 1 << 23, 100)
    out = [b"g.req.%d:%d|c|#veneurglobalonly,svc:api" % (i, v) for i, v in
           enumerate(counts)]
    out += [b"g.load.%d:%.4f|g|#veneurglobalonly" % (i, v) for i, v in
            enumerate(rng.normal(size=shape["gauges"]))]
    names = (rng.zipf(1.2, shape["timer_samples"]) - 1) % shape["timers"]
    vals = rng.lognormal(3.0, 0.8, shape["timer_samples"])
    text = [b"%.4f" % v for v in vals]
    out += [b"g.lat.%d:%s|ms|#svc:api" % (n, t) for n, t in zip(names, text)]
    sn = (rng.zipf(1.2, shape["set_members"]) - 1) % shape["sets"]
    uid = rng.integers(0, shape["uids"], shape["set_members"])
    out += [b"g.users.%d:u%d|s" % (n, u) for n, u in zip(sn, uid)]
    return (b"\n".join(out), names,
            np.asarray([float(t) for t in text], np.float32))


def _global_locals(device, seeds, shape, kept=None):
    """Each seed's interval through one NativeAggregator (`feed`, then a
    flush with want_raw) and the port's export_metrics: the serialized
    MetricList a local forwards, and its raw timer samples. With `kept`,
    each local's (raw, table) is appended to it too."""
    from veneur_tpu_torch.forward.convert import export_metrics
    from veneur_tpu_torch.proto import forwardrpc_pb2 as fpb
    from veneur_tpu_torch.server.native_aggregator import NativeAggregator
    spec = _default_spec()
    loc = NativeAggregator(spec, device=device)
    lists, samples = [], []
    for s in seeds:
        lines, names, vals = _global_interval(s, shape)
        loc.feed(lines)
        _res, table, raw = loc.flush([0.5], want_raw=True)
        if kept is not None:
            kept.append((raw, table))
        lists.append(fpb.MetricList(metrics=export_metrics(
            raw, table, spec.compression, spec.hll_precision))
            .SerializeToString())
        samples.append((names, vals))
    return lists, samples


def _global_oracle(lists, precision: int) -> dict:
    """What a global must flush for these MetricLists, from the exports
    alone: counters their exact f64 sum, gauges the last value, sets the
    element-wise register max of the imported sketches, histograms the
    exact count, min and max of the imported digests."""
    from veneur_tpu_torch.ops import hll
    from veneur_tpu_torch.proto import forwardrpc_pb2 as fpb
    counters, gauges, sets, histos = {}, {}, {}, {}
    n_metrics = n_centroids = 0
    for data in lists:
        for m in fpb.MetricList.FromString(data).metrics:
            key = (m.name, ",".join(m.tags))
            n_metrics += 1
            which = m.WhichOneof("value")
            if which == "counter":
                counters[key] = counters.get(key, 0.0) + float(
                    m.counter.value)
            elif which == "gauge":
                gauges[key] = float(np.float32(m.gauge.value))
            elif which == "set":
                p, regs = hll.deserialize(m.set.hyper_log_log)
                _check(p == precision, f"set {key} at precision {p}")
                sets[key] = (regs if key not in sets
                             else np.maximum(sets[key], regs))
            else:
                td = m.histogram.t_digest
                w = np.asarray([c.weight for c in td.main_centroids],
                               np.float32)
                n_centroids += len(w)
                c, mn, mx = histos.get(key, (0.0, np.inf, -np.inf))
                histos[key] = (c + float(w.astype(np.float64).sum()),
                               min(mn, float(np.float32(td.min))),
                               max(mx, float(np.float32(td.max))))
    return dict(counter=counters, gauge=gauges, set=sets, histogram=histos,
                metrics=n_metrics, centroids=n_centroids)


def _global_server(device, **kw):
    """The global: phase 9's Server config (native ingest, the default
    widths) with the gRPC import listener; one checkpoint retained."""
    from veneur_tpu_torch.server.server import Server
    from veneur_tpu_torch.sinks.debug import DebugMetricSink
    sink = DebugMetricSink()
    srv = Server(_server_config(profile_capture_enabled=False,
                                grpc_address="127.0.0.1:0",
                                checkpoint_retain=1, **kw),
                 metric_sinks=[sink], device=device)
    return srv, sink


def _import(srv, lists, json_body=None) -> float:
    """Each MetricList through the port's ForwardClient, one SendMetrics a
    local, acknowledged in order, or `json_body` as a JSONMetric POST
    /import; returns the seconds until the pipeline has folded them all
    (the card finished too)."""
    import torch
    import urllib.request
    from veneur_tpu_torch.forward.rpc import ForwardClient
    from veneur_tpu_torch.proto import forwardrpc_pb2 as fpb
    n = sum(len(fpb.MetricList.FromString(d).metrics) for d in lists)
    base = srv.imported_total + srv.import_errors
    t0 = time.perf_counter()
    client = ForwardClient(f"127.0.0.1:{srv.grpc_port}")
    try:
        for data in lists:
            client.send_serialized(data, timeout=120)
    finally:
        client.close()
    if json_body is not None:
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.http_port}/import", data=json_body,
            method="POST", headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            _check(r.status == 202, f"POST /import answered {r.status}")
        n += len(json.loads(json_body))
    while srv.imported_total + srv.import_errors - base < n:
        _check(time.perf_counter() - t0 < 300,
               f"{srv.imported_total - base} of {n} imports folded "
               "after 300 s")
        time.sleep(0.001)
    if srv.device.type == "cuda":
        torch.cuda.synchronize()
    return time.perf_counter() - t0


def _flush_raw(srv, label: str, want_raw: bool = False) -> tuple:
    """One manual flush: its wall ms, each flush phase's ms, and the
    flush's own (res, table, raw) (raw None when the Server did not ask
    for the raw rows and `want_raw` is off; with it on, the flush gathers
    them and the Server gets what it asked for). A wrapper already on the
    aggregator (`_count_flushes`) stays on."""
    agg = srv.aggregator
    captured = []
    orig = agg.compute_flush
    wrapped = "compute_flush" in vars(agg)

    def capture(state, table, percentiles, **kw):
        asked = kw.get("want_raw", False)
        out = orig(state, table, percentiles,
                   **dict(kw, want_raw=asked or want_raw))
        captured.append(out if len(out) == 3 else (*out, None))
        return out if asked else out[:2]
    agg.compute_flush = capture
    before = _phase_sums(srv)
    t0 = time.perf_counter()
    try:
        _check(srv.trigger_flush(timeout=300), f"{label}: flush failed")
    finally:
        if wrapped:
            agg.compute_flush = orig
        else:
            del agg.compute_flush
    wall_ms = (time.perf_counter() - t0) * 1e3
    after = _phase_sums(srv)
    _check(len(captured) == 1, f"{label}: {len(captured)} compute_flush calls")
    return wall_ms, {k: (v - before.get(k, 0.0)) / 1e6
                     for k, v in after.items()}, captured[0]


def _global_rows(res, table, raw) -> dict:
    """The flush's app rows by kind and (name, joined tags)."""
    out = {k: {} for k in ("counter", "gauge", "set", "words", "histogram",
                           "quantiles")}
    for kind in ("counter", "gauge", "set", "histogram"):
        for i, (_s, m) in enumerate(table.get_meta(kind)):
            if m.name.startswith(("veneur.", "ssf.")):
                continue
            key = (m.name, ",".join(m.tags))
            if kind == "counter":
                out[kind][key] = float(res["counter"][i])
            elif kind == "gauge":
                out[kind][key] = float(res["gauge"][i])
            elif kind == "set":
                out[kind][key] = float(res["set_estimate"][i])
                if raw is not None:
                    out["words"][key] = np.asarray(raw["hll"][i])
            else:
                out[kind][key] = (float(res["histo_count"][i]),
                                  float(res["histo_min"][i]),
                                  float(res["histo_max"][i]))
                out["quantiles"][key] = np.asarray(res["histo_quantiles"][i],
                                                   np.float64)
    return out


def _check_global_flush(rows, oracle, device, precision, label) -> dict:
    """Counters exact, gauges the last import, set words the registers'
    max and the set estimates those words', histogram count/min/max
    exact."""
    import torch
    from veneur_tpu_torch.ops import hll
    for kind in ("counter", "gauge", "histogram"):
        _check(rows[kind] == oracle[kind],
               f"{label}: {kind}s differ from the exports' "
               f"({len(rows[kind])} vs {len(oracle[kind])} keys)")
    _check(sorted(rows["words"]) == sorted(oracle["set"]),
           f"{label}: set keys differ from the exports'")
    keys = sorted(oracle["set"])
    words = np.stack([rows["words"][k] for k in keys])
    want = hll.pack_registers_np(np.stack([oracle["set"][k] for k in keys]),
                                 precision)
    _check(np.array_equal(words, want), f"{label}: set words differ from "
           "the imported sketches' register max")
    est = hll.estimate_packed_rows(torch.from_numpy(words).to(device),
                                   precision=precision).cpu().numpy()
    _check([rows["set"][k] for k in keys] == [float(e) for e in est],
           f"{label}: set estimates are not their words' estimates")
    return dict(counters=len(rows["counter"]), gauges=len(rows["gauge"]),
                sets=len(keys), histograms=len(rows["histogram"]))


def _same_global_rows(got, want, q_tol, label, est_rtol=0.0):
    """Two global flushes of the same imports: counters, gauges, set words
    and histogram count/min/max equal, set estimates within `est_rtol`,
    quantiles within rtol/atol `q_tol` (returns the worst gap); with
    q_tol None the quantiles are measured, not held (`_quantile_gap`)."""
    for kind in ("counter", "gauge", "histogram"):
        _check(got[kind] == want[kind], f"{label}: {kind}s differ")
    _check(sorted(got["words"]) == sorted(want["words"]) and all(
        np.array_equal(got["words"][k], want["words"][k])
        for k in want["words"]), f"{label}: set words differ")
    _check(sorted(got["set"]) == sorted(want["set"]) and all(
        abs(got["set"][k] - v) <= est_rtol * abs(v)
        for k, v in want["set"].items()), f"{label}: set estimates differ")
    if q_tol is None:
        return _quantile_gap(got, want)
    return _same_quantiles(got, want, q_tol, label)


def _quantile_gap(got, want, tol: float = 1e-6) -> dict:
    """How far two flushes' quantiles lie apart: the worst absolute and
    relative gaps, and the keys with a quantile outside rtol/atol `tol`."""
    _check(sorted(got["quantiles"]) == sorted(want["quantiles"]),
           "histogram keys differ")
    worst_abs = worst_rel = 0.0
    outside = 0
    for k, w in want["quantiles"].items():
        g = got["quantiles"][k]
        d = np.abs(g - w)
        worst_abs = max(worst_abs, float(np.nanmax(d, initial=0.0)))
        worst_rel = max(worst_rel, float(np.nanmax(
            d / np.maximum(np.abs(w), 1e-30), initial=0.0)))
        outside += int(not np.allclose(g, w, rtol=tol, atol=tol,
                                       equal_nan=True))
    return dict(keys=len(want["quantiles"]), outside_1e_6=outside,
                worst_abs=worst_abs, worst_rel=worst_rel)


def _same_quantiles(got, want, tol, label) -> float:
    _check(sorted(got["quantiles"]) == sorted(want["quantiles"]),
           f"{label}: histogram keys differ")
    worst = 0.0
    for k, w in want["quantiles"].items():
        g = got["quantiles"][k]
        _check(np.array_equal(np.isnan(g), np.isnan(w)) and np.allclose(
            g, w, rtol=tol, atol=tol, equal_nan=True),
            f"{label}: {k} quantiles {g} vs {w}")
        d = np.abs(g - w)
        worst = max(worst, float(np.nanmax(d, initial=0.0)))
    return worst


def _timer_errors(rows, samples, timers: int) -> dict:
    """Each timer key's p50/p99 relative error against the midpoint
    quantiles of the union of the locals' raw samples (reported, not
    held: merged digests may miss)."""
    names = np.concatenate([n for n, _v in samples])
    vals = np.concatenate([v for _n, v in samples])
    order = np.argsort(names, kind="stable")
    names, vals = names[order], vals[order]
    bounds = np.searchsorted(names, np.arange(timers + 1))
    errs = {0.5: [], 0.99: []}
    for t in range(timers):
        v = vals[bounds[t]:bounds[t + 1]]
        got = rows["quantiles"].get((f"g.lat.{t}", "svc:api"))
        if len(v) < 24 or got is None:
            continue
        for qi, q in ((0, 0.5), (2, 0.99)):
            want = float(midpoint_quantile_rows(v[None, :], q)[0])
            errs[q].append(abs(got[qi] - want) / abs(want))
    return {f"p{int(q * 100)}": dict(
        keys=len(e), mean=float(np.mean(e)), p99=float(np.percentile(e, 99)),
        max=float(np.max(e)), over_1pct=int(np.sum(np.asarray(e) > 0.01)))
        for q, e in errs.items() if e}


def _range_body(iv: float, n: int) -> dict:
    """A range read over the last `n` intervals, one step each: counters,
    set rows (K3) and timers (K2)."""
    rng = dict(range=n * iv, step=iv)
    return {"queries": [
        dict(rng, prefix="g.req.12", kinds=["counter"]),
        dict(rng, prefix="g.users.1", kinds=["set"]),
        dict(rng, prefix="g.lat.1", kinds=["timer"], quantiles=PERCENTILES)]}


def _points_by_key(out) -> dict:
    return {(qi, m["name"], ",".join(m["tags"])): m["points"]
            for qi, r in enumerate(out["results"]) for m in r["matches"]}


def _watch_status(srv) -> str:
    return json.loads(_http(srv.http_port, "/watch")[1])["watches"][0][
        "status"]


def _import_interval(srv, lists, json_body, counter_want) -> float:
    """The global interval: the lists over gRPC (timed, returned), an
    instant read of one counter (it must read the gRPC imports' sum; the
    read also applies everything staged, so the JSONMetric batch after it
    lands last, as a later local's does), then the JSONMetric POST."""
    import_s = _import(srv, lists)
    _c, got, _ms = _post_json(srv.http_port, "/query", {
        "name": "g.req.0", "kinds": ["counter"]})
    value = got["results"][0]["matches"][0]["value"]
    _check(value == counter_want, f"global: instant g.req.0 read {value}, "
           f"the gRPC imports sum to {counter_want}")
    _import(srv, [], json_body)
    return import_s


def _replay(device, lists, json_body, counter_want) -> dict:
    """Some locals' imports through a fresh global Server on `device` (on
    the CPU the plain versions run): the flush's app rows."""
    srv, _sink = _global_server(device, query_enabled=True)
    srv.start()
    try:
        _import_interval(srv, lists, json_body, counter_want)
        _ms, _ph, flushed = _flush_raw(srv, f"{device.type} replay")
    finally:
        srv.shutdown()
    return _global_rows(*flushed)


def global_tier_path(device, clock_hz, shape=None, n_locals=GLOBAL_LOCALS,
                     n_tail=GLOBAL_TAIL_LOCALS, keep=None) -> dict:
    """Phase 11: the global tier on the card (see the module docstring).
    With `keep`, the locals' flush outputs, raw timer samples and the
    first flush's rows are left in it for phase 14b."""
    import shutil
    import tempfile
    import torch
    from veneur_tpu_torch.forward.jsonmetric import to_json_metrics
    from veneur_tpu_torch.ops import cuda_digest, cuda_history, cuda_ingest
    from veneur_tpu_torch.proto import forwardrpc_pb2 as fpb

    shape = shape or GLOBAL_SHAPE
    spec = _default_spec()
    p = spec.hll_precision
    t0 = time.perf_counter()
    kept = [] if keep is not None else None
    lists, samples = _global_locals(device, range(1000, 1001 + n_locals),
                                    shape, kept)
    json_list, lists = lists[-1], lists[:-1]
    json_body = json.dumps(to_json_metrics(list(
        fpb.MetricList.FromString(json_list).metrics))).encode()
    tail, _tail_samples = _global_locals(
        device, range(2000, 2000 + n_tail), shape)
    oracle = _global_oracle(lists + [json_list], p)
    grpc_sum = _global_oracle(lists, p)["counter"][("g.req.0", "svc:api")]
    out = dict(locals=n_locals, tail_locals=n_tail,
               locals_s=time.perf_counter() - t0,
               list_bytes=int(np.mean([len(d) for d in lists])),
               json_bytes=len(json_body), metrics=oracle["metrics"],
               centroids=oracle["centroids"])
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    root = f"{tmp}/global"
    tiers = dict(watch_enabled=True, history_enabled=True,
                 query_enabled=True, history_windows=8,
                 history_max_keys=1 << 14)
    try:
        # -- the locals' interval on the card ------------------------------
        srv, sink = _global_server(device, checkpoint_dir=root, **tiers)
        srv.start()
        try:
            agg, iv = srv.aggregator, srv.interval
            _c, reg, _ms = _post_json(srv.http_port, "/watch", {
                "name": "g.req.0", "threshold": 0.5})
            _check(_watch_status(srv) == "OK", "watch not OK at first")
            k1_steps = {}
            orig_k1 = cuda_ingest.fused_ingest

            def k1(state, streams, sp):
                # the first import step whose histogram stream has a run
                # past a warp's 32 positions (the warp-walk path): its
                # state and streams, copied. Looked for in the first 64
                # steps only, each look a host wait
                k1_steps["n"] = k1_steps.get("n", 0) + 1
                if "case" not in k1_steps and k1_steps["n"] <= 64 \
                        and _max_run(streams.h_slot) > 32:
                    k1_steps["case"] = (type(state)(*(t.clone()
                                                      for t in state)),
                                        type(streams)(*(t.clone()
                                                        for t in streams)))
                    k1_steps["at"] = k1_steps["n"]
                return orig_k1(state, streams, sp)
            cuda_ingest.launches = cuda_digest.launches = 0
            cuda_history.launches = 0
            steps0, synced0 = agg.steps_total, (agg.step_ns,
                                                agg.steps_synced)
            # the Python Batcher's steps (the histo_stat lanes the engine's
            # digests drain into, and the JSONMetric batch); the rest are
            # the engine's packed steps
            py_steps = [0]
            orig_on_batch = agg.batcher.on_batch

            def on_batch(batch):
                py_steps[0] += 1
                return orig_on_batch(batch)
            agg.batcher.on_batch = on_batch
            cuda_ingest.fused_ingest = k1
            try:
                import_s = _import_interval(srv, lists, json_body, grpc_sum)
            finally:
                cuda_ingest.fused_ingest = orig_k1
                agg.batcher.on_batch = orig_on_batch
            import_steps = agg.steps_total - steps0
            k1_import = cuda_ingest.launches
            _check(k1_import == import_steps > 0,
                   f"global: K1 {k1_import} launches for {import_steps} "
                   "import steps")
            step_ns = agg.step_ns - synced0[0]
            step_n = agg.steps_synced - synced0[1]
            ckpt_t = srv._t_ckpt_write.snapshot(qs=())[0][1]
            with digest_calls() as k2_calls:
                wall, phases, flushed = _flush_raw(srv, "global flush")
            launches = {"fused_ingest": cuda_ingest.launches,
                        "digest_quantiles": cuda_digest.launches,
                        "merge_windows": cuda_history.launches}
            _check(launches["fused_ingest"] == agg.steps_total - steps0,
                   "global: K1 launches != steps")
            _check(launches["digest_quantiles"] >= 1,
                   "global: K2 not launched by the flush")
            _check(srv.imported_total == oracle["metrics"]
                   and srv.import_errors == 0,
                   f"global: imported {srv.imported_total} of "
                   f"{oracle['metrics']}, {srv.import_errors} errors")
            rows = _global_rows(*flushed)
            out["flush_checked"] = _check_global_flush(rows, oracle, device,
                                                       p, "global flush")
            _check(srv._ckpt_writer.wait_idle(120.0),
                   "global: checkpoint not written")
            ckpt_t1 = srv._t_ckpt_write.snapshot(qs=())[0][1]
            cli = subprocess.run(
                [sys.executable, "-m", "veneur_tpu_torch.cli.checkpoint",
                 "verify", root], capture_output=True, text=True, timeout=120)
            _check(cli.returncode == 0, f"checkpoint verify: {cli.stdout}"
                   f"{cli.stderr}")
            t_w = time.perf_counter()
            while _watch_status(srv) != "ALERT":
                _check(time.perf_counter() - t_w < 60,
                       "global: the watch did not go to ALERT")
                time.sleep(0.01)
            out.update(
                import_s=import_s,
                metrics_per_s=oracle["metrics"] / import_s,
                centroids_per_s=oracle["centroids"] / import_s,
                import_steps=import_steps, import_steps_python=py_steps[0],
                k1_case_step=k1_steps.get("at"),
                import_step_ms=import_s * 1e3 / max(import_steps, 1),
                import_step_ms_synced=step_ns / max(step_n, 1) / 1e6,
                flush_ms=wall, flush_phase_ms={k: v for k, v in
                                               phases.items() if v},
                checkpoint_write_ms=(ckpt_t1.sum - ckpt_t.sum)
                / max(ckpt_t1.count - ckpt_t.count, 1) / 1e6,
                checkpoint_bytes=srv._c_ckpt_bytes.value(),
                verify_stdout=cli.stdout.strip().splitlines()[-1:],
                launches=launches)
            # the JSONMetric batch flushes what the same batch flushes
            # over gRPC
            _import(srv, [json_list])
            _ms, _ph, via_grpc = _flush_raw(srv, "json batch over gRPC")
            _import(srv, [], json_body)
            _ms, _ph, via_json = _flush_raw(srv, "json batch over HTTP")
            out["json_vs_grpc_worst"] = _same_global_rows(
                _global_rows(*via_json), _global_rows(*via_grpc), 2e-5,
                "JSON vs gRPC")
            # the range read before shutdown, then the second interval,
            # left unflushed: shutdown checkpoints it
            _c, before, _ms = _post_json(srv.http_port, "/query",
                                         _range_body(iv, 3))
            _check(_watch_status(srv) == "ALERT", "global: watch left ALERT")
            tail_s = _import(srv, tail)
            _check(srv._ckpt_writer.wait_idle(120.0),
                   "global: checkpoint not written")
            writes = srv._c_ckpt_writes.value()
        finally:
            t_sd = time.perf_counter()
            srv.shutdown()
            out["shutdown_s"] = time.perf_counter() - t_sd
        _check(srv._c_ckpt_writes.value() == writes + 1,
               "global: shutdown wrote no tail checkpoint")
        k1_case = k1_steps.get("case")
        _check(k1_case is not None, "global: no import step in the first 64 "
               "had a histogram run past 32")
        del srv
        torch.cuda.empty_cache()

        # -- what the first Server would have flushed for the tail ----------
        ref, _ = _global_server(device, checkpoint_dir=f"{tmp}/ref",
                                checkpoint_on_shutdown=False)
        ref.start()
        try:
            _import(ref, tail)
            _ms, _ph, ref_flushed = _flush_raw(ref, "tail reference")
        finally:
            ref.shutdown()
        want_tail = _global_rows(*ref_flushed)
        del ref, ref_flushed
        torch.cuda.empty_cache()

        # -- restart: the tail restored on the card -------------------------
        cpu_root = f"{tmp}/cpu_restore"
        shutil.copytree(root, cpu_root)
        srv2, _ = _global_server(device, checkpoint_dir=root,
                                 restore_on_start=True,
                                 checkpoint_on_shutdown=False, **tiers)
        fold = {}
        orig_restore = srv2._restore_from_checkpoint

        def timed_restore():
            t_r = time.perf_counter()
            orig_restore()
            torch.cuda.synchronize()
            fold["ms"] = (time.perf_counter() - t_r) * 1e3
        srv2._restore_from_checkpoint = timed_restore
        cuda_ingest.launches = cuda_digest.launches = 0
        cuda_history.launches = 0
        srv2.start()
        try:
            agg2 = srv2.aggregator
            restore_steps = agg2.steps_total
            _check(srv2._c_ckpt_restores.value() == 1, "global: no restore")
            _check(cuda_ingest.launches == restore_steps >= 2,
                   f"global restore: K1 {cuda_ingest.launches} launches, "
                   f"{restore_steps} steps")
            restore_launches = {"fused_ingest": cuda_ingest.launches}
            _check(_watch_status(srv2) == "ALERT",
                   "global: the watch is not in ALERT after the restart")
            with merge_calls() as k3_calls:
                _c, after, _ms = _post_json(srv2.http_port, "/query",
                                            _range_body(srv2.interval, 4))
            _check(cuda_history.launches == 1 and len(k3_calls) == 1,
                   f"global: the range read launched K3 "
                   f"{cuda_history.launches} times")
            (k3_rows, k3_sel), k3_kw, k3_out = k3_calls[0]
            k3_set_rows = k3_rows if k3_kw.get("idx") is None else \
                k3_rows.index_select(0, k3_kw["idx"].long())
            _check(torch.equal(k3_out, cuda_history.merge_windows_packed_plain(
                k3_set_rows, k3_sel, precision=k3_kw["precision"])),
                "global: K3 differs from its plain version on the "
                "restored ring")
            pb, pa = _points_by_key(before), _points_by_key(after)
            _check(sorted(pb) == sorted(pa) and len(pb) > 100,
                   "global: the restored ring's range read matched other keys")
            for key, pts in pb.items():
                _check(pa[key][:3] == pts and len(pa[key]) == 4,
                       f"global: range read {key} differs after the restart")
            restore_launches["merge_windows"] = cuda_history.launches
            with digest_calls() as k2_tail_calls:
                _ms, _ph, restored = _flush_raw(srv2, "restored flush")
            got_tail = _global_rows(*restored)
            # exact but for the quantiles: a restore re-adds each digest's
            # cells as weighted samples, which lands them in other cells
            # than the imports' did (the JAX package's restore does the
            # same, ROADMAP C-5), so their gap is measured, not held here;
            # the CPU restore below holds the card's restore to 2e-5
            out["restore_vs_import_gap"] = _same_global_rows(
                got_tail, want_tail, None, "restored flush vs the tail")
            restore_launches["digest_quantiles"] = cuda_digest.launches
        finally:
            srv2.shutdown()
        del srv2, restored
        torch.cuda.empty_cache()

        # -- the card's checkpoint restored on the CPU ----------------------
        cpu, _ = _global_server(torch.device("cpu"), checkpoint_dir=cpu_root,
                                restore_on_start=True,
                                checkpoint_on_shutdown=False)
        cpu.start()
        try:
            _ms, _ph, cpu_flushed = _flush_raw(cpu, "CPU restore")
        finally:
            cpu.shutdown()
        out["cpu_restore_worst"] = _same_global_rows(
            _global_rows(*cpu_flushed), got_tail, 2e-5,
            "CPU restore vs card restore", est_rtol=2e-5)
        # -- some locals' interval replayed on the card and on the CPU ------
        t_c = time.perf_counter()
        some = lists[:GLOBAL_REPLAY_LOCALS]
        some_sum = _global_oracle(some, p)["counter"][("g.req.0", "svc:api")]
        on_card = _replay(device, some, json_body, some_sum)
        torch.cuda.empty_cache()
        out["cpu_replay_worst"] = _same_quantiles(
            _replay(torch.device("cpu"), some, json_body, some_sum), on_card,
            2e-5, "CPU replay")
        out.update(replay_locals=len(some),
                   cpu_replay_s=time.perf_counter() - t_c)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # -- K1 and K2 on the phase's own tensors --------------------------------
    state, streams = k1_case
    out["k1"] = _ingest_streams_case(state, streams, spec, device, clock_hz,
                                     plain_reps=1)
    del state, streams, k1_case
    out["k2"] = _digest_case(device, k2_calls[0], clock_hz)
    out["k2_tail"] = _digest_case(device, k2_tail_calls[0], clock_hz)
    out["timer_error"] = _timer_errors(rows, samples, shape["timers"])
    if keep is not None:
        keep.update(locals=kept, rows=rows, samples=samples, shape=shape,
                    timer_error=out["timer_error"])
    out.update(restore_ms=fold["ms"], restore_steps=restore_steps,
               restore_launches=restore_launches,
               launches_phase={k: out["launches"][k] + restore_launches[k]
                               for k in restore_launches})
    torch.cuda.empty_cache()
    return out


# -- phase 12: the forward tier -------------------------------------------------

# four locals forward each flush through one proxy to two globals, exactly
# once; the first local also checkpoints, for the restart
FORWARD_LOCALS = 4
FORWARD_LINES = 50_000
FORWARD_TAIL_LINES = 10_000
FORWARD_SETS = 100
_SCOPE_TAG = b"veneurglobalonly"
_LOCAL_TAG = b"veneurlocalonly"


def _forward_lines(seed: int, n: int = FORWARD_LINES,
                   local_sets: bool = True) -> list:
    """One local's interval: phase 4's mix, with every tenth counter name
    and every tenth gauge name global-only (so that those forward), the
    set names past the first 100 local-only, and 100 global byte
    counters of 2^22 to 2^23 each, whose sums over the four locals pass
    2^24. (A set forwards as a dense sketch, 2^14 4-bit registers = 8
    KB: the hundreds of set names phase 4's mix gives a local would pass
    gRPC's 4 MiB message cap at the proxy, as in the reference.)

    The byte counters are multiples of 8. An ingest step sums a slot's
    entries in one f32 before the two-float fold, so where several
    locals' imports of a key share a global's step, a partial sum past
    2^24 rounds (ROADMAP C-6, the reference's own). Multiples of 8 keep
    every such sum exact up to 2^27, so the gate holds the two-float
    accumulation across steps; 100 more global counters of odd values
    (`bytes.odd.*`, the same range) show the rounding, reported and not
    held. With `local_sets` False every set name forwards, as in phase
    4's mix unchanged (that unit's size is reported, never sent)."""
    rng = np.random.default_rng(seed)
    out = []
    for line in make_lines(rng, n):
        name = line.split(b":", 1)[0]
        i = int(name.rsplit(b".", 1)[1])
        if name.startswith((b"api.requests.", b"queue.depth.")) \
                and i % 10 == 0:
            line += (b"," if b"|#" in line else b"|#") + _SCOPE_TAG
        elif local_sets and name.startswith(b"users.active.") \
                and i >= FORWARD_SETS:
            line += b"|#" + _LOCAL_TAG
        out.append(line)
    out += [b"bytes.sent.%d:%d|c|#veneurglobalonly" % (i, 8 * v)
            for i, v in enumerate(rng.integers(1 << 19, 1 << 20, 100))]
    out += [b"bytes.odd.%d:%d|c|#veneurglobalonly" % (i, 2 * v + 1)
            for i, v in enumerate(rng.integers(1 << 21, 1 << 22, 100))]
    return out


def _held_counters(rows, oracle, label) -> dict:
    """The global counters against the exact f64 sums of the lines: equal
    for every key but `bytes.odd.*`, whose gaps (C-6) are returned."""
    got, want = rows["counter"], oracle["counter"]
    _check(sorted(got) == sorted(want), f"{label}: counter keys differ "
           f"({len(got)} vs {len(want)})")
    odd = [k for k in want if k[0].startswith("bytes.odd.")]
    _check(len(odd) == 100, f"{label}: {len(odd)} odd byte counters")
    held = [k for k in want if not k[0].startswith("bytes.odd.")]
    _check(all(got[k] == want[k] for k in held),
           f"{label}: counters differ from the exact sums of the lines")
    gaps = [abs(got[k] - want[k]) for k in odd]
    return dict(held=len(held), odd_keys=len(odd),
                odd_off=sum(g > 0 for g in gaps), odd_max_abs=max(gaps))


def _forward_oracle(intervals) -> dict:
    """What the globals must flush for some local intervals' lines (one
    list of lines each): every global counter's exact f64 sum, every
    global gauge's candidates (each local's last write), every timer's
    samples and every forwarded set's members, by (name, sorted tags
    without the scope tags)."""
    counters, gauges, timers, sets = {}, {}, {}, {}
    for lines in intervals:
        last = {}
        for line in lines:
            head, *rest = line.split(b"|")
            name, value = head.split(b":", 1)
            rate, tags, scoped, local = 1.0, [], False, False
            for part in rest[1:]:
                if part.startswith(b"@"):
                    rate = float(part[1:])
                else:
                    tags = part[1:].split(b",")
                    scoped, local = _SCOPE_TAG in tags, _LOCAL_TAG in tags
                    tags = sorted(t for t in tags
                                  if t not in (_SCOPE_TAG, _LOCAL_TAG))
            key = (name.decode(), b",".join(tags).decode())
            if rest[0] == b"c":
                if scoped:
                    counters[key] = counters.get(key, 0.0) + float(
                        np.float32(float(value) * (1.0 / rate)))
            elif rest[0] == b"g":
                if scoped:
                    last[key] = float(np.float32(float(value)))
            elif rest[0] == b"ms":
                timers.setdefault(key, []).append(
                    float(np.float32(float(value))))
            elif not local:
                sets.setdefault(key, set()).add(value)
        for key, v in last.items():
            gauges.setdefault(key, set()).add(v)
    return dict(counter=counters, gauge=gauges, timer=timers, set=sets)


def _forward_rows(res, table, _raw=None) -> dict:
    """One global flush's app rows by kind and (name, sorted tags)."""
    out = {k: {} for k in ("counter", "gauge", "set", "quantiles")}
    for kind, field in (("counter", "counter"), ("gauge", "gauge"),
                        ("set", "set_estimate"),
                        ("histogram", "histo_quantiles")):
        for i, (_s, m) in enumerate(table.get_meta(kind)):
            if m.name.startswith(("veneur.", "ssf.")):
                continue
            key = (m.name, ",".join(sorted(m.tags)))
            v = res[field][i]
            if kind == "histogram":
                out["quantiles"][key] = np.asarray(v, np.float64)
            else:
                out[kind][key] = float(v)
    return out


def _merge_forward_rows(per_global, label) -> dict:
    """The globals' rows as one flush; every key on exactly one global."""
    merged = {k: {} for k in per_global[0]}
    for rows in per_global:
        for kind, by_key in rows.items():
            both = set(merged[kind]) & set(by_key)
            _check(not both, f"{label}: {len(both)} {kind} keys on both "
                   f"globals, e.g. {sorted(both)[:2]}")
            merged[kind].update(by_key)
    _check(all(any(rows[k] for k in rows) for rows in per_global),
           f"{label}: a global received no key")
    return merged


def _check_forward_flush(rows, oracle, label) -> dict:
    """Counters exact, gauges one of the locals' last writes, set
    estimates within 5% for keys with >= 100 members, timer p50 / p99
    within 6% / 1% of the midpoint quantiles of the locals' samples for
    keys with >= 24."""
    counters = _held_counters(rows, oracle, label)
    _check(sorted(rows["gauge"]) == sorted(oracle["gauge"]) and all(
        v in oracle["gauge"][k] for k, v in rows["gauge"].items()),
        f"{label}: a gauge is none of the locals' last writes")
    _check(sorted(rows["set"]) == sorted(oracle["set"]),
           f"{label}: set keys differ")
    big = [k for k, m in oracle["set"].items() if len(m) >= 100]
    set_rel = [abs(rows["set"][k] - len(oracle["set"][k]))
               / len(oracle["set"][k]) for k in big]
    _check(len(big) >= 8 and max(set_rel) < 0.05,
           f"{label}: HLL off by {max(set_rel, default=0):.4f}")
    _check(sorted(rows["quantiles"]) == sorted(oracle["timer"]),
           f"{label}: timer keys differ")
    by_len = {}
    for k, v in oracle["timer"].items():
        if len(v) >= 24:
            by_len.setdefault(len(v), []).append(k)
    worst = {0.5: 0.0, 0.99: 0.0}
    checked = 0
    for n, keys in by_len.items():
        vals = np.asarray([oracle["timer"][k] for k in keys])
        got = np.stack([rows["quantiles"][k] for k in keys])
        for qi, q, tol in ((0, 0.5, 0.06), (2, 0.99, 0.01)):
            exact = midpoint_quantile_rows(vals, q)
            rel = np.abs(got[:, qi] - exact) / np.maximum(np.abs(exact),
                                                          1e-9)
            worst[q] = max(worst[q], float(rel.max()))
            _check((rel < tol).all(), f"{label}: p{int(q * 100)} off by "
                   f"{rel.max():.4f} on a {n}-sample key")
        checked += len(keys)
    _check(checked >= 8, f"{label}: quantile oracle checked {checked} keys")
    return dict(counters=counters, gauges=len(rows["gauge"]),
                sets=len(rows["set"]), timers=len(rows["quantiles"]),
                quantile_keys_checked=checked, worst_p50_rel=worst[0.5],
                worst_p99_rel=worst[0.99], worst_hll_rel=max(set_rel))


def _local_server(device, proxy_port: int, **kw):
    """A local: phase 9's Server config, forwarding exactly once to the
    proxy."""
    from veneur_tpu_torch.server.server import Server
    return Server(_server_config(
        profile_capture_enabled=False,
        forward_address=f"127.0.0.1:{proxy_port}",
        forward_dedup_window=64, **kw), device=device)


@contextlib.contextmanager
def _export_log():
    """Yields a list of (ms, metrics, bytes) per export_metrics call in
    the block (the Server looks it up at each call), the forward units'
    staging."""
    from veneur_tpu_torch.forward import convert
    log, orig = [], convert.export_metrics

    def timed(*a, **kw):
        t0 = time.perf_counter()
        out = orig(*a, **kw)
        log.append(((time.perf_counter() - t0) * 1e3, len(out),
                    sum(m.ByteSize() for m in out)))
        return out
    convert.export_metrics = timed
    try:
        yield log
    finally:
        convert.export_metrics = orig


def _count_flushes(srv, flushes: list) -> None:
    """Adds one to `flushes[0]` at each of the Server's compute_flush
    calls: each launches K2 once on the card, on its histogram rows
    padded to at least 64 (one block: no kind here passes 2^17 live
    rows)."""
    agg = srv.aggregator
    orig = agg.compute_flush

    def counted(*a, **kw):
        flushes[0] += 1
        return orig(*a, **kw)
    agg.compute_flush = counted


def _unit_size(device, lines) -> dict:
    """The unit a local stages for these lines (a NativeAggregator flush
    with want_raw, then export_metrics, as a Server's flush stages it):
    its metrics, forwarded sets and serialized bytes."""
    from veneur_tpu_torch.forward.convert import export_metrics
    from veneur_tpu_torch.proto import forwardrpc_pb2 as fpb
    from veneur_tpu_torch.server.native_aggregator import NativeAggregator
    spec = _default_spec()
    loc = NativeAggregator(spec, device=device)
    loc.feed(b"\n".join(lines))
    _res, table, raw = loc.flush([0.5], want_raw=True)
    unit = export_metrics(raw, table, spec.compression, spec.hll_precision)
    return dict(metrics=len(unit),
                sets=sum(m.WhichOneof("value") == "set" for m in unit),
                bytes=fpb.MetricList(metrics=unit).ByteSize())


def _imports(globs) -> int:
    return sum(g.imported_total + g.import_errors for g in globs)


def _forward_round(locs, globs, proxy, lines_by_local, label,
                   fails: bool, exports) -> list:
    """Each local's lines through its UDP listener, then each local's
    flush in turn, waiting for its forward to settle (acked, or failed
    when `fails`) and for the globals to fold what the proxy delivered.
    Returns each local's flush and forward numbers."""
    for loc, lines in zip(locs, lines_by_local):
        base = _lines_seen(loc.aggregator)
        _send_paced(loc, _datagrams(lines), label)
        _wait_seen(loc, base, len(lines), label)
    out = []
    for i, loc in enumerate(locs):
        err0, sends0 = loc.forward_errors, loc.forward_sends_total
        fwd0, imp0, n_exp = proxy.forwarded, _imports(globs), len(exports)
        before = _phase_sums(loc)
        t0 = time.perf_counter()
        _check(loc.trigger_flush(timeout=300), f"{label}: local {i} flush")
        flush_ms = (time.perf_counter() - t0) * 1e3
        while not (loc.forward_errors > err0 if fails else
                   loc.forward_sends_total > sends0
                   and len(loc.forward_spill) == 0):
            _check(time.perf_counter() - t0 < 120,
                   f"{label}: local {i}'s forward did not settle")
            _check(fails or loc.forward_errors == err0,
                   f"{label}: local {i}'s forward failed")
            time.sleep(0.0005)
        settled_ms = (time.perf_counter() - t0) * 1e3
        while _imports(globs) - imp0 < proxy.forwarded - fwd0:
            _check(time.perf_counter() - t0 < 120,
                   f"{label}: the globals did not fold local {i}'s unit")
            time.sleep(0.0005)
        folded_ms = (time.perf_counter() - t0) * 1e3
        phases = {k: (v - before.get(k, 0.0)) / 1e6
                  for k, v in _phase_sums(loc).items()}
        _check(len(exports) == n_exp + 1,
               f"{label}: local {i} staged {len(exports) - n_exp} units")
        exp_ms, n_metrics, n_bytes = exports[-1]
        out.append(dict(flush_ms=flush_ms, settled_ms=settled_ms,
                        flush_to_folded_ms=folded_ms,
                        forward_ms=phases.get("forward", 0.0),
                        export_ms=exp_ms, unit_metrics=n_metrics,
                        unit_bytes=n_bytes,
                        delivered=proxy.forwarded - fwd0))
    return out


def _flush_globals(globs, label) -> tuple:
    """Both globals flushed by hand: their rows as one flush, and each
    flush's wall ms."""
    rows, walls = [], []
    for i, g in enumerate(globs):
        wall, _ph, flushed = _flush_raw(g, f"{label}: global {i}")
        rows.append(_forward_rows(*flushed))
        walls.append(wall)
    return _merge_forward_rows(rows, label), walls


def _spill_gauge(srv) -> float:
    samples = srv.metrics.get("veneur.forward.spill_bytes").samples()
    return samples[0][1] if samples else 0.0


def forward_tier_path(device, clock_hz) -> dict:
    """Phase 12: the forward tier on the card (see the module docstring)."""
    import shutil
    import tempfile
    import torch
    from veneur_tpu_torch.forward.discovery import StaticDiscoverer
    from veneur_tpu_torch.forward.proxysrv import ProxyServer
    from veneur_tpu_torch.ops import cuda_digest, cuda_ingest
    from veneur_tpu_torch.reliability.faults import FAULTS, PROXY_FORWARD
    from veneur_tpu_torch.server.server import Server

    t0 = time.perf_counter()
    seeds = [[12_000 + 10 * r + i for i in range(FORWARD_LOCALS)]
             for r in range(3)]
    rounds = [[_forward_lines(s) for s in rs] for rs in seeds]
    fourth, tail = _forward_lines(12_040), _forward_lines(12_050,
                                                          FORWARD_TAIL_LINES)
    oracle1 = _forward_oracle(rounds[0])
    oracle23 = _forward_oracle(rounds[1] + rounds[2])
    oracle_r = _forward_oracle([fourth, tail])
    out = dict(locals=FORWARD_LOCALS, lines_per_interval=len(rounds[0][0]),
               lines_s=time.perf_counter() - t0)
    # the unit phase 4's mix would make with every set name forwarded:
    # past gRPC's 4 MiB receive cap, which neither package raises
    # (ROADMAP C-7), so the phase keeps set names past 100 local-only
    out["unit_all_sets_forwarded"] = _unit_size(
        device, _forward_lines(seeds[0][0], local_sets=False))
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_fwd_")
    flushes = [0]
    cuda_ingest.launches = cuda_digest.launches = 0
    wide0 = cuda_digest.wide_launches
    # every Server of the phase (`fleet`, for the launch count) and the
    # ones still running (`live`, for the shutdown)
    globs, locs, fleet, live, proxy = [], [], [], [], None
    try:
        globs = [Server(_server_config(
            profile_capture_enabled=False, statsd_listen_addresses=[],
            grpc_address="127.0.0.1:0", forward_dedup_window=64),
            device=device) for _ in range(2)]
        fleet += globs
        live += globs
        for g in globs:
            _count_flushes(g, flushes)
            g.start()
        dests = [f"127.0.0.1:{g.grpc_port}" for g in globs]
        _check(dests[1] not in dests[0], "global addresses overlap")
        proxy = ProxyServer(StaticDiscoverer(dests), dedup_window=64)
        proxy.start("127.0.0.1:0")
        ckpt = dict(checkpoint_dir=f"{tmp}/local0", checkpoint_retain=1)
        locs = [_local_server(device, proxy.port, **(ckpt if i == 0 else {}))
                for i in range(FORWARD_LOCALS)]
        fleet += locs
        live += locs
        for loc in locs:
            _count_flushes(loc, flushes)
            loc.start()
        py_steps = [0, 0]
        for gi, g in enumerate(globs):
            # the Python Batcher's steps: the 256-entry histo_stat lane
            # the engine's imported digests drain into
            orig = g.aggregator.batcher.on_batch

            def on_batch(batch, gi=gi, orig=orig):
                py_steps[gi] += 1
                return orig(batch)
            g.aggregator.batcher.on_batch = on_batch
        out["setup_s"] = time.perf_counter() - t0

        with _export_log() as exports:
            # -- interval 1: every unit delivered --------------------------
            t1 = time.perf_counter()
            r1 = _forward_round(locs, globs, proxy, rounds[0], "forward 1",
                                False, exports)
            out["interval1_s"] = time.perf_counter() - t1
            with digest_calls() as k2_calls:
                rows1, walls1 = _flush_globals(globs, "forward 1")
            out["interval1"] = _check_forward_flush(rows1, oracle1,
                                                    "forward 1")
            _check(all(loc._fwd_acked_seq == 0
                       and len(loc.forward_spill) == 0 for loc in locs),
                   "forward 1: a local's unit is not acked")
            # the relay's rate, end to end: what the proxy delivered over
            # the time from the locals' flushes returning to the globals'
            # folds (the local's pump, the proxy, the globals' gRPC
            # receive and their fold)
            out.update(local_flushes=r1, global_flush_ms=walls1,
                       pump_to_fold_metrics_per_s=sum(r["delivered"]
                                                      for r in r1)
                       / sum(r["flush_to_folded_ms"] - r["flush_ms"]
                             for r in r1) * 1e3)

            # -- interval 2: g2 fails, every unit held ---------------------
            base_imports = _imports(globs)
            base_forwarded = proxy.forwarded
            FAULTS.arm(PROXY_FORWARD, error=True, match=dests[1])
            try:
                r2 = _forward_round(locs, globs, proxy, rounds[1],
                                    "forward 2", True, exports)
            finally:
                FAULTS.reset()
            _check(all(len(loc.forward_spill.pending_units()) == 1
                       for loc in locs),
                   "forward 2: a local does not hold its unit")
            spill = [_spill_gauge(loc) for loc in locs]
            _check(min(spill) > 0, f"forward 2: spill_bytes {spill}")
            _check(len(proxy._inflight) == FORWARD_LOCALS,
                   f"forward 2: {len(proxy._inflight)} groupings pinned")

            # -- interval 3: the fault cleared, each unit re-sent ----------
            r3 = _forward_round(locs, globs, proxy, rounds[2], "forward 3",
                                False, exports)
            _check(all(loc._fwd_acked_seq == 2
                       and len(loc.forward_spill) == 0 for loc in locs),
                   "forward 3: the held units were not acked")
            _check(not proxy._inflight, "forward 3: groupings left pinned")
            _check(_imports(globs) - base_imports
                   == proxy.forwarded - base_forwarded,
                   "forward 3: the globals folded other than delivered")
            rows23, _w = _flush_globals(globs, "forward 2-3")
            out["interval23_counters"] = _held_counters(
                rows23, oracle23, "forward 2-3")
            dups = dict(proxy=proxy.dup_suppressed,
                        globals=[g._c_dup_suppressed.value()
                                 for g in globs])
            out.update(fault_flushes=r2, retry_flushes=r3,
                       spill_bytes=spill, dup_suppressed=dups,
                       proxy_errors=proxy.errors)

            # -- a restart: the first local's next unit held back ----------
            loc0 = locs[0]
            FAULTS.arm(PROXY_FORWARD, error=True, match=dests[1])
            try:
                _forward_round([loc0], globs, proxy, [fourth], "forward 4",
                               True, exports)
            finally:
                FAULTS.reset()
            base = _lines_seen(loc0.aggregator)
            _send_paced(loc0, _datagrams(tail), "forward tail")
            _wait_seen(loc0, base, len(tail), "forward tail")
            # the held unit's seq; the tail's unit takes the next
            sid, epoch, seq = (loc0._fwd_source_id, loc0._fwd_epoch,
                               loc0._fwd_next_seq)
            writes = loc0._c_ckpt_writes.value()
            live.remove(loc0)
            loc0.shutdown()
            _check(loc0._c_ckpt_writes.value() == writes + 1,
                   "forward: shutdown wrote no tail checkpoint")
        loc0b = _local_server(device, proxy.port, restore_on_start=True,
                              **ckpt)
        fleet.append(loc0b)
        live.append(loc0b)
        _count_flushes(loc0b, flushes)
        fold = {}
        orig_restore = loc0b._restore_from_checkpoint

        def timed_restore():
            t_r = time.perf_counter()
            orig_restore()
            torch.cuda.synchronize()
            fold["ms"] = (time.perf_counter() - t_r) * 1e3
        loc0b._restore_from_checkpoint = timed_restore
        k1_before = cuda_ingest.launches
        loc0b.start()
        restore_steps = loc0b.aggregator.steps_total
        _check(loc0b._c_ckpt_restores.value() == 1, "forward: no restore")
        _check(cuda_ingest.launches - k1_before == restore_steps >= 1,
               f"forward restore: K1 {cuda_ingest.launches - k1_before} "
               f"launches, {restore_steps} steps")
        units = [(u.epoch, u.seq)
                 for u in loc0b.forward_spill.pending_units()]
        _check((loc0b._fwd_source_id, loc0b._fwd_epoch) == (sid, epoch + 1)
               and units == [(epoch, seq - 1), (epoch, seq)],
               f"forward restart: identity {loc0b._fwd_epoch}, units "
               f"{units} (held seq {seq - 1}, tail seq {seq})")
        fwd0, imp0 = proxy.forwarded, _imports(globs)
        with _export_log() as exports_b:
            _check(loc0b.trigger_flush(timeout=300),
                   "forward restart: flush")
        t_b = time.perf_counter()
        while len(loc0b.forward_spill) or \
                _imports(globs) - imp0 < proxy.forwarded - fwd0:
            _check(time.perf_counter() - t_b < 120,
                   "forward restart: the replay did not land")
            time.sleep(0.0005)
        _check(loc0b._fwd_acked_seq == 0 and not proxy._inflight,
               "forward restart: the replay was not acked")
        rows_r, _w = _flush_globals(globs, "forward restart")
        out["restart_counters"] = _held_counters(rows_r, oracle_r,
                                                 "forward restart")
        out.update(
            restore_ms=fold["ms"], restore_steps=restore_steps,
            replayed_units=units, replay_export_metrics=[
                e[1] for e in exports_b],
            global_steps=[g.aggregator.steps_total for g in globs],
            global_stats_lane_steps=py_steps,
            local_steps=[s.aggregator.steps_total for s in fleet[2:]],
            proxy_metrics_by_destination={
                f"{d} {proto}": n for (d, proto), n
                in sorted(proxy.metrics_by_destination.items())},
            dup_suppressed_after_restart=dict(
                proxy=proxy.dup_suppressed,
                globals=[g._c_dup_suppressed.value() for g in globs]))
    finally:
        FAULTS.reset()
        for srv in live:
            srv.shutdown()
        if proxy is not None:
            proxy.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    # the path's launches, the shutdowns' tail flushes included; the
    # comparison and timing below come after
    launches = {"fused_ingest": cuda_ingest.launches,
                "digest_quantiles": cuda_digest.launches}
    steps = sum(s.aggregator.steps_total for s in fleet)
    _check(launches["fused_ingest"] == steps,
           f"forward: K1 {launches['fused_ingest']} launches for {steps} "
           "ingest steps")
    _check(launches["digest_quantiles"] == flushes[0] >= 20
           and cuda_digest.wide_launches == wide0,
           f"forward: K2 launched {launches['digest_quantiles']} times "
           f"({cuda_digest.wide_launches - wide0} wide) for {flushes[0]} "
           "flushes")
    out.update(launches=launches, flushes=flushes[0],
               k2=_digest_case(device, k2_calls[0], clock_hz))
    torch.cuda.empty_cache()
    return out


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


# -- phase 13: the Server under pressure ----------------------------------------

P13_SEED = 150_150              # config 15's replay seed
P13_STEADY, P13_DIURNAL, P13_FLASH, P13_POST = 10_000, 4_000, 20_000, 3_000
P13_Q_MAX = 3_500               # above any steady tenant's key count
P13_EXPLODE = P13_Q_MAX + 1_500
P13_EXACT_K = 250
P13_GOLD = 200                  # shed_priority_tags lines in interval 3
P13_GOLD_TAG = "tier:gold"
P13_ISOLATED = ("blue", "dex", "default")
P13_NOISY, P13_RUNAWAY = "acme", "crux"
P13_RINGS = 2


def _http_code(port: int, path: str, body: bytes = None,
               ctype: str = "application/json") -> int:
    """The status code of one GET (or POST with `body`)."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=body, headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            r.read()
            return r.status
    except urllib.error.HTTPError as e:
        e.read()
        return e.code


def _wait_for(cond, what: str, timeout_s: float = 30.0,
              poll_s: float = 0.005) -> None:
    t0 = time.perf_counter()
    while not cond():
        _check(time.perf_counter() - t0 < timeout_s,
               f"{what} after {timeout_s:.0f} s")
        time.sleep(poll_s)


def _ring_of(gram: bytes) -> int:
    """Each key's datagrams ride one ring, so its order is fixed."""
    return sum(gram.split(b":", 1)[0]) % P13_RINGS


def _inject_rings(srv, grams) -> None:
    """Through the rings' admission boundary (rings_inject): a full ring
    answers INJECT_BACKPRESSURE and counts nothing, so the retry is
    exact."""
    from veneur_tpu_torch.native import INJECT_BACKPRESSURE
    eng = srv.aggregator.eng
    for i, g in enumerate(grams):
        while eng.rings_inject(_ring_of(g), g) == INJECT_BACKPRESSURE:
            time.sleep(0.0005)
        if (i & 0xFFF) == 0xFFF:
            while srv.aggregator.reader_counters()["ring_depth"] > 16_000:
                time.sleep(0.001)


def _tenant_totals(ten) -> tuple:
    return ({t: n for (t,), n in ten.admitted_snapshot()},
            {t: n for (t,), n in ten.shed_snapshot()})


def _settle_tenants(srv, sent: dict, label: str) -> None:
    """Until every datagram sent is in the tenant ledger (admitted or
    shed, folded from both rings by the overload poller), the rings are
    empty and their workers have parsed every admitted line; then one
    more fold, which carries the demoted rows counted at the parse."""
    total = sum(sent.values())

    def folded():
        adm, shd = _tenant_totals(srv.tenancy)
        return sum(adm.values()) + sum(shd.values())
    _wait_for(lambda: folded() >= total, f"{label}: tenant ledger short")
    _check(folded() == total, f"{label}: ledger {folded()} != sent {total}")
    agg = srv.aggregator
    last = [-1]

    def parsed():
        # empty rings, and no line parsed in the last 50 ms
        if agg.reader_counters()["ring_depth"]:
            return False
        now = _lines_seen(agg)
        done, last[0] = now == last[0], now
        return done
    _wait_for(parsed, f"{label}: rings not drained", poll_s=0.05)
    srv._sync_native_admission(srv._overload)


class _FlushProbe:
    """Wraps the compute_flush of a Server's aggregator (again after a
    grow installs a new one): captures each call's (res, table) and
    checks that K2 launched in every flush that has histogram rows, read
    before any timing harness runs."""

    def __init__(self, srv, label: str):
        self.calls, self.label = [], label
        self.wrap(srv)

    def wrap(self, srv) -> None:
        from veneur_tpu_torch.ops import cuda_digest
        agg = srv.aggregator
        if getattr(agg, "_p13_probe", None) is self:
            return
        orig = agg.compute_flush
        label = self.label

        def probe(state, table, percentiles, **kw):
            k0 = cuda_digest.launches
            out = orig(state, table, percentiles, **kw)
            if table.get_meta("histogram"):
                _check(cuda_digest.launches > k0,
                       f"{label}: a flush with histogram rows launched no "
                       "K2")
            self.calls.append((out[0], out[1]))
            return out
        agg.compute_flush = probe
        agg._p13_probe = self

    def flush(self, srv, what: str):
        self.wrap(srv)
        n = len(self.calls)
        _check(srv.trigger_flush(timeout=300),
               f"{self.label}: {what} flush failed")
        _check(len(self.calls) == n + 1,
               f"{self.label}: {what}: {len(self.calls) - n} compute_flush "
               "calls")
        return self.calls[-1]


class _TenantTable:
    """A flush's key table and rows restricted to the isolated tenants'
    keys (replay.<tenant>.*): what _check_tenant_flush holds to the
    oracle of their lines."""

    ROWS = _AppTable.ROWS

    def __init__(self, res, table, tenants):
        prefixes = tuple(f"replay.{t}." for t in tenants)
        self.metas, self.res = {}, {}
        for kind, keys in self.ROWS.items():
            metas = table.get_meta(kind)
            keep = [i for i, (_s, m) in enumerate(metas)
                    if m.name.startswith(prefixes)]
            self.metas[kind] = [metas[i] for i in keep]
            for key in keys:
                self.res[key] = np.asarray(res[key])[keep]

    def get_meta(self, kind):
        return self.metas[kind]


def _check_tenant_flush(res, table, lines, label) -> dict:
    """The isolated tenants' keys against the f64 oracle of their lines:
    counters exact, gauges the last write, timer p50 within 6% and p99
    within 1% for keys with >= 24 samples, set estimates within 5% for
    keys with >= 20 members (the tenants' sets are small: the linear-
    counting range, where the estimate is near exact)."""
    t = _TenantTable(res, table, P13_ISOLATED)
    counters, gauges, timers, sets = _oracle(lines)

    def rows(kind):
        return [(m.name, m.joined_tags or "") for _s, m in t.get_meta(kind)]
    for kind, want, key in (("counter", counters, "counter"),
                            ("gauge", gauges, "gauge")):
        keys = rows(kind)
        _check(sorted(keys) == sorted(want),
               f"{label}: {kind} keys differ from the lines'")
        got = np.asarray(t.res[key], np.float64)
        _check(np.array_equal(got, [want[k] for k in keys]),
               f"{label}: {kind} values differ from the f64 oracle")
    h_keys = rows("histogram")
    _check(sorted(h_keys) == sorted(timers), f"{label}: timer keys")
    hq = np.asarray(t.res["histo_quantiles"])
    worst, checked = {0.5: 0.0, 0.99: 0.0}, 0
    for i, k in enumerate(h_keys):
        if len(timers[k]) < 24:
            continue
        checked += 1
        for qi, q, tol in ((0, 0.5, 0.06), (2, 0.99, 0.01)):
            exact = float(midpoint_quantile_rows(
                np.asarray([timers[k]]), q)[0])
            rel = float(abs(hq[i, qi] - exact) / max(abs(exact), 1e-9))
            worst[q] = max(worst[q], rel)
            _check(rel < tol, f"{label}: {k} p{int(q * 100)} off by "
                   f"{rel:.4f}")
    _check(checked >= 4, f"{label}: {checked} timer keys checked")
    s_keys = rows("set")
    _check(sorted(s_keys) == sorted(sets), f"{label}: set keys")
    est = np.asarray(t.res["set_estimate"], np.float64)
    n = np.asarray([len(sets[k]) for k in s_keys], np.float64)
    big = n >= 20
    rel = np.abs(est[big] - n[big]) / n[big]
    _check(big.sum() >= 1 and (rel < 0.05).all(),
           f"{label}: set estimates off by {rel.max(initial=0):.4f}")
    return dict(counters=len(rows("counter")), gauges=len(rows("gauge")),
                timers=len(h_keys), sets=len(s_keys),
                quantile_keys_checked=checked, worst_p50_rel=worst[0.5],
                worst_p99_rel=worst[0.99],
                worst_set_rel=float(rel.max(initial=0.0)))


def _p13a_server(device, ckpt: str, **kw):
    from veneur_tpu_torch.server.server import Server
    from veneur_tpu_torch.sinks.debug import DebugMetricSink
    sink = DebugMetricSink()
    srv = Server(_server_config(
        profile_capture_enabled=False, reader_rings=P13_RINGS,
        num_readers=1, query_enabled=True, tenant_enabled=True,
        tenant_fair_rate=P13_FLASH / 10.0, tenant_fair_burst_mult=3.0,
        tenant_quarantine_max_keys=P13_Q_MAX, tenant_quarantine_decay=0.25,
        tenant_quarantine_readmit_frac=0.5, overload_enabled=True,
        overload_native_admission=True, overload_poll_interval_s=0.05,
        overload_hold_s=0.3, shed_priority_tags=[P13_GOLD_TAG],
        checkpoint_dir=ckpt, checkpoint_interval_flushes=100_000,
        checkpoint_on_shutdown=True, **kw), metric_sinks=[sink],
        device=device)
    ring_steps = [0]
    agg = srv.aggregator
    emit = agg._emit_rings

    def counted():
        stepped = emit()
        ring_steps[0] += stepped
        return stepped
    agg._emit_rings = counted
    srv.start()
    srv._overload._signals = lambda: {}
    return srv, sink, ring_steps


def _force_state(srv, pressure: float, want: int, label: str) -> None:
    ov = srv._overload
    ov._signals = (lambda: {"forced": pressure}) if pressure else (
        lambda: {})
    _wait_for(lambda: ov.state == want, f"{label}: overload state "
              f"{ov.state_name}, want {want}", 15.0)


def _k1_expected(srv, ring_steps) -> int:
    """K1 launches a Server's steps make: one a step, and one more for
    each further ring row of a ring step (packed_rings_core)."""
    return srv.aggregator.steps_total + (P13_RINGS - 1) * ring_steps[0]


def pressure_path(device) -> dict:
    """Phase 13a: overload and tenancy, BASELINE config 15 at the default
    widths (see the module docstring)."""
    import shutil
    import tempfile
    from benchmarks.replay import ReplayGenerator
    from veneur_tpu_torch.forward.jsonmetric import to_json_metrics
    from veneur_tpu_torch.ops import cuda_digest, cuda_ingest
    from veneur_tpu_torch.proto import metricpb_pb2 as mpb
    from veneur_tpu_torch.reliability.overload import (CRITICAL, HEALTHY,
                                                       SHEDDING)
    from veneur_tpu_torch.server.flusher import generate_intermetrics

    label = "phase 13a"
    gen = ReplayGenerator(P13_SEED)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_p13_")
    out, k1_want = {}, 0
    cuda_ingest.launches = cuda_digest.launches = 0
    srv = None
    try:
        srv, sink, rsteps = _p13a_server(device, tmp)
        port = srv.http_port
        probe = _FlushProbe(srv, label)
        codes = {"healthz": set()}

        def health():
            codes["healthz"].add(_http_code(port, "/healthz"))
            return _http_code(port, "/readyz")
        _check(health() == 200, f"{label}: /readyz not 200 when healthy")
        # interval 2: steady and diurnal traffic, then the flash crowd
        # under forced SHEDDING
        t0 = time.perf_counter()
        grams = gen.steady(P13_STEADY) + gen.diurnal(P13_DIURNAL)
        _inject_rings(srv, grams)
        _force_state(srv, 0.90, SHEDDING, label)
        _check(health() == 503, f"{label}: /readyz not 503 at SHEDDING")
        _wait_for(lambda: srv.aggregator.pending_set_shift > 0,
                  f"{label}: the poller pushed no set shift")
        flash = gen.flash_crowd(P13_FLASH)
        _inject_rings(srv, flash)
        grams += flash
        _settle_tenants(srv, gen.ledger(), label)
        inject_s = time.perf_counter() - t0
        adm, shd = _tenant_totals(srv.tenancy)
        _check(all(shd.get(t, 0) == 0 for t in P13_ISOLATED),
               f"{label}: an isolated tenant was shed: {shd}")
        _check(shd.get(P13_NOISY, 0) > 0, f"{label}: the noisy tenant was "
               "not throttled")
        res, table = probe.flush(srv, "flash interval")
        iso = [g for g in grams if any(
            g.startswith(f"replay.{t}.".encode()) for t in P13_ISOLATED)]
        out["isolated"] = _check_tenant_flush(res, table, iso, label)
        # interval 3: the post segment and priority lines (blue's), then
        # CRITICAL: query and import shed, the flush protected and its
        # set estimates corrected by 2^shift (latched at the last swap)
        gold = [b"p13.gold.c%d:%d|c|#%s,tenant:blue" % (
                    i % 20, i + 1, P13_GOLD_TAG.encode())
                for i in range(P13_GOLD // 2)]
        gold += [b"p13.gold.s%d:u%d|s|#%s,tenant:blue" % (
                     i % 2, i, P13_GOLD_TAG.encode())
                 for i in range(P13_GOLD // 2)]
        sent_extra = {"blue": len(gold)}
        post = gen.steady(P13_POST)
        _inject_rings(srv, post + gold)
        ledger = gen.ledger()
        ledger["blue"] += sent_extra["blue"]
        _settle_tenants(srv, ledger, label)
        shift = srv.aggregator.active_set_shift
        _force_state(srv, 0.99, CRITICAL, label)
        _check(health() == 503, f"{label}: /readyz not 503 at CRITICAL")
        q0 = srv._c_query_shed.value()
        code_q = _http_code(port, "/query", json.dumps(
            {"name": "p13.gold.c1"}).encode())
        m = mpb.Metric(name="p13.imported", type=mpb.Counter,
                       scope=mpb.Global)
        m.counter.value = 1
        code_i = _http_code(port, "/import",
                            json.dumps(to_json_metrics([m])).encode())
        _check((code_q, code_i) == (503, 503)
               and srv._c_query_shed.value() == q0 + 1,
               f"{label}: at CRITICAL query {code_q}, import {code_i}")
        ov = srv._overload
        flush_shed0 = ov.shed.get("flush", 0)
        sink.flushed.clear()
        res, table = probe.flush(srv, "CRITICAL")
        app = _app_ims(sink)
        _check(app and all(any(P13_GOLD_TAG in t for t in m.tags)
                           for m in app),
               f"{label}: the CRITICAL flush published non-priority rows")
        rows = generate_intermetrics(
            res, table, percentiles=srv.cfg.percentiles,
            aggregates=srv.cfg.aggregates, is_local=srv.cfg.is_local,
            timestamp=0, hostname=srv.hostname)
        withheld = sum(1 for r in rows if not r.name.startswith("veneur.")
                       and not any(P13_GOLD_TAG in t for t in r.tags))
        _check(ov.shed.get("flush", 0) - flush_shed0 == withheld > 0,
               f"{label}: shed_total{{class=flush}} "
               f"{ov.shed.get('flush', 0) - flush_shed0}, withheld "
               f"{withheld}")
        est = {m.name: float(v) for (_s, m), v in zip(
            table.get_meta("set"), res["set_estimate"])}
        gold_sets = [m for m in app if m.name.startswith("p13.gold.s")]
        _check(shift > 0 and len(gold_sets) == 2 and all(
            m.value == est[m.name] * (1 << shift) for m in gold_sets),
            f"{label}: degraded set estimates lack the 2^{shift} correction")
        out["critical"] = dict(withheld_rows=withheld, set_shift=shift,
                               published_rows=len(app))
        # recovery: /readyz 200 again once the controller steps down
        _force_state(srv, 0.0, HEALTHY, label)
        _check(health() == 200, f"{label}: /readyz not 200 after recovery")
        # quarantine: the runaway tenant's explosion, then exactly K rows
        _inject_rings(srv, gen.tag_explosion(P13_EXPLODE, P13_RUNAWAY))
        ledger = gen.ledger()
        ledger["blue"] += sent_extra["blue"]
        _settle_tenants(srv, ledger, label)
        _check(srv.aggregator.tenant_table()[P13_RUNAWAY]["demoted"],
               f"{label}: {P13_RUNAWAY} not demoted")
        rows0 = dict(srv.tenancy.demoted_rows_snapshot())
        _inject_rings(srv, gen.tag_explosion(P13_EXACT_K, P13_RUNAWAY))
        ledger = gen.ledger()
        ledger["blue"] += sent_extra["blue"]
        _settle_tenants(srv, ledger, label)
        rows1 = dict(srv.tenancy.demoted_rows_snapshot())
        k_rows = rows1.get((P13_RUNAWAY,), 0) - rows0.get((P13_RUNAWAY,), 0)
        _check(k_rows == P13_EXACT_K, f"{label}: {k_rows} post-demotion "
               f"rows counted, want {P13_EXACT_K}")
        _check(all(n == 0 or t == P13_RUNAWAY for (t,), n in rows1.items()),
               f"{label}: a steady tenant was demoted: {rows1}")
        _check(codes["healthz"] == {200},
               f"{label}: /healthz answered {codes['healthz']}")
        # restart: the shutdown checkpoint carries the tenants chunk
        srv.shutdown()
        k1_want += _k1_expected(srv, rsteps)
        adm1, shd1 = _tenant_totals(srv.tenancy)
        rows_b1 = dict(srv.tenancy.demoted_rows_snapshot())
        old, srv = srv, None
        srv, sink, rsteps = _p13a_server(device, tmp, restore_on_start=True)
        probe = _FlushProbe(srv, label)
        _check(srv.aggregator.tenant_table()[P13_RUNAWAY]["demoted"]
               and dict(srv.tenancy.demoted_rows_snapshot()) == rows_b1,
               f"{label}: quarantine did not survive the restart")
        post = gen.steady(P13_POST)
        _inject_rings(srv, post)
        sent2 = {t: n - adm1.get(t, 0) - shd1.get(t, 0)
                 for t, n in gen.ledger().items()}
        sent2["blue"] += sent_extra["blue"]
        _settle_tenants(srv, sent2, label)
        readmitted = None
        for i in range(4):
            probe.flush(srv, f"decay {i}")
            if not srv.aggregator.tenant_table()[P13_RUNAWAY]["demoted"]:
                readmitted = i + 1
                break
        _check(readmitted is not None, f"{label}: decay never readmitted "
               f"{P13_RUNAWAY}")
        srv.shutdown()
        k1_want += _k1_expected(srv, rsteps)
        adm2, shd2 = _tenant_totals(srv.tenancy)
        ledger = gen.ledger()
        ledger["blue"] += sent_extra["blue"]
        _check(all(n == adm1.get(t, 0) + shd1.get(t, 0) + adm2.get(t, 0)
                   + shd2.get(t, 0) for t, n in ledger.items()),
               f"{label}: sent != admitted + shed across the restart")
        launches = {"fused_ingest": cuda_ingest.launches,
                    "digest_quantiles": cuda_digest.launches}
        _check(launches["fused_ingest"] == k1_want,
               f"{label}: K1 {launches['fused_ingest']} launches for "
               f"{k1_want} step rows")
        srv = None
        out.update(
            seed=P13_SEED, datagrams=sum(ledger.values()),
            inject_s=inject_s, sent=ledger,
            admitted={t: adm1.get(t, 0) + adm2.get(t, 0) for t in ledger},
            shed={t: shd1.get(t, 0) + shd2.get(t, 0) for t in ledger},
            readmitted_after_flushes=readmitted,
            demoted_rows={t: n for (t,), n in rows_b1.items()},
            launches=launches,
            healthz=sorted(codes["healthz"]),
            ring_steps=rsteps[0], transitions=len(old._overload.transitions))
        return out
    finally:
        if srv is not None:
            srv.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)


def _p13b_mix(names: int) -> dict:
    """Config 6's mix at `names` live names: 60% counters, 25% gauges,
    10% timers, 5% sets, and the counters' first capacity (~1/8 of
    them, a power of two)."""
    n_c, n_g, n_t = int(names * 0.60), int(names * 0.25), int(names * 0.10)
    mix = dict(counter=n_c, gauge=n_g, timer=n_t,
               set=names - n_c - n_g - n_t)
    mix["cap_c0"] = 1 << max(12, (n_c // 8).bit_length())
    return mix


def _p13b_payloads(mix: dict) -> dict:
    """Config 6's payloads by kind, 200 lines each."""
    fmt = {"counter": b"c%d:1|c", "gauge": b"g%d:0.5|g",
           "timer": b"t%d:3.25|ms", "set": b"s%d:u%d|s"}
    out = {}
    for kind, f in fmt.items():
        lines = [f % ((i, i) if kind == "set" else i)
                 for i in range(mix[kind])]
        out[kind] = [b"\n".join(lines[k:k + 200])
                     for k in range(0, len(lines), 200)]
    return out


_P13B_NAME = {"counter": "c", "gauge": "g", "timer": "t", "set": "s"}


def _p13b_app(rows: dict) -> dict:
    """The flush rows of the phase's own names (c<i>, g<i>, t<i>, s<i>),
    not the server's self-telemetry."""
    return {k: v for k, v in rows.items()
            if k[1][:1] == _P13B_NAME[k[0]] and k[1][1:].isdigit()}


def _p13b_server(device, mix: dict, ckpt: str, **kw):
    from veneur_tpu_torch.server.server import Server
    from veneur_tpu_torch.sinks.blackhole import BlackholeMetricSink
    srv = Server(_server_config(
        profile_capture_enabled=False, statsd_listen_addresses=[],
        http_address="", table_grow_enabled=True,
        table_max_capacity=max(1 << 24, 4 * mix["counter"]),
        tpu_counter_capacity=mix["cap_c0"],
        # the static kinds carry config 6's headroom: the 85% high-water
        # mark never grows them
        tpu_gauge_capacity=int(mix["gauge"] * 1.25) + 64,
        tpu_set_capacity=int(mix["set"] * 1.25) + 64,
        tpu_histo_capacity=int(mix["timer"] * 1.25) + 64,
        tpu_status_capacity=64, tpu_batch_counter=1 << 16,
        tpu_batch_gauge=1 << 15, tpu_batch_set=1 << 14,
        tpu_batch_histo=1 << 14, tpu_compact_every=8, checkpoint_dir=ckpt,
        checkpoint_interval_flushes=100_000, checkpoint_on_shutdown=True,
        **kw), metric_sinks=[BlackholeMetricSink()], device=device)
    srv.start()
    return srv


def _feed_queue(srv, payloads, label: str) -> None:
    base = _lines_seen(srv.aggregator)
    for p in payloads:
        srv.packet_queue.put(p)
    n = 200 * len(payloads)
    _wait_for(lambda: _lines_seen(srv.aggregator) - base >= n,
              f"{label}: {n} lines not parsed", 300.0, 0.002)


def _rows_by_key(res, table) -> dict:
    """{(kind, name, joined tags): value} of a flush: counters, gauges,
    set estimates and each timer's quantiles."""
    out = {}
    for kind, key in (("counter", "counter"), ("gauge", "gauge"),
                      ("set", "set_estimate")):
        for (_s, m), v in zip(table.get_meta(kind), res[key]):
            out[(kind, m.name, m.joined_tags or "")] = float(v)
    for (_s, m), qs in zip(table.get_meta("histogram"),
                           res["histo_quantiles"]):
        out[("timer", m.name, m.joined_tags or "")] = tuple(
            float(q) for q in qs)
    return out


def _table_keys(table) -> int:
    return sum(len(table.get_meta(k))
               for k in ("counter", "gauge", "set", "histogram"))


def growth_path(device, names: int = 1_000_000) -> dict:
    """Phase 13b: key-table growth, BASELINE config 6 at scale 0.1 (see
    the module docstring)."""
    import shutil
    import tempfile
    from veneur_tpu_torch.ops import cuda_digest, cuda_ingest

    label = "phase 13b"
    mix = _p13b_mix(names)
    t0 = time.perf_counter()
    by_kind = _p13b_payloads(mix)
    payloads = [p for kind in ("counter", "gauge", "timer", "set")
                for p in by_kind[kind]]
    counters = by_kind["counter"]
    out = dict(mix=mix, payloads_s=time.perf_counter() - t0)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_p13b_")
    cuda_ingest.launches = cuda_digest.launches = 0
    srv = _p13b_server(device, mix, tmp)
    k1_want = 0
    try:
        probe = _FlushProbe(srv, label)
        cap = srv.aggregator.spec.counter_capacity
        _check(cap == mix["cap_c0"], f"{label}: capacity {cap}")
        # the cardinality march: each step feeds a prefix sized against
        # the current capacity, then flushes; the manager doubles the
        # counter table at that swap. Only the first step overshoots the
        # slots, so every drop is one of its over-capacity attempts.
        attempts, overshoot, t_march = 0, None, time.perf_counter()
        pauses, pause_keys = [], []
        while cap * 0.85 < mix["counter"] + 64:
            if overshoot is None:
                k = min(int(cap * 1.10), mix["counter"]) // 200
                overshoot = max(0, k * 200 - cap)
            else:
                k = min(int(cap * 0.97), mix["counter"]) // 200
            k = min(k, len(counters))
            _feed_queue(srv, counters[:k], label)
            attempts += k * 200
            res, table = probe.flush(srv, f"march at {cap}")
            c = {key[1]: v for key, v in _p13b_app(_rows_by_key(
                res, table)).items() if key[0] == "counter"}
            # every counter that was not dropped flushes its exact sum
            _check(len(c) == min(k * 200, cap)
                   and all(v == 1.0 for v in c.values()),
                   f"{label}: the interval at capacity {cap} flushed "
                   f"{len(c)} counters, not all exact")
            newcap = srv.aggregator.spec.counter_capacity
            if newcap == cap:
                break
            pauses.append(srv.tables.last_grow_swap_ns / 1e6)
            pause_keys.append(_table_keys(table))
            cap = newcap
        _check(cap * 0.85 >= mix["counter"] + 64,
               f"{label}: the march stalled at capacity {cap}")
        dropped = srv.aggregator.dropped_capacity
        _check(dropped == overshoot, f"{label}: {dropped} counters dropped, "
               f"{overshoot} over-capacity attempts")
        march_s = time.perf_counter() - t_march
        grows = dict(srv.metrics.get("veneur.table.grows_total").samples())
        caps = dict(srv.metrics.get("veneur.table.capacity").samples())
        _check(grows.get(("counter",), 0) >= 1
               and caps.get(("counter",)) == cap,
               f"{label}: telemetry grows {grows}, capacity {caps}")
        # one pass over the whole population at the grown capacity
        before = _phase_sums(srv)
        t1 = time.perf_counter()
        _feed_queue(srv, payloads, label)
        feed_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        res, table = probe.flush(srv, "full population")
        flush_ms = (time.perf_counter() - t1) * 1e3
        drain_ms = (_phase_sums(srv).get("ingest_drain", 0.0)
                    - before.get("ingest_drain", 0.0)) / 1e6
        drain_keys = _table_keys(table)
        app = _p13b_app(_rows_by_key(res, table))
        n_app = {kind: sum(1 for k in app if k[0] == kind)
                 for kind in ("counter", "gauge", "timer", "set")}
        _check(n_app == {k: mix[k] for k in n_app},
               f"{label}: the full flush holds {n_app}")
        _check(all(app[("counter", f"c{i}", "")] == 1.0
                   for i in range(mix["counter"]))
               and all(app[("gauge", f"g{i}", "")] == 0.5
                       for i in range(mix["gauge"]))
               and all(v == (3.25,) * len(PERCENTILES)
                       for k, v in app.items() if k[0] == "timer")
               and all(abs(v - 1.0) < 0.05 for k, v in app.items()
                       if k[0] == "set"),
               f"{label}: the full flush's values are not exact")
        _check(srv.aggregator.dropped_capacity == dropped,
               f"{label}: the grown tables dropped keys")
        # the tail, left unflushed for the shutdown checkpoint: ~4% of the
        # population, each kind's first names (a restore's host staging
        # costs ~0.07 ms a key)
        tail = [p for kind, frac in (("counter", 24), ("gauge", 48),
                                     ("timer", 20), ("set", 20))
                for p in by_kind[kind][:max(1, len(by_kind[kind]) // frac)]]
        _feed_queue(srv, tail, label)
        probe.wrap(srv)
        n_calls = len(probe.calls)
        srv.shutdown()
        _check(len(probe.calls) == n_calls + 1,
               f"{label}: shutdown made no tail flush")
        tail_rows = _rows_by_key(*probe.calls[-1])
        k1_want += srv.aggregator.steps_total
        total = attempts + 200 * (len(payloads) + len(tail))
        srv = None
        # the restart adopts the grown capacities before the fold
        t1 = time.perf_counter()
        srv = _p13b_server(device, mix, tmp, restore_on_start=True)
        restore_s = time.perf_counter() - t1
        _check(srv.aggregator.spec.counter_capacity == cap
               and srv.tables.grows_snapshot()
               and srv.aggregator.steps_total >= 1,
               f"{label}: the restart did not adopt capacity {cap}")
        restore_steps = srv.aggregator.steps_total
        probe = _FlushProbe(srv, label)
        got = _rows_by_key(*probe.flush(srv, "restored"))
        got = {k: v for k, v in got.items() if k in tail_rows}
        _check(sorted(got) == sorted(tail_rows),
               f"{label}: the restored flush holds {len(got)} of the "
               f"tail's {len(tail_rows)} keys")
        gap = 0.0
        for k, want in tail_rows.items():
            if k[0] == "timer":
                gap = max(gap, max(abs(a - b) / max(abs(b), 1e-9)
                                   for a, b in zip(got[k], want)))
            else:
                _check(got[k] == want, f"{label}: restored {k} {got[k]} "
                       f"!= {want}")
        srv.shutdown()
        k1_want += srv.aggregator.steps_total
        srv = None
        launches = {"fused_ingest": cuda_ingest.launches,
                    "digest_quantiles": cuda_digest.launches}
        _check(launches["fused_ingest"] == k1_want,
               f"{label}: K1 {launches['fused_ingest']} launches for "
               f"{k1_want} steps")
        frac = dropped / total
        _check(frac < 0.01, f"{label}: drop fraction {frac:.5f}")
        out.update(
            counter_capacity=[mix["cap_c0"], cap],
            grows={lv[0]: n for lv, n in grows.items()},
            attempts=total, dropped=dropped, drop_fraction=frac,
            grow_pause_ms=pauses, grow_swap_keys=pause_keys,
            plain_swap_ingest_drain_ms=drain_ms, plain_swap_keys=drain_keys,
            # a swap's ingest_drain is mostly the finalize of its
            # interval's keys: per key, a grow swap against a plain one
            grow_swap_us_per_key=[1e3 * p / max(k, 1)
                                  for p, k in zip(pauses, pause_keys)],
            plain_swap_us_per_key=1e3 * drain_ms / max(drain_keys, 1),
            march_s=march_s, feed_s=feed_s,
            feed_lines_per_s=200 * len(payloads) / feed_s,
            full_flush_ms=flush_ms, tail_keys=len(tail_rows),
            restore_s=restore_s, restore_steps=restore_steps,
            restored_quantile_gap=gap, launches=launches)
        return out
    finally:
        if srv is not None:
            srv.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)


def _offsets_case(device, clock_hz, spec, label) -> dict:
    """K1 on a table whose rows x width pass 2^31 (C-8): the main path's
    batch with its set and histogram slots mirrored to the table's top
    rows (the Zipf-hot ones last), through the kernel on one state and
    the plain version on a copy of it on the card, every leaf
    byte-compared; timed as phase 3 times K1."""
    import torch
    from veneur_tpu_torch.aggregation.host import BatchSpec
    from veneur_tpu_torch.aggregation.state import empty_state
    from veneur_tpu_torch.aggregation.state import DeviceState
    from veneur_tpu_torch.aggregation.step import Batch, build_streams
    from veneur_tpu_torch.ops import cuda_ingest

    bspec = BatchSpec()
    b = _main_path_batch(np.random.default_rng(13), spec, bspec)
    b = b._replace(set_slot=(spec.set_capacity - 1 - b.set_slot
                             ).astype(np.int32),
                   histo_slot=(spec.histo_capacity - 1 - b.histo_slot
                               ).astype(np.int32))
    state = empty_state(spec, device)
    streams = build_streams(state, Batch(*(
        None if a is None else torch.from_numpy(a).to(device) for a in b)),
        spec)
    plain = DeviceState(*(t.clone() for t in state))
    cuda_ingest.fused_ingest(state, streams, spec)
    cuda_ingest.fused_ingest_plain(plain, streams, spec)
    torch.cuda.synchronize()
    for name in cuda_ingest.STATE_LEAVES:
        _check(torch.equal(getattr(state, name), getattr(plain, name)),
               f"{label}: fused_ingest leaf {name} differs from the plain "
               "version")
    del plain
    top = {"set": int(streams.s_slot[streams.s_slot < cuda_ingest.BIG]
                      .max()) * spec.hll_words,
           "histogram": int(streams.h_slot[streams.h_slot < cuda_ingest.BIG]
                            .max()) * spec.total_cells}

    def run():
        cuda_ingest.fused_ingest(state, streams, spec)
    ms = _time_ms(run, device, 50)
    device_ms = _device_ms(run, 50, clock_hz)
    plain_ms = _time_ms(lambda: cuda_ingest.fused_ingest_plain(
        state, streams, spec), device, 1, warmup=1)
    nbytes, ops = _ingest_work(streams, spec)
    bound_ms, bound_by = _bound(nbytes, ops)
    chain = max(_max_run(streams.c_slot), _max_run(streams.h_slot))
    chain_ms = chain * 4 / clock_hz * 1e3
    if chain_ms > bound_ms:
        bound_ms, bound_by = chain_ms, "operations"
    state_gb = sum(t.numel() * t.element_size() for t in state) / 1e9
    del state, streams
    torch.cuda.empty_cache()
    return dict(shape=label, max_abs_err=0.0, ms=ms, device_ms=device_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                state_gb=state_gb, top_offset=top, bytes=nbytes, ops=ops)


def wide_offsets(device, clock_hz) -> list:
    """Phase 13c: K1 at set_capacity 2^20 (p = 14: 12.9 GB of HLL words)
    and at histo_capacity 4,600,000 (x 472 cells: past 2^31), each state
    freed before the next is allocated."""
    import dataclasses
    base = _default_spec()
    return [_offsets_case(device, clock_hz, dataclasses.replace(
                base, set_capacity=1 << 20), "set_capacity 1048576"),
            _offsets_case(device, clock_hz, dataclasses.replace(
                base, histo_capacity=4_600_000), "histo_capacity 4600000")]


# -- phase 14: sharding and the collective global tier --------------------------

# BASELINE config 12 (benchmarks/e2e.py config12) runs a Server at
# tpu_n_shards 4; config 11 (config11_collective_merge) merges config 4's
# 64 locals in a collective tier over a (2, 4) mesh (example.yaml
# collective_* keys). One card holds every tile (ROADMAP C5).
P14_SHARDS = 4
P14_REPLICAS = 2
P14_RINGS = 4


def _kv_rows(res, table) -> dict:
    """A flush's app counters, gauges and set estimates by kind and
    (name, joined tags)."""
    out = {"counter": {}, "gauge": {}, "set": {}}
    for kind, key in (("counter", "counter"), ("gauge", "gauge"),
                      ("set", "set_estimate")):
        for i, (_s, m) in enumerate(table.get_meta(kind)):
            if not m.name.startswith(("veneur.", "ssf.")):
                out[kind][(m.name, m.joined_tags or "")] = float(res[key][i])
    return out


def _set_words_oracle(lines, precision: int) -> dict:
    """{(name, joined tags): packed words} of every set key in `lines`:
    the register max of its members' (register, rho), hashed on the host
    with the engine's hash."""
    from veneur_tpu_torch.ops import hll
    from veneur_tpu_torch.utils.hashing import hll_reg_rho
    dense = {}
    for line in lines:
        head, kind = line.split(b"|", 2)[:2]
        if kind != b"s":
            continue
        name, member = head.split(b":", 1)
        regs = dense.setdefault((name.decode(), ""), np.zeros(
            1 << precision, np.uint8))
        reg, rho = hll_reg_rho(member, precision)
        regs[reg] = max(regs[reg], rho)
    return {k: hll.pack_registers_np(v, precision) for k, v in dense.items()}


def _flush_state(srv, label: str) -> tuple:
    """One manual flush: its wall ms, each flush phase's ms, and the
    flush's detached state with its (res, table)."""
    agg = srv.aggregator
    got = []
    orig = agg.compute_flush

    def capture(state, table, percentiles, **kw):
        out = orig(state, table, percentiles, **kw)
        got.append((state, out[0], out[1]))
        return out
    agg.compute_flush = capture
    before = _phase_sums(srv)
    t0 = time.perf_counter()
    try:
        _check(srv.trigger_flush(timeout=300), f"{label}: flush failed")
    finally:
        del agg.compute_flush
    wall_ms = (time.perf_counter() - t0) * 1e3
    after = _phase_sums(srv)
    _check(len(got) == 1, f"{label}: {len(got)} compute_flush calls")
    return wall_ms, {k: (v - before.get(k, 0.0)) / 1e6
                     for k, v in after.items()}, got[0]


def _inject_wave(srv, grams, label: str) -> None:
    """One wave of `_ring_waves` through its rings' admission
    (rings_inject), retrying a full ring's backpressure (counted
    nothing)."""
    from veneur_tpu_torch.native import INJECT_BACKPRESSURE, INJECT_OK
    eng = srv.aggregator.eng
    for r, g in grams:
        v = eng.rings_inject(r, g)
        while v == INJECT_BACKPRESSURE:
            time.sleep(0.0005)
            v = eng.rings_inject(r, g)
        _check(v == INJECT_OK, f"{label}: inject verdict {v}")


def _inject_waves(srv, waves, label: str) -> None:
    """Every wave back to back while the Server's pipeline thread pumps
    at its own pace: a step then carries whatever the ring workers had
    parsed when a shard's lane filled, so which samples share a step,
    and with them a digest's compaction points, follow thread timing."""
    for grams, _n in waves:
        _inject_wave(srv, grams, label)


def _paced_waves(srv, waves, label: str) -> list:
    """One wave a step, as `_rings_route` paces phase 8: per wave, every
    datagram in, a wait (with a timeout) until the ring workers have
    parsed the wave, then one pipeline visit that drains the rings into
    the shard batchers and runs the step (query_snapshot's discipline),
    held to have stepped exactly once. A wave's rows fill no shard's
    lane, so a step's samples, and so the compaction points, are fixed.
    Returns the lines of each step."""
    from veneur_tpu_torch.query.snapshot import PipelineCall
    agg = srv.aggregator
    base = _lines_seen(agg)
    sent, per_step = 0, []
    for i, (grams, n) in enumerate(waves):
        steps0 = agg.steps_total
        _inject_wave(srv, grams, label)
        sent += n
        t0 = time.perf_counter()
        while _lines_seen(agg) - base < sent:
            _check(time.perf_counter() - t0 < 60,
                   f"{label}: {_lines_seen(agg) - base} of {sent} lines "
                   "parsed after 60 s")
            time.sleep(0.0002)
        call = PipelineCall(lambda a: a.query_snapshot())
        srv.packet_queue.put(call)
        _check(call.wait(60) and call.ok,
               f"{label}: wave {i}'s step visit failed ({call.detail})")
        _check(agg.steps_total - steps0 == 1,
               f"{label}: wave {i} took {agg.steps_total - steps0} steps")
        per_step.append(n)
    return per_step


def _sharded_run(device, lines, label, p9, words, rings=0, paced=True,
                 capture=None, **kw) -> dict:
    """One Server at tpu_n_shards 4 (phase 9's config otherwise): the
    lines through its UDP listener paced as phase 8 paces them, or with
    `rings` through that many reader rings (each name's lines on one
    ring) one wave a step (`paced`) or back to back, then one flush,
    held to phase 4's oracles (the quantiles only where the steps are
    fixed: not on unpaced rings), to phase 9's single-shard flush and to
    the lines' set words. With `capture`, the second K1 launch's state
    and streams and the flush's K2 inputs are kept in it."""
    import torch
    from veneur_tpu_torch.ops import cuda_digest, cuda_ingest
    from veneur_tpu_torch.server.native_aggregator import (
        NativeShardedAggregator)
    from veneur_tpu_torch.server.server import Server
    from veneur_tpu_torch.sinks.debug import DebugMetricSink

    srv = Server(_server_config(profile_capture_enabled=False,
                                tpu_n_shards=P14_SHARDS,
                                reader_rings=max(rings, 1), **kw),
                 metric_sinks=[DebugMetricSink()], device=device)
    srv.start()
    orig_k1 = cuda_ingest.fused_ingest
    try:
        agg = srv.aggregator
        _check(type(agg) is NativeShardedAggregator
               and agg.n_shards == P14_SHARDS,
               f"{label}: backend {type(agg).__name__}")
        if capture is not None:
            seen = [0]

            def k1(state, streams, sp):
                seen[0] += 1
                if seen[0] == 2:
                    capture["k1"] = (type(state)(*(t.clone() for t in state)),
                                     type(streams)(*(t.clone()
                                                     for t in streams)), sp)
                return orig_k1(state, streams, sp)
            cuda_ingest.fused_ingest = k1
        cuda_ingest.launches = cuda_digest.launches = 0
        steps0 = agg.steps_total
        base = _lines_seen(agg)
        t0 = time.perf_counter()
        per_step = []
        if rings and paced:
            per_step = _paced_waves(srv, _ring_waves(lines, rings,
                                                     spread=False), label)
        elif rings:
            _inject_waves(srv, _ring_waves(lines, rings, spread=False),
                          label)
        else:
            _send_paced(srv, _datagrams(lines), label)
        _wait_seen(srv, base, len(lines), label)
        ingest_s = time.perf_counter() - t0
        flush_ms, phases, (state, res, table) = _flush_state(srv, label)
        launches = {"fused_ingest": cuda_ingest.launches,
                    "digest_quantiles": cuda_digest.launches}
        cuda_ingest.fused_ingest = orig_k1
        steps = agg.steps_total - steps0
        _check(launches["fused_ingest"] == steps > 0,
               f"{label}: {launches['fused_ingest']} K1 launches for "
               f"{steps} steps (one a sharded step)")
        _check(launches["digest_quantiles"] == 1,
               f"{label}: {launches['digest_quantiles']} K2 launches in the "
               "merged flush")
        checked = _check_server_flush(res, table, lines, label,
                                      gate_quantiles=paced or not rings)
        rows = _kv_rows(res, table)
        for kind in ("counter", "gauge", "set"):
            _check(rows[kind] == p9[kind], f"{label}: {kind}s differ from "
                   f"phase 9's single-shard flush ({len(rows[kind])} vs "
                   f"{len(p9[kind])} keys)")
        # the set words, from the same detached state again (the timed
        # flush gathered no raw rows), with K2's inputs captured
        with digest_calls() as calls:
            again, tb, raw = agg.compute_flush(state, table, PERCENTILES,
                                               want_raw=True)
        _check(all(np.asarray(again[k]).tobytes()
                   == np.asarray(res[k]).tobytes() for k in res),
               f"{label}: the repeated flush differs")
        got_words = {(m.name, m.joined_tags or ""): raw["hll"][i]
                     for i, (_s, m) in enumerate(tb.get_meta("set"))
                     if not m.name.startswith(("veneur.", "ssf."))}
        _check(sorted(got_words) == sorted(words) and all(
            np.array_equal(got_words[k], w) for k, w in words.items()),
            f"{label}: set words differ from the lines' register max")
        if capture is not None:
            capture["k2"] = calls[0]
        return dict(lines=len(lines), steps=steps, launches=launches,
                    ingest_s=ingest_s, samples_per_s=len(lines) / ingest_s,
                    flush_ms=flush_ms,
                    device_update_ms=phases.get("device_update"),
                    h2d_bytes=agg.h2d_bytes, rings=rings,
                    paced=bool(rings and paced),
                    lines_per_step=([min(per_step), max(per_step)]
                                    if per_step else None),
                    preshard=agg.preshard, set_keys=len(words),
                    **{k: v for k, v in checked.items()
                       if k.startswith("worst") or k in (
                           "counters", "gauges", "timers", "sets")})
    finally:
        cuda_ingest.fused_ingest = orig_k1
        srv.shutdown()
        torch.cuda.empty_cache()


def sharded_path(device, clock_hz, lines, p9) -> dict:
    """Phase 14a: the Server at tpu_n_shards 4 on phase 4's lines, split
    emit, pre-sharded emit, and four reader rings; then K1 at the
    flattened S = 4 step's shape and K2 at the merged flush's, each held
    to its plain version and timed."""
    spec = _default_spec()
    words = _set_words_oracle(lines, spec.hll_precision)
    cap = {}
    out = {"split": _sharded_run(device, lines, "sharded split", p9, words,
                                 capture=cap)}
    out["preshard"] = _sharded_run(device, lines, "sharded preshard", p9,
                                   words, native_preshard_enabled=True)
    out["rings"] = _sharded_run(device, lines, "sharded rings", p9, words,
                                rings=P14_RINGS,
                                native_preshard_enabled=True)
    # the same waves back to back: counters, gauges and set words still
    # held, the quantiles' errors only printed (ROADMAP C-10)
    out["rings_unpaced"] = _sharded_run(
        device, lines, "sharded rings unpaced", p9, words, rings=P14_RINGS,
        paced=False, native_preshard_enabled=True)
    state, streams, fspec = cap.pop("k1")
    out["k1"] = _ingest_streams_case(state, streams, fspec, device,
                                     clock_hz, plain_reps=1)
    out["k1"]["shape"] = dict(tiles=P14_SHARDS, rows=fspec.counter_capacity,
                              lanes=[int(t.numel()) for t in
                                     (streams.c_slot, streams.g_slot,
                                      streams.s_slot, streams.h_slot)])
    del state, streams
    out["k2"] = _digest_case(device, cap.pop("k2"), clock_hz)
    out["launches"] = {k: sum(r["launches"][k] for r in (
        out["split"], out["preshard"], out["rings"], out["rings_unpaced"]))
        for k in ("fused_ingest", "digest_quantiles")}
    return out


def collective_path(device, p11) -> dict:
    """Phase 14b: phase 11's 64 locals and its 65th absorbed co-located
    into a CollectiveGlobalTier at (R, S) = (2, 4) on the card: the 65th
    local's lines through a local Server with collective_attach (its
    flush hands the interval over through _absorb_colocated), the 64
    others' flush outputs through absorb_raw, as their Servers' absorbs
    make it; then the global's flush, held to phase 11's gRPC-imported
    flush of the same 65 locals."""
    import torch
    from veneur_tpu_torch.collective.tier import CollectiveGlobalTier
    from veneur_tpu_torch.ops import cuda_digest, cuda_ingest, hll
    from veneur_tpu_torch.server.server import Server
    from veneur_tpu_torch.sinks.debug import DebugMetricSink

    shape = p11["shape"]
    gsrv = Server(_server_config(
        profile_capture_enabled=False, collective_enabled=True,
        collective_group="phase14", tpu_n_shards=P14_SHARDS,
        tpu_n_replicas=P14_REPLICAS), metric_sinks=[DebugMetricSink()],
        device=device)
    lsrv = Server(_server_config(profile_capture_enabled=False,
                                collective_attach="phase14"),
                  metric_sinks=[DebugMetricSink()], device=device)
    gsrv.start()
    lsrv.start()
    out = {}
    try:
        tier = gsrv.aggregator
        _check(isinstance(tier, CollectiveGlobalTier)
               and (tier.n_replicas, tier.n_shards)
               == (P14_REPLICAS, P14_SHARDS),
               f"collective: backend {type(tier).__name__}")
        cuda_ingest.launches = cuda_digest.launches = 0
        tsteps0, lsteps0 = tier.steps_total, lsrv.aggregator.steps_total
        # the last local (phase 11's JSONMetric one, seed 1000 + n - 1)
        # comes through the local Server
        locs = p11["locals"]
        last = _global_interval(1000 + len(locs) - 1,
                                shape)[0].split(b"\n")
        base = _lines_seen(lsrv.aggregator)
        _send_paced(lsrv, _datagrams(last), "collective local")
        _wait_seen(lsrv, base, len(last), "collective local")
        _check(lsrv.trigger_flush(timeout=300), "collective: local flush")
        _check(lsrv._c_coll_rows.value() > 0
               and lsrv._c_coll_errors.value() == 0,
               "collective: the local Server's flush was not absorbed")
        t0 = time.perf_counter()
        rows_in = 0
        for raw, table in locs[:-1]:
            rows_in += tier.absorb_raw(raw, table,
                                       participant=tier.assign_participant())
        with tier._absorb_lock:      # the staged tail's routed step too
            tier._emit_absorbed()
        torch.cuda.synchronize()
        absorb_s = time.perf_counter() - t0
        flush_ms, phases, (res, table, raw) = _flush_raw(
            gsrv, "collective", want_raw=True)
        launches = {"fused_ingest": cuda_ingest.launches,
                    "digest_quantiles": cuda_digest.launches}
        steps = (tier.steps_total - tsteps0
                 + lsrv.aggregator.steps_total - lsteps0)
        _check(launches["fused_ingest"] == steps > 0,
               f"collective: {launches['fused_ingest']} K1 launches for "
               f"{steps} steps")
        _check(launches["digest_quantiles"] == 2,
               f"collective: {launches['digest_quantiles']} K2 launches for "
               "the local's and the tier's flush")
        _check(gsrv.imported_total == 0 and gsrv.import_errors == 0,
               f"collective: {gsrv.imported_total} wire imports")
        rows = _global_rows(res, table, raw)
        want = p11["rows"]
        _check(rows["histogram"] == want["histogram"],
               "collective: histogram count/min/max differ from phase 11's "
               "gRPC flush")
        # counters exact, the byte counters past 2^24 too
        _check(sorted(rows["counter"]) == sorted(want["counter"]),
               "collective: counter keys differ")
        bad = [k for k, v in want["counter"].items()
               if rows["counter"][k] != v]
        _check(not bad, f"collective: {len(bad)} counters differ from "
               f"phase 11's gRPC flush, e.g. {bad[:3]}")
        # sets: the tier's words are the register max of the 65 locals'
        # flushed words, its estimates those words' within rtol 1e-6
        # (ROADMAP C-watch 7); set keys are phase 11's
        prec = tier.spec.hll_precision
        regs = {}
        for lraw, tb in locs:
            for i, (_s, m) in enumerate(tb.get_meta("set")):
                if m.name.startswith(("veneur.", "ssf.")):
                    continue
                key = (m.name, ",".join(m.tags))
                r = hll.unpack_registers_np(np.asarray(lraw["hll"][i]), prec)
                regs[key] = r if key not in regs else np.maximum(regs[key],
                                                                 r)
        keys = sorted(regs)
        _check(sorted(rows["words"]) == keys == sorted(want["set"]),
               "collective: set keys differ from the locals' and phase 11's")
        words = np.stack([rows["words"][k] for k in keys])
        _check(np.array_equal(words, hll.pack_registers_np(
            np.stack([regs[k] for k in keys]), prec)),
            "collective: set words differ from the locals' register max")
        est = hll.estimate_packed_rows(torch.from_numpy(words).to(device),
                                       precision=prec).cpu().numpy()
        set_gap = max(abs(rows["set"][k] - float(e)) / max(float(e), 1e-30)
                      for k, e in zip(keys, est))
        _check(set_gap <= 1e-6, f"collective: a set estimate is "
               f"{set_gap:.3g} from its words' estimate")
        words_as_phase11 = sum(np.array_equal(rows["words"][k],
                                              want["words"][k]) for k in keys)
        written = {}
        for raw, tb in p11["locals"]:
            for i, (_s, m) in enumerate(tb.get_meta("gauge")):
                written.setdefault((m.name, ",".join(m.tags)), set()).add(
                    float(raw["gauge"][i]))
        _check(sorted(rows["gauge"]) == sorted(want["gauge"]) and all(
            v in written[k] for k, v in rows["gauge"].items()),
            "collective: a gauge is no local's write")
        err = _timer_errors(rows, p11["samples"], shape["timers"])
        worst11 = p11["timer_error"]["p99"]["max"]
        _check(err["p99"]["max"] <= max(0.01, 1.5 * worst11),
               f"collective: worst p99 error {err['p99']['max']:.4f}, "
               f"phase 11's gRPC flush {worst11:.4f}")
        timer = tier._phase_timer
        sums = {lv[0]: st.sum / 1e6 for lv, st in timer.snapshot(qs=())}
        counts = {lv[0]: st.count for lv, st in timer.snapshot(qs=())}
        out.update(locals=len(locs), rows_absorbed=rows_in + int(
            lsrv._c_coll_rows.value()), absorb_s=absorb_s,
            absorbed_rows_per_s=rows_in / absorb_s, flush_ms=flush_ms,
            device_update_ms=phases.get("device_update"),
            phase_ms=sums, phase_counts=counts, steps=steps,
            launches=launches, imported_total=gsrv.imported_total,
            counters=len(rows["counter"]), counters_past_2_24=sum(
                v >= (1 << 24) for v in want["counter"].values()),
            sets=len(keys), set_estimate_worst_rel=set_gap,
            set_words_as_phase11=words_as_phase11,
            gauges=len(rows["gauge"]),
            histograms=len(rows["histogram"]), timer_error=err,
            timer_error_phase11=p11["timer_error"])
        return out
    finally:
        lsrv.shutdown()
        gsrv.shutdown()
        torch.cuda.empty_cache()


# -- phase 15: live resharding and tag frequency --------------------------------

# BASELINE config 12 (benchmarks/e2e.py config12_elastic_resize) at scale 1:
# three seeded segments of its storm through a Server at tpu_n_shards 4,
# resized 4 -> 8 -> 2, at config 12's capacities. The Server takes the
# storm through its packet queue (the post-socket path) on the default
# config's native ingest.
P15_SHARDS = 4
P15_PLAN = (8, 2)
P15_INTERVAL_S = 10.0    # config 12's flush cadence: the transition bound
P15_CAPS = dict(tpu_counter_capacity=1 << 13, tpu_gauge_capacity=256,
                tpu_set_capacity=1 << 10, tpu_histo_capacity=1 << 10,
                tpu_batch_counter=1 << 13, tpu_batch_histo=1 << 13,
                tpu_batch_set=1 << 12)
# How far the JAX package's elastic pass moves the storm's timer
# percentiles from its static pass on the fixed steps of
# `storm_fixed_run` (relative, the largest over p50/p90/p99): a moved
# digest folds back through fold_snapshot, which re-adds its cells as
# weighted samples (ROADMAP C-5). tests/test_torch_reshard_storm.py
# measures it on these lines and steps with the JAX Server and holds the
# port's CPU gap to it within the digest tolerance (2e-5).
P15_JAX_TIMER_GAP = 2.6908e-4
DIGEST_TOL = 2e-5
# BASELINE config 5 (config5_span_firehose) at scale 1
P15B_SPANS = 100_000
P15B_HOT = 20
P15B_TAIL = 1_000_000


def storm_segments(scale: float = 1.0) -> list:
    """Config 12's storm: per segment (its 100-line payloads, its line
    count, its timer samples): counters el.c<i> of one sample each, the
    gauge el.g, timer el.t over uniform integers, 40 members into each
    set el.s<k>."""
    n_counter = max(64, int(2048 * scale))
    n_timer = max(32, int(512 * scale))
    n_set = max(8, int(64 * scale))
    out = []
    for seg in range(3):
        rng = np.random.default_rng(1200 + seg)
        lines = [b"el.c%d:%d|c" % (i, 10007 + 3 * i + seg)
                 for i in range(n_counter)]
        lines.append(b"el.g:%d|g" % (10 + seg))
        vals = rng.integers(1, 100000, n_timer)
        lines += [b"el.t:%d|ms" % v for v in vals]
        lines += [b"el.s%d:m%d-%d|s" % (k, seg, j) for k in range(n_set)
                  for j in range(40)]
        out.append(([b"\n".join(lines[i:i + 100])
                     for i in range(0, len(lines), 100)], len(lines), vals))
    return out


def storm_config(**kw) -> dict:
    """Phase 15a's Server config as keyword arguments (both packages'
    Config take them): config 12's capacities at tpu_n_shards 4, native
    ingest, overload admission, resharding, no listener."""
    base = dict(interval="3600s", hostname="", metric_max_length=4096,
                percentiles=PERCENTILES, aggregates=AGGREGATES,
                statsd_listen_addresses=[], ssf_listen_addresses=[],
                http_address="", native_ingest=True,
                tpu_n_shards=P15_SHARDS, overload_enabled=True,
                reshard_enabled=True, **P15_CAPS)
    base.update(kw)
    return base


class _DropSpans:
    """A trace backend that drops every span: a Server's own telemetry
    re-enters its pipeline at points thread timing sets."""

    def send(self, span) -> None:
        pass

    def close(self) -> None:
        pass


def storm_fixed_run(srv, segments, elastic: bool,
                    timeout_s: float = 300.0) -> list:
    """The storm on fixed steps (any package's started Server, its own
    telemetry dropped): each segment whole into the packet queue and
    parsed, then (elastic) the resize to P15_PLAN[segment] for the first
    two, before the next segment. The drain visit queues behind every
    payload put before it, so the swap cuts the stream at a segment's
    end. Returns the resizes' summaries; the caller flushes."""
    summaries = []
    for s, (payloads, n, _vals) in enumerate(segments):
        want = srv.aggregator.processed + n
        for p in payloads:
            srv.packet_queue.put(p)
        t0 = time.perf_counter()
        while srv.aggregator.processed < want:
            if time.perf_counter() - t0 > timeout_s:
                raise TimeoutError(f"segment {s}: {srv.aggregator.processed}"
                                   f" of {want} lines processed")
            time.sleep(0.002)
        if elastic and s < len(P15_PLAN):
            summaries.append(srv.trigger_reshard(P15_PLAN[s],
                                                 timeout=timeout_s))
    return summaries


def timer_gap(got: dict, want: dict) -> float:
    """The largest relative gap between two flushes' timer percentiles."""
    return max(abs(got[k] - want[k]) / max(abs(want[k]), 1.0)
               for k in want)


def _storm_rows(srv, label: str) -> dict:
    """One manual flush of a phase 15a Server: its app counters, gauges,
    set words and el.t percentiles by key, the flush's wall ms."""
    from veneur_tpu_torch.ops import cuda_digest
    wall_ms, phases, (state, res, table) = _flush_state(srv, label)
    rows = _kv_rows(res, table)
    # the set words, from the same detached state again; this repeat is
    # no launch of the path's
    k2 = cuda_digest.launches
    _again, tb, raw = srv.aggregator.compute_flush(state, table, PERCENTILES,
                                                   want_raw=True)
    cuda_digest.launches = k2
    rows["words"] = {(m.name, m.joined_tags or ""): raw["hll"][i]
                     for i, (_s, m) in enumerate(tb.get_meta("set"))
                     if not m.name.startswith(("veneur.", "ssf."))}
    hq = np.asarray(res["histo_quantiles"])
    rows["timer"] = {}
    for i, (_s, m) in enumerate(table.get_meta("histogram")):
        if m.name == "el.t":
            for q, v in zip(PERCENTILES, hq[i]):
                rows["timer"][q] = float(v)
    rows["flush_ms"] = wall_ms
    rows["device_update_ms"] = phases.get("device_update")
    return rows


def _same_storm_rows(got, want, label) -> None:
    """Counters, gauges and set words byte-exact against the static pass."""
    for kind in ("counter", "gauge"):
        _check(got[kind] == want[kind],
               f"{label}: {kind}s differ from the static pass "
               f"({len(got[kind])} vs {len(want[kind])} keys)")
    _check(sorted(got["words"]) == sorted(want["words"]) and all(
        np.array_equal(got["words"][k], w)
        for k, w in want["words"].items()),
        f"{label}: set words differ from the static pass")


def _storm_oracle_gate(rows, segments, label) -> dict:
    """el.t's p50 within 6% and p99 within 1% of the midpoint quantiles
    of its 1,536 samples (phase 4's gate)."""
    vals = np.concatenate([v for _p, _n, v in segments]).astype(np.float64)
    err = {}
    for q, tol in ((0.5, 0.06), (0.99, 0.01)):
        exact = float(midpoint_quantile_rows(vals, q))
        err[q] = abs(rows["timer"][q] - exact) / exact
        _check(err[q] < tol, f"{label}: p{int(q * 100)} off by "
               f"{err[q]:.4f} (limit {tol})")
    return {"worst_p50_rel": err[0.5], "worst_p99_rel": err[0.99]}


def _storm_server(device, **kw):
    from veneur_tpu_torch.config import Config
    from veneur_tpu_torch.server.server import Server
    from veneur_tpu_torch.sinks.debug import DebugMetricSink
    srv = Server(Config(**storm_config(**kw)),
                 metric_sinks=[DebugMetricSink()], device=device)
    srv.start()
    # the controller stays HEALTHY: the passes must admit the same lines
    srv._overload._signals = lambda: {}
    return srv


def _query_poller(srv, probes: list, stop) -> None:
    """POST /query for el.c0 every 20 ms until `stop`: each probe's code,
    its stale_bounded mark, and whether a transfer was active before it
    was sent and after it was answered (reshard_active, the flag the
    query engine reads), with the coordinator's move count before and
    after (a whole move between the two reads shows there)."""
    import urllib.error
    import urllib.request
    body = json.dumps({"name": "el.c0"}).encode()
    url = f"http://127.0.0.1:{srv.http_port}/query"
    moves = (lambda: srv.reshard.moves_total + srv.reshard.failed_total) \
        if srv.reshard is not None else (lambda: 0)
    while not stop.is_set():
        before, m0 = srv.reshard_active, moves()
        req = urllib.request.Request(url, data=body, headers={
            "Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                code = r.status
                marked = bool(json.loads(r.read()).get("stale_bounded"))
        except urllib.error.HTTPError as e:
            code, marked = e.code, False
        except OSError:
            code, marked = -1, False
        probes.append((code, marked, before, srv.reshard_active,
                       moves() != m0))
        stop.wait(0.02)


def _storm_fire_run(device, segments, label, elastic, crash=False) -> dict:
    """Config 12's pass under fire: each segment's payloads put by a
    feeder thread while (elastic) the resize runs, queries probed
    throughout; then one flush. Holds: sent == admitted + shed, every
    probe 200, a probe answered with a transfer active before and after
    marked stale_bounded and one with none unmarked; with `crash`, the
    second resize's first fold faults (RESHARD_FOLD) and replays."""
    import threading
    from veneur_tpu_torch.reliability.faults import FAULTS, RESHARD_FOLD
    srv = _storm_server(device, http_address="127.0.0.1:0",
                        query_enabled=True, reshard_enabled=elastic)
    probes, stop = [], threading.Event()
    poller = threading.Thread(target=_query_poller,
                              args=(srv, probes, stop))
    try:
        ov = srv._overload
        adm0, shed0 = dict(ov.admitted), dict(ov.shed)
        sent, summaries = 0, []
        poller.start()
        t0 = time.perf_counter()
        for s, (payloads, _n, _v) in enumerate(segments):
            feeder = threading.Thread(
                target=lambda pl=payloads: [srv.packet_queue.put(p)
                                            for p in pl])
            feeder.start()
            sent += len(payloads)
            try:
                if elastic and s < len(P15_PLAN):
                    if crash and s == 1:
                        FAULTS.arm(RESHARD_FOLD, error=True, times=1)
                    summaries.append(srv.trigger_reshard(P15_PLAN[s],
                                                         timeout=120))
            finally:
                feeder.join()
                FAULTS.reset()
        rows = _storm_rows(srv, label)     # queued behind every payload
        ingest_s = time.perf_counter() - t0
        stop.set()
        poller.join()
        adm = sum(ov.admitted.values()) - sum(adm0.values())
        shed = {k: v - shed0.get(k, 0) for k, v in ov.shed.items()}
        shed.pop("flush", None)
        shed = sum(shed.values())
        _check(adm + shed == sent, f"{label}: {sent} packets sent, "
               f"{adm} admitted + {shed} shed")
        codes = [p[0] for p in probes]
        _check(probes and all(c == 200 for c in codes),
               f"{label}: query codes {sorted(set(codes))} "
               f"over {len(codes)} probes")
        during = [p for p in probes if p[2] and p[3] and not p[4]]
        outside = [p for p in probes if not (p[2] or p[3] or p[4])]
        _check(all(p[1] for p in during) and not any(p[1] for p in outside),
               f"{label}: stale_bounded marks do not follow the transfer "
               f"({sum(p[1] for p in during)} of {len(during)} during, "
               f"{sum(p[1] for p in outside)} of {len(outside)} outside)")
        for sm in summaries:
            _check(not sm["failed"], f"{label}: {sm['plan']} failed: "
                   f"{sm['detail']}")
        rows.update(summaries=summaries, sent=sent, admitted=adm, shed=shed,
                    probes=len(probes), stale_marked=sum(p[1]
                                                         for p in probes),
                    ingest_s=ingest_s,
                    steps=srv.aggregator.steps_total,
                    n_shards=getattr(srv.aggregator, "n_shards", 1))
        return rows
    finally:
        stop.set()
        if poller.is_alive():
            poller.join()
        FAULTS.reset()
        srv.shutdown()


def _storm_fixed(device, segments, label, elastic, capture=None) -> dict:
    """`storm_fixed_run` on the card; with `capture`, the first K1
    launch at each new shard count (a migration fold's step) is kept
    in it by shard count."""
    from veneur_tpu_torch.ops import cuda_ingest
    srv = _storm_server(device)
    srv.trace_client.backend = _DropSpans()
    orig_k1 = cuda_ingest.fused_ingest
    if capture is not None:
        def k1(state, streams, sp):
            n = getattr(srv.aggregator, "n_shards", 1)
            if n != P15_SHARDS and n not in capture:
                capture[n] = (type(state)(*(t.clone() for t in state)),
                              type(streams)(*(t.clone() for t in streams)),
                              sp)
            return orig_k1(state, streams, sp)
        cuda_ingest.fused_ingest = k1
    try:
        t0 = time.perf_counter()
        summaries = storm_fixed_run(srv, segments, elastic)
        rows = _storm_rows(srv, label)
        rows.update(summaries=summaries, ingest_s=time.perf_counter() - t0,
                    steps=srv.aggregator.steps_total,
                    n_shards=getattr(srv.aggregator, "n_shards", 1))
        return rows
    finally:
        cuda_ingest.fused_ingest = orig_k1
        srv.shutdown()


def reshard_path(device, clock_hz) -> dict:
    """Phase 15a: config 12's storm, three passes under fire (static
    4-shard, elastic 4 -> 8 -> 2 with a fold crash, elastic steady) and
    two on fixed steps (static and elastic); then K1 at the S = 8 and
    S = 2 steps of the migration folds, held to its plain version and
    timed."""
    import torch
    from veneur_tpu_torch.ops import cuda_digest, cuda_ingest
    segments = storm_segments()
    cuda_ingest.launches = cuda_digest.launches = 0
    out = {"static": _storm_fire_run(device, segments, "15a static",
                                     elastic=False)}
    out["crash"] = _storm_fire_run(device, segments, "15a crash",
                                   elastic=True, crash=True)
    out["steady"] = _storm_fire_run(device, segments, "15a steady",
                                    elastic=True)
    cap = {}
    out["fixed_static"] = _storm_fixed(device, segments, "15a fixed static",
                                       elastic=False)
    out["fixed_elastic"] = _storm_fixed(device, segments,
                                        "15a fixed elastic", elastic=True,
                                        capture=cap)
    launches = {"fused_ingest": cuda_ingest.launches,
                "digest_quantiles": cuda_digest.launches}
    runs = [out[k] for k in ("static", "crash", "steady", "fixed_static",
                             "fixed_elastic")]
    steps = sum(r["steps"] for r in runs)
    _check(launches["fused_ingest"] == steps > 0,
           f"15a: {launches['fused_ingest']} K1 launches for {steps} steps")
    # one flush a pass, and the mover's flush of each drained interval
    moves = sum(len(r["summaries"]) for r in runs)
    _check(launches["digest_quantiles"] >= len(runs) + moves,
           f"15a: {launches['digest_quantiles']} K2 launches for "
           f"{len(runs)} flushes and {moves} drained intervals")
    static = out["static"]
    for name in ("crash", "steady", "fixed_static", "fixed_elastic"):
        _same_storm_rows(out[name], static, f"15a {name}")
    for name in ("crash", "steady", "fixed_elastic"):
        r = out[name]
        _check([s["plan"] for s in r["summaries"]] == ["4->8", "8->2"]
               and r["n_shards"] == P15_PLAN[-1]
               and all(s["rows_moved"] > 0 for s in r["summaries"]),
               f"15a {name}: resizes {r['summaries']}")
    crash = out["crash"]["summaries"][1]
    _check(crash["replays"] >= 1 and crash["dup_suppressed"] >= 1,
           f"15a crash: the faulted transfer replayed {crash['replays']} "
           f"times, {crash['dup_suppressed']} duplicates suppressed")
    _check(out["crash"]["stale_marked"] + out["steady"]["stale_marked"] > 0,
           "15a: no probe answered during a transfer")
    transitions = [s["duration_ns"] / 1e9
                   for s in out["steady"]["summaries"]]
    _check(max(transitions) <= P15_INTERVAL_S,
           f"15a steady: transitions {transitions} s past the "
           f"{P15_INTERVAL_S} s interval")
    # timers: on fixed steps against the exact oracle, and the elastic
    # pass against the static one at the JAX package's measured gap
    for name in ("fixed_static", "fixed_elastic"):
        out[name].update(_storm_oracle_gate(out[name], segments,
                                            f"15a {name}"))
    gap = timer_gap(out["fixed_elastic"]["timer"],
                    out["fixed_static"]["timer"])
    _check(gap <= P15_JAX_TIMER_GAP + DIGEST_TOL,
           f"15a fixed elastic: timer percentiles {gap:.3g} from the static "
           f"pass, the JAX package's gap {P15_JAX_TIMER_GAP:.3g} "
           f"(+ {DIGEST_TOL})")
    out["timer_gap"] = {"fixed": gap, **{
        name: timer_gap(out[name]["timer"], static["timer"])
        for name in ("crash", "steady")}}
    out["launches"] = launches
    out["transition_s"] = transitions
    for n in sorted(cap):
        state, streams, fspec = cap[n]
        r = _ingest_streams_case(state, streams, fspec, device, clock_hz,
                                 plain_reps=1)
        r["shape"] = dict(tiles=n, rows=fspec.counter_capacity,
                          lanes=[int(t.numel()) for t in (
                              streams.c_slot, streams.g_slot,
                              streams.s_slot, streams.h_slot)])
        out[f"k1_s{n}"] = r
    _check(sorted(cap) == sorted(P15_PLAN),
           f"15a: K1 captured at shard counts {sorted(cap)}")
    del cap
    torch.cuda.empty_cache()
    return out


def _firehose():
    """Config 5's spans, serialized: half carry one of P15B_HOT hot tag
    values, half a tail value of P15B_TAIL; with every member's true
    count."""
    from veneur_tpu_torch.proto import ssf_pb2
    rng = np.random.default_rng(5)
    payloads, true = [], {}
    for i in range(P15B_SPANS):
        span = ssf_pb2.SSFSpan(version=0, trace_id=i + 1, id=i + 2,
                               service="svc", name="op",
                               start_timestamp=1000 + i,
                               end_timestamp=2000 + i)
        if i % 2 == 0:
            v = f"hot{int(rng.integers(0, P15B_HOT))}"
        else:
            v = f"tail{int(rng.integers(0, P15B_TAIL))}"
        span.tags["customer"] = v
        key = f"customer:{v}"
        true[key] = true.get(key, 0) + 1
        payloads.append(span.SerializeToString())
    return payloads, true


def tagfreq_path(device) -> dict:
    """Phase 15b: config 5's span firehose through a Server's span path
    with tag_frequency_enabled (top K 20, batches of 8,192 members); the
    sketch's rows reported through the self-telemetry loop-back into the
    metric pipeline."""
    import functools
    from veneur_tpu_torch.config import Config
    from veneur_tpu_torch.protocol.wire import parse_ssf
    from veneur_tpu_torch.server.server import Server
    from veneur_tpu_torch.sinks.debug import DebugMetricSink
    payloads, true = _firehose()
    sink = DebugMetricSink()
    srv = Server(_server_config(
        profile_capture_enabled=False, statsd_listen_addresses=[],
        tag_frequency_enabled=True, tag_frequency_top_k=P15B_HOT,
        tag_frequency_batch_size=8192, span_channel_capacity=8192),
        metric_sinks=[sink], device=device)
    srv.start()
    try:
        tf = srv.tag_frequency
        _check(tf.hh.counters.device.type == "cuda",
               f"15b: the sketch is on {tf.hh.counters.device}")
        update_ms, flushed = [], []
        upd, fl = tf.hh.update, tf.flush

        def timed(members, weights=None):
            t0 = time.perf_counter()
            upd(members, weights)         # ends in a copy back: synced
            update_ms.append((time.perf_counter() - t0) * 1e3)

        def flush():
            out = fl()
            flushed.append(out)
            return out
        tf.hh.update, tf.flush = timed, flush
        handle = functools.partial(srv.span_pipeline.handle_span,
                                   ssf_format="packet")
        base = tf.spans_seen
        t0 = time.perf_counter()
        for p in payloads:
            while not handle(parse_ssf(p)):      # a full channel: retry
                time.sleep(0.001)
        _wait_for(lambda: tf.spans_seen - base >= P15B_SPANS,
                  "15b: spans through the sketch", 300.0)
        ingest_s = time.perf_counter() - t0
        _check(srv.trigger_flush(timeout=300), "15b: flush failed")
        _wait_for(lambda: flushed, "15b: the span sinks' flush", 60.0)
        got = {s.tags["tag"]: s.value for s in flushed[0]
               if s.name == "veneur.span.tag_frequency"}
        total = [s.value for s in flushed[0]
                 if s.name == "veneur.span.tag_frequency.total"]
        hot = {f"customer:hot{i}" for i in range(P15B_HOT)}
        true_top = set(sorted(true, key=lambda k: -true[k])[:P15B_HOT])
        _check(true_top == hot, "15b: the true top 20 is not the hot tags")
        recall = len(true_top & set(got)) / len(true_top)
        _check(recall == 1.0, f"15b: top-20 recall {recall}")
        # the sketch's mass N: the firehose's members, and any the Server's
        # own telemetry spans carried
        n = float(sum(true.values()))
        _check(len(total) == 1 and total[0] >= n,
               f"15b: total {total}, {n} members sent")
        eps_n = math.e / tf.hh.width * total[0]
        over = {k: v - true[k] for k, v in got.items()}
        _check(min(over.values()) >= 0, "15b: an estimate below the true "
               f"count ({min(over.values())})")
        _check(max(over.values()) <= eps_n, f"15b: overestimate "
               f"{max(over.values())} past eps*N {eps_n:.2f}")

        def reached():
            srv.trigger_flush(timeout=60)
            return any(m.name == "veneur.span.tag_frequency"
                       for m in sink.flushed)
        _wait_for(reached, "15b: the sink's rows in the metric pipeline",
                  60.0, poll_s=0.1)
        rows = sum(m.name == "veneur.span.tag_frequency"
                   for m in sink.flushed)
        return dict(spans=P15B_SPANS, members=int(n),
                    sketch_total=total[0],
                    spans_per_s=P15B_SPANS / ingest_s, ingest_s=ingest_s,
                    top20_recall=recall, overestimate_max=max(over.values()),
                    overestimate_mean=float(np.mean(list(over.values()))),
                    eps_n=eps_n, batches=len(update_ms),
                    update_ms_median=float(np.median(update_ms)),
                    update_ms_max=max(update_ms), sink_rows=rows,
                    width=tf.hh.width, depth=tf.hh.depth)
    finally:
        srv.shutdown()


# -- phase 16: every sink, the S3 archive and the operator CLIs ---------------

P16_SPANS = 10_000
P16_REPLAY, P16_REPLAY_NAMES = 50_000, 10_000
# a power of two: Datadog's and the archive's counter rates (value over
# the interval) undo exactly
P16_INTERVAL_S = 4096
P16_EVENTS = 3
P16_SPAN_WAVE = 1_000


class _P16Fake:
    """A local HTTP endpoint that keeps every POST: (path, the headers a
    sink sets, the body inflated, the bytes on the wire)."""

    def __init__(self):
        import http.server
        import threading
        import zlib
        got = self.captured = []
        lock = threading.Lock()

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(n)
                body = (zlib.decompress(raw) if self.headers.get(
                    "Content-Encoding") == "deflate" else raw)
                with lock:
                    got.append((self.path, self.headers.get("X-SF-Token"),
                                body, n))
                self.send_response(200)
                self.send_header("Content-Length", "2")
                self.end_headers()
                self.wfile.write(b"ok")

        self.httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                                     Handler)
        self.httpd.daemon_threads = True
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()

    def posts(self, prefix):
        return [c for c in list(self.captured) if c[0].startswith(prefix)]

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


class _P16Udp:
    """A UDP socket (the X-Ray daemon's) that keeps every datagram, and
    the span id of each segment that is in `keep`."""

    def __init__(self, keep):
        import socket
        import threading
        self.keep = keep
        self.got, self.ids = [], []
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 1 << 24)
        self.sock.bind(("127.0.0.1", 0))
        self.sock.settimeout(0.2)
        self.addr = "127.0.0.1:%d" % self.sock.getsockname()[1]
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _run(self):
        import socket
        while not self._stop.is_set():
            try:
                gram = self.sock.recv(65536)
            except socket.timeout:
                continue
            except OSError:
                return
            self.got.append(gram)
            i = int(json.loads(gram.split(b"\n", 1)[1])["id"], 16)
            if i in self.keep:
                self.ids.append(i)

    def close(self):
        self._stop.set()
        self._t.join(timeout=5)
        self.sock.close()


class _P16Recorder:
    """The injected Kafka producer, LightStep client and S3 client: each
    keeps what it is handed; the S3 client fails its first put."""

    def __init__(self):
        self.produced, self.reports, self.puts = [], [], []
        self.put_calls = 0

    def produce(self, topic, key, value):
        self.produced.append((topic, key, value))

    def lightstep_client(self):
        rec = self

        class Client:
            def report(self, d):
                rec.reports.append(d)
        return Client()

    def put_object(self, Bucket, Key, Body):
        self.put_calls += 1
        if self.put_calls == 1:
            raise RuntimeError("the archive is down")
        self.puts.append((Bucket, Key, Body))


_P16_GRPC_CHILD = r"""
import json, sys
from veneur_tpu_torch.sinks.grpsink import serve_span_sink
lo, hi = int(sys.argv[1]), int(sys.argv[2])
ids = {"falconer": [], "grpc_span_sink": []}

def keep(got):
    return lambda span: lo <= span.id <= hi and got.append(span.id)
servers = [serve_span_sink(keep(ids[k])) for k in ids]
print(json.dumps([port for _s, port in servers]), flush=True)
for line in sys.stdin:
    if line.strip() != "count":
        break
    print(json.dumps({k: len(v) for k, v in ids.items()}), flush=True)
print(json.dumps(ids), flush=True)
for server, _port in servers:
    server.stop(grace=1)
"""


class _P16GrpcFakes:
    """The Falconer and gRPC span sinks' collectors: two serve_span_sink
    servers in a child process, keeping the span ids in [lo, hi]. The two
    sinks make one unary call a span; answered here, the calls would take
    a share of the Server's interpreter lock (scripts/grpc_span_rate.py
    compares the two)."""

    def __init__(self, lo, hi):
        self.proc = subprocess.Popen(
            [sys.executable, "-c", _P16_GRPC_CHILD, str(lo), str(hi)],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        line = self.proc.stdout.readline()
        _check(line, "16: the gRPC collectors did not start")
        self.falconer_port, self.grpc_port = json.loads(line)

    def counts(self) -> dict:
        self.proc.stdin.write("count\n")
        self.proc.stdin.flush()
        return json.loads(self.proc.stdout.readline())

    def ids(self) -> dict:
        self.proc.stdin.write("ids\n")
        self.proc.stdin.flush()
        out = json.loads(self.proc.stdout.readline())
        self.proc.wait(timeout=30)
        return out

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def _p16_metrics_proxy(target_url):
    """GET / forwards to the Server's GET /metrics and keeps each
    exposition it hands on: the two that veneur-prometheus polls."""
    import http.server
    import threading
    import urllib.request
    seen = []

    class Handler(http.server.BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            with urllib.request.urlopen(target_url, timeout=30) as r:
                body = r.read()
            seen.append(body.decode())
            self.send_response(200)
            self.send_header("Content-Type", "text/plain")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, seen


def _p16_spans():
    """The first P16_SPANS spans of phase 15b's firehose (config 5)."""
    payloads, _true = _firehose()
    return payloads[:P16_SPANS]


def _sink_ns(srv) -> dict:
    """veneur.sink.flush_duration_ns sums by sink, in ns."""
    t = srv.metrics.get("veneur.sink.flush_duration_ns")
    return {lv[0]: st.sum for lv, st in t.snapshot(qs=())}


def _dd_series(posts):
    return [s for _p, _t, body, _n in posts
            for s in json.loads(body)["series"]]


def _sfx_points(posts):
    return [(token, kind, p) for _p, token, body, _n in posts
            for kind, pts in json.loads(body).items() for p in pts]


def _canon(items):
    return sorted(json.dumps(x, sort_keys=True) for x in items)


def _dd_oracle(series, lines, label) -> dict:
    """Phase 4's oracles on the Datadog series: each counter (its rate
    times the interval) the exact f64 sum, each gauge the last write,
    p50 and p99 within 6% and 1% of the midpoint quantiles for keys of
    >= 24 samples, set estimates within 5% for >= 100 members."""
    counters, gauges, timers, sets = _oracle(lines)
    by = {(s["metric"], ",".join(sorted(s["tags"]))): s for s in series}
    for k, v in counters.items():
        s = by.get(k)
        _check(s is not None and s["type"] == "rate"
               and s["interval"] == P16_INTERVAL_S
               and s["points"][0][1] * P16_INTERVAL_S == v,
               f"{label}: counter {k} is {s} against {v}")
    for k, v in gauges.items():
        s = by.get(k)
        _check(s is not None and s["type"] == "gauge"
               and s["points"][0][1] == v, f"{label}: gauge {k}")
    worst = {0.5: 0.0, 0.99: 0.0}
    by_len = {}
    for k, vals in timers.items():
        if len(vals) >= 24:
            by_len.setdefault(len(vals), []).append(k)
    checked = 0
    for n, keys in by_len.items():
        vals = np.asarray([timers[k] for k in keys])
        for q, suffix, tol in ((0.5, "50percentile", 0.06),
                               (0.99, "99percentile", 0.01)):
            exact = midpoint_quantile_rows(vals, q)
            got = np.asarray([by[(f"{k[0]}.{suffix}", k[1])]["points"][0][1]
                              for k in keys])
            rel = np.abs(got - exact) / np.maximum(np.abs(exact), 1e-9)
            worst[q] = max(worst[q], float(rel.max()))
            _check((rel < tol).all(), f"{label}: p{int(q * 100)} off by "
                   f"{rel.max():.4f} on a {n}-sample key")
        checked += len(keys)
    _check(checked >= 8, f"{label}: quantile oracle checked {checked} keys")
    big = [k for k, m in sets.items() if len(m) >= 100]
    rel = [abs(by[k]["points"][0][1] - len(sets[k])) / len(sets[k])
           for k in big]
    _check(len(big) >= 8 and max(rel) < 0.05,
           f"{label}: HLL off by {max(rel):.4f}")
    return dict(counters=len(counters), gauges=len(gauges),
                timers=len(timers), sets=len(sets),
                quantile_keys_checked=checked, worst_p50_rel=worst[0.5],
                worst_p99_rel=worst[0.99], worst_hll_rel=max(rel))


def _kafka_rows(ims):
    """The Kafka metric sink's messages for these InterMetrics, by its
    documented schema (Go's json.Marshal of InterMetric)."""
    types = {"counter": 0, "gauge": 1, "status": 2}
    return [dict(Name=m.name, Timestamp=m.timestamp, Value=m.value,
                 Tags=list(m.tags), Type=types.get(m.type, 1),
                 Message=m.message, HostName=m.hostname,
                 Sinks=({s: {} for s in sorted(m.sinks)}
                        if m.sinks is not None else None))
            for m in ims if m.is_acceptable_to("kafka")
            and math.isfinite(m.value)]


def _csv_rows(body: bytes):
    """TSV rows without the partition column (the date of the encode)."""
    rows = [r.rsplit("\t", 1) for r in body.decode().splitlines()]
    _check(len({p for _r, p in rows}) <= 1 and all(
        len(p) == 8 and p.isdigit() for _r, p in rows),
        "16: the archive's partition column")
    return [r for r, _p in rows]


def _run_cli(args, timeout_s=120.0):
    """`python -m <args>` from the repository root; -> (rc, out, err,
    seconds)."""
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", *args],
                         capture_output=True, text=True, timeout=timeout_s)
    return res.returncode, res.stdout, res.stderr, time.perf_counter() - t0


def sinks_path(device, lines) -> dict:
    """Phase 16: one Server that new_from_config builds on `device` at the
    default widths, flushing into every sink, the S3 archive and the
    CLIs, each against a local fake in this process."""
    import functools
    import gzip
    import os
    import shutil
    import socket
    import tempfile
    import threading
    from veneur_tpu_torch.cli import emit as emit_cli
    from veneur_tpu_torch.ops import cuda_digest, cuda_history, cuda_ingest
    from veneur_tpu_torch.plugins.s3 import S3Plugin
    from veneur_tpu_torch.protocol.wire import parse_ssf
    from veneur_tpu_torch.proto import ssf_pb2
    from veneur_tpu_torch.server.factory import new_from_config
    from veneur_tpu_torch.sinks.datadog import DatadogMetricSink
    from veneur_tpu_torch.sinks.kafka import KafkaMetricSink, KafkaSpanSink
    from veneur_tpu_torch.sinks.lightstep import LightStepSpanSink
    from veneur_tpu_torch.sinks.localfile import encode_intermetrics_csv
    from veneur_tpu_torch.sinks.signalfx import SignalFxMetricSink

    t_phase = time.perf_counter()
    payloads = _p16_spans()
    ids = {ssf_pb2.SSFSpan.FromString(p).id for p in payloads}
    _check(len(ids) == P16_SPANS and ids == set(range(min(ids),
                                                      max(ids) + 1)),
           "16: the span ids are not one range of distinct ids")
    dd, ddt, sfx, hec = _P16Fake(), _P16Fake(), _P16Fake(), _P16Fake()
    dd2, sfx2 = _P16Fake(), _P16Fake()      # the object paths' replays
    xray = _P16Udp(ids)
    grpc_fakes = _P16GrpcFakes(min(ids), max(ids))
    rec = _P16Recorder()
    stage = tempfile.mkdtemp(prefix="p16-stage-")
    hostname = "p16-host"
    cfg = _server_config(
        interval=f"{P16_INTERVAL_S}s", hostname=hostname, tpu_n_shards=1,
        profile_capture_enabled=False,
        statsd_listen_addresses=["udp://127.0.0.1:0", "tcp://127.0.0.1:0"],
        ssf_listen_addresses=["udp://127.0.0.1:0"],
        num_span_workers=8, span_channel_capacity=8192,
        debug_flushed_metrics=True,
        datadog_api_key="p16", datadog_api_hostname=dd.url,
        datadog_trace_api_address=ddt.url,
        signalfx_api_key="p16", signalfx_endpoint_base=sfx.url,
        splunk_hec_address=hec.url, splunk_hec_token="p16",
        splunk_span_sample_rate=1,
        # read_config's defaults for the two (a Config built in code
        # starts them at 0)
        datadog_flush_max_per_body=25000, splunk_hec_batch_size=100,
        xray_address=xray.addr, xray_sample_percentage=100,
        falconer_address=f"127.0.0.1:{grpc_fakes.falconer_port}",
        grpsink_address=f"127.0.0.1:{grpc_fakes.grpc_port}")
    # no Kafka client, lightstep or boto3 on the card's machine: the three
    # go in injected, with recording clients
    kafka_m = KafkaMetricSink("p16-broker:9092", metric_topic="metrics",
                              check_topic="checks", producer=rec.produce)
    kafka_s = KafkaSpanSink("p16-broker:9092", span_topic="spans",
                            producer=rec.produce)
    ls = LightStepSpanSink("p16", num_clients=2,
                           client_factory=rec.lightstep_client)
    s3 = S3Plugin("p16-bucket", "us-east-1", hostname,
                  interval_s=P16_INTERVAL_S, client=rec,
                  staging_dir=stage)
    s3_ms, s3_flush = [], s3.flush

    def timed_s3(metrics):
        # the archive's time a flush: its CSV encode, gzip and put
        t0 = time.perf_counter()
        try:
            return s3_flush(metrics)
        finally:
            s3_ms.append((time.perf_counter() - t0) * 1e3)
    s3.flush = timed_s3
    srv = new_from_config(cfg, extra_metric_sinks=[kafka_m],
                          extra_span_sinks=[kafka_s, ls],
                          extra_plugins=[s3], device=device)
    out = {}
    try:
        names = sorted(s.name for s in srv.metric_sinks)
        span_names = sorted(s.name for s in srv.span_sinks)
        _check(names == ["datadog", "debug", "kafka", "signalfx"]
               and span_names == ["datadog", "falconer", "grpc_span_sink",
                                  "kafka", "lightstep", "splunk", "xray"],
               f"16: sinks {names}, span sinks {span_names}")
        debug = next(s for s in srv.metric_sinks if s.name == "debug")
        srv.start()
        agg = srv.aggregator
        udp_addr = srv.local_addr(0)
        tcp_addr = srv.local_addr(1)
        _check(srv._sockets[1].type == socket.SOCK_STREAM,
               "16: the second statsd socket is not the TCP listener")
        cuda_ingest.launches = cuda_digest.launches = 0
        cuda_history.launches = 0
        steps0 = agg.steps_total
        flushes = 0

        # interval 0: a few lines; the archive's first put fails
        base = _lines_seen(agg)
        warm = [b"p16.warm:1|c", b"p16.flush.mark:1|ms"]
        _send_paced(srv, [b"\n".join(warm)], "16 warm-up")
        _wait_seen(srv, base, len(warm), "16 warm-up")
        debug.flushed.clear()
        _flush_interval(srv, "16 warm-up")
        flushes += 1
        staged = os.listdir(stage)
        _check(rec.put_calls == 1 and not rec.puts and len(staged) == 1
               and staged[0].endswith(".tsv.gz"),
               f"16: after a failed put the staging dir holds {staged}")
        with open(os.path.join(stage, staged[0]), "rb") as f:
            kept = gzip.decompress(f.read())
        _check(_csv_rows(kept) == _csv_rows(encode_intermetrics_csv(
            debug.flushed, hostname, P16_INTERVAL_S)),
            "16: the staged object of the failed put is not the flush's")

        # interval 1: phase 8's datagrams, emit -replay over TCP, events,
        # service checks and, on a thread of their own, the firehose's
        # spans, each put on the span channel as phase 15b puts them
        for f in (dd, ddt, sfx, hec):
            f.captured.clear()
        rec.produced.clear()
        debug.flushed.clear()
        handle = functools.partial(srv.span_pipeline.handle_span,
                                   ssf_format="packet")
        feed = {}

        def feed_spans():
            try:
                for w in range(0, P16_SPANS, P16_SPAN_WAVE):
                    for p in payloads[w:w + P16_SPAN_WAVE]:
                        while not handle(parse_ssf(p)):    # a full channel
                            time.sleep(0.001)
                    # a wave at a time: the X-Ray socket never holds more
                    # than a wave's datagrams
                    done = min(w + P16_SPAN_WAVE, P16_SPANS)
                    t1 = time.perf_counter()
                    while len(xray.ids) < done:
                        if time.perf_counter() - t1 > 120:
                            feed["error"] = (
                                f"span wave {w // P16_SPAN_WAVE}: X-Ray "
                                f"{len(xray.ids)} of {done} after 120 s")
                            return
                        time.sleep(0.01)
            except BaseException as e:       # reported on the main thread
                feed["error"] = repr(e)
        feeder = threading.Thread(target=feed_spans, daemon=True)
        # phase 8's datagrams alone first: their samples/s is phase 9's
        datagrams = _datagrams(lines)
        base = _lines_seen(agg)
        t1 = time.perf_counter()
        send_s = _send_paced(srv, datagrams, "16")
        _wait_seen(srv, base, len(lines), "16")
        ingest_s = time.perf_counter() - t1
        # then emit -replay over TCP (a process of its own) while the
        # spans go in on their thread: the two share no socket
        t2 = time.perf_counter()
        replay = subprocess.Popen(
            [sys.executable, "-m", "veneur_tpu_torch.cli.emit", "-hostport",
             "tcp://%s:%d" % tcp_addr, "-replay", str(P16_REPLAY),
             "-replay_names", str(P16_REPLAY_NAMES)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        feeder.start()
        try:
            for i in range(P16_EVENTS):
                rc = emit_cli.main([
                    "-hostport", "udp://%s:%d" % udp_addr,
                    "-e_title", f"p16 deploy {i}", "-e_text",
                    f"build {i} out", "-e_alert_type", "info",
                    "-e_event_tags", "via:emit", "-sc_name",
                    f"p16.check.{i}", "-sc_status", str(i % 3),
                    "-sc_msg", f"check {i}"])
                _check(rc == 0, f"16: emit event {i} exited {rc}")
            r_out, r_err = replay.communicate(timeout=300)
        finally:
            if replay.poll() is None:
                replay.kill()
                replay.wait()
        _check(replay.returncode == 0, f"16: emit -replay: {r_err[-2000:]}")
        emit_rate = float(r_out.split("(")[1].split("/s")[0])
        _wait_seen(srv, base, len(lines) + P16_REPLAY, "16 replay")
        replay_s = time.perf_counter() - t2
        _wait_for(lambda: len(srv.event_samples) >= P16_EVENTS,
                  "16: the events", 30.0)
        feeder.join(timeout=600)
        _check(not feeder.is_alive() and "error" not in feed,
               f"16: the span feed: {feed.get('error', 'still running')}")
        # the gRPC sinks ingest last: the feed ends when they have it all
        _wait_for(lambda: min(grpc_fakes.counts().values()) >= P16_SPANS,
                  "16: the gRPC collectors' spans", 300.0, poll_s=0.05)
        spans_s = time.perf_counter() - t2

        def ours(seq):
            return sum(1 for i in seq if i in ids)
        # Kafka and LightStep ingest before X-Ray and the gRPC sinks
        # (injected span sinks come first), so this holds at once
        _wait_for(lambda: ours(ssf_pb2.SSFSpan.FromString(v).id
                               for t, _k, v in list(rec.produced)
                               if t == "spans") >= P16_SPANS
                  and ours(d["span_id"] for d in list(rec.reports))
                  >= P16_SPANS, "16: Kafka's and LightStep's spans", 60.0,
                  poll_s=0.05)

        # each span sink's ingest time over the interval, summed over the
        # span workers
        span_ingest_ms = {k: v / 1e6 for k, v in
                          srv.span_pipeline._ingest_ns.items()}
        sink0 = _sink_ns(srv)
        flush_ms, phases, _rt = _flush_interval(srv, "16")
        flushes += 1
        sink_ms = {k: (v - sink0.get(k, 0.0)) / 1e6
                   for k, v in _sink_ns(srv).items()}
        ims = list(debug.flushed)
        _check(len(ims) > 0, "16: the debug sink got nothing")

        # gate 2: Datadog and SignalFx, the card's frame against the
        # object path over the debug sink's InterMetrics
        series = _dd_series(dd.posts("/api/v1/series"))
        checks = [c for _p, _t, b, _n in dd.posts("/api/v1/check_run")
                  for c in json.loads(b)]
        want_dd = DatadogMetricSink(api_key="p16", hostname=hostname,
                                    api_url=dd2.url,
                                    interval_s=P16_INTERVAL_S)
        want_dd.flush(ims)
        _check(_canon(series) == _canon(_dd_series(dd2.posts(
            "/api/v1/series"))), "16: Datadog's columnar series differ "
            "from its object path's")
        _check(_canon(checks) == _canon(
            c for _p, _t, b, _n in dd2.posts("/api/v1/check_run")
            for c in json.loads(b)), "16: Datadog's service checks differ")
        max_body = max(len(json.loads(b)["series"]) for _p, _t, b, _n in
                       dd.posts("/api/v1/series"))
        _check(max_body <= cfg.datadog_flush_max_per_body,
               f"16: a Datadog body of {max_body} series")
        oracle = _dd_oracle(series, lines, "16 datadog")
        replay_sum = sum(s["points"][0][1] * P16_INTERVAL_S for s in series
                         if s["metric"].startswith("replay.counter."))
        _check(replay_sum == P16_REPLAY,
               f"16: replay counters sum to {replay_sum}")
        points = _sfx_points(sfx.posts("/v2/datapoint"))
        want_sfx = SignalFxMetricSink(api_key="p16", endpoint=sfx2.url,
                                      hostname=hostname)
        want_sfx.flush(ims)
        _check(_canon(points) == _canon(_sfx_points(sfx2.posts(
            "/v2/datapoint"))), "16: SignalFx's columnar datapoints "
            "differ from its object path's")
        _check(len(points) == len(ims), f"16: {len(points)} SignalFx "
               f"points for {len(ims)} rows")

        # gate 3: Kafka one for one, the archive's object
        msgs = [(t, k, json.loads(v)) for t, k, v in rec.produced
                if t in ("metrics", "checks")]
        want_k = _kafka_rows(ims)
        _check([m for _t, _k, m in msgs] == want_k
               and all(k == m["Name"].encode() and t == (
                   "checks" if m["Type"] == 2 else "metrics")
                   for t, k, m in msgs),
               f"16: {len(msgs)} Kafka messages for {len(want_k)} rows")
        _check(rec.put_calls == 2 and len(rec.puts) == 1,
               f"16: {rec.put_calls} puts")
        bucket, key, body = rec.puts[0]
        _check(bucket == "p16-bucket" and key.startswith(hostname + "/")
               and key.endswith(".tsv.gz"), f"16: S3 key {key}")
        _check(_csv_rows(gzip.decompress(body)) == _csv_rows(
            encode_intermetrics_csv(ims, hostname, P16_INTERVAL_S)),
            "16: the S3 object is not the flush's rows")
        _check(os.listdir(stage) == staged, "16: the acked put's staged "
               f"copy was kept: {os.listdir(stage)}")

        # gate 5: events and service checks
        intake = [e for _p, _t, b, _n in dd.posts("/intake")
                  for e in json.loads(b)["events"]]
        sfx_events = [e for _p, _t, b, _n in sfx.posts("/v2/event")
                      for e in json.loads(b)]
        titles = {f"p16 deploy {i}" for i in range(P16_EVENTS)}
        _check({e["title"] for e in intake} == titles
               and {e["eventType"] for e in sfx_events} == titles,
               f"16: events at /intake {len(intake)}, SignalFx "
               f"{len(sfx_events)}")
        _check({c["check"] for c in checks} >= {
            f"p16.check.{i}" for i in range(P16_EVENTS)},
            f"16: service checks {sorted(c['check'] for c in checks)}")

        # gate 4: every span id exactly once at every span sink
        _wait_for(lambda: ours(int(json.loads(b)["event"]["id"], 16)
                               for _p, _t, body, _n in hec.posts("/")
                               for b in body.splitlines()) >= P16_SPANS
                  and ddt.posts("/v0.3/traces"), "16: Splunk and Datadog "
                  "traces", 60.0)
        got_ids = {
            "datadog": [s["span_id"] for _p, _t, b, _n in
                        ddt.posts("/v0.3/traces")
                        for trace in json.loads(b) for s in trace],
            "splunk": [int(json.loads(b)["event"]["id"], 16)
                       for _p, _t, body, _n in hec.posts("/")
                       for b in body.splitlines()],
            "xray": list(xray.ids),
            **grpc_fakes.ids(),
            "kafka": [ssf_pb2.SSFSpan.FromString(v).id
                      for t, _k, v in rec.produced if t == "spans"],
            "lightstep": [d["span_id"] for d in rec.reports]}
        splunk = next(s for s in srv.span_sinks if s.name == "splunk")
        _check(splunk.dropped == 0, f"16: Splunk dropped {splunk.dropped}")
        for name, seen in got_ids.items():
            mine = [i for i in seen if i in ids]
            _check(len(mine) == P16_SPANS and set(mine) == ids,
                   f"16: span sink {name} got {len(mine)} of our spans, "
                   f"{len(set(mine))} distinct")
        nbytes = {
            "datadog": sum(n for _p, _t, _b, n in dd.captured),
            "signalfx": sum(n for _p, _t, _b, n in sfx.captured),
            "kafka": sum(len(v) for t, _k, v in rec.produced
                         if t != "spans"),
            "s3": len(body),
            "datadog_spans": sum(n for _p, _t, _b, n in ddt.captured),
            "splunk": sum(n for _p, _t, _b, n in hec.captured),
            "xray": sum(len(g) for g in xray.got),
            "kafka_spans": sum(len(v) for t, _k, v in rec.produced
                               if t == "spans")}

        # the CLIs: veneur-prometheus polls /metrics twice (through a
        # proxy that keeps both expositions) and sends its statsd back
        proxy, expos = _p16_metrics_proxy(
            f"http://127.0.0.1:{srv.http_port}/metrics")
        debug.flushed.clear()
        base_lines = _lines_seen(agg)
        base = srv.packets_received
        try:
            rc, _o, p_err, prom_s = _run_cli([
                "veneur_tpu_torch.cli.prometheus", "-p",
                f"http://127.0.0.1:{proxy.server_address[1]}/metrics",
                "-h2", "%s:%d" % udp_addr, "-i", "200ms", "-once"])
        finally:
            proxy.shutdown()
            proxy.server_close()
        _check(rc == 0 and len(expos) == 2,
               f"16: veneur-prometheus exited {rc} after {len(expos)} "
               f"polls: {p_err[-2000:]}")
        from veneur_tpu_torch.cli.prometheus import (Translator,
                                                     parse_exposition)
        # what the CLI sent, by its own translator over the expositions
        # it read; the deltas, from the two expositions apart
        tr = Translator()
        first = tr.translate(*parse_exposition(expos[0]))
        sent = tr.translate(*parse_exposition(expos[1]))
        t_prev = {(n, tuple(sorted(lb.items()))): v for n, lb, v in
                  parse_exposition(expos[0])[1]}
        deltas = {}
        types1, samples1 = parse_exposition(expos[1])
        for n, lb, v in samples1:
            base_name = n
            for suffix in ("_bucket", "_sum", "_count"):
                if n.endswith(suffix) and n[:-len(suffix)] in types1:
                    base_name = n[:-len(suffix)]
            kind = types1.get(n) or types1.get(base_name, "untyped")
            prev = t_prev.get((n, tuple(sorted(lb.items()))))
            if (kind in ("counter", "histogram") or kind == "summary"
                    and n.endswith(("_sum", "_count"))) \
                    and prev is not None and v > prev:
                deltas[(n, ",".join(f"{k}:{x}" for k, x in
                                    sorted(lb.items())))] = v - prev
        counts = {}
        for p in sent:
            name, rest = p.decode().split(":", 1)
            value, mtype, *tail = rest.split("|")
            if mtype == "c":
                counts[(name, tail[0][1:] if tail else "")] = value
        _check(counts and counts.keys() == deltas.keys() and all(
            float(v) == float(f"{deltas[k]:g}") for k, v in counts.items()),
            f"16: veneur-prometheus sent {len(counts)} counters for "
            f"{len(deltas)} deltas between its two polls")
        n_sent = len(first) + len(sent)
        _wait_for(lambda: srv.packets_received - base >= n_sent,
                  "16: veneur-prometheus's packets", 30.0)
        mark = [b"p16.flush.mark:2|ms"]
        _send_paced(srv, mark, "16 cli")
        _wait_seen(srv, base_lines, n_sent + len(mark), "16 cli")
        _flush_interval(srv, "16 cli")
        flushes += 1
        got = {(m.name, ",".join(m.tags)): m.value for m in debug.flushed
               if m.type == "counter"}
        wrong = {k: (v, got.get(k)) for k, v in counts.items()
                 if got.get(k) != float(np.float32(float(v)))}
        _check(not wrong, f"16: the next flush's counters differ from the "
               f"deltas sent: {list(wrong.items())[:5]}")
        # the span worker's per-sink flush timer (ns) of interval 1
        span_flush_ms = {
            m.tags[0].split(":", 1)[1]: m.value / 1e6 for m in debug.flushed
            if m.name == "veneur.worker.span.flush_duration_ns.max"
            and m.tags and m.tags[0].startswith("sink:")}

        # the telemetry dump lists each sink's flush duration
        rc, t_out, t_err, tele_s = _run_cli([
            "veneur_tpu_torch.cli.telemetry", "--json",
            f"http://127.0.0.1:{srv.http_port}/metrics"])
        _check(rc == 0, f"16: telemetry exited {rc}: {t_err[-2000:]}")
        dump = json.loads(t_out)
        for name in names:
            _check(any(r["series"].startswith(
                "veneur_sink_flush_duration_ns")
                and f'sink="{name}"' in r["series"] for r in dump),
                f"16: the telemetry dump has no flush duration for {name}")

        launches = {"fused_ingest": cuda_ingest.launches,
                    "digest_quantiles": cuda_digest.launches,
                    "merge_windows": cuda_history.launches}
        steps = agg.steps_total - steps0
        _check(launches["fused_ingest"] == steps > 0,
               f"16: {launches['fused_ingest']} K1 launches for {steps} "
               "steps")
        _check(launches["digest_quantiles"] >= flushes,
               f"16: {launches['digest_quantiles']} K2 launches for "
               f"{flushes} flushes")
        received, dropped = srv.packets_received, srv.packets_dropped
        _check(dropped == 0, f"16: {dropped} datagrams dropped")
        out.update(
            lines=len(lines), replay_lines=P16_REPLAY,
            datagrams=len(datagrams), datagrams_received=received,
            steps=steps, flushes=flushes, launches=launches,
            send_s=send_s, ingest_s=ingest_s,
            samples_per_s=len(lines) / ingest_s, replay_s=replay_s,
            emit_replay_per_s=emit_rate,
            spans=P16_SPANS, spans_s=spans_s,
            spans_per_s=P16_SPANS / spans_s, flush_ms=flush_ms,
            sink_fanout_ms=phases.get("sink_fanout"),
            frame_build_ms=phases.get("frame_build"),
            device_update_ms=phases.get("device_update"),
            s3_flush_ms=s3_ms[1], sink_flush_ms=sink_ms,
            span_sink_flush_ms=span_flush_ms,
            span_sink_ingest_ms=span_ingest_ms, payload_bytes=nbytes,
            rows=len(ims), datadog_series=len(series),
            datadog_bodies=len(dd.posts("/api/v1/series")),
            signalfx_points=len(points), kafka_messages=len(msgs),
            events=len(intake), service_checks=len(checks),
            prometheus_packets=n_sent, prometheus_deltas=len(deltas),
            prometheus_s=prom_s, telemetry_s=tele_s,
            telemetry_series=len(dump), **oracle)
    finally:
        srv.shutdown()
        for f in (dd, ddt, sfx, hec, dd2, sfx2):
            f.close()
        xray.close()
        grpc_fakes.close()
        shutil.rmtree(stage, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# -- phase 17: the port's lint and its sanitized engine ---------------------------

P17_PASSES = 12
# the intake corpora, by test file (read out of the files' source, which
# import the JAX package and so are never imported here)
P17_CORPORA = {
    "tests/test_native.py": ("GOOD_PACKETS", "BAD_PACKETS"),
    "tests/test_intake_fuzz.py": ("MALFORMED_METRIC_CORPUS",
                                  "MALFORMED_EVENT_CORPUS",
                                  "MALFORMED_CHECK_CORPUS"),
}
P17_RUNS = ("feed", "corpus", "udp")


def _intake_corpora() -> list:
    """Every packet of the intake corpora as bytes, each list evaluated
    from its assignment in the test file with no builtins but range."""
    import ast
    out = []
    for rel, names in P17_CORPORA.items():
        with open(rel) as f:
            tree = ast.parse(f.read(), filename=rel)
        found = set()
        for node in tree.body:
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and getattr(node.targets[0], "id", None) in names:
                found.add(node.targets[0].id)
                out += eval(compile(ast.Expression(node.value), rel, "eval"),
                            {"__builtins__": {"range": range}})
        _check(found == set(names), f"phase 17: {rel} lacks "
               f"{sorted(set(names) - found)}")
    return [p if isinstance(p, bytes) else p.encode("utf-8",
                                                    "surrogateescape")
            for p in out]


def _write_grams(path, grams) -> None:
    lens = np.asarray([len(g) for g in grams], np.int64)
    with open(path, "wb") as f:
        f.write(len(grams).to_bytes(8, "little"))
        f.write(lens.tobytes())
        f.write(b"".join(grams))


def _read_grams(path) -> list:
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        lens = np.frombuffer(f.read(8 * n), np.int64)
        blob = f.read()
    offs = np.concatenate([[0], np.cumsum(lens)])
    return [blob[offs[i]:offs[i + 1]] for i in range(n)]


class _ChildEmits:
    """The sanitized child's side of NativeAggregator's packed emits: two
    buffers in turn, each keeping its previous emit's counts, and the
    control word set as `_begin_step` sets it; every emitted buffer is
    appended to `out`."""

    def __init__(self, init, offs, compact_every: int, out):
        self.bufs = [init.copy(), init.copy()]
        self.prev = [np.zeros(4, np.uint32) for _ in range(2)]
        self.idx, self.steps = 0, 0
        self.offs, self.compact_every, self.out = offs, compact_every, out

    def emit(self, eng) -> None:
        buf = self.bufs[self.idx]
        if sum(eng.emit_packed(buf, self.offs, self.prev[self.idx])) == 0:
            return
        self.idx = 1 - self.idx
        self.steps += 1
        buf[0] = 1 if self.steps % self.compact_every == 0 else 0
        self.out.write(buf.tobytes())


def _child_udp(eng, em, grams, n_lines: int) -> dict:
    """Phase 8's udp route on the bare engine: one reader on a loopback
    socket, a sender thread that waits for the reader every 64
    datagrams, and NativeAggregator.pump's loop on this thread."""
    import socket
    import threading
    rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rx.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 1 << 22)
    rx.bind(("127.0.0.1", 0))
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    eng.readers_start([rx.fileno()])
    failed = []

    def send():
        try:
            for i in range(0, len(grams), 64):
                for d in grams[i:i + 64]:
                    tx.sendto(d, rx.getsockname())
                sent, t0 = min(i + 64, len(grams)), time.perf_counter()
                while eng.reader_counters()["datagrams"] < sent:
                    if time.perf_counter() - t0 > 30:
                        raise TimeoutError(f"datagram {sent} not taken")
                    time.sleep(0.0002)
        except BaseException as e:      # reported below
            failed.append(e)
    th = threading.Thread(target=send)
    th.start()
    t0 = time.perf_counter()
    try:
        while True:
            st = eng.stats()
            if st["processed"] + st["parse_errors"] + st["dropped"] \
                    >= n_lines:
                break
            _check(not failed and time.perf_counter() - t0 < 120,
                   f"phase 17 child udp: {st} of {n_lines} lines, {failed}")
            full, _ = eng.pump(20)
            for _ in range(8):
                if not full:
                    break
                em.emit(eng)
                full, _ = eng.pump(0)
            if full:
                em.emit(eng)
            eng.drain_specials()
        counters = eng.reader_counters()
    finally:
        th.join()
        eng.readers_stop()
        rx.close()
        tx.close()
    _check(not failed, f"phase 17 child udp: sender failed: {failed}")
    return counters


def sanitized_child(work: str) -> int:
    """Phase 17's child, under the sanitizer runtimes and with no CUDA
    call (it imports numpy and the engine's binding only): phase 8's
    datagrams by feed, the intake corpora by feed, and phase 8's
    datagrams again over loopback UDP through the readers and pump, each
    into a fresh engine, every packed buffer written to WORK/<run>.bin
    and the engine's counts to WORK/<run>.json."""
    import os
    import types
    from veneur_tpu_torch import native
    t0 = time.perf_counter()
    _check(native.sanitized(), "phase 17 child: VENEUR_NATIVE_SANITIZE unset")
    lib = os.path.basename(native.load()._name)
    _check(lib == native.library(True)[1].name,
           f"phase 17 child: loaded {lib}, not the sanitized build")
    with open(os.path.join(work, "meta.json")) as f:
        meta = json.load(f)
    init = np.load(os.path.join(work, "init.npy"))
    offs = np.asarray(meta["offs"], np.int32)
    spec = types.SimpleNamespace(**meta["spec"])
    bspec = types.SimpleNamespace(**meta["bspec"])
    grams = {"feed": _read_grams(os.path.join(work, "feed.grams")),
             "corpus": _read_grams(os.path.join(work, "corpus.grams"))}
    grams["udp"] = grams["feed"]
    for run in P17_RUNS:
        eng = native.NativeIngest(spec, bspec)
        with open(os.path.join(work, f"{run}.bin"), "wb") as out:
            em = _ChildEmits(init, offs, meta["compact_every"], out)
            counters = None
            if run == "udp":
                counters = _child_udp(eng, em, grams[run], meta["lines"])
            else:
                for d in grams[run]:
                    full, off = eng.feed(d)
                    while full:
                        em.emit(eng)
                        full, off = eng.feed(d, off)
                    eng.drain_specials()
            em.emit(eng)                # the swap's emit
        with open(os.path.join(work, f"{run}.json"), "w") as f:
            json.dump({"emits": em.steps, "stats": eng.stats(),
                       "readers": counters}, f)
        del eng
    print(json.dumps({"child_s": time.perf_counter() - t0, "library": lib}))
    return 0


def _san_env() -> dict:
    """The child's environment: the sanitizer runtimes g++ ships,
    preloaded, and the reference's sanitizer options."""
    import os
    preload = []
    for name in ("libasan.so", "libubsan.so"):
        path = subprocess.run(["g++", f"-print-file-name={name}"],
                              capture_output=True, text=True,
                              timeout=60).stdout.strip()
        _check(os.path.isabs(path) and os.path.isfile(path),
               f"phase 17: g++ ships no {name} ({path!r})")
        preload.append(path)
    return {**os.environ, "VENEUR_NATIVE_SANITIZE": "1",
            "LD_PRELOAD": ":".join(preload),
            "ASAN_OPTIONS": "detect_leaks=0",
            "UBSAN_OPTIONS": "halt_on_error=1:print_stacktrace=1"}


def lint_and_sanitized_path(device, lines, feed_ims) -> dict:
    """Phase 17: `python -m veneur_tpu_torch.analysis --all --json` on
    this tree in one child, and the sanitized engine in another (see
    sanitized_child), both at once; then every packed buffer the
    sanitized engine emitted is held word for word against the plain
    engine's on the same input, put in place of it and run through K1
    on the card. The feed and udp runs' flushes must equal phase 8's
    feed InterMetrics; each run's engine counts must equal the plain
    engine's."""
    import os
    import shutil
    import tempfile
    import threading
    import torch
    from veneur_tpu_torch.aggregation.host import BatchSpec
    from veneur_tpu_torch.ops import cuda_digest, cuda_ingest
    from veneur_tpu_torch.server.flusher import generate_intermetrics
    from veneur_tpu_torch.server.native_aggregator import NativeAggregator

    t_phase = time.perf_counter()
    lint = subprocess.Popen(
        [sys.executable, "-m", "veneur_tpu_torch.analysis", "--all",
         "--json"], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    work = tempfile.mkdtemp(prefix="p17_")
    child = None
    try:
        spec, bspec = _default_spec(), BatchSpec()
        probe = NativeAggregator(spec, bspec, device=device)
        grams = {"feed": _datagrams(lines), "corpus": _intake_corpora()}
        grams["udp"] = grams["feed"]
        with open(os.path.join(work, "meta.json"), "w") as f:
            json.dump({"spec": {k: getattr(spec, k) for k in (
                "counter_capacity", "gauge_capacity", "set_capacity",
                "histo_capacity", "hll_precision")},
                "bspec": {k: getattr(bspec, k) for k in (
                    "counter", "gauge", "set", "histo")},
                "offs": probe._pk_offs.tolist(),
                "compact_every": probe.compact_every,
                "lines": len(lines)}, f)
        np.save(os.path.join(work, "init.npy"), probe._pk_bufs[0].array)
        del probe
        _write_grams(os.path.join(work, "feed.grams"), grams["feed"])
        _write_grams(os.path.join(work, "corpus.grams"),
                     [g + b"\n" for g in grams["corpus"]])
        grams["corpus"] = [g + b"\n" for g in grams["corpus"]]
        t_child = time.perf_counter()
        child = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--sanitized-child",
             work], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, env=_san_env())
        linted = {}

        def wait_lint():
            linted["out"] = lint.communicate(timeout=300)
            linted["wall_s"] = time.perf_counter() - t_phase
        waiter = threading.Thread(target=wait_lint)
        waiter.start()
        c_out, c_err = child.communicate(timeout=300)
        child_wall = time.perf_counter() - t_child
        _check(child.returncode == 0,
               f"phase 17: sanitized child exited {child.returncode}:\n"
               f"{c_out[-3000:]}{c_err[-6000:]}")
        _check("AddressSanitizer" not in c_err
               and "runtime error:" not in c_err,
               f"phase 17: sanitizer report:\n{c_err[-6000:]}")
        child_rep = json.loads(c_out.strip().splitlines()[-1])
        cuda_ingest.launches = cuda_digest.launches = 0
        steps, runs = 0, {}
        for run in P17_RUNS:
            with open(os.path.join(work, f"{run}.json")) as f:
                crun = json.load(f)
            words = np.fromfile(os.path.join(work, f"{run}.bin"), np.int32)
            san = words.reshape(crun["emits"], -1) if crun["emits"] \
                else words.reshape(0, 1)
            held = {"n": 0, "bad": []}

            class Held(NativeAggregator):
                # the plain engine's buffer against the sanitized one's,
                # then the sanitized words are the ones K1 reads
                def _begin_step(self, buf):
                    do_compact = super()._begin_step(buf)
                    i = held["n"]
                    held["n"] += 1
                    if i >= len(san) or not np.array_equal(buf.array,
                                                           san[i]):
                        held["bad"].append(i)
                    else:
                        buf.array[...] = san[i]
                    return do_compact
            agg = Held(spec, bspec, device=device)
            for d in grams[run]:
                agg.feed(d)
            state, table = agg.swap()
            res, table = agg.compute_flush(state, table, PERCENTILES)
            torch.cuda.synchronize()
            ims = generate_intermetrics(
                res, table, percentiles=PERCENTILES, aggregates=AGGREGATES,
                is_local=False, timestamp=int(time.time()))
            label = f"phase 17 {run}"
            _check(held["n"] == crun["emits"] and not held["bad"],
                   f"{label}: {held['n']} plain emits against "
                   f"{crun['emits']} sanitized, unequal at {held['bad']}")
            plain = agg.eng.stats()
            _check(plain == crun["stats"],
                   f"{label}: engine counts {crun['stats']} sanitized, "
                   f"{plain} plain")
            if run == "udp":
                rd = crun["readers"]
                _check(rd["datagrams"] == len(grams[run])
                       and rd["ring_dropped"] == 0 and rd["toolong"] == 0,
                       f"{label}: reader counters {rd}")
            r = {"emits": held["n"], "words_compared": int(words.size),
                 "stats": plain, "steps": agg.steps_total,
                 "intermetrics": len(ims)}
            if run != "corpus":
                r["worst_percentile_gap_vs_phase8_feed"] = \
                    _same_intermetrics(ims, feed_ims,
                                       f"{label} vs phase 8 feed")
            steps += agg.steps_total
            runs[run] = r
            del agg, state, res
        launches = {"fused_ingest": cuda_ingest.launches,
                    "digest_quantiles": cuda_digest.launches}
        # the lint ran beside the child and the K1 runs
        waiter.join()
        _check("out" in linted, "phase 17: vtlint did not finish")
        l_out, l_err = linted["out"]
        _check(lint.returncode == 0,
               f"phase 17: vtlint exited {lint.returncode}:\n"
               f"{l_out[-3000:]}{l_err[-3000:]}")
        rep = json.loads(l_out.strip().splitlines()[-1])
        _check(rep["ok"] is True and rep["findings"] == []
               and len(rep["passes"]) == P17_PASSES,
               f"phase 17: vtlint ok={rep['ok']}, "
               f"{len(rep['passes'])} passes, findings {rep['findings']}")
        _check(launches["fused_ingest"] == steps > 0,
               f"phase 17: {launches['fused_ingest']} K1 launches for "
               f"{steps} steps")
        _check(launches["digest_quantiles"] >= len(P17_RUNS),
               f"phase 17: K2 launched {launches['digest_quantiles']} "
               f"times in {len(P17_RUNS)} flushes")
        return {"lint": {"ok": rep["ok"], "passes": len(rep["passes"]),
                         "files_parsed": rep["files_parsed"],
                         "runtime_s": rep["runtime_s"],
                         "wall_s": linted["wall_s"],
                         "pass_s": {r["name"]: r["runtime_s"]
                                    for r in rep["passes"]}},
                "sanitized_library": child_rep["library"],
                "child_s": child_rep["child_s"], "child_wall_s": child_wall,
                "runs": runs, "launches": launches,
                "phase_s": time.perf_counter() - t_phase}
    finally:
        for p in (lint, child):
            if p is not None and p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(work, ignore_errors=True)
        torch.cuda.empty_cache()


def k1_ab(trees) -> None:
    """K1 at the default shape (phase 3's kernel_ingest: a warm default
    table, the main path's Zipf batch and the hot batch, each held
    byte-exact to the plain version) in each source tree in turn, each
    in a process of its own that builds that tree's kernels. Run as

        python3 chip_smoke.py --k1-ab OLD_TREE . . OLD_TREE

    to compare two commits on one card in one call."""
    code = ("import json, torch, chip_smoke as cs\n"
            "cs.build_kernels()\n"
            "r = cs.kernel_ingest(torch.device('cuda'), cs.sm_clock_hz())\n"
            "print('K1AB ' + json.dumps(dict(ms=r['ms'], "
            "device_ms=r['device_ms'], checks_ms=r['checks_ms'], "
            "hot_ms=r['hot']['ms'], hot_device_ms=r['hot']['device_ms'], "
            "max_abs_err=r['max_abs_err'])))\n")
    for tree in trees:
        res = subprocess.run([sys.executable, "-c", code], cwd=tree,
                             capture_output=True, text=True, timeout=600)
        _check(res.returncode == 0, f"k1 in {tree}: {res.stderr[-2000:]}")
        line = [x for x in res.stdout.splitlines() if x.startswith("K1AB ")]
        _check(len(line) == 1, f"k1 in {tree}: no result")
        print(f"k1 default shape, tree {tree}:", line[0][5:])


def main() -> int:
    if sys.argv[1:2] == ["--sanitized-child"]:
        # phase 17's child: no torch, no CUDA call (see sanitized_child)
        return sanitized_child(sys.argv[2])
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
    if sys.argv[1:2] == ["--k1-ab"]:
        print("card:", device_line())
        k1_ab(sys.argv[2:])
        return 0
    device = torch.device("cuda")
    laps = {}
    t_lap = [time.perf_counter()]

    def lap(name):
        # seconds each phase of the script took, printed at the end
        now = time.perf_counter()
        laps[name] = round(now - t_lap[0], 1)
        t_lap[0] = now
    card = device_line()
    print("card:", card)
    build_s = build_kernels(sanitized=True)

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

    lap("1-3 build and kernels")
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

    lap("4")
    # phase 8, right after phase 4: the same lines on the native path
    p8 = {}
    nat, udp_ims = native_path(device, lines, main_ims, keep=p8)
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

    lap("8")
    # phase 9, after phase 8: the Server and the CLI on the card
    p9_rows = {}
    srv = server_path(device, lines, udp_ims, keep=p9_rows)
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

    lap("9")
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

    lap("5 and 3")
    hist, range_k2, hist_frames = history_path(device, clock_hz)
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

    # phase 10, after phase 6 (whose ring is freed): the Server with the
    # history, query and watch tiers on
    lap("6")
    tiers = server_tiers_path(device, hist_frames, clock_hz)
    del hist_frames
    print("server tiers path:", json.dumps(tiers))
    print(f"server tiers path on {card}: instant query p50 "
          f"{tiers['instant_ms_p50']:.2f} ms, p99 "
          f"{tiers['instant_ms_p99']:.2f} ms through HTTP; range batch "
          f"{float(np.median(tiers['range_ms_warm'])):.1f} ms warm through "
          f"the Server (phase 6's program alone "
          f"{hist['range_ms_warm']['total']:.1f} ms); flush "
          f"{tiers['flush_ms']:.1f} ms with the ring (phase 9's first "
          f"{srv['flush_ms']:.1f} ms without); watch evaluation "
          f"{tiers['watch_eval_ms_mean']:.2f} ms an interval; K2 "
          f"{tiers['launches']['digest_quantiles']} launches, K3 "
          f"{tiers['launches']['merge_windows']} on this path")
    torch.cuda.empty_cache()

    lap("10")
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

    # phase 11: the global tier (64 locals -> 1 global), its checkpoint
    # and a restart
    lap("3 and 7")
    p11_keep = {}
    glob = global_tier_path(device, clock_hz, keep=p11_keep)
    print("global tier path:", json.dumps(glob))
    gl = glob["launches_phase"]
    print(f"global tier on {card}: {glob['metrics_per_s']:.0f} metrics/s, "
          f"{glob['centroids_per_s']:.0f} centroids/s through gRPC "
          f"({glob['metrics']} metrics, {glob['import_steps']} K1 steps of "
          f"{glob['import_step_ms']:.2f} ms); flush "
          f"{glob['flush_ms']:.1f} ms (device_update "
          f"{glob['flush_phase_ms'].get('device_update', 0.0):.1f}, "
          f"checkpoint_build "
          f"{glob['flush_phase_ms'].get('checkpoint_build', 0.0):.1f}); "
          f"checkpoint write {glob['checkpoint_write_ms']:.1f} ms, "
          f"{glob['checkpoint_bytes']:.0f} bytes written; restore fold "
          f"{glob['restore_ms']:.1f} ms in {glob['restore_steps']} K1 steps; "
          f"launches K1 {gl['fused_ingest']}, K2 {gl['digest_quantiles']}, "
          f"K3 {gl['merge_windows']}")
    _check(all(v >= 1 for v in gl.values()),
           f"global tier: a kernel was never launched {gl}")
    torch.cuda.empty_cache()

    # phase 12: the forward tier (4 locals -> a proxy -> 2 globals)
    lap("11")
    fwd = forward_tier_path(device, clock_hz)
    print("forward tier path:", json.dumps(fwd))
    fl = fwd["launches"]
    lf = fwd["local_flushes"]
    print(f"forward tier on {card}: local flush "
          f"{np.median([r['flush_ms'] for r in lf]):.1f} ms median, "
          f"forward {np.median([r['forward_ms'] for r in lf]):.1f} ms, "
          f"export_metrics {np.median([r['export_ms'] for r in lf]):.1f} "
          f"ms for {np.median([r['unit_metrics'] for r in lf]):.0f} metrics "
          f"({np.median([r['unit_bytes'] for r in lf]):.0f} bytes) a unit; "
          f"flush to folded on the globals "
          f"{np.median([r['flush_to_folded_ms'] for r in lf]):.1f} ms; "
          f"pump to fold {fwd['pump_to_fold_metrics_per_s']:.0f} "
          f"metrics/s; restore "
          f"{fwd['restore_ms']:.1f} ms in {fwd['restore_steps']} K1 steps; "
          f"launches K1 {fl['fused_ingest']}, K2 {fl['digest_quantiles']} "
          f"({fwd['flushes']} flushes); with every set name forwarded a "
          f"unit would be {fwd['unit_all_sets_forwarded']['bytes']} bytes "
          f"({fwd['unit_all_sets_forwarded']['sets']} sets), gRPC's "
          f"receive cap {4 << 20}")
    torch.cuda.empty_cache()

    # phase 13: the Server under pressure (overload and tenancy, table
    # growth), then K1 past 32-bit offsets
    lap("12")
    press = pressure_path(device)
    print("pressure path (config 15):", json.dumps(press))
    torch.cuda.empty_cache()
    grow = growth_path(device)
    print("growth path (config 6 at scale 0.1):", json.dumps(grow))
    torch.cuda.empty_cache()
    p13 = {k: press["launches"][k] + grow["launches"][k]
           for k in ("fused_ingest", "digest_quantiles")}
    offsets = wide_offsets(device, clock_hz)
    for o in offsets:
        print("kernel fused_ingest, 64-bit offsets (C-8):", json.dumps(o))
    print(f"pressure path on {card}: {press['datagrams']} datagrams "
          f"({press['inject_s']:.1f} s to inject and settle the first "
          f"{P13_STEADY + P13_DIURNAL + P13_FLASH}), {P13_NOISY} shed "
          f"{press['shed'][P13_NOISY]}, isolated tenants shed none; "
          f"CRITICAL withheld {press['critical']['withheld_rows']} rows; "
          f"{P13_RUNAWAY} readmitted after "
          f"{press['readmitted_after_flushes']} flushes. Growth: counters "
          f"{grow['counter_capacity'][0]} -> {grow['counter_capacity'][1]} "
          f"in {len(grow['grow_pause_ms'])} grow swaps (ingest_drain "
          f"{', '.join(f'{x:.1f}' for x in grow['grow_pause_ms'])} ms; a "
          f"plain swap {grow['plain_swap_ingest_drain_ms']:.1f} ms), drop "
          f"fraction {grow['drop_fraction']:.5f}, full flush "
          f"{grow['full_flush_ms']:.0f} ms; K1 {p13['fused_ingest']} "
          f"launches, K2 {p13['digest_quantiles']}")
    lap("13")

    # phase 14: sharding (tpu_n_shards 4) and the collective global tier
    shard = sharded_path(device, clock_hz, lines, p9_rows)
    print("sharded path (tpu_n_shards 4):", json.dumps(shard))
    coll = collective_path(device, p11_keep)
    del p11_keep
    print("collective tier path (R 2, S 4):", json.dumps(coll))
    p14 = {k: shard["launches"][k] + coll["launches"][k]
           for k in ("fused_ingest", "digest_quantiles")}
    ph = coll["phase_ms"]
    for name in ("split", "preshard", "rings", "rings_unpaced"):
        r = shard[name]
        print(f"sharded {name}: {r['steps']} steps"
              + (f" of {r['lines_per_step'][0]}-{r['lines_per_step'][1]} "
                 "lines (one wave each)" if r["paced"] else "")
              + f"; worst p50 {r['worst_p50_rel']:.5f}, p99 "
              f"{r['worst_p99_rel']:.5f}"
              + (" (printed, not gated)" if name == "rings_unpaced"
                 else " (limits 0.06, 0.01)"))
    print(f"sharded path on {card}: " + ", ".join(
        f"{name} {shard[name]['samples_per_s']:.0f} samples/s, flush "
        f"{shard[name]['flush_ms']:.1f} ms" for name in
        ("split", "preshard", "rings", "rings_unpaced"))
        + f" (phase 9, one shard: "
        f"{srv['samples_per_s']:.0f} samples/s, flush "
        f"{srv['flush_ms']:.1f} ms); K1 at the S = 4 step "
        f"{shard['k1']['device_ms']:.4f} ms on the card (bound "
        f"{shard['k1']['bound_ms']:.4f}), K2 at the merged flush "
        f"{shard['k2']['device_ms']:.4f} ms. Collective tier: "
        f"{coll['absorbed_rows_per_s']:.0f} absorbed rows/s "
        f"({coll['rows_absorbed']} rows of 65 locals, phase 11's gRPC "
        f"import {glob['metrics_per_s']:.0f} metrics/s); stage "
        f"{ph.get('stage', 0.0):.1f} ms, all_to_all_route "
        f"{ph.get('all_to_all_route', 0.0):.1f} ms, replica_merge "
        f"{ph.get('replica_merge', 0.0):.1f} ms, merged flush "
        f"{coll['flush_ms']:.1f} ms; {coll['imported_total']} wire "
        f"imports; launches K1 {p14['fused_ingest']}, K2 "
        f"{p14['digest_quantiles']}")
    torch.cuda.empty_cache()
    lap("14")

    # phase 15: live resharding (config 12) and tag frequency (config 5)
    rs = reshard_path(device, clock_hz)
    print("reshard path (config 12, 4 -> 8 -> 2):", json.dumps(
        {k: ({kk: vv for kk, vv in v.items() if kk not in (
            "counter", "gauge", "words", "set")}
            if isinstance(v, dict) and "summaries" in v else v)
         for k, v in rs.items()}, default=str))
    for name in ("fixed_static", "fixed_elastic"):
        print(f"15a {name}: el.t worst p50 {rs[name]['worst_p50_rel']:.5f}, "
              f"p99 {rs[name]['worst_p99_rel']:.5f} (limits 0.06, 0.01)")
    tfq = tagfreq_path(device)
    print("tag-frequency path (config 5):", json.dumps(tfq))
    p15 = rs["launches"]
    st = rs["steady"]["summaries"]
    print(f"reshard path on {card}: steady transitions "
          + ", ".join(f"{s['plan']} {s['duration_ns'] / 1e9:.3f} s "
                      f"(units built {s['build_ns'] / 1e6:.1f} ms, fold "
                      f"waves {[round(f / 1e6, 1) for f in s['fold_ns']]} "
                      f"ms, {s['rows_folded']} rows folded, "
                      f"{s['rows_moved']} moved)" for s in st)
        + f"; crash pass replayed {rs['crash']['summaries'][1]['replays']}"
        f", suppressed {rs['crash']['summaries'][1]['dup_suppressed']}; "
        f"probes {sum(rs[k]['probes'] for k in ('static', 'crash', 'steady'))}"
        f" all 200, {rs['crash']['stale_marked']} + "
        f"{rs['steady']['stale_marked']} stale-bounded; timer gap to the "
        f"static pass: fixed steps {rs['timer_gap']['fixed']:.3g} (gate "
        f"{P15_JAX_TIMER_GAP + DIGEST_TOL:.3g}), under fire crash "
        f"{rs['timer_gap']['crash']:.3g}, steady "
        f"{rs['timer_gap']['steady']:.3g} (printed); K1 at S = 8 "
        f"{rs['k1_s8']['device_ms']:.4f} ms on the card (bound "
        f"{rs['k1_s8']['bound_ms']:.4f}), at S = 2 "
        f"{rs['k1_s2']['device_ms']:.4f} ms (bound "
        f"{rs['k1_s2']['bound_ms']:.4f}); launches K1 "
        f"{p15['fused_ingest']}, K2 {p15['digest_quantiles']}. Tag "
        f"frequency: {tfq['spans_per_s']:.0f} spans/s, count-min update "
        f"{tfq['update_ms_median']:.2f} ms a batch of 8,192 (median of "
        f"{tfq['batches']}), recall {tfq['top20_recall']}, overestimate "
        f"max {tfq['overestimate_max']:.0f} (eps*N {tfq['eps_n']:.2f})")
    torch.cuda.empty_cache()
    lap("15")

    # phase 16: every sink, the S3 archive and the operator CLIs
    snk = sinks_path(device, lines)
    print("sinks path:", json.dumps(snk))
    p16 = snk["launches"]
    print(f"sinks path on {card}: flush {snk['flush_ms']:.1f} ms "
          f"(sink_fanout {snk['sink_fanout_ms']:.1f}, frame_build "
          f"{snk['frame_build_ms']:.1f}, S3 {snk['s3_flush_ms']:.1f}); "
          "sink flush ms " + ", ".join(
              f"{k} {v:.1f}" for k, v in sorted(snk["sink_flush_ms"].items()))
          + f"; {snk['rows']} rows, {snk['datadog_series']} Datadog series "
          f"in {snk['datadog_bodies']} bodies; payload bytes "
          + ", ".join(f"{k} {v}" for k, v in
                      sorted(snk["payload_bytes"].items()))
          + f"; emit -replay {snk['emit_replay_per_s']:.0f} lines/s; "
          f"{snk['spans_per_s']:.0f} spans/s into 7 span sinks; K1 "
          f"{p16['fused_ingest']} launches for {snk['steps']} steps, K2 "
          f"{p16['digest_quantiles']} for {snk['flushes']} flushes; phase "
          f"{snk['phase_s']:.1f} s")
    lap("16")

    # phase 17: the port's lint and its sanitized engine
    lnt = lint_and_sanitized_path(device, lines, p8.pop("feed_ims"))
    print("lint and sanitized engine:", json.dumps(lnt))
    p17 = lnt["launches"]
    print(f"phase 17 on {card}: vtlint ok={lnt['lint']['ok']}, "
          f"{lnt['lint']['passes']} passes, {lnt['lint']['files_parsed']} "
          f"files in {lnt['lint']['runtime_s']:.1f} s (its process "
          f"{lnt['lint']['wall_s']:.1f} s); sanitized engine "
          f"{lnt['sanitized_library']}: child {lnt['child_wall_s']:.1f} s; "
          "packed buffers equal word for word: " + ", ".join(
              f"{k} {r['emits']} ({r['words_compared']} words)"
              for k, r in lnt["runs"].items())
          + f"; K1 {p17['fused_ingest']} launches, K2 "
          f"{p17['digest_quantiles']}; phase {lnt['phase_s']:.1f} s")
    lap("17")

    # every run whose quantiles are held to the exact oracle: its worst
    # p50 and p99 errors beside their limits
    gated = {"4": main, "5": big, "7": wide, "9": srv,
             "12": fwd["interval1"], "13a": press["isolated"],
             **{f"8 {k}": nat[k] for k in ("feed", "udp", "rings")},
             **{f"14a {k}": shard[k] for k in ("split", "preshard",
                                               "rings")},
             **{f"15a {k}": rs[k] for k in ("fixed_static",
                                            "fixed_elastic")},
             "16 datadog": snk}
    worst = {k: [round(r["worst_p50_rel"], 6), round(r["worst_p99_rel"], 6)]
             for k, r in gated.items()}
    worst["14b p99 only"] = [None, round(coll["timer_error"]["p99"]["max"],
                                         6)]
    print("gated runs' worst [p50, p99] (limits 0.06, 0.01; 14b p99 "
          f"max(0.01, 1.5 x phase 11's "
          f"{glob['timer_error']['p99']['max']:.4f})):", json.dumps(worst))

    src = "veneur_tpu_torch/csrc/"
    kernels = [
        dict(name="fused_ingest", route="cuda",
             source=src + "fused_ingest.cu",
             replaces="veneur_tpu/ops/pallas_ingest.py:310",
             launches=srv["launches"]["fused_ingest"],
             launches_by_phase={
                 "4": main["launches"]["fused_ingest"],
                 "8_udp": nat["udp"]["launches"]["fused_ingest"],
                 "9": srv["launches"]["fused_ingest"],
                 "10": tiers["launches"]["fused_ingest"],
                 "11": gl["fused_ingest"],
                 "12": fl["fused_ingest"],
                 "13": p13["fused_ingest"],
                 "14": p14["fused_ingest"],
                 "15": p15["fused_ingest"],
                 "16": p16["fused_ingest"],
                 "17": p17["fused_ingest"]},
             max_abs_err=ingest["max_abs_err"], ms=ingest["ms"],
             plain_ms=ingest["plain_ms"], bound_ms=ingest["bound_ms"],
             bound_by=ingest["bound_by"], library_ms=None,
             import_step={k: glob["k1"][k] for k in (
                 "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
                 "bound_by", "max_run")},
             grown_offsets=[{k: o[k] for k in (
                 "shape", "max_abs_err", "ms", "device_ms", "plain_ms",
                 "bound_ms", "bound_by")} for o in offsets],
             sharded_step={k: shard["k1"][k] for k in (
                 "shape", "max_abs_err", "ms", "device_ms", "checks_ms",
                 "plain_ms", "bound_ms", "bound_by", "max_run")},
             reshard_steps=[{k: rs[f"k1_s{n}"][k] for k in (
                 "shape", "max_abs_err", "ms", "device_ms", "checks_ms",
                 "plain_ms", "bound_ms", "bound_by", "max_run")}
                 for n in P15_PLAN]),
        dict(name="digest_quantiles", route="cuda",
             source=src + "digest_quantiles.cu",
             replaces="veneur_tpu/ops/pallas_digest.py:189",
             launches=srv["launches"]["digest_quantiles"],
             launches_by_phase={
                 "4": main["launches"]["digest_quantiles"],
                 "8_udp": nat["udp"]["launches"]["digest_quantiles"],
                 "9": srv["launches"]["digest_quantiles"],
                 "10": tiers["launches"]["digest_quantiles"],
                 "11": gl["digest_quantiles"],
                 "12": fl["digest_quantiles"],
                 "13": p13["digest_quantiles"],
                 "14": p14["digest_quantiles"],
                 "15": p15["digest_quantiles"],
                 "16": p16["digest_quantiles"],
                 "17": p17["digest_quantiles"]},
             max_abs_err=max(d["max_abs_err"] for d in digests),
             ms=digests[0]["ms"], plain_ms=digests[0]["plain_ms"],
             bound_ms=digests[0]["bound_ms"],
             bound_by=digests[0]["bound_by"], library_ms=None,
             merged_flush={k: shard["k2"][k] for k in (
                 "rows", "cells", "q", "max_abs_err", "ms", "device_ms",
                 "plain_ms", "bound_ms", "bound_by", "live_p50",
                 "live_p99")}),
        dict(name="merge_windows", route="cuda",
             source=src + "merge_windows.cu",
             replaces="veneur_tpu/ops/pallas_history.py:92",
             launches=tiers["launches"]["merge_windows"],
             launches_by_phase={
                 "6": hist["launches"]["merge_windows"],
                 "10": tiers["launches"]["merge_windows"],
                 "11": gl["merge_windows"]},
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
    print(f"build {build_s:.1f} s; seconds by phase:", json.dumps(laps),
          f"total {sum(laps.values()):.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
