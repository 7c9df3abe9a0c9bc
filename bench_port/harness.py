"""One run of one cell: set-up, the measured window, the comparison and
the result line.

Set-up builds the cell's corpus from the seed, starts the Server in
process from the configuration's file (its own ticker out of the way:
the interval is set far past the run), and warms it with the first items
of the corpus and one flush. The window then feeds the replayed corpus,
one item at a time, through the entry the Server's listeners use (the
mix's kind says which: `kinds/<kind>.py`'s `put`). The Server's own
packet queue is left as it is; the feeder keeps the mix's `backlog` of
items in it, topping it up in a burst whenever the pipeline thread has
drained it to the low-water mark, and sleeping in between.
The feeder plays the flush ticker: at every interval of the window, and
at its end, it enqueues a flush request behind the items before it, so
the queue's order fixes which items each interval holds. The window ends
when its last flush has reached the sinks. In the untraced run the
profiler records the card's activity alone over the window, for the
card's busy time a sample (`trace.CardClock`).

After the window the Server is shut down and the kind's reference holds
every flushed interval to its own answer.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import sys
import threading
import time
from pathlib import Path

import numpy as np

from bench_port import generate

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
FLUSH_TIMEOUT_S = 120.0         # a flush not done by then fails the run
POLL_S = 0.0005                 # the feeder's sleep while the backlog drains
SLICE_BEFORE_S = 1.0            # traced slice: before the middle flush
SLICE_AFTER_S = 2.5             # and after it
FORBIDDEN = ("jax", "jaxlib", "flax", "veneur_tpu", "benchmarks")


def load_benchmark() -> dict:
    with open(REPO / "BENCHMARK.json") as f:
        return json.load(f)


def plan(bench: dict, workload: str) -> dict:
    """The cell's entries: its workload, configuration, mix, and the
    metrics it reports with and without a trace."""
    cell = next((w for w in bench["workloads"] if w["name"] == workload),
                None)
    if cell is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])

    def has(metric):
        return "workloads" not in metric or workload in metric["workloads"]

    e2e = [m for m in bench["end_to_end"] if has(m)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m
                     else m["moves"] in names)]
    return dict(cell=cell, config=config, end_to_end=e2e,
                per_layer=per_layer)


def load_config(config_entry: dict) -> dict:
    with open(REPO / config_entry["file"]) as f:
        return json.load(f)


def _module(folder: str, name: str):
    """`<folder>/<name>.py` under the benchmark, or None."""
    path = ROOT / folder / f"{name}.py"
    full = f"bench_port.{folder}.{name}"
    if full in sys.modules:
        return sys.modules[full]
    if not path.exists():
        return None
    spec = importlib.util.spec_from_file_location(full, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[full] = mod
    spec.loader.exec_module(mod)
    return mod


def kind(name: str):
    """The module of a kind of traffic: `kinds/<kind>.py`, with
    `corpus(mix, seed)`, `reference(corpus)` and `put(srv, item)`."""
    mod = _module("kinds", name)
    if mod is None:
        raise FileNotFoundError(f"no module for traffic kind {name!r}")
    return mod


def reader(metric: str):
    """The reader of a per-layer metric: `metrics/<name>.py`, or the
    name without its last dotted part (a metric split by cell)."""
    name = metric
    while (mod := _module("metrics", name)) is None:
        if "." not in name:
            raise FileNotFoundError(f"no reader for metric {metric!r}")
        name = name.rsplit(".", 1)[0]
    return mod.read


def forbidden_modules() -> list:
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


# -- the system under test ----------------------------------------------------

LABEL_SAMPLES = 16              # rows a segment whose labels are kept


def _capture_sink():
    from veneur_tpu_torch.sinks.base import MetricSink

    class CaptureSink(MetricSink):
        """Keeps, for each flush, each segment's names and values and when
        the sink returned. It keeps no reference to the frame's key
        metadata, so the program's own objects die when the flush is
        done (retained, they would lengthen every later garbage
        collection); the labels of LABEL_SAMPLES rows a segment are
        copied for the comparison."""
        name = "bench_capture"
        accepts_frames = True

        def __init__(self):
            self.frames = []

        def flush(self, metrics):
            raise RuntimeError("the capture sink takes frames only")

        def flush_frame(self, frame):
            segs = []
            for seg in frame.segments:
                metas = seg.metas
                n = len(metas)
                if not n:
                    continue
                suffix = seg.names[0][len(metas[0].name):]
                step = max(1, n // LABEL_SAMPLES)
                labels = [(metas[i].name, tuple(metas[i].tags))
                          for i in range(0, n, step)]
                segs.append((seg.names, seg.values, suffix, labels))
            self.frames.append((segs, time.perf_counter()))

    return CaptureSink()


def build_server(server_keys: dict, device):
    from veneur_tpu_torch.config import Config
    from veneur_tpu_torch.server.server import Server
    from veneur_tpu_torch.sinks.blackhole import BlackholeMetricSink
    keys = dict(server_keys)
    # the harness plays the ticker: the Server's own never fires in a run
    keys.update(interval="3600s", statsd_listen_addresses=[],
                http_address="", grpc_address="")
    capture = _capture_sink()
    srv = Server(Config(**keys),
                 metric_sinks=[BlackholeMetricSink(), capture],
                 device=device)
    srv.start()
    return srv, capture


def _request(fn):
    """A packet-queue item that runs fn(aggregator) on the pipeline
    thread when the queue's order reaches it, keeping its result."""
    from veneur_tpu_torch.query.snapshot import PipelineRequest

    class Visit(PipelineRequest):
        __slots__ = ("result",)

        def run(self, aggregator):
            try:
                self.result = fn(aggregator)
                self.ok = True
            except Exception as e:  # noqa: BLE001 - the waiter must wake
                self.detail = f"{type(e).__name__}: {e}"
            finally:
                self.done.set()

    return Visit()


def _visit(srv, fn, timeout: float = FLUSH_TIMEOUT_S):
    """Run fn(aggregator) on the pipeline thread at this point of the
    queue's order; returns its result."""
    v = _request(fn)
    srv.packet_queue.put(v)
    if not v.wait(timeout) or not v.ok:
        raise RuntimeError(f"pipeline visit failed: {v.detail}")
    return v.result


def counters(srv) -> dict:
    """The program's own counters, read between two items."""
    agg = srv.aggregator
    eng = _visit(srv, lambda a: a.eng.stats())
    t = srv.metrics.get("veneur.flush.phase_duration_ns")
    phases = {lv[0]: (st.count, st.sum) for lv, st in t.snapshot(qs=())}
    return dict(dispatch_ns=agg.dispatch_ns, steps=agg.steps_total,
                phases=phases, processed=eng["processed"],
                parse_errors=eng["parse_errors"], dropped=eng["dropped"])


def delta(a: dict, b: dict) -> dict:
    out = {}
    for k, v in b.items():
        if k == "phases":
            out[k] = {p: (c - a[k].get(p, (0, 0))[0],
                          s - a[k].get(p, (0, 0))[1])
                      for p, (c, s) in v.items()}
        else:
            out[k] = v - a.get(k, 0)
    return out


# -- the traced run's probes --------------------------------------------------

class Probes:
    """The trace run's spans around calls into each layer, and the work
    records that the roofline readers need."""

    def __init__(self, srv):
        import torch
        from veneur_tpu_torch.aggregation import step
        from veneur_tpu_torch.ops import cuda_digest, cuda_ingest
        self.srv, self.torch = srv, torch
        self.recording = False
        self.feed_ns = 0
        self.k1 = []                # streams of each K1 launch in the slice
        self.k2 = []                # (rows, cells, q) of each flush K2 call
        self.in_flush = threading.local()
        rf = torch.profiler.record_function
        agg = srv.aggregator
        eng = agg.eng
        self._undo = []

        def patch(obj, name, wrapper):
            orig = getattr(obj, name)
            self._undo.append((obj, name, orig, name in vars(obj)))
            setattr(obj, name, wrapper(orig))

        def timed(label, attr):
            def wrap(orig):
                def call(*a, **kw):
                    t0 = time.perf_counter_ns()
                    with rf(label):
                        out = orig(*a, **kw)
                    setattr(self, attr, getattr(self, attr)
                            + time.perf_counter_ns() - t0)
                    return out
                return call
            return wrap

        def ranged(label):
            def wrap(orig):
                def call(*a, **kw):
                    with rf(label):
                        return orig(*a, **kw)
                return call
            return wrap

        def k1(orig):
            def call(state, st, spec):
                if self.recording and state.counter_acc.is_cuda:
                    self.k1.append(st)
                return orig(state, st, spec)
            return call

        def k2(orig):
            def call(mean, weight, mn, mx, qs):
                if self.recording and mean.is_cuda and getattr(
                        self.in_flush, "on", False):
                    self.k2.append((mean.shape[0], mean.shape[1],
                                    qs.shape[0]))
                return orig(mean, weight, mn, mx, qs)
            return call

        def flush(orig):
            def call(*a, **kw):
                self.in_flush.on = True
                try:
                    return orig(*a, **kw)
                finally:
                    self.in_flush.on = False
            return call

        patch(eng, "feed", timed("engine.feed", "feed_ns"))
        # the pipeline thread's waits for an item, named in the trace
        patch(srv.packet_queue, "get", ranged("queue.get"))
        patch(step, "compact_core", ranged("step.compact"))
        patch(agg, "swap", ranged("flush.swap"))
        patch(agg, "compute_flush", flush)
        patch(cuda_ingest, "fused_ingest", k1)
        patch(cuda_digest, "quantiles_rows", k2)
        self.prof = None
        self.t_start = self.t_stop = None
        if srv.device.type == "cuda":
            # the first profile of a process initializes CUPTI: in set-up
            self.start()
            self.stop()

    def start(self):
        """Start the profiler on the pipeline thread, between two items."""
        torch = self.torch
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.srv.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.k1, self.k2 = [], []

        def go(_agg):
            self.prof.start()
            self.recording = True
            return time.perf_counter()
        self.t_start = _visit(self.srv, go)

    def stop(self):
        def halt(_agg):
            self.recording = False
            if self.srv.device.type == "cuda":
                self.torch.cuda.synchronize()
            self.prof.stop()
            return time.perf_counter()
        self.t_stop = _visit(self.srv, halt)

    def undo(self):
        for obj, name, orig, own in reversed(self._undo):
            if own:
                setattr(obj, name, orig)
            else:
                delattr(obj, name)


# -- one run ------------------------------------------------------------------

def _ticks(interval: float, seconds: float) -> list:
    n = max(1, math.ceil(seconds / interval - 1e-9))
    return [min(interval * k, seconds) for k in range(1, n + 1)]


def window(srv, put, corpus, backlog, interval: float, seconds: float,
           probes=None):
    """Feed the replayed corpus for `seconds`, flushing at each tick.
    Returns the flushes' (request, the time the pipeline thread reached
    it, items before it) and the window's start and end."""
    items = corpus.items
    n = len(items)
    high, low = backlog
    q = srv.packet_queue
    ticks = _ticks(interval, seconds)
    slice_at = None
    if probes is not None:
        mid = ticks[(len(ticks) - 1) // 2]
        slice_at = (max(0.0, mid - SLICE_BEFORE_S), mid + SLICE_AFTER_S)
    flushes = []
    pos = 0
    k = 0
    tracing = 0                 # 0 before the slice, 1 in it, 2 after
    t0 = time.perf_counter()
    while k < len(ticks):
        if q.qsize() > low:
            time.sleep(POLL_S)
            continue
        for _ in range(high - q.qsize()):
            put(srv, items[pos % n])
            pos += 1
            now = time.perf_counter() - t0
            if slice_at is not None:
                if tracing == 0 and now >= slice_at[0]:
                    probes.start()
                    tracing = 1
                elif tracing == 1 and now >= slice_at[1]:
                    probes.stop()
                    tracing = 2
            if now >= ticks[k]:
                # the interval's end: when the pipeline thread has taken
                # every item before it and reaches its flush request
                reached = _request(lambda _agg: time.perf_counter())
                q.put(reached)
                flushes.append((srv.trigger_flush(wait=False), reached, pos))
                k += 1
                if k == len(ticks):
                    break
    for req, _t, _p in flushes:
        if not req.wait(FLUSH_TIMEOUT_S):
            raise RuntimeError(f"a flush of the window failed: {req.detail}")
    t_end = time.perf_counter()
    if tracing == 1:
        # the window closed inside the slice: it ends with the last flush
        probes.stop()
    flushes = [(req, reached.result, p) for req, reached, p in flushes]
    return flushes, t0, t_end


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             t_process: float, device: str = "cuda", control: bool = False,
             bench: dict = None, overrides: dict = None, log=print):
    """One run; returns the result dict (the last stdout line's object)."""
    import torch
    bench = bench or load_benchmark()
    p = plan(bench, workload)
    cfg = load_config(p["config"])
    mix = generate.load_mix(p["cell"]["traffic"])
    server_keys = dict(cfg["server"])
    comparison = cfg["comparison"]
    limits = comparison["limits"]
    interval = float(cfg["interval_s"])
    if overrides:
        server_keys.update(overrides.get("server", {}))
        mix = _merge(mix, overrides.get("mix", {}))
        interval = float(overrides.get("interval_s", interval))
    chips = int(p["cell"]["chips"])
    if device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            raise SystemExit(f"bench_port: the cell needs {chips} CUDA "
                             "device(s); torch sees "
                             f"{torch.cuda.device_count()}")
    dev = torch.device(device)

    traffic = kind(mix["kind"])
    corpus = traffic.corpus(mix, seed)
    srv, capture = build_server(server_keys, dev)
    probes = None
    try:
        if trace:
            probes = Probes(srv)
        # warm-up: one short interval of the cell's own traffic, flushed
        for item in corpus.items[:corpus.warmup_items]:
            traffic.put(srv, item)
        if not srv.trigger_flush(timeout=FLUSH_TIMEOUT_S):
            raise RuntimeError("the warm-up flush failed")
        if dev.type == "cuda":
            torch.cuda.synchronize()
        capture.frames.clear()
        c0 = counters(srv)
        feed0 = probes.feed_ns if probes else 0
        card = None
        if not trace and dev.type == "cuda":
            from bench_port import trace as tr
            card = tr.CardClock()
        t_setup = time.perf_counter() - t_process

        if card is not None:
            card.start()
        flushes, t0, t_end = window(srv, traffic.put, corpus, mix["backlog"],
                                    interval, seconds, probes)
        win_s = t_end - t0
        card_s = card.stop() if card is not None else 0.0
        c1 = counters(srv)
        frames = list(capture.frames[:len(flushes)])
        peak = (torch.cuda.max_memory_allocated(dev)
                if dev.type == "cuda" else 0)
        d = delta(c0, c1)
        if probes is not None:
            d["feed_ns"] = probes.feed_ns - feed0
            probes.undo()
        slice_ = None
        if probes is not None and probes.t_start > t0:
            from bench_port import trace as tr
            slice_ = tr.Slice(tr.read_trace(probes.prof),
                              probes.t_stop - probes.t_start)
    finally:
        srv.shutdown()
    spec = srv.aggregator.spec
    per_layer_ctx = dict(delta=d, slice=slice_, cell=workload, wall={},
                         flushes=len(flushes),
                         k1=_k1_work(probes, spec) if probes else [],
                         k2=list(probes.k2) if probes else [])
    del srv
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # -- the comparison -------------------------------------------------------
    ref = traffic.reference(corpus)
    readings = {}
    bounds = [0] + [pos for _r, _t, pos in flushes]
    for k in range(len(flushes)):
        if control:
            got = ref.control_rows(bounds[k], bounds[k + 1])
        elif k < len(frames):
            got = ref.rows(frames[k][0])
        else:
            got = None
        want = ref.interval(bounds[k], bounds[k + 1])
        if got is None:
            nums = {name: math.inf for name in limits}
        else:
            nums = ref.compare(got, want, comparison)
        for name in limits:
            readings[name] = max(readings.get(name, 0.0), nums[name])
        log(f"interval {k}: items {bounds[k]}-{bounds[k + 1]}, "
            + ", ".join(f"{n} {v:.6g}" for n, v in sorted(nums.items())),
            file=sys.stderr)
    checks = {n: dict(value=_num(readings[n]), limit=limits[n])
              for n in limits}
    correct = all(readings[n] <= limits[n] for n in limits)
    per_item = np.concatenate([[0], np.cumsum(corpus.item_samples)])
    samples = int(bounds[-1] // len(corpus.items) * per_item[-1]
                  + per_item[bounds[-1] % len(corpus.items)])
    failed = int(d["dropped"] + d["parse_errors"])

    # -- the metrics ----------------------------------------------------------
    metrics = {}
    wall = per_layer_ctx["wall"]
    wall.update(ingest_samples_per_s=samples / win_s, flush_ms=sum(
        fr[1] - t for (_r, t, _p), fr in zip(flushes, frames))
        * 1e3 / max(1, len(frames)))
    if not trace:
        values = dict(setup_s=t_setup)
        if card is not None:
            values["card_ns_per_sample"] = card_s * 1e9 / max(1, samples)
        for m in p["end_to_end"]:
            if m["name"] in values:
                metrics[m["name"]] = dict(value=values[m["name"]],
                                          unit=m["unit"])
    else:
        for m in p["per_layer"]:
            v = reader(m["name"])(per_layer_ctx)
            if v is not None:
                metrics[m["name"]] = dict(value=v, unit=m["unit"])
    device_info = dict(
        platform="gpu" if dev.type == "cuda" else dev.type,
        kind=torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        count=chips, memory_peak_bytes=int(peak))
    result = dict(correct=bool(correct), attempted=samples, failed=failed,
                  metrics=metrics, device=device_info)
    if trace and slice_ is not None:
        device_info.update(busy_s=slice_.busy_s, window_s=slice_.window_s)
        result["breakdown"] = dict(device_ops=slice_.top_ops(),
                                   idle_gaps=slice_.idle_gaps())
    bad = forbidden_modules()
    if bad:
        raise SystemExit("bench_port: the process holds "
                         f"{', '.join(bad)} after the window")
    log(f"window {win_s:.3f} s, {len(flushes)} flushes, {samples} samples, "
        f"setup {t_setup:.3f} s, card busy {card_s:.4f} s, "
        f"wall {wall['ingest_samples_per_s']:.1f} samples/s, "
        f"flush {wall['flush_ms']:.3f} ms", file=sys.stderr)
    if card is not None:
        log(f"card trace events by kind: {card.kinds}; busiest (name, s, "
            f"launches): {card.top}", file=sys.stderr)
    log("program: " + json.dumps(dict(
        steps=d["steps"], dispatch_s=d["dispatch_ns"] / 1e9,
        processed=d["processed"],
        phases_ms={k: v[1] / 1e6 for k, v in d["phases"].items()},
        flush_ms=[(fr[1] - t) * 1e3 for (_r, t, _p), fr in
                  zip(flushes, frames)])), file=sys.stderr)
    for m in p["per_layer"] if trace else ():
        if m["name"] not in metrics:
            log(f"per-layer {m['name']}: nothing to read", file=sys.stderr)
    if trace and slice_ is not None:
        log("K2 launches in the slice (grid): " + str(
            [a.get("grid") for _t, _s, a in slice_.kernels(
                "digest_quantiles")][:20]) + "; flush calls recorded: "
            + str(per_layer_ctx["k2"][:20]), file=sys.stderr)
    for n, c in checks.items():
        log(f"check {n} {c['value']} limit {c['limit']}", file=sys.stderr)
    result["checks"] = checks
    return result


def _num(x: float) -> float:
    return x if math.isfinite(x) else sys.float_info.max


def _merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(
            out.get(k), dict) else v
    return out


def _k1_work(probes, spec) -> list:
    """(bytes, operations, chain) of each K1 launch recorded in the slice
    (worked out after the window, on the card)."""
    from bench_port import peaks
    out = [peaks.k1_work(st, spec.hll_words, spec.total_cells)
           for st in probes.k1]
    probes.k1 = []
    return out
