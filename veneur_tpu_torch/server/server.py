"""The server daemon: listeners → parse → aggregate → flush → sinks.

Maps the reference's Server (server.go:83 struct, :771 Start, :1303 Serve):

- UDP/TCP statsd listeners with SO_REUSEPORT reader sharding
  (networking.go:19 StartStatsd, socket_linux.go:26).
- HandleMetricPacket prefix dispatch: `_e{` → event, `_sc` → service
  check, else metric (server.go:939-988).
- One pipeline thread owning the device table (the N worker goroutines of
  worker.go collapse into one ingest step a batch; logical shards are
  slot ranges).
- Flush ticker with per-flush deadline and the crash-only FlushWatchdog
  (server.go:853-890, :900-935).
- Sinks flushed in parallel threads with a WaitGroup-equivalent barrier,
  then plugins (flusher.go:105-131).
- The global tier's import: a gRPC Forward service (`grpc_address`) and
  POST /import hand MetricLists to the pipeline thread, which stages them
  through the aggregator's import lanes (the native engine decodes the
  gRPC bytes itself).
- Durability (`checkpoint_dir`): a due flush also gathers the live rows'
  raw sketch state and hands a snapshot to the async CheckpointWriter;
  `restore_on_start` folds the newest valid checkpoint (this package's or
  the JAX package's) through the same merge lanes before any listener
  starts, and shutdown writes the unflushed tail.
- Forwarding (`forward_address`): a local's flush exports its
  forwardable sketches (export_metrics over the flush's raw gather) and
  ships them to a global or a proxy over gRPC or HTTP, on an aux thread.
  With `forward_dedup_window` each interval is staged as an ack-gated
  unit under a (source_id, epoch, seq) envelope before the checkpoint
  build, re-sent under the same seq until acked, and a receiver
  suppresses the duplicates its window has seen (forward/envelope.py).
- Overload (`overload_enabled`): reliability/overload.py's controller
  polls the pressure signals, admits or sheds each statsd buffer before
  its parse (and, with `overload_native_admission`, pushes the same
  decision into the C++ rings), degrades timers and sets at SHEDDING,
  and at CRITICAL sheds imports, queries and watch evaluations and
  withholds low-priority rows from the sinks. Tenancy (`tenant_enabled`,
  reliability/tenancy.py) layers weighted per-tenant buckets under it
  and mirrors the engine's quarantine; the checkpoint carries it.
- Key-table growth (`table_grow_enabled`, tables/): a flush whose tables
  passed their high-water mark swaps into a backend built at the grown
  capacities; the detached interval flushes against the old one, and
  the checkpoint's "keytables" chunk re-grows a restore before its fold.
- Sharding (`tpu_n_shards` > 1; 0 takes one shard a card): the key table
  split into shard tiles on the one device (server/sharded_aggregator.py,
  the native engine's sharded emits). `collective_enabled` makes this
  Server the collective global tier (collective/tier.py) over
  (`tpu_n_replicas`, shards), registered in-process under
  `collective_group`; a local with `collective_attach` hands each flush's
  forwardable rows to it (no wire bytes) and falls back to its forward
  path when the tier is absent or the absorb fails.

The device state lives on `device`: the card unless the caller names
another. The pipeline thread launches the ingest kernel (through the
aggregator's step) and the query tier's instant reads; the flush worker
launches the digest kernel (in compute_flush) and, with the history tier,
the ring write; the query batcher runs range reads over the ring and the
watch engine evaluates detached intervals. Every thread uses its current
CUDA stream, the default stream in each, so an interval's last ingest
step is ordered before its flush, a query's read before the next step,
and a range read enqueued under the ring's lock before the next ring
write.

A config key of a feature this package had not ported would raise
NotImplementedError at construction, naming the ROADMAP item that brings
it (`NOT_PORTED`); every key the JAX Server serves is served here.
"""

from __future__ import annotations

import logging
import os
import queue
import socket
import ssl
import tempfile
import threading
import time
from typing import List, Optional

from veneur_tpu_torch.aggregation.host import BatchSpec
from veneur_tpu_torch.aggregation.state import TableSpec, resolve_device
from veneur_tpu_torch.config import Config
from veneur_tpu_torch.forward.envelope import FRESH, Envelope, EnvelopeError
from veneur_tpu_torch.query.snapshot import PipelineRequest
from veneur_tpu_torch.reliability.faults import FAULTS, FLUSH_WORKER
from veneur_tpu_torch.reliability.overload import CRITICAL
from veneur_tpu_torch.reliability.policy import (OPEN, CircuitBreaker,
                                                 CircuitOpenError,
                                                 RetryPolicy)
from veneur_tpu_torch.samplers import parser
from veneur_tpu_torch.server.aggregator import Aggregator
from veneur_tpu_torch.server.flusher import generate_intermetrics
from veneur_tpu_torch.sinks.base import ResilientSink, dispatch_flush

log = logging.getLogger("veneur_tpu_torch.server")

_STOP = object()    # pipeline-queue sentinel: drain and exit
MAX_UDP_SSF = 65536

# Config keys whose feature is not ported yet: (key, is it set?, the
# ROADMAP item that ports it). Each raises NotImplementedError in Server().
# Every key the JAX Server serves is served here too.
NOT_PORTED: tuple = ()


def refuse_not_ported(cfg: Config) -> None:
    """Raise NotImplementedError for the first config key whose feature
    this package has not ported yet; never ignore one in silence."""
    for key, is_set, item in NOT_PORTED:
        if is_set(cfg):
            raise NotImplementedError(
                f"{key}: not ported to veneur_tpu_torch yet (ROADMAP {item})")


class FlushRequest:
    """One flush command traveling pipeline thread → flush worker.

    Waiters observe THIS request's completion — not "any flush", which
    would let a ticker flush satisfy a manual trigger's wait and return
    before the caller's data reached the sinks. `ok` is False when the
    flush was deferred under backpressure, failed, or (for the waiter)
    timed out; `detail` says which."""

    __slots__ = ("done", "ok", "detail")

    def __init__(self):
        self.done = threading.Event()
        self.ok = False
        self.detail = ""

    def finish(self, ok: bool, detail: str = "") -> None:
        self.ok = ok
        self.detail = detail
        self.done.set()

    def wait(self, timeout: float) -> bool:
        """True iff the flush completed successfully within `timeout`."""
        if not self.done.wait(timeout):
            self.detail = f"timed out after {timeout:.0f}s"
            return False
        return self.ok


class _ImportBatch(list):
    """Queue item carrying forwarded metricpb.Metrics into the pipeline
    thread (the ImportMetricChan of reference worker.go:55)."""


class _ImportBytes(bytes):
    """Queue item carrying a raw serialized forwardrpc.MetricList for the
    native import decoder (NativeAggregator.import_pb_bytes): the gRPC
    thread never pays Python protobuf deserialization."""


class _SpanMetricBatch(list):
    """Queue item carrying span-extracted UDPMetrics (ssfmetrics loop-back
    into the aggregation pipeline)."""


def resolve_addr(addr: str):
    """reference protocol/addr.go:18 ResolveAddr: scheme://host:port with
    schemes udp/tcp/unix(gram)."""
    from urllib.parse import urlparse
    u = urlparse(addr)
    if u.scheme in ("udp", "udp4", "udp6", "tcp", "tcp4", "tcp6"):
        # u.port is only touched here: an abstract unix name like
        # '@veneur:ssf' parses as netloc with a non-numeric "port" and
        # would raise
        port = u.port if u.port is not None else 8126
        kind = "udp" if u.scheme.startswith("udp") else "tcp"
        return (kind, (u.hostname or "127.0.0.1", port))
    if u.scheme in ("unix", "unixgram"):
        # netloc survives for abstract-namespace paths ('@name' parses as
        # URL userinfo) and the schemeless-path form 'unixgram:path'
        return (u.scheme, u.netloc + u.path)
    raise ValueError(f"unsupported listener scheme in {addr!r}")


def unix_bind_address(path: str) -> str:
    """'@name' -> Linux abstract-namespace address; shared by the server
    bind and the emit client so both mangle identically."""
    return "\0" + path[1:] if path.startswith("@") else path


def tick_delay(interval: float, now: float) -> float:
    """Seconds until the next wall-clock multiple of `interval`
    (reference server.go:866 CalculateTickDelay; pinned by its test's
    11:45:26.371 @ 10s → 3.629s case)."""
    return interval - (now % interval)


def spec_from_config(cfg: Config) -> TableSpec:
    return TableSpec(
        counter_capacity=cfg.tpu_counter_capacity,
        gauge_capacity=cfg.tpu_gauge_capacity,
        status_capacity=cfg.tpu_status_capacity,
        set_capacity=cfg.tpu_set_capacity,
        histo_capacity=cfg.tpu_histo_capacity,
        compression=float(cfg.tpu_digest_compression),
        cells_per_k=int(cfg.tpu_digest_cells_per_k),
        exact_extremes=int(cfg.tpu_digest_exact_extremes))


class Server:
    def __init__(self, cfg: Config, metric_sinks: Optional[List] = None,
                 span_sinks: Optional[List] = None,
                 plugins: Optional[List] = None, device=None):
        refuse_not_ported(cfg)
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            if not cfg.pallas_ingest_enabled:
                # the JAX package's kernel-free ingest chain; on the card
                # this package always runs the fused ingest kernel
                raise NotImplementedError(
                    "pallas_ingest_enabled: false asks for a kernel-free "
                    "ingest chain, which veneur_tpu_torch does not have on "
                    "the card")
            # build the kernels now, before any thread starts: a first
            # step or flush that compiled them would stall the ticker
            # and read as a missed flush
            from veneur_tpu_torch.ops import _build
            _build.load()
        self.cfg = cfg
        self.interval = cfg.parse_interval()
        self.hostname = cfg.hostname
        self.tags = list(cfg.tags)
        self._native_readers_active = False
        n_shards = max(1, cfg.tpu_n_shards)
        if cfg.tpu_n_shards == 0 and self.device.type == "cuda":
            # auto: one shard per card when several are attached
            import torch
            n_shards = max(1, torch.cuda.device_count())
        self._collective_registered = ""
        if cfg.collective_enabled:
            # the collective global tier (collective/tier.py) over
            # (tpu_n_replicas, shards): takes routed absorbs from
            # co-located locals and merges the replica rows at flush
            from veneur_tpu_torch.collective import tier as collective_tier
            from veneur_tpu_torch.parallel import sharded
            n_replicas = max(1, cfg.tpu_n_replicas)
            if cfg.tpu_n_shards == 0:
                n_shards = max(1, n_shards // n_replicas)
            spec = spec_from_config(cfg)
            while n_shards > 1 and not sharded.divides(spec, n_shards):
                n_shards -= 1
            self.aggregator = collective_tier.CollectiveGlobalTier(
                spec, self._batch_spec(), n_shards=n_shards,
                n_replicas=n_replicas, device=self.device,
                compact_every=cfg.tpu_compact_every)
            self._native = False
            collective_tier.register(cfg.collective_group, self.aggregator)
            self._collective_registered = cfg.collective_group
        else:
            self.aggregator, self._native = self._make_aggregator(n_shards)
        if cfg.profile_capture_enabled and self.device.type == "cuda":
            # GET /debug/profile captures from an HTTP thread
            from veneur_tpu_torch.observability import runtime
            runtime.init_profiler()
        self.metric_sinks = list(metric_sinks or [])
        self.span_sinks = list(span_sinks or [])
        self.plugins = list(plugins or [])

        # span pipeline: metric-extraction sink always first
        # (server.go:409, ssfmetrics always prepended)
        from veneur_tpu_torch.server.spans import SpanPipeline
        from veneur_tpu_torch.sinks.ssfmetrics import MetricExtractionSink
        extraction = MetricExtractionSink(
            self.process_span_metrics,
            indicator_timer_name=cfg.indicator_span_timer_name,
            objective_timer_name=cfg.objective_span_timer_name)
        # tag-frequency heavy hitters (count-min over the span firehose);
        # each flush reports the interval's top K through the
        # self-telemetry loop-back. The trace client is made below; the
        # report reads it at flush time.
        self.tag_frequency = None
        if cfg.tag_frequency_enabled:
            from veneur_tpu_torch.sinks.tagfreq import TagFrequencySink
            from veneur_tpu_torch.trace.client import report_batch
            self.tag_frequency = TagFrequencySink(
                report=lambda samples: report_batch(self.trace_client,
                                                    samples),
                tag_keys=cfg.tag_frequency_tag_keys,
                top_k=cfg.tag_frequency_top_k,
                depth=cfg.tag_frequency_depth,
                width=cfg.tag_frequency_width,
                batch_size=cfg.tag_frequency_batch_size,
                device=self.device)
            self.span_sinks.append(self.tag_frequency)
        # bare tags map to empty values (parser.go:694 ParseTagSliceToMap)
        common_tags = {t.split(":", 1)[0]: (t.split(":", 1)[1]
                                            if ":" in t else "")
                       for t in cfg.tags}
        self.span_pipeline = SpanPipeline(
            [extraction] + self.span_sinks,
            capacity=cfg.span_channel_capacity or 100,
            num_workers=max(1, cfg.num_span_workers),
            common_tags=common_tags,
            report_samples=self._report_span_worker_samples)
        # after the span pipeline exists: exclusion rules wire BOTH sink
        # kinds (server.go:1467 setSinkExcludedTags)
        self._wire_excluded_tags()

        # self-telemetry: a channel trace client into our own span pipeline
        # (trace.NewChannelClient, server.go:309-313) — self-spans re-enter
        # the pipeline and are extracted back to metrics by ssfmetrics
        from veneur_tpu_torch.trace.client import ChannelBackend, Client
        self.trace_client = Client(ChannelBackend(self.span_pipeline))
        self._last_stats = {}
        self._unique_ts = None
        # h2d_bytes high-water at the last flush report, for per-interval
        # byte tags on the flush trace (flush worker thread only)
        self._h2d_reported = 0

        self.event_samples = []       # EventWorker buffer (worker.go:527)
        self._event_lock = threading.Lock()
        self.packet_queue: "queue.Queue" = queue.Queue(maxsize=4096)
        # detached flush intervals; drained by the dedicated flush thread
        # (flusher.go:105-115 runs on its own goroutine — the pipeline/worker
        # threads never wait on sinks). Bounded: each job holds a detached
        # device-state snapshot, so a backlogged flush worker must drop
        # intervals rather than grow without limit.
        self._flush_jobs: "queue.Queue" = queue.Queue(maxsize=4)
        self.last_flush = time.time()
        self.last_flush_done = time.time()
        # slow-sink containment (flush-worker thread only)
        self._sink_threads: dict = {}

        # -- telemetry registry (observability/) --------------------------
        # THE source of truth for self-observation: /stats, the
        # self-metric flush, and GET /metrics all read it. Every counter
        # write is an atomic Counter.inc(); the int attributes below
        # (parse_errors, flush_count, ...) are read-only views. Timer
        # digests live on the server's device.
        from veneur_tpu_torch.observability import TelemetryRegistry
        self.metrics = TelemetryRegistry(
            timer_compression=float(cfg.self_timer_compression or 50.0),
            device=self.device)
        self._flush_trace = bool(cfg.flush_trace_enabled)
        self._register_instruments()

        # (duration_ns, n_metrics) per forward send, success or failure;
        # guarded by _sink_stats_lock with the other flush telemetry
        self._forward_stats: list = []

        # -- resilience layer (reliability/) ------------------------------
        # All knobs default off: no policy, no breakers, no spill — every
        # egress path keeps the reference's single-attempt
        # drop-on-failure behavior byte for byte.
        from veneur_tpu_torch.utils.hashing import fnv1a_64
        self.retry_policy = None
        if cfg.sink_retry_max > 0:
            # hostname-derived seed: deterministic per instance, but a
            # fleet's retry storms decorrelate across hosts
            self.retry_policy = RetryPolicy(
                max_retries=cfg.sink_retry_max,
                base_ms=cfg.sink_retry_base_ms,
                seed=fnv1a_64(cfg.hostname.encode()))
        # one breaker per sink INSTANCE, shared between the fan-out gate
        # and the sink's own ResilientSink harness so veneur.circuit.state
        # reads a single state machine per destination
        self._sink_breakers: dict = {}      # id(sink) -> CircuitBreaker
        self._forward_breaker = None
        if cfg.circuit_failure_threshold > 0:
            for s in self.metric_sinks + self.span_sinks:
                self._sink_breakers[id(s)] = CircuitBreaker(
                    cfg.circuit_failure_threshold, cfg.circuit_cooldown_s)
            if cfg.is_local and cfg.forward_address:
                self._forward_breaker = CircuitBreaker(
                    cfg.circuit_failure_threshold, cfg.circuit_cooldown_s)
        if self.retry_policy is not None or self._sink_breakers:
            for s in self.metric_sinks + self.span_sinks:
                if isinstance(s, ResilientSink):
                    s.configure_resilience(self.retry_policy,
                                           self._sink_breakers.get(id(s)))
        self.forward_spill = None
        if cfg.forward_spill_max_bytes > 0:
            from veneur_tpu_torch.reliability.spill import ForwardSpillBuffer
            self.forward_spill = ForwardSpillBuffer(
                cfg.forward_spill_max_bytes, cfg.forward_spill_max_age_s)

        # -- exactly-once forwarding (forward/envelope.py) -----------------
        # Off by default (forward_dedup_window == 0): no envelopes, no
        # dedup state. With a window, this server deduplicates every
        # enveloped import it receives; a LOCAL with a forward_address
        # also mints a source identity and ack-gates its spill buffer
        # (the spill becomes the durable send queue, reliability/spill.py).
        self._dedup = None
        self._fwd_source_id = None
        self._fwd_epoch = 0
        self._fwd_next_seq = 0
        self._fwd_acked_seq = -1
        self._fwd_meta_lock = threading.Lock()
        self._fwd_send_lock = threading.Lock()
        if cfg.forward_dedup_window > 0:
            from veneur_tpu_torch.forward.envelope import (DedupWindow,
                                                           mint_source_id)
            self._dedup = DedupWindow(
                cfg.forward_dedup_window,
                max_sources=cfg.forward_dedup_max_sources)
            if cfg.is_local and cfg.forward_address:
                self._fwd_source_id = mint_source_id()
                if self.forward_spill is None:
                    # ack-gating needs the spill as its send queue even
                    # when the merge-on-retry buffer wasn't configured
                    from veneur_tpu_torch.reliability.spill import (
                        ForwardSpillBuffer)
                    self.forward_spill = ForwardSpillBuffer(
                        32 << 20, cfg.forward_spill_max_age_s)

        # -- overload management (reliability/overload.py) ----------------
        # Off by default: no controller object, and every hot-path gate
        # is a single `is not None` check.
        self._overload = None
        # -- multi-tenant fairness (reliability/tenancy.py) ----------------
        # Off by default: no identity extraction anywhere. With tenancy
        # on, the TenantFairness ledger exists even without the overload
        # controller; its fairness buckets only bite at SHEDDING+ through
        # the controller.
        self.tenancy = None
        self._tenant_restore_entries = None
        if cfg.tenant_enabled:
            from veneur_tpu_torch.reliability.tenancy import TenantFairness
            self.tenancy = TenantFairness(
                tag=cfg.tenant_tag,
                weights=cfg.tenant_weights,
                base_rate=cfg.tenant_fair_rate,
                burst_mult=cfg.tenant_fair_burst_mult,
                quarantine_max_keys=cfg.tenant_quarantine_max_keys,
                quarantine_decay=cfg.tenant_quarantine_decay,
                quarantine_readmit_frac=cfg.tenant_quarantine_readmit_frac)
        if cfg.overload_enabled:
            from veneur_tpu_torch.reliability.overload import (
                OverloadController)
            self._overload = OverloadController(
                signals=self._overload_signals,
                enter_pressured=cfg.overload_enter_pressured,
                enter_shedding=cfg.overload_enter_shedding,
                enter_critical=cfg.overload_enter_critical,
                exit_margin=cfg.overload_exit_margin,
                hold_s=cfg.overload_hold_s,
                admit_rate=cfg.overload_admit_rate,
                admit_burst=cfg.overload_admit_burst,
                timer_sample_rate=cfg.overload_timer_sample_rate,
                set_shift=cfg.overload_set_shift,
                shed_priority_tags=cfg.shed_priority_tags,
                tenancy=self.tenancy)

        # -- elastic live resharding (reshard/) ----------------------------
        # Off by default: no coordinator, and the flush path's gate is one
        # `is not None` check. The collective tier lays out its own mesh,
        # so the two exclude each other.
        self._resharding = False
        self.reshard = None
        if cfg.reshard_enabled and not cfg.collective_enabled:
            from veneur_tpu_torch.reshard import ReshardCoordinator
            self.reshard = ReshardCoordinator(self)

        # -- self-adjusting key tables (tables/) ----------------------------
        # Off by default: no manager, no pressure ladder, and the flush
        # path's grow gate is a single `is not None` check.
        # The collective tier does not resize live, so the manager is not
        # armed there.
        self.tables = None
        if cfg.table_grow_enabled and not cfg.collective_enabled:
            from veneur_tpu_torch.tables import TableManager, TablePressure
            self.tables = TableManager(
                self.aggregator.spec,
                n_shards=getattr(self.aggregator, "n_shards", 1),
                max_capacity=cfg.table_max_capacity,
                idle_ttl_s=cfg.table_idle_ttl_s)
            if not self._native:
                # the pressure ladder rides the Python key tables; the
                # C++ engine keeps exact counted drops (absorbed by the
                # next grow) instead
                pressure = TablePressure(
                    salsa_enabled=cfg.table_salsa_enabled)
                self.tables.pressure = pressure
                self.aggregator.set_pressure(pressure)

        # -- TCP statsd hardening -----------------------------------------
        # live-connection accounting for tcp_max_connections; the idle
        # deadline lives in _tcp_conn
        self._tcp_conn_lock = threading.Lock()
        self._tcp_conns_live = 0

        # per-metric-sink flush accounting for the sink.* conventions
        # (sinks/sinks.go:11-29), accumulated by sink flush threads; fan-out
        # retry counts per sink (plain sinks only; ResilientSink sinks
        # count their own)
        self._sink_stats_lock = threading.Lock()
        self._sink_flush_stats: dict = {}
        self._sink_flush_errors: dict = {}
        self._fanout_retries: dict = {}
        self._packets_received = 0
        self._packets_dropped_py = 0
        self._packets_toolong_py = 0
        # orders shutdown's reader-counter fold against concurrent
        # packets_received/packets_dropped reads on the flush thread
        self._reader_fold_lock = threading.Lock()
        self._shutdown = threading.Event()
        # created eagerly when configured: _emit_stats_address is called
        # from both the flush worker and the span-flush thread, and a
        # lazy-init race would leak a socket
        self._stats_sock: Optional[socket.socket] = None
        self._stats_dest = None
        if cfg.stats_address:
            from veneur_tpu_torch.utils.statsd_emit import parse_addr
            try:
                self._stats_dest = parse_addr(cfg.stats_address)
                self._stats_sock = socket.socket(socket.AF_INET,
                                                 socket.SOCK_DGRAM)
            except ValueError as e:
                # a typo'd stats_address degrades the mirror, never the
                # server
                log.warning("bad stats_address %r: %s; stats mirror "
                            "disabled", cfg.stats_address, e)
        self._unix_locks: List[tuple] = []   # (lock_fd, lock_path, sock_path)
        self._threads: List[threading.Thread] = []
        self._pipeline_thread: Optional[threading.Thread] = None
        self._flush_thread: Optional[threading.Thread] = None
        self._aux_threads: List[threading.Thread] = []
        self._aux_lock = threading.Lock()
        self._sockets: List[socket.socket] = []
        self._forward_client = None
        # participant row in an attached collective tier, assigned by the
        # tier at the first co-located absorb
        self._collective_participant = None
        self._grpc_server = None
        self.grpc_port = None
        self._httpd = None
        self.http_port = None
        # -- durability layer (persistence/) --------------------------------
        # Off by default (empty checkpoint_dir): no writer thread, no
        # extra work anywhere in the flush path. /readyz waits for a
        # configured restore.
        self._ckpt_writer = None
        self._flushes_since_ckpt = 0
        self._restore_complete = not (cfg.checkpoint_dir
                                      and cfg.restore_on_start)
        if cfg.checkpoint_dir:
            from veneur_tpu_torch.persistence import CheckpointWriter
            self._ckpt_writer = CheckpointWriter(
                cfg.checkpoint_dir, retain=max(1, cfg.checkpoint_retain),
                write_timer=self._t_ckpt_write,
                bytes_counter=self._c_ckpt_bytes,
                writes_counter=self._c_ckpt_writes)
        # -- history tier (history/) ---------------------------------------
        # Off by default: no ring on the device, flushes run the plain
        # program. Server-scoped on purpose: the writer's key index
        # outlives interval tables (windows are addressed by key
        # identity, not by slot). The ring is allocated at the first flush.
        self.history = None
        if cfg.history_enabled:
            from veneur_tpu_torch.history import HistorySpec, HistoryWriter
            hspec = HistorySpec.for_table(
                spec_from_config(cfg),
                windows=cfg.history_windows,
                tiers=cfg.history_decimation_tiers,
                max_keys=cfg.history_max_keys)
            self.history = HistoryWriter(
                hspec, interval_s=self.interval, device=self.device,
                c_writes=self._c_history_writes,
                c_evictions=self._c_history_evictions,
                c_range=self._c_history_range_queries,
                g_hbm=self._g_history_hbm_bytes)
        # -- query tier (query/) -------------------------------------------
        # Off by default: no batcher thread, POST /query answers 404.
        self.query_engine = None
        if cfg.query_enabled:
            from veneur_tpu_torch.query import QueryEngine
            self.query_engine = QueryEngine(
                self, max_batch=cfg.query_max_batch,
                timeout_ms=cfg.query_timeout_ms,
                requests=self._c_query_requests,
                batched=self._c_query_batched,
                duration=self._t_query,
                stale_reads=self._c_reshard_stale,
                history=self.history)
        # -- watch tier (watch/) -------------------------------------------
        # Off by default: no engine thread, the /watch routes answer 404.
        self.watch_engine = None
        if cfg.watch_enabled:
            from veneur_tpu_torch.watch import WatchEngine
            self.watch_engine = WatchEngine(
                self, max_active=cfg.watch_max_active,
                max_subscribers=cfg.watch_stream_max_subscribers,
                webhook_url=cfg.watch_webhook_url,
                retry_policy=self.retry_policy,
                evaluated=self._c_watch_evaluated,
                fired=self._c_watch_fired,
                suppressed=self._c_watch_suppressed,
                dropped=self._c_watch_notify_dropped,
                eval_ns=self._c_watch_eval_ns,
                active=self._g_watch_active,
                history=self.history)
        # last: every attribute a collector closes over now exists
        self._register_collectors()

    def _batch_spec(self) -> BatchSpec:
        cfg = self.cfg
        return BatchSpec(counter=cfg.tpu_batch_counter,
                         gauge=cfg.tpu_batch_gauge,
                         status=cfg.tpu_batch_status, set=cfg.tpu_batch_set,
                         histo=cfg.tpu_batch_histo)

    def _make_aggregator(self, n_shards: int, engine=None, spec=None):
        """The backend for `n_shards` from the current config, on the
        server's device: with n_shards > 1 the sharded backend
        (NativeShardedAggregator with native_ingest, the default, else
        ShardedAggregator), otherwise the C++ engine's NativeAggregator or
        the Python-parsing Aggregator. Returns (aggregator, is_native).
        tables/growth.py passes the running `engine`, whose reader rings
        keep feeding the same handle across the rebuild, and the grown
        `spec`. The collective tier has its own construction path in
        __init__ and does not resize live."""
        cfg = self.cfg
        args = dict(
            spec=spec if spec is not None else spec_from_config(cfg),
            bspec=self._batch_spec(), device=self.device,
            compact_every=cfg.tpu_compact_every)
        n_shards = max(1, int(n_shards))
        if n_shards > 1:
            if cfg.native_ingest:
                from veneur_tpu_torch.server.native_aggregator import (
                    NativeShardedAggregator)
                return NativeShardedAggregator(
                    n_shards=n_shards, preshard=cfg.native_preshard_enabled,
                    engine=engine, **args), True
            from veneur_tpu_torch.server.sharded_aggregator import (
                ShardedAggregator)
            return ShardedAggregator(n_shards=n_shards, **args), False
        if cfg.native_ingest:
            from veneur_tpu_torch.server.native_aggregator import (
                NativeAggregator)
            return NativeAggregator(engine=engine, **args), True
        return Aggregator(**args), False

    def _register_instruments(self) -> None:
        """The registry's owned instruments. Families of features this
        package has not ported yet are registered all the same, so the
        inventory (and every exposition of it) matches the JAX package's;
        they stay zero."""
        M = self.metrics
        self._c_parse_errors = M.counter(
            "veneur.parse_errors_total",
            "statsd/SSF payloads that failed to parse (Python layer)")
        self._c_import_errors = M.counter(
            "veneur.import.errors_total",
            "imported metrics rejected by /import or gRPC ingest")
        self._c_internal_errors = M.counter(
            "veneur.pipeline.internal_errors_total",
            "work items caught by the pipeline thread's backstop")
        self._c_imported = M.counter(
            "veneur.import.metrics_total",
            "metrics accepted from the forward/import tier")
        self._c_forward_errors = M.counter(
            "veneur.forward.error_total", "failed forward sends")
        self._c_forward_sends = M.counter(
            "veneur.forward.sends_total", "completed forward sends")
        self._c_forward_retries = M.counter(
            "veneur.forward.retries_total", "forward send retry attempts")
        self._c_dup_suppressed = M.counter(
            "veneur.forward.dup_suppressed_total",
            "already-folded forward intervals suppressed by the dedup "
            "window (duplicates are still acked so senders evict)")
        self._c_envelope_rejected = M.counter(
            "veneur.forward.envelope_rejected_total",
            "forward imports rejected for malformed or out-of-bound "
            "(source_id, epoch, seq) envelopes — never folded")
        # the co-located collective absorb (collective/tier.py),
        # registered with the tier off too, so the inventory is stable
        self._c_coll_rows = M.counter(
            "veneur.collective.absorbed_rows_total",
            "forwardable rows handed to the co-located collective tier "
            "as device arrays instead of gRPC")
        self._c_coll_errors = M.counter(
            "veneur.collective.absorb_errors_total",
            "co-located collective absorbs that failed (the interval "
            "falls back to the wire forward path)")
        self._c_flush_count = M.counter(
            "veneur.flush.completed_total",
            "flush intervals run to completion (success or failure)")
        self._c_intervals_deferred = M.counter(
            "veneur.flush.intervals_deferred_total",
            "intervals deferred because the flush worker was backlogged")
        self._c_sink_skips = M.counter(
            "veneur.flush.skipped_total",
            "per-sink interval flushes skipped (slow sink / open circuit)")
        self._c_metrics_scrapes = M.counter(
            "veneur.metrics.scrapes_total", "GET /metrics scrapes served")
        self._t_flush_phase = M.timer(
            "veneur.flush.phase_duration_ns",
            "per-phase flush wall time, sketched by the in-house t-digest",
            labelnames=("phase",))
        self._t_sink_flush = M.timer(
            "veneur.sink.flush_duration_ns",
            "one sink flush call, success or failure",
            labelnames=("sink",))
        # injected into an attached tier (set_phase_timer), so the tier
        # module stays registry-free
        self._t_coll_phase = M.timer(
            "veneur.collective.phase_duration_ns",
            "collective tier phase wall time: stage, all_to_all_route, "
            "replica_merge, flush", labelnames=("phase",))
        # native ring emit latency, observed as a per-flush delta
        # average of the C++ emit_packed counters (zero hot-path cost)
        self._t_ring_emit = M.timer(
            "veneur.ring.emit_packed_duration_ns",
            "average packed-emit call latency over the last flush "
            "interval (C++ vt_emit_packed, steady_clock)")
        self._ring_emit_prev = (0, 0)
        self._c_ckpt_writes = M.counter(
            "veneur.checkpoint.writes_total",
            "checkpoint snapshots durably written")
        self._c_ckpt_bytes = M.counter(
            "veneur.checkpoint.bytes",
            "serialized snapshot bytes written (manifest + chunks)")
        self._c_ckpt_restores = M.counter(
            "veneur.checkpoint.restores_total",
            "snapshots folded into a starting server")
        self._c_ckpt_corrupt = M.counter(
            "veneur.checkpoint.corrupt_total",
            "snapshots rejected by checksum/schema validation and "
            "quarantined")
        self._t_ckpt_write = M.timer(
            "veneur.checkpoint.write_duration_ns",
            "one checkpoint serialize+fsync on the writer thread")
        self._c_tcp_rejected = M.counter(
            "veneur.tcp.rejected_total",
            "TCP statsd connections refused at tcp_max_connections")
        self._c_tcp_idle_closed = M.counter(
            "veneur.tcp.idle_closed_total",
            "TCP statsd connections closed at the idle deadline")
        self._c_query_requests = M.counter(
            "veneur.query.requests_total",
            "individual queries accepted by POST /query (one request "
            "body may carry several)")
        self._c_query_batched = M.counter(
            "veneur.query.batched_launches_total",
            "device launches the query batcher coalesced concurrent "
            "reads into")
        self._c_query_shed = M.counter(
            "veneur.query.shed_total",
            "queries shed with 503: overload CRITICAL or shutdown "
            "(exact drop accounting — one inc per refused request)")
        self._t_query = M.timer(
            "veneur.query.duration_ns",
            "end-to-end batched query service time: snapshot "
            "round-trip + device launch + response assembly")
        self._c_reshard_moves = M.counter(
            "veneur.reshard.moves_total",
            "live mesh resizes completed (drain + transfer + cutover)")
        self._c_reshard_rows_moved = M.counter(
            "veneur.reshard.rows_moved_total",
            "rows whose owner shard changed under a resize and were "
            "folded into the new mesh exactly once")
        self._c_reshard_failed = M.counter(
            "veneur.reshard.failed_total",
            "resizes abandoned: transfer timeout, fold failure after "
            "replays, or invalid target")
        self._c_reshard_stale = M.counter(
            "veneur.reshard.stale_reads_total",
            "queries answered during a transfer from the serving table "
            "before all moved rows folded (stale-bounded by one flush "
            "interval)")
        self._t_reshard = M.timer(
            "veneur.reshard.duration_ns",
            "one live resize end to end: drain swap through final fold")
        self._g_watch_active = M.gauge(
            "veneur.watch.active",
            "standing watches currently registered, by watch kind",
            labelnames=("kind",))
        self._c_watch_evaluated = M.counter(
            "veneur.watch.evaluated_total",
            "watch evaluations performed (one per active watch per "
            "evaluated interval)", labelnames=("kind",))
        self._c_watch_fired = M.counter(
            "veneur.watch.fired_total",
            "watch state transitions into ALERT", labelnames=("kind",))
        self._c_watch_suppressed = M.counter(
            "veneur.watch.suppressed_total",
            "breaches that did not transition (debounce pending or "
            "hysteresis hold) plus per-watch evaluations lost to a "
            "skipped interval (exact accounting)",
            labelnames=("kind",))
        self._c_watch_notify_dropped = M.counter(
            "veneur.watch.notify_dropped_total",
            "transition notifications lost: SSE subscriber queue "
            "drop-oldest + terminal webhook failures (one inc per "
            "lost event)", labelnames=("kind",))
        self._c_watch_eval_ns = M.counter(
            "veneur.watch.eval_ns_total",
            "watch-engine-thread time per evaluated interval")
        self._c_history_writes = M.counter(
            "veneur.history.writes_total",
            "per-key window values written into the history ring (one "
            "per live key per flushed interval)")
        self._c_history_evictions = M.counter(
            "veneur.history.evictions_total",
            "ring rows reclaimed from their least-recently-flushed "
            "key plus window writes turned away with every row in "
            "current use (the ring is a bounded cache)")
        self._c_history_range_queries = M.counter(
            "veneur.history.range_queries_total",
            "range queries planned against the ring (each POST /query "
            "item carrying a range counts once)")
        self._g_history_hbm_bytes = M.gauge(
            "veneur.history.hbm_bytes",
            "device-resident bytes of the history ring (0 while the "
            "tier is off)")

    def _register_collectors(self) -> None:
        """Read-through registry collectors for values owned elsewhere:
        packet counters folded from the C++ reader group, aggregator
        device accounting, the reliability layer's breakers, device
        memory. Evaluated only at collect time (/metrics scrape, /stats,
        self-metric flush) — zero hot-path cost. Families of features not
        ported yet read no series. The JAX package's veneur.jax.* compile
        counters have no analogue here: the port compiles its kernels
        once, with nvcc, before the server starts."""
        from veneur_tpu_torch.observability import runtime
        M = self.metrics
        M.callback("veneur.packets_received_total",
                   lambda: self.packets_received, kind="counter",
                   help="datagrams delivered (Python + C++ readers)")
        M.callback("veneur.packets_dropped_total",
                   lambda: self.packets_dropped, kind="counter",
                   help="datagrams lost to backpressure after delivery")
        M.callback("veneur.packet.error_toolong_total",
                   lambda: self.packets_toolong, kind="counter",
                   help="datagrams dropped whole: over metric_max_length")
        M.callback("veneur.worker.metrics_processed_total",
                   lambda: self.aggregator.processed, kind="counter",
                   help="metrics staged into the device table")
        M.callback("veneur.worker.metrics_dropped_total",
                   lambda: self.aggregator.dropped_capacity, kind="counter",
                   help="metrics dropped at table capacity")
        M.callback("veneur.spans_received_total",
                   lambda: self.span_pipeline.spans_received, kind="counter",
                   help="SSF spans accepted by the span pipeline")
        M.callback("veneur.device.h2d_bytes_total",
                   lambda: self.aggregator.h2d_bytes, kind="counter",
                   help="packed ingest bytes shipped host-to-device")
        M.callback("veneur.device.step_ns_total",
                   lambda: self.aggregator.step_ns, kind="counter",
                   help="device ingest-step wall time including the "
                        "sampled device sync (host side)")
        M.callback("veneur.device.dispatch_ns_total",
                   lambda: self.aggregator.dispatch_ns, kind="counter",
                   help="device ingest-step dispatch-only wall time — "
                        "async enqueue cost, no sync (host side)")
        M.callback("veneur.device.steps_total",
                   lambda: self.aggregator.steps_total, kind="counter",
                   help="device ingest steps dispatched")
        M.callback("veneur.device.steps_synced_total",
                   lambda: self.aggregator.steps_synced, kind="counter",
                   help="ingest steps that waited for the device "
                        "(1-in-N sample plus swap boundaries)")
        M.callback("veneur.device.hbm_bytes_in_use",
                   runtime.hbm_bytes_in_use, labelnames=("device",),
                   help="tensor bytes allocated per card "
                        "(torch.cuda.memory_stats; absent without a card)")
        M.callback("veneur.device.hbm_bytes_peak",
                   runtime.hbm_bytes_peak, labelnames=("device",),
                   help="peak tensor bytes allocated per card "
                        "(torch.cuda.memory_stats; absent without a card)")
        # native ring (C++ vr_stats snapshot; mutex-guarded counters +
        # relaxed parser atomics, safe to read while the pipeline emits)
        for name, key, kind, text in (
                ("veneur.ring.depth", "ring_depth", "gauge",
                 "parsed datagrams waiting in the native ring"),
                ("veneur.ring.depth_highwater", "ring_highwater", "gauge",
                 "deepest the native ring has been since start"),
                ("veneur.ring.pump_batches_total", "pump_batches",
                 "counter", "non-empty batches drained by pipeline_pump"),
                ("veneur.ring.buffer_swap_stalls_total", "pump_stalls",
                 "counter", "pump drains that hit the staging-buffer cap "
                 "(double-buffer swap had to wait on the device)"),
                ("veneur.ring.emit_packed_total", "emit_packed_calls",
                 "counter", "packed-emit calls made by the C++ engine"),
                ("veneur.ring.emit_packed_ns_total", "emit_packed_ns",
                 "counter", "wall time inside C++ vt_emit_packed")):
            M.callback(name, lambda k=key: float(self._ring_stats().get(k, 0)),
                       kind=kind, help=text)
        # per-ring family (multi-ring engine only; empty single-ring).
        # The unlabeled veneur.ring.* names above stay the EXACT
        # cross-ring aggregates.
        for name, key, kind, text in (
                ("veneur.ring.per_ring_depth", "ring_depth", "gauge",
                 "parsed datagrams waiting, per native ring"),
                ("veneur.ring.per_ring_depth_highwater", "ring_highwater",
                 "gauge", "deepest each native ring has been since start"),
                ("veneur.ring.per_ring_datagrams_total", "datagrams",
                 "counter", "datagrams accepted per native ring"),
                ("veneur.ring.per_ring_dropped_total", "ring_dropped",
                 "counter", "ring-overflow drops per native ring"),
                ("veneur.ring.per_ring_parse_batches_total", "pump_batches",
                 "counter", "datagram parse batches per ring worker"),
                ("veneur.ring.per_ring_stalls_total", "pump_stalls",
                 "counter", "lane-full parser stalls per native ring"),
                ("veneur.ring.per_ring_emit_packed_total",
                 "emit_packed_calls", "counter",
                 "packed arena-row emits per native ring")):
            M.callback(name, lambda k=key: self._collect_per_ring(k),
                       kind=kind, labelnames=("ring",), help=text)
        M.callback("veneur.faults.injected_total",
                   lambda: FAULTS.injected_total, kind="counter",
                   help="chaos faults fired by the process-global injector")
        # the same collectors _report_self_metrics deltas against, so JSON
        # stats, the self-metric flush, and /metrics can never disagree
        M.callback("veneur.sink.retries_total", self._collect_sink_retries,
                   kind="counter", labelnames=("sink",),
                   help="egress retries per destination "
                        "(fan-out + sink harness + forward)")
        M.callback("veneur.sink.posts_skipped_open_total",
                   self._collect_posts_skipped, kind="counter",
                   labelnames=("sink",),
                   help="sink network calls refused by an open circuit")
        M.callback("veneur.circuit.state", self._collect_circuit_state,
                   kind="gauge", labelnames=("sink",),
                   help="breaker state: 0 closed / 1 half-open / 2 open")
        M.callback("veneur.circuit.opens_total",
                   self._collect_circuit_opens, kind="counter",
                   labelnames=("sink",),
                   help="closed-to-open breaker transitions")
        M.callback("veneur.checkpoint.age_s",
                   lambda: (time.time() - self._ckpt_writer.last_write_ts
                            if self._ckpt_writer is not None
                            and self._ckpt_writer.last_write_ts else None),
                   help="seconds since the last durable checkpoint")
        M.callback("veneur.forward.spill_bytes",
                   lambda: (self.forward_spill.bytes
                            if self.forward_spill is not None else None),
                   help="mergeable sketch bytes awaiting re-forward")
        M.callback("veneur.forward.spill.spilled_total",
                   lambda: (self.forward_spill.spilled_total
                            if self.forward_spill is not None else None),
                   kind="counter",
                   help="metrics spilled after failed forwards")
        M.callback("veneur.forward.spill.dropped_total",
                   lambda: (self.forward_spill.dropped_total
                            if self.forward_spill is not None else None),
                   kind="counter",
                   help="spilled metrics dropped at the cap or max age")
        M.callback("veneur.forward.acked_seq",
                   lambda: (float(self._fwd_acked_seq)
                            if self._fwd_source_id is not None
                            and self._fwd_acked_seq >= 0 else None),
                   help="highest sequence number the receiving tier has "
                        "acked in the current epoch")
        M.callback("veneur.dedup.window_evictions_total",
                   lambda: (float(self._dedup.evictions)
                            if self._dedup is not None else None),
                   kind="counter",
                   help="dedup streams evicted at the "
                        "forward_dedup_max_sources LRU bound")
        # overload management: None/[] while the controller is off keeps
        # the series out of the exposition, as spill/checkpoint above
        M.callback("veneur.overload.state",
                   lambda: (float(self._overload.state)
                            if self._overload is not None else None),
                   help="health state: 0 healthy / 1 pressured / "
                        "2 shedding / 3 critical")
        M.callback("veneur.overload.pressure",
                   lambda: (self._overload.pressure
                            if self._overload is not None else None),
                   help="max normalized pressure signal, 0..1")
        M.callback("veneur.overload.shed_total",
                   lambda: (self._overload.shed_snapshot()
                            if self._overload is not None else []),
                   kind="counter", labelnames=("class",),
                   help="samples refused by admission control or flush "
                        "protection, by priority class")
        M.callback("veneur.overload.admitted_total",
                   lambda: (float(self._overload.admitted_total)
                            if self._overload is not None else None),
                   kind="counter",
                   help="packets admitted past the overload controller")
        M.callback("veneur.overload.degraded_flushes_total",
                   lambda: (float(self._overload.degraded_flushes)
                            if self._overload is not None else None),
                   kind="counter",
                   help="flushes published with degraded aggregation "
                        "corrections or CRITICAL fan-out filtering")
        M.callback("veneur.overload.degraded_samples_total",
                   self._collect_degraded_samples, kind="counter",
                   labelnames=("kind",),
                   help="samples statistically subsumed (not staged) by "
                        "degraded timer sampling / set subsampling")
        # multi-tenant fairness: [] while tenancy is off keeps the
        # labeled families out of the exposition
        M.callback("veneur.tenant.admitted_total",
                   lambda: (self.tenancy.admitted_snapshot()
                            if self.tenancy is not None else []),
                   kind="counter", labelnames=("tenant",),
                   help="datagrams admitted past admission, by tenant")
        M.callback("veneur.tenant.shed_total",
                   lambda: (self.tenancy.shed_snapshot()
                            if self.tenancy is not None else []),
                   kind="counter", labelnames=("tenant",),
                   help="datagrams refused by admission, by tenant")
        M.callback("veneur.tenant.quarantined",
                   lambda: (self.tenancy.quarantined_snapshot()
                            if self.tenancy is not None else []),
                   labelnames=("tenant",),
                   help="1 while the tenant is demoted to aggregate-only "
                        "rollup rows by the tag-explosion detector")
        M.callback("veneur.tenant.demoted_rows_total",
                   lambda: (self.tenancy.demoted_rows_snapshot()
                            if self.tenancy is not None else []),
                   kind="counter", labelnames=("tenant",),
                   help="rows collapsed onto per-tenant rollup keys "
                        "while quarantined (exact)")
        # self-adjusting key tables: [] while growth is off
        M.callback("veneur.table.grows_total",
                   lambda: (self.tables.grows_snapshot()
                            if self.tables is not None else []),
                   kind="counter", labelnames=("kind",),
                   help="capacity grow swaps executed at the flush "
                        "boundary, by table kind")
        M.callback("veneur.table.capacity",
                   lambda: (self.tables.capacity_snapshot(
                            self.aggregator.spec)
                            if self.tables is not None else []),
                   labelnames=("kind",),
                   help="current per-kind key-table capacity (rows)")
        M.callback("veneur.table.evicted_total",
                   lambda: (self.tables.evicted_snapshot()
                            if self.tables is not None else []),
                   kind="counter", labelnames=("kind",),
                   help="keys reclaimed by the idle-TTL census "
                        "(table_idle_ttl_s), exact")
        M.callback("veneur.table.merged_cells_total",
                   lambda: (self.tables.pressure.merged_snapshot()
                            if self.tables is not None
                            and self.tables.pressure is not None else []),
                   kind="counter", labelnames=("kind",),
                   help="distinct long-tail keys redirected into SALSA "
                        "merge cells under table pressure (exact; "
                        "additive error bounded by the cell total)")
        M.callback("veneur.table.demoted_rows_total",
                   lambda: (self.tables.pressure.demoted_snapshot()
                            if self.tables is not None
                            and self.tables.pressure is not None else []),
                   kind="counter", labelnames=("kind",),
                   help="tag variants collapsed onto per-key-family "
                        "rollup rows by the explosion detector (exact)")

    # -- registry collector helpers -----------------------------------------
    def _ring_stats(self) -> dict:
        """Native ring snapshot, or {} on servers without the C++
        engine (collectors then read their zero defaults)."""
        fn = getattr(self.aggregator, "ring_stats", None)
        return fn() if fn is not None else {}

    def _collect_per_ring(self, key: str):
        """Labeled sample list for one per-ring stat: [((ring,), v)].
        Empty (no exposition rows) outside multi-ring mode. Allocation
        happens at collection cadence only — never on the ingest path."""
        fn = getattr(self.aggregator, "ring_stats_per_ring", None)
        if fn is None:
            return []
        return [((str(i),), float(st.get(key, 0)))
                for i, st in enumerate(fn())]

    def _poll_ring_telemetry(self) -> None:
        """Flush-interval poll: turn the cumulative C++ emit counters
        into one per-interval average-latency observation. Runs on the
        flush worker thread only (the prev-tuple needs no lock)."""
        st = self._ring_stats()
        calls = int(st.get("emit_packed_calls", 0))
        ns = int(st.get("emit_packed_ns", 0))
        pc, pn = self._ring_emit_prev
        if calls > pc:
            self._t_ring_emit.observe((ns - pn) / (calls - pc))
        self._ring_emit_prev = (calls, ns)

    def _breaker_list(self):
        out = [(s.name, self._sink_breakers[id(s)])
               for s in self.metric_sinks + self.span_sinks
               if id(s) in self._sink_breakers]
        if self._forward_breaker is not None:
            out.append(("forward", self._forward_breaker))
        return out

    def _collect_circuit_state(self):
        # fold same-named sink instances to the WORST state — duplicate
        # label sets are invalid exposition
        by_name: dict = {}
        for name, b in self._breaker_list():
            by_name[name] = max(by_name.get(name, 0), b.state)
        return [((name,), float(v)) for name, v in sorted(by_name.items())]

    def _collect_circuit_opens(self):
        by_name: dict = {}
        for name, b in self._breaker_list():
            by_name[name] = by_name.get(name, 0) + b.opens_total
        return [((name,), float(v)) for name, v in sorted(by_name.items())
                if v]

    def _collect_sink_retries(self):
        totals: dict = {}
        with self._sink_stats_lock:
            for name, n in self._fanout_retries.items():
                totals[name] = totals.get(name, 0) + n
        fwd = self._c_forward_retries.value()
        if fwd:
            totals["forward"] = totals.get("forward", 0) + fwd
        for s in self.metric_sinks + self.span_sinks:
            if isinstance(s, ResilientSink):
                own = s.reliability_counters()[0]
            else:
                own = getattr(s, "retries_total", 0)
            if own:
                totals[s.name] = totals.get(s.name, 0) + own
        return [((name,), float(n)) for name, n in sorted(totals.items())]

    def _collect_posts_skipped(self):
        totals: dict = {}
        for s in self.metric_sinks + self.span_sinks:
            if isinstance(s, ResilientSink):
                n = s.reliability_counters()[1]
                if n:
                    totals[s.name] = totals.get(s.name, 0) + n
        return [((name,), float(n)) for name, n in sorted(totals.items())]

    def _collect_degraded_samples(self):
        if self._overload is None:
            return []
        return [(("timer",),
                 float(getattr(self.aggregator, "degraded_timer_skipped", 0))),
                (("set",),
                 float(getattr(self.aggregator, "degraded_set_skipped", 0)))]

    # -- overload pressure signals ------------------------------------------
    def _overload_signals(self):
        """One {name: pressure} sample, each normalized to [0, 1] against
        that resource's capacity. The controller takes the max: one
        saturated resource is an overloaded server. Every signal is
        defensive: a broken source reads nothing for a tick rather than
        killing the poller."""
        sig: dict = {}
        try:
            sig["packet_queue"] = (self.packet_queue.qsize()
                                   / max(1, self.packet_queue.maxsize))
        except Exception as e:
            log.debug("overload signal packet_queue failed: %s", e)
        try:
            sig["flush_jobs"] = (self._flush_jobs.qsize()
                                 / max(1, self._flush_jobs.maxsize))
        except Exception as e:
            log.debug("overload signal flush_jobs failed: %s", e)
        try:
            # flush lag against the staleness budget the watchdog and
            # /healthz use; 1.0 == "the watchdog would fire now"
            stale = time.time() - min(self.last_flush, self.last_flush_done)
            missed = self.cfg.flush_watchdog_missed_flushes
            budget = (missed * self.interval if missed and missed > 0
                      else 10.0 * self.interval + 60.0)
            sig["flush_lag"] = max(0.0, stale / budget)
        except Exception as e:
            log.debug("overload signal flush_lag failed: %s", e)
        try:
            # key-table capacity drops since the previous poll: any delta
            # means rows are already being lost, so saturate at once
            drops = self.aggregator.dropped_capacity
            prev = getattr(self, "_ov_prev_capacity_drops", None)
            self._ov_prev_capacity_drops = drops
            sig["capacity_drops"] = (1.0 if prev is not None
                                     and drops > prev else 0.0)
        except Exception as e:
            log.debug("overload signal capacity_drops failed: %s", e)
        try:
            if self.forward_spill is not None \
                    and self.cfg.forward_spill_max_bytes > 0:
                sig["spill_bytes"] = (self.forward_spill.bytes
                                      / self.cfg.forward_spill_max_bytes)
        except Exception as e:
            log.debug("overload signal spill_bytes failed: %s", e)
        try:
            # an open forward breaker parks the server in PRESSURED (0.75
            # sits between the default pressured and shedding thresholds)
            if self._forward_breaker is not None \
                    and self._forward_breaker.state == OPEN:
                sig["forward_breaker"] = 0.75
        except Exception as e:
            log.debug("overload signal forward_breaker failed: %s", e)
        try:
            w = self._ckpt_writer
            if w is not None and w.last_write_ts:
                cadence = max(1, self.cfg.checkpoint_interval_flushes)
                budget = 10.0 * cadence * self.interval + 60.0
                sig["checkpoint_age"] = ((time.time() - w.last_write_ts)
                                         / budget)
        except Exception as e:
            log.debug("overload signal checkpoint_age failed: %s", e)
        try:
            # the native datagram ring: ring depth is the native path's
            # queue pressure, and any ring overflow since the last poll
            # means datagrams are already being lost (saturate)
            if self._native_readers_active:
                rcs = self.aggregator.reader_counters()
                sig["native_ring"] = rcs["ring_depth"] / 65536.0
                drops = rcs["ring_dropped"]
                prev = getattr(self, "_ov_prev_ring_drops", None)
                self._ov_prev_ring_drops = drops
                if prev is not None and drops > prev:
                    sig["native_ring"] = 1.0
        except Exception as e:
            log.debug("overload signal native_ring failed: %s", e)
        return sig

    def _sync_native_admission(self, ov) -> None:
        """Push the controller's statsd admission knobs into the C++
        reader ring(s) and fold their exact per-class decisions back into
        the controller's counters (overload_native_admission; off, the
        native path bypasses admission)."""
        if not (self._native_readers_active
                and self.cfg.overload_native_admission):
            return
        try:
            state, rate, burst, tags = ov.native_admission_params()
            self.aggregator.admission_set(True, state, rate, burst, tags)
            # the drain's "tenants" sub-dict routes through
            # fold_native_counts into the tenancy ledger
            ov.fold_native_counts(self.aggregator.admission_drain())
            self._sync_native_tenancy(drain=False)
        except Exception as e:
            log.warning("native admission sync failed: %s", e)

    def _push_tenant_config(self) -> None:
        """One-time tenant push-down before the rings start (the tag is
        read lock-free on the C++ admission path): create the engine
        table, replay checkpointed quarantine state, seed weights."""
        ten = self.tenancy
        fn = getattr(self.aggregator, "tenant_config", None)
        if ten is None or fn is None:
            return
        try:
            fn(**ten.native_config())
            if self._tenant_restore_entries:
                self.aggregator.tenant_restore(self._tenant_restore_entries)
                self._tenant_restore_entries = None
            base_rate, weights = ten.native_params()
            self.aggregator.tenant_params(base_rate, weights)
        except Exception as e:
            log.warning("tenant config push-down failed: %s", e)

    def _sync_native_tenancy(self, drain: bool) -> None:
        """Per-tick tenant sync with the C++ engine: push base rate and
        weights, refresh the quarantine mirror from the engine table.
        With `drain`, also fold the per-tenant admission deltas into the
        ledger: used only when no overload controller owns that fold."""
        ten = self.tenancy
        if ten is None or not self._native_readers_active \
                or not hasattr(self.aggregator, "tenant_params"):
            return
        try:
            base_rate, weights = ten.native_params()
            self.aggregator.tenant_params(base_rate, weights)
            ten.update_table(self.aggregator.tenant_table())
            if drain:
                drained = self.aggregator.admission_drain()
                if self._overload is not None:
                    self._overload.fold_native_counts(drained)
                elif drained.get("tenants"):
                    ten.fold_native(drained["tenants"])
        except Exception as e:
            log.warning("tenant sync failed: %s", e)

    # -- tag exclusion wiring (server.go:1467-1510) -------------------------
    def _wire_excluded_tags(self):
        base: List[str] = []
        per_sink: dict = {}
        for entry in self.cfg.tags_exclude:
            parts = entry.split("|")
            if len(parts) == 1:
                base.append(entry)
            else:
                for sink_name in parts[1:]:
                    per_sink.setdefault(sink_name, []).append(parts[0])
        for sink in self.metric_sinks:
            sink.set_excluded_tags(base + per_sink.get(sink.name, []))
        # span sinks that opt in get the same rules (server.go:1467
        # setSinkExcludedTags wires BOTH sink kinds)
        for sink in self.span_pipeline.span_sinks:
            if hasattr(sink, "set_excluded_tags"):
                sink.set_excluded_tags(base + per_sink.get(sink.name, []))

    # -- ingest path --------------------------------------------------------
    def handle_metric_packet(self, packet: bytes) -> None:
        """reference server.go:939 HandleMetricPacket."""
        if not packet:
            return
        try:
            if packet.startswith(b"_e{"):
                sample = parser.parse_event(packet)
                with self._event_lock:
                    self.event_samples.append(sample)
            elif packet.startswith(b"_sc"):
                m = parser.parse_service_check(packet)
                self.aggregator.process_metric(m)
            else:
                m = parser.parse_metric(packet)
                self.aggregator.process_metric(m)
        except parser.ParseError as e:
            self._c_parse_errors.inc()
            log.debug("bad packet %r: %s", packet[:64], e)

    def _process_packets(self, data: bytes) -> None:
        """reference server.go:1081 processMetricPacket + SplitBytes. With
        the native engine, the whole buffer (splitting included) is handled
        in C++; only events/service checks come back up. With an overload
        controller the buffer is admitted (or shed, counted per class and
        tenant) before the parse: the cost refused is the parse itself.
        Ring traffic never reaches here; with overload_native_admission
        the same decision runs in the C++ rings."""
        if self._overload is not None \
                and not self._overload.admit(data, "statsd"):
            return
        if self._native:
            for special in self.aggregator.feed(data):
                self.handle_metric_packet(special)
            return
        for line in data.split(b"\n"):
            if line:
                self.handle_metric_packet(line)

    def _pipeline_loop(self):
        """The single device-owning thread (all worker goroutines in one).
        With the native reader group, UDP datagrams bypass packet_queue
        entirely: C++ threads recvmmsg into a ring, and pump() drains it
        here (parse + stage + batch dispatch) with the GIL released while
        idle. packet_queue still carries control items and the non-UDP
        listeners' data."""
        while True:
            # re-checked each pass: start() flips the flag after binding
            # the UDP sockets, which happens after this thread launches
            if self._native_readers_active:
                for special in self.aggregator.pump(20):
                    # through the backstop like every other work item (a
                    # special is one event/service-check line; the extra
                    # native feed() round-trip just re-classifies it)
                    self._dispatch_item(special)
                while True:
                    try:
                        item = self.packet_queue.get_nowait()
                    except queue.Empty:
                        break
                    if item is _STOP:
                        return
                    self._dispatch_item(item)
            else:
                try:
                    item = self.packet_queue.get(timeout=0.05)
                except queue.Empty:
                    continue
                if item is _STOP:
                    return
                self._dispatch_item(item)

    def _dispatch_item(self, item):
        try:
            self._dispatch_item_inner(item)
        except Exception as e:
            # the pipeline thread must NEVER die to a data-plane
            # exception: the backstop for any unknown failure class is
            # here, at the single place every work item passes through
            # (the native pump path routes its specials here too).
            # Counted and logged with traceback; a flush request that died
            # mid-handling must still release its waiter instead of
            # letting trigger_flush block out its whole budget.
            self._c_internal_errors.inc()
            log.exception("pipeline item failed (server continues); "
                          "item=%r", type(item).__name__)
            if isinstance(item, (FlushRequest, PipelineRequest)):
                item.finish(False, f"internal error: {e}")

    def _dispatch_item_inner(self, item):
        if isinstance(item, FlushRequest):
            self._handle_flush_request(item)
        elif isinstance(item, PipelineRequest):
            # query-tier snapshot/launch visits: the FIFO position in this
            # queue is the read-your-writes boundary, and a launch
            # enqueued here precedes any later in-place ingest step on
            # this thread's stream (query/snapshot.py)
            item.run(self.aggregator)
        elif isinstance(item, _ImportBytes):
            t0 = time.perf_counter_ns()
            n, errs = self.aggregator.import_pb_bytes(bytes(item))
            self._c_imported.inc(n)
            if errs:
                self._c_import_errors.inc(errs)
            self._report_import_merge(t0)
        elif isinstance(item, _ImportBatch):
            from veneur_tpu_torch.forward.convert import import_into
            # counted on this one thread, so concurrent imports cannot
            # lose increments (importsrv/server.go:130 import.metrics_total)
            t0 = time.perf_counter_ns()
            self._c_imported.inc(len(item))
            for metric in item:
                try:
                    import_into(self.aggregator, metric)
                except Exception as e:
                    # counted, so a mixed fleet sees incompatible payloads
                    # (foreign sketch bytes) instead of losing them
                    self._c_import_errors.inc()
                    log.warning("bad imported metric %s: %s",
                                metric.name, e)
            self._report_import_merge(t0)
        elif isinstance(item, _SpanMetricBatch):
            for m in item:
                self.aggregator.process_metric(m)
        else:
            self._process_packets(item)

    def _report_import_merge(self, t0_ns: int) -> None:
        """veneur.import.response_duration_ns tagged part:merge (the
        reference's http.go:78: time spent handing imports to workers)."""
        from veneur_tpu_torch.samplers import ssf_samples
        from veneur_tpu_torch.trace.client import report_one
        report_one(self.trace_client, ssf_samples.timing(
            "veneur.import.response_duration_ns",
            (time.perf_counter_ns() - t0_ns) / 1e9, {"part": "merge"}))

    def _handle_flush_request(self, req: FlushRequest) -> None:
        """Pipeline-thread half of a flush: ONLY the state/table swap; all
        downstream work (device flush math, intermetric generation, sink
        fan-out, plugins) runs on the flush worker so ingest never stalls
        behind a slow sink (flusher.go:105-115 semantics)."""
        # Backpressure check BEFORE the swap: when the flush worker is
        # backlogged the interval simply extends in device state — nothing
        # is discarded (the reference never drops aggregated data short of
        # a crash, flusher.go:28-131; the watchdog remains the backstop
        # for a fully wedged worker). Only the pipeline thread puts jobs,
        # so full() → put_nowait cannot race into queue.Full.
        if self._flush_jobs.full():
            self._c_intervals_deferred.inc()
            log.warning("flush worker backlogged; interval deferred "
                        "(state retained)")
            req.finish(False, "deferred: flush worker backlogged")
            return
        # A flush landing mid-reshard first folds the remaining migration
        # units (this is the pipeline thread, so the folds race nothing):
        # the flush then covers the whole drained interval, and the
        # transition ends at this flush boundary.
        if self.reshard is not None and self.reshard.active:
            self.reshard.complete_pending_folds(
                self.aggregator, float(self.cfg.reshard_transfer_timeout_s))
        now = time.time()
        self.last_flush = now
        # self-adjusting key tables: a due capacity change executes at
        # this swap boundary (tables/growth.py, the one grow site), so the
        # grow pause is the swap pause. While a reshard owns the swap
        # boundary, planning waits for the next flush (trigger_table_grow
        # answers 409 instead).
        grow_targets = None
        if self.tables is not None and not self.reshard_active:
            try:
                grow_targets = self.tables.plan(self.aggregator)
            except Exception:
                log.exception("table grow planning failed; interval "
                              "flushes at current capacities")
        # the interval's owning aggregator rides the flush job: after a
        # grow, the detached interval's flush math runs against the old
        # spec's backend, not the one just installed
        agg = self.aggregator
        # the ingest-drain phase: how long the interval's device state
        # takes to detach from the hot path (the only flush work that
        # blocks ingest) — timed here, surfaced as the flush trace's
        # first child span and the phase=ingest_drain timer
        swap_t0 = time.perf_counter_ns()
        try:
            if grow_targets:
                from veneur_tpu_torch.tables import grow_swap, grown_spec
                state, table, agg = grow_swap(
                    self, grown_spec(agg.spec, grow_targets))
            else:
                state, table = agg.swap()
        except Exception as e:
            log.exception("flush swap failed")
            if grow_targets:
                # a grow the device cannot hold (tables/growth.py built
                # nothing into place): the interval stays live, and the
                # ceiling drops to the capacities it has, so the next
                # flush swaps at them instead of failing again
                from veneur_tpu_torch.tables.growth import spec_capacities
                caps = spec_capacities(agg.spec)
                self.tables.max_capacity = max(caps[k] for k in grow_targets)
            req.finish(False, f"swap failed: {e}")
            return
        swap_ns = time.perf_counter_ns() - swap_t0
        if grow_targets:
            self.tables.note_grow(grow_targets, swap_ns)
        self._t_flush_phase.observe(swap_ns, phase="ingest_drain")
        # snapshot pipeline-owned counters here: the native engine's
        # stats call isn't safe to interleave with feed()
        # lifetime counters from the installed backend (a grow carries
        # them over to it)
        cur = self.aggregator
        stats = {
            "swap_ns": swap_ns,
            "h2d_bytes": cur.h2d_bytes,
            "packets_received": self.packets_received,
            "packets_dropped": self.packets_dropped,
            "packets_toolong": self.packets_toolong,
            "parse_errors": self.parse_errors + cur.extra_parse_errors(),
            "processed": cur.processed + 0,
            "dropped": cur.dropped_capacity,
            "import_errors": self.import_errors,
            "imported_total": self.imported_total,
            "forward_errors": self.forward_errors,
            "internal_errors": self.internal_errors,
            "spans_received": self.span_pipeline.spans_received,
            "span_chan_cap_hits": self.span_pipeline.chan_cap_hits,
            "intervals_deferred": self.flush_intervals_deferred,
            "sink_flushes_skipped": self.sink_flushes_skipped,
            "set_shift": cur.last_set_shift,
        }
        if agg is not self.aggregator:
            # a grow retired `agg`: no later step copies out of its
            # pinned buffers, and none still in flight may outlive them
            agg.wait_copies()
        self._flush_jobs.put_nowait((agg, state, table, stats, now, req))

    # -- listeners ----------------------------------------------------------
    def _bind_unix(self, sock: socket.socket, path: str) -> None:
        """Bind a unix socket with the reference's ownership semantics
        (networking.go:286-302 acquireLockForSocket + :304 abstract):
        '@name' is the Linux abstract namespace — no filesystem presence,
        no lock; pathname sockets take an exclusive flock on
        '<path>.lock' (two veneurs must never share a socket file),
        clear any stale socket, and are chmod'd 0666 so any local
        process can emit."""
        if path.startswith("@"):
            sock.bind(unix_bind_address(path))
            return
        import fcntl
        lock_path = path + ".lock"
        lock_fd = os.open(lock_path, os.O_CREAT | os.O_RDWR, 0o644)
        try:
            fcntl.flock(lock_fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            os.close(lock_fd)
            raise RuntimeError(
                f"lock file {lock_path!r} for socket {path!r} is held by "
                "another process already")
        self._unix_locks.append((lock_fd, lock_path, path))
        if os.path.exists(path):
            os.unlink(path)
        sock.bind(path)
        os.chmod(path, 0o666)

    def _release_unix_locks(self) -> None:
        for lock_fd, lock_path, sock_path in self._unix_locks:
            try:
                os.unlink(sock_path)
            except OSError:
                pass
            # the .lock file itself is deliberately NOT unlinked: flock
            # mutual exclusion only holds if every contender locks the
            # same inode; unlinking would let a starting server create a
            # fresh inode while another holds the old one — two owners
            try:
                os.close(lock_fd)   # closing releases the flock
            except OSError:
                pass
        self._unix_locks = []

    def _udp_reader(self, sock: socket.socket):
        # buffer is metric_max_length+1 so an over-limit datagram is
        # detectable by length and dropped WHOLE with a counter — the
        # reference's "toolong" guard (server.go:800 pool sizing,
        # :1082 processMetricPacket). A directly-constructed Config
        # (tests/embedding) leaves the field 0 — the YAML reader is what
        # applies the 4096 default — so 0 means the UDP datagram bound.
        limit = self.cfg.metric_max_length or 65536
        bufsize = limit + 1
        sock.settimeout(0.5)  # lets readers observe shutdown and release fd
        # Several reader threads (one per bound socket) share the fold
        # counters with the shutdown fold and the property readers. The
        # fold is batched per recv-loop iteration: one blocking recv,
        # then drain whatever else the kernel already has (bounded), then
        # ONE lock acquisition for the whole batch.
        batch_cap = 64
        while not self._shutdown.is_set():
            try:
                data = sock.recv(bufsize)
            except socket.timeout:
                continue
            except OSError:
                return
            batch = [data]
            sock.setblocking(False)
            try:
                while len(batch) < batch_cap:
                    batch.append(sock.recv(bufsize))
            except OSError:
                pass  # EAGAIN: kernel queue drained (or socket closing —
                #       the next blocking recv surfaces a real error)
            finally:
                sock.settimeout(0.5)
            received = len(batch)
            toolong = dropped = 0
            for data in batch:
                if len(data) > limit:
                    toolong += 1
                    continue
                try:
                    self.packet_queue.put(data, timeout=1.0)
                except queue.Full:
                    dropped += 1  # backpressure drop, counted
            with self._reader_fold_lock:
                self._packets_received += received
                self._packets_toolong_py += toolong
                self._packets_dropped_py += dropped

    @property
    def packets_received(self) -> int:
        """Python-read packets plus the native reader group's datagrams
        (C++ counters are mutex-guarded; readable from any thread)."""
        with self._reader_fold_lock:
            n = self._packets_received
            if self._native_readers_active:
                n += self.aggregator.reader_counters()["datagrams"]
        return n

    @property
    def packets_dropped(self) -> int:
        """Datagrams lost to backpressure after the kernel delivered them:
        the native ring's overflow or the Python path's queue.Full drops."""
        with self._reader_fold_lock:
            n = self._packets_dropped_py
            if self._native_readers_active:
                n += self.aggregator.reader_counters()["ring_dropped"]
        return n

    @property
    def packets_toolong(self) -> int:
        """Whole datagrams dropped for exceeding metric_max_length
        (reference packet.error_total{reason:toolong})."""
        with self._reader_fold_lock:
            n = self._packets_toolong_py
            if self._native_readers_active:
                n += self.aggregator.reader_counters()["toolong"]
        return n

    # -- registry-backed accessors ------------------------------------------
    @property
    def parse_errors(self) -> int:
        return int(self._c_parse_errors.value())

    @property
    def internal_errors(self) -> int:
        return int(self._c_internal_errors.value())

    @property
    def import_errors(self) -> int:
        return int(self._c_import_errors.value())

    @property
    def imported_total(self) -> int:
        return int(self._c_imported.value())

    @property
    def forward_errors(self) -> int:
        return int(self._c_forward_errors.value())

    @property
    def forward_sends_total(self) -> int:
        return int(self._c_forward_sends.value())

    @property
    def forward_retries_total(self) -> int:
        return int(self._c_forward_retries.value())

    @property
    def flush_count(self) -> int:
        return int(self._c_flush_count.value())

    @property
    def flush_intervals_deferred(self) -> int:
        return int(self._c_intervals_deferred.value())

    @property
    def sink_flushes_skipped(self) -> int:
        return int(self._c_sink_skips.value())

    def _ssf_udp_reader(self, sock: socket.socket):
        """One SSF span protobuf per datagram (server.go:1125
        ReadSSFPacketSocket -> HandleTracePacket)."""
        from veneur_tpu_torch.protocol.wire import parse_ssf
        bufsize = self.cfg.trace_max_length_bytes or MAX_UDP_SSF
        sock.settimeout(0.5)
        while not self._shutdown.is_set():
            try:
                data = sock.recv(bufsize)
            except socket.timeout:
                continue
            except OSError:
                return
            if not data:
                continue
            try:
                span = parse_ssf(data)
            except Exception:
                self._c_parse_errors.inc()
                continue
            self.span_pipeline.handle_span(span, ssf_format="packet")

    def _ssf_stream_listener(self, sock: socket.socket):
        """Framed SSF stream (server.go:1160 ReadSSFStreamSocket)."""
        sock.settimeout(0.5)
        while not self._shutdown.is_set():
            try:
                conn, _ = sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            threading.Thread(target=self._ssf_stream_conn, args=(conn,),
                             daemon=True).start()

    def _ssf_stream_conn(self, conn):
        """Buffered frame reader: framing errors (bad version, oversized
        length) poison the stream and close it (wire.go IsFramingError), but
        a corrupt protobuf body inside a well-formed frame is recoverable —
        the frame boundary is intact, so keep reading (server.go:1186).
        The 0.5s recv timeout lets the thread observe shutdown."""
        import struct
        from veneur_tpu_torch.protocol.wire import (MAX_SSF_PACKET_LENGTH,
                                                    parse_ssf)
        buf = b""
        conn.settimeout(0.5)
        with conn:
            while not self._shutdown.is_set():
                try:
                    data = conn.recv(65536)
                except socket.timeout:
                    continue
                except OSError:
                    return
                if not data:
                    return
                buf += data
                while len(buf) >= 5:
                    if buf[0] != 0:
                        self._c_parse_errors.inc()
                        return  # unknown frame version: poisoned
                    (length,) = struct.unpack(">I", buf[1:5])
                    if length > MAX_SSF_PACKET_LENGTH:
                        self._c_parse_errors.inc()
                        return  # oversized frame: poisoned
                    if len(buf) < 5 + length:
                        break
                    body, buf = buf[5:5 + length], buf[5 + length:]
                    try:
                        span = parse_ssf(body)
                    except Exception:
                        self._c_parse_errors.inc()
                        continue
                    self.span_pipeline.handle_span(span,
                                                   ssf_format="framed")

    def _tcp_listener(self, sock: socket.socket, tls_ctx):
        """reference server.go:1283 ReadTCPSocket: newline-delimited metrics
        over stream conns, optional TLS with client-cert auth."""
        sock.settimeout(0.5)
        while not self._shutdown.is_set():
            try:
                conn, _ = sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            # connection cap BEFORE spawning a thread: each conn costs a
            # reader thread, and an accept flood must degrade to refused
            # connections (counted, retryable) rather than thread
            # exhaustion
            cap = self.cfg.tcp_max_connections
            with self._tcp_conn_lock:
                over = bool(cap and cap > 0 and self._tcp_conns_live >= cap)
                if not over:
                    self._tcp_conns_live += 1
            if over:
                self._c_tcp_rejected.inc()
                log.warning("TCP statsd connection refused: "
                            "tcp_max_connections=%d reached", cap)
                try:
                    conn.close()
                except OSError:
                    pass
                continue
            conn.settimeout(5.0)
            if tls_ctx is not None:
                try:
                    conn = tls_ctx.wrap_socket(conn, server_side=True)
                except ssl.SSLError as e:
                    log.warning("TLS handshake failed: %s", e)
                    with self._tcp_conn_lock:
                        self._tcp_conns_live -= 1
                    continue
            t = threading.Thread(target=self._tcp_conn, args=(conn,),
                                 daemon=True)
            t.start()

    def _tcp_conn(self, conn):
        buf = b""
        limit = self.cfg.metric_max_length
        idle_limit = self.cfg.tcp_idle_timeout_s
        if idle_limit and idle_limit > 0:
            # wake often enough to notice the deadline: the 5.0s recv
            # timeout set at accept only bounds ONE recv, so a slowloris
            # peer trickling a byte per timeout held the thread forever
            conn.settimeout(min(5.0, idle_limit))
        last_data = time.monotonic()
        try:
            with conn:
                while not self._shutdown.is_set():
                    try:
                        data = conn.recv(65536)
                    except socket.timeout:
                        # idle conns stay open (server.go ReadTCPSocket)
                        # unless an idle deadline is configured
                        if idle_limit and idle_limit > 0 and \
                                time.monotonic() - last_data >= idle_limit:
                            self._c_tcp_idle_closed.inc()
                            log.info("TCP statsd connection closed: idle "
                                     "for %.1fs (deadline %.1fs)",
                                     time.monotonic() - last_data,
                                     idle_limit)
                            return
                        continue
                    except OSError:
                        return
                    if not data:
                        break
                    last_data = time.monotonic()
                    buf += data
                    *lines, buf = buf.split(b"\n")
                    for line in lines:
                        if len(line) > limit:
                            self._c_parse_errors.inc()
                            continue
                        if line:
                            self.packet_queue.put(line)
                    if len(buf) > limit:
                        # oversized line w/o newline: drop conn
                        self._c_parse_errors.inc()
                        return
        finally:
            with self._tcp_conn_lock:
                self._tcp_conns_live -= 1

    def _tls_context(self):
        if not (self.cfg.tls_key and self.cfg.tls_certificate):
            return None
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        cert = key = None
        try:
            cert = self._write_temp(self.cfg.tls_certificate)
            key = self._write_temp(self.cfg.tls_key)
            ctx.load_cert_chain(cert, key)
        finally:
            # never leave key material on disk
            for path in (cert, key):
                if path:
                    try:
                        os.unlink(path)
                    except OSError:
                        pass
        if self.cfg.tls_authority_certificate:
            ctx.load_verify_locations(
                cadata=self.cfg.tls_authority_certificate)
            ctx.verify_mode = ssl.CERT_REQUIRED
        return ctx

    @staticmethod
    def _write_temp(pem: str) -> str:
        f = tempfile.NamedTemporaryFile("w", suffix=".pem", delete=False)
        f.write(pem)
        f.close()
        return f.name

    def start(self):
        """reference server.go:771 Start + networking.go:19 StartStatsd."""
        # chaos: env overrides config; both use the reliability/faults.py
        # spec grammar. Armed BEFORE any listener or flush thread exists
        # so the very first interval can be faulted.
        fault_spec = (os.environ.get("VENEUR_FAULT_INJECTION", "")
                      or self.cfg.fault_injection)
        if fault_spec:
            FAULTS.configure(fault_spec)
        if self.cfg.sentry_dsn:
            from veneur_tpu_torch.utils import crash
            crash.setup(self.cfg.sentry_dsn)
            crash.hook_threads()
        if self.cfg.enable_profiling:
            # reference server.go:1337 pkg/profile CPU profile; dumped as
            # pstats at shutdown
            import cProfile
            self._profiler = cProfile.Profile()
            self._profiler.enable()
        if self.cfg.mutex_profile_fraction or self.cfg.block_profile_rate:
            # accepted for config-surface compat (server.go:331-344 sets
            # Go runtime profiling rates); CPython has no mutex/block
            # profiler to arm — say so instead of silently ignoring
            log.warning(
                "mutex_profile_fraction/block_profile_rate are Go-runtime "
                "knobs with no CPython equivalent; ignored "
                "(use enable_profiling for the cProfile CPU profile)")
        for sink in self.metric_sinks + self.span_sinks:
            sink.start()
        # durable restart: fold the newest valid checkpoint into the
        # (still empty) first interval before any ingest thread exists;
        # restore merges through the same lanes as live traffic, so
        # samples arriving after this land on top of it
        if self._ckpt_writer is not None and self.cfg.restore_on_start:
            self._restore_from_checkpoint()
            self._restore_complete = True  # /readyz gates on this
        if self._overload is not None:
            # the poller pushes the degradation knobs into the aggregator
            # each tick; active_set_shift latches at the next swap, so the
            # 2^k flush correction always matches what was staged
            def _push_degrade(ov):
                self.aggregator.degraded_timer_rate = ov.degraded_timer_rate()
                self.aggregator.pending_set_shift = ov.degraded_set_shift()
                # ring admission rides the same tick: push the state and
                # bucket knobs down, fold the exact decisions back up
                self._sync_native_admission(ov)

            self._overload.start(self.cfg.overload_poll_interval_s,
                                 on_poll=_push_degrade)
        t = threading.Thread(target=self._pipeline_loop, daemon=True,
                             name="pipeline")
        t.start()
        self._pipeline_thread = t
        self._threads.append(t)
        fw = threading.Thread(target=self._flush_worker, daemon=True,
                              name="flush-worker")
        fw.start()
        self._flush_thread = fw

        # C++ recvmmsg readers when the native engine is active: socket
        # reads and parsing never touch the GIL
        use_native_readers = self._native and self.cfg.native_udp_readers
        # multi-ring scale-out: with reader_rings > 1 each ring owns its
        # SO_REUSEPORT socket, so the bind fan-out follows reader_rings
        # (kernel flow-hashes datagrams across the group; one fd -> one
        # ring -> one parser core, no cross-core handoff)
        n_rings = max(1, self.cfg.reader_rings) if use_native_readers else 1
        udp_fanout = max(1, self.cfg.num_readers, n_rings)
        native_reader_fds = []
        for addr in self.cfg.statsd_listen_addresses:
            kind, target = resolve_addr(addr)
            if kind == "udp":
                for reader_i in range(udp_fanout):
                    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
                    if udp_fanout > 1 and hasattr(
                            socket, "SO_REUSEPORT"):
                        sock.setsockopt(socket.SOL_SOCKET,
                                        socket.SO_REUSEPORT, 1)
                        # a :0 address must resolve ONCE: re-binding port
                        # 0 per reader yields N distinct ephemeral ports
                        # and no kernel sharding (reference
                        # networking.go:44-55 reuses the first socket's
                        # concrete address for the rest of the group)
                        if reader_i == 1 and target[1] == 0:
                            target = self._sockets[-1].getsockname()
                    if self.cfg.read_buffer_size_bytes > 0:
                        sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF,
                                        self.cfg.read_buffer_size_bytes)
                    # else: keep the kernel default — SO_RCVBUF=0 clamps
                    # to the ~2KB minimum and a loopback burst of a few
                    # dozen datagrams already overruns it (read_config
                    # applies the 2MiB default; direct Config() users
                    # must not get a lossy listener)
                    sock.bind(target)
                    self._sockets.append(sock)
                    if use_native_readers:
                        native_reader_fds.append(sock.fileno())
                    else:
                        rt = threading.Thread(target=self._udp_reader,
                                              args=(sock,), daemon=True)
                        rt.start()
                        self._threads.append(rt)
            elif kind == "tcp":
                sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
                sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
                sock.bind(target)
                sock.listen(128)
                self._sockets.append(sock)
                lt = threading.Thread(target=self._tcp_listener,
                                      args=(sock, self._tls_context()),
                                      daemon=True)
                lt.start()
                self._threads.append(lt)
            elif kind == "unixgram":
                # datagram statsd (networking.go:145 startStatsdUnix:
                # ListenUnixgram)
                sock = socket.socket(socket.AF_UNIX, socket.SOCK_DGRAM)
                self._bind_unix(sock, target)
                self._sockets.append(sock)
                rt = threading.Thread(target=self._udp_reader, args=(sock,),
                                      daemon=True)
                rt.start()
                self._threads.append(rt)
            elif kind == "unix":
                # stream statsd: newline-delimited metrics over
                # SOCK_STREAM, same read loop as TCP minus TLS (the
                # reference supports only unixgram statsd and panics on
                # unix:// — networking.go:29; accepting the stream form
                # here is a strict superset)
                sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                self._bind_unix(sock, target)
                sock.listen(128)
                self._sockets.append(sock)
                lt = threading.Thread(target=self._tcp_listener,
                                      args=(sock, None), daemon=True)
                lt.start()
                self._threads.append(lt)

        if native_reader_fds:
            # tenant identity and quarantine live in the multi-ring
            # engine's admission path: the config lands before any ring
            # thread exists, and one ring with tenancy still runs the vrm
            # engine (force_rings), not the tenant-blind vr one
            if self.tenancy is not None:
                self._push_tenant_config()
            # +1 so the kernel flags (MSG_TRUNC) any datagram OVER the
            # limit; the C++ reader drops it whole and counts toolong —
            # the same guard as the Python reader / the reference
            self.aggregator.readers_start(
                native_reader_fds,
                max_len=(self.cfg.metric_max_length or 65536) + 1,
                n_rings=n_rings,
                pin_cores=list(self.cfg.reader_pin_cores) or None,
                force_rings=self.tenancy is not None)
            self._native_readers_active = True
            # arm ring admission from the first datagram: the poller's
            # first tick is up to a poll interval away
            if self._overload is not None:
                self._sync_native_admission(self._overload)
            else:
                self._sync_native_tenancy(drain=False)

        # SSF span listeners (networking.go:198 StartSSF)
        self.span_pipeline.start()
        for addr in self.cfg.ssf_listen_addresses:
            kind, target = resolve_addr(addr)
            if kind in ("udp", "unixgram"):
                if kind == "udp":
                    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
                    sock.bind(target)
                else:
                    sock = socket.socket(socket.AF_UNIX, socket.SOCK_DGRAM)
                    self._bind_unix(sock, target)
                self._sockets.append(sock)
                rt = threading.Thread(target=self._ssf_udp_reader,
                                      args=(sock,), daemon=True)
                rt.start()
                self._threads.append(rt)
            elif kind in ("unix", "tcp"):
                if kind == "unix":
                    sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                    self._bind_unix(sock, target)
                else:
                    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
                    sock.setsockopt(socket.SOL_SOCKET,
                                    socket.SO_REUSEADDR, 1)
                    sock.bind(target)
                sock.listen(64)
                self._sockets.append(sock)
                lt = threading.Thread(target=self._ssf_stream_listener,
                                      args=(sock,), daemon=True)
                lt.start()
                self._threads.append(lt)

        ft = threading.Thread(target=self._flush_ticker, daemon=True,
                              name="flush-ticker")
        ft.start()
        self._threads.append(ft)

        if self.cfg.flush_watchdog_missed_flushes > 0:
            wt = threading.Thread(target=self._watchdog, daemon=True,
                                  name="flush-watchdog")
            wt.start()
            self._threads.append(wt)

        # HTTP API (reference server.go:1303 Serve + http.go Handler)
        if self.cfg.http_address:
            from veneur_tpu_torch.server.httpapi import start_http_server
            kind, target = resolve_addr(
                self.cfg.http_address if "//" in self.cfg.http_address
                else f"tcp://{self.cfg.http_address}")
            if kind != "tcp":
                raise ValueError(
                    f"http_address must be tcp, got {self.cfg.http_address!r}")
            self._httpd = start_http_server(self, target)
            self.http_port = self._httpd.server_address[1]

        # global-tier import server (reference importsrv/,
        # server.go:753-762). With a dedup window the service runs the
        # exactly-once contract: envelopes parsed from metadata, malformed
        # ones rejected (INVALID_ARGUMENT).
        if self.cfg.grpc_address:
            from veneur_tpu_torch.forward import rpc
            _, target = resolve_addr(
                self.cfg.grpc_address if "//" in self.cfg.grpc_address
                else f"tcp://{self.cfg.grpc_address}")
            native_import = hasattr(self.aggregator, "import_pb_bytes")
            self._grpc_server, self.grpc_port = rpc.serve(
                self.import_bytes if native_import else self.import_metrics,
                f"{target[0]}:{target[1]}", raw=native_import,
                with_metadata=self._dedup is not None,
                on_reject=self._c_envelope_rejected.inc)
        # forwarding client, dialed once at start (server.go:843-851);
        # http(s):// addresses take the HTTP /import path unless
        # forward_use_grpc forces gRPC (flusher.go:84-95 dispatch)
        if self.cfg.forward_address:
            from veneur_tpu_torch.forward.rpc import (
                ForwardClient, HTTPForwardClient)
            addr = self.cfg.forward_address
            is_http = addr.startswith(("http://", "https://"))
            if is_http and not self.cfg.forward_use_grpc:
                # no retry_policy here: _send_forward wraps both client
                # kinds uniformly (and counts retries)
                self._forward_client = HTTPForwardClient(addr)
            else:
                for prefix in ("http://", "https://", "grpc://", "tcp://"):
                    if addr.startswith(prefix):
                        addr = addr[len(prefix):]
                # with retries configured, queue RPCs while the channel
                # (re)connects instead of failing fast
                self._forward_client = ForwardClient(
                    addr, wait_for_ready=self.cfg.sink_retry_max > 0)
        self._redact_secrets()

    _SECRET_FIELDS = (
        # the reference's list (server.go:741-747) ...
        "sentry_dsn", "tls_key", "datadog_api_key", "signalfx_api_key",
        "lightstep_access_token", "aws_access_key_id",
        "aws_secret_access_key",
        # ... plus this config surface's other credential fields
        "trace_lightstep_access_token", "splunk_hec_token")

    def _redact_secrets(self) -> None:
        """Scrub credentials from the retained config once every consumer
        (sinks, TLS context, crash reporter — all built by now) holds its
        own copy (server.go:741-747): anything that later dumps state
        (debug endpoints, crash reports, logs) cannot leak keys. The
        server redacts its OWN shallow copy — the caller's Config object
        stays intact, so reusing it for another server keeps working."""
        import dataclasses as _dc
        self.cfg = _dc.replace(self.cfg)
        for f in self._SECRET_FIELDS:
            if getattr(self.cfg, f, ""):
                setattr(self.cfg, f, "REDACTED")
        if self.cfg.signalfx_per_tag_api_keys:
            self.cfg.signalfx_per_tag_api_keys = [
                {"name": d.get("name", ""), "api_key": "REDACTED"}
                for d in self.cfg.signalfx_per_tag_api_keys]

    def _dedup_check(self, envelope) -> Optional[bool]:
        """Exactly-once admission for one enveloped import batch, before
        the enqueue (which cannot fail). Returns None = fold it (fresh,
        or dedup/envelope off), True = suppress but ack (already folded,
        or past the window's staleness bound: acking lets the sender
        evict; a NACK would replay forever). Raises EnvelopeError
        (counted) for envelopes the window refuses outright."""
        if self._dedup is None or envelope is None:
            return None
        try:
            verdict = self._dedup.observe(envelope)
        except EnvelopeError:
            self._c_envelope_rejected.inc()
            raise
        if verdict == FRESH:
            return None
        self._c_dup_suppressed.inc()
        return True

    def import_metrics(self, metrics: List, envelope=None) -> bool:
        """Import entry for parsed metrics (gRPC without the native
        engine, and POST /import): enqueue onto the pipeline thread
        (importsrv/server.go:102 SendMetrics → IngestMetrics). Returns
        True, the gRPC service's ack, for a folded batch and for a
        suppressed duplicate alike; False when CRITICAL overload sheds
        the batch (HTTP answers 503, the enveloped gRPC service
        RESOURCE_EXHAUSTED, so the sender retries elsewhere or later)."""
        if self._overload is not None \
                and not self._overload.admit_import(len(metrics)):
            return False
        if self._dedup_check(envelope):
            return True
        self.packet_queue.put(_ImportBatch(metrics))
        self._trace_import_absorb(envelope, rows=len(metrics))
        return True

    def import_bytes(self, data: bytes, envelope=None) -> bool:
        """Raw-bytes gRPC import entry (native decode path): the pipeline
        thread hands the serialized MetricList straight to the engine's
        importer. Same shed and dedup contract as import_metrics."""
        if self._overload is not None \
                and not self._overload.admit_import():
            return False
        if self._dedup_check(envelope):
            return True
        self.packet_queue.put(_ImportBytes(data))
        self._trace_import_absorb(envelope, nbytes=len(data))
        return True

    def _trace_import_absorb(self, envelope, rows=None, nbytes=None):
        """When the sender's envelope carries trace context, record a
        veneur.import.absorb span parented onto its flush.forward span,
        so the receiving tier's span pipeline holds one connected tree
        per interval. An untraced envelope records nothing."""
        if envelope is None \
                or getattr(envelope, "trace_id", None) is None:
            return
        from veneur_tpu_torch.trace.tracer import Span
        sp = Span("veneur.import.absorb", service="veneur",
                  trace_id=envelope.trace_id,
                  parent_id=envelope.parent_span_id)
        sp.set_tag("source_id", envelope.source_id)
        if rows is not None:
            sp.set_tag("rows", str(rows))
        if nbytes is not None:
            sp.set_tag("bytes", str(nbytes))
        sp.client_finish(self.trace_client)

    def process_span_metrics(self, metrics: List) -> None:
        """Extraction-sink loop-back: span-derived UDPMetrics re-enter the
        aggregation pipeline (ssfmetrics/metrics.go:65-69 routing)."""
        self.packet_queue.put(_SpanMetricBatch(metrics))

    def local_addr(self, index: int = 0):
        return self._sockets[index].getsockname()

    # -- flush orchestration ------------------------------------------------
    def _flush_ticker(self):
        if self.cfg.synchronize_with_interval:
            # align the first tick to a wall-clock multiple of the
            # interval for downstream bucketing convenience
            # (server.go:866-870 CalculateTickDelay)
            if self._shutdown.wait(tick_delay(self.interval, time.time())):
                return
            self.trigger_flush(wait=False)
        while not self._shutdown.wait(self.interval):
            self.trigger_flush(wait=False)

    def trigger_flush(self, wait: bool = True,
                      timeout: Optional[float] = None):
        """Enqueue a flush on the pipeline thread (the ticker of
        server.go:853-890).

        With wait=True (the reference tests' manual-flush idiom), blocks
        until THIS request's flush completed and returns True on success,
        False on deferral/failure/timeout — never silently.

        With wait=False returns the FlushRequest, so a caller can observe
        this specific flush later (req.wait / req.ok / req.detail)."""
        req = FlushRequest()
        self.packet_queue.put(req)
        if not wait:
            return req
        budget = timeout if timeout is not None else max(
            2 * self.interval, 120.0)
        ok = req.wait(budget)
        if not ok:
            log.warning("manual flush did not complete: %s", req.detail)
        return ok

    @property
    def reshard_active(self) -> bool:
        return self.reshard is not None and self.reshard.active

    def trigger_reshard(self, new_n_shards: int, wait: bool = True,
                        timeout: Optional[float] = None):
        """Resize the mesh live to `new_n_shards` (reshard/). With
        wait=True, block until the transfer completed and return its
        summary dict; with wait=False, return the live transfer handle
        (.done, .summary()). Raises ReshardError when the feature is
        off, a move is already in progress, the target is invalid or
        the transfer failed."""
        if self.reshard is None:
            from veneur_tpu_torch.reshard import ReshardError
            raise ReshardError("resharding is disabled "
                               "(reshard_enabled: false)")
        return self.reshard.resize(new_n_shards, wait=wait,
                                   timeout_s=timeout)

    def trigger_table_grow(self, targets: dict, wait: bool = True,
                           timeout: Optional[float] = None):
        """Force a per-kind key-table capacity change at the next flush
        boundary (tables/growth.py executes it inside the swap's
        quiesce). Raises GrowConflict (.status 409) while a reshard owns
        the swap boundary: capacity changes wait behind mesh moves, never
        interleave with them. With wait=True returns the flush result
        like trigger_flush."""
        from veneur_tpu_torch.tables.growth import GrowConflict
        if self.tables is None:
            raise RuntimeError("table growth is disabled "
                               "(table_grow_enabled: false)")
        if self.reshard_active:
            raise GrowConflict("grow rejected: reshard in progress "
                               "owns the swap boundary (retry after)")
        self.tables.force(targets)
        return self.trigger_flush(wait=wait, timeout=timeout)

    def _flush_worker(self):
        """Dedicated flush thread: drains detached intervals and runs the
        full flush fan-out. Serializes overlapping flushes; a slow sink
        delays at most the NEXT flush, never ingest."""
        while True:
            job = self._flush_jobs.get()
            if job is _STOP:
                return
            agg, state, table, stats, swapped_at, req = job
            ok, detail = True, ""
            try:
                self._do_flush(agg, state, table, stats, swapped_at)
            except Exception as e:
                # a failed flush must never kill the flush thread; state
                # was already swapped, next interval starts clean
                ok, detail = False, f"{type(e).__name__}: {e}"
                log.exception("flush failed")
            finally:
                self.last_flush_done = time.time()
                self._c_flush_count.inc()
                req.finish(ok, detail)

    def _do_flush(self, agg, state, table, stats, swapped_at):
        # chaos hook: a fault here exercises the failed-flush containment
        # in _flush_worker (state already swapped; next interval clean)
        FAULTS.inject(FLUSH_WORKER)
        flush_t0 = time.perf_counter()
        # tenant ledger and mirror sync when the overload poller does not
        # already fold it each tick (tenancy without the controller, or
        # native admission off)
        if self.tenancy is not None and not (
                self._overload is not None
                and self.cfg.overload_native_admission):
            self._sync_native_tenancy(drain=True)
        # stamp with the interval's swap time, not the job's run time — a
        # queued interval must not shift into the next time bucket
        ts = int(swapped_at)
        # every flush stage is wrapped in a self-span reported through the
        # channel trace client, so the span tree re-enters our own span
        # pipeline and is visible to span sinks (flusher.go:29
        # tracer.StartSpan("flush") + StartSpanFromContext per stage)
        from veneur_tpu_torch.trace.tracer import Span
        root = Span("flush", service="veneur")
        trace = self._flush_trace
        swap_ns = int(stats.get("swap_ns", 0))
        # h2d bytes shipped THIS interval (the aggregator counter is
        # lifetime-cumulative; the flush worker is the only reader of
        # _h2d_reported, so the delta needs no lock)
        h2d_total = int(stats.get("h2d_bytes", 0))
        h2d_delta = max(0, h2d_total - self._h2d_reported)
        self._h2d_reported = h2d_total
        if trace:
            # the swap already ran on the pipeline thread before this job
            # was queued; backdate the root by its duration and replay it
            # as the first child so the trace covers the whole interval
            root.start_ns -= swap_ns
            drain = root.child("flush.ingest_drain", start_ns=root.start_ns)
            drain.set_tag("h2d_bytes", str(h2d_delta))
            self.trace_client.record(drain.finish(root.start_ns + swap_ns))

        def stage(name):
            return root.child(f"flush.{name}")

        dev_t0 = time.perf_counter_ns()
        sp = stage("device_update")
        # a due checkpoint rides the forward path's raw sketch outputs:
        # the same want_raw gather in the flush's own host copy, no
        # checkpoint-only read
        ckpt_due = (self._ckpt_writer is not None
                    and self._flushes_since_ckpt + 1
                    >= max(1, self.cfg.checkpoint_interval_flushes))
        raw = None
        if (self._forward_client is not None or ckpt_due
                or self.cfg.collective_attach):
            flush_arrays, table, raw = agg.compute_flush(
                state, table, self.cfg.percentiles, want_raw=True,
                history=self.history)
        else:
            flush_arrays, table = agg.compute_flush(
                state, table, self.cfg.percentiles, history=self.history)
        if self.tables is not None:
            try:
                # idle census over the detached table: exact
                # evicted_total and the shrink demand signal
                self.tables.census_flush(table, swapped_at)
            except Exception:
                log.exception("table census failed; eviction accounting "
                              "skipped this interval")
        self._t_flush_phase.observe(time.perf_counter_ns() - dev_t0,
                                    phase="device_update")
        if trace:
            sp.set_tag("h2d_bytes", str(h2d_delta))
        sp.client_finish(self.trace_client)
        # watch tier: hand the DETACHED interval to the watch engine's own
        # thread. swap() gave the pipeline a fresh state, so nothing
        # writes this one again; offer() never blocks (bounded queue,
        # drop-oldest with exact accounting), so watches cannot stretch
        # the flush deadline. The interval's ring window seq is pinned
        # now: a later flush advances the ring before the engine runs. At
        # overload CRITICAL the evaluation is shed outright (counted).
        if self.watch_engine is not None:
            if (self._overload is not None
                    and self._overload.state >= CRITICAL):
                self.watch_engine.skip_interval("overload CRITICAL")
            else:
                hist_seq = (self.history.seq - 1
                            if self.history is not None
                            and self.history.armed else None)
                self.watch_engine.offer(
                    state, table, int(stats.get("set_shift", 0)), ts,
                    hist_seq)
        # exactly-once forwarding: export + stage this interval's unit
        # under a fresh (epoch, seq) BEFORE the checkpoint build, so the
        # snapshot's spill chunk carries the payload with its envelope
        # (_stage_forward_unit explains the crash-replay invariant)
        #
        # co-located collective tier: hand this interval's forwardable rows
        # to the in-process tier as device staging. A successful absorb IS
        # the forward, so the wire path (stage + send) is skipped for the
        # interval; a failure falls through to it untouched.
        absorbed = False
        if self.cfg.collective_attach and raw is not None:
            # the absorb gets the flush.forward stage span the wire path
            # would; the tier parents its absorb span onto it
            asp = stage("forward")
            asp.set_tag("transport", "colocated")
            try:
                absorbed = self._absorb_colocated(raw, table, span=asp)
            finally:
                asp.client_finish(self.trace_client)
        if (self._fwd_source_id is not None and raw is not None
                and not absorbed):
            self._stage_forward_unit(raw, table)
        if self._ckpt_writer is not None:
            if ckpt_due:
                self._checkpoint_interval(agg, flush_arrays, table, raw, ts)
                self._flushes_since_ckpt = 0
            else:
                self._flushes_since_ckpt += 1
        if self._forward_client is not None and not absorbed:
            # fire-and-forget, concurrent with sink flushes
            # (flusher.go:84-95); the forward logs and counts its own
            # errors, and the flush thread never blocks on a slow global
            # tier. Both read only the host copy of `raw`.
            fsp = stage("forward")
            if self._fwd_source_id is not None:
                # ack-gated: the interval was staged above; the pump
                # re-sends every pending unit under its original envelope
                self._spawn_aux(self._pump_traced, fsp)
            else:
                self._spawn_aux(self._forward_traced, fsp, raw, table)

        if self.cfg.count_unique_timeseries:
            from veneur_tpu_torch.server.flusher import unique_timeseries
            self._unique_ts = unique_timeseries(table, self.cfg.is_local)

        # span sinks flush concurrently (flusher.go:56 go flushTraces)
        self._spawn_aux(self.span_pipeline.flush)

        with self._event_lock:
            samples, self.event_samples = self.event_samples, []
        for sink in self.metric_sinks:
            try:
                sink.flush_other_samples(samples)
            except Exception as e:
                log.warning("sink %s FlushOtherSamples: %s", sink.name, e)

        # columnar fast path: when every sink takes frames and no plugin
        # needs object lists, skip per-metric InterMetric construction
        # entirely (see flusher.MetricFrame)
        if (self.metric_sinks
                and all(getattr(s, "accepts_frames", False)
                        for s in self.metric_sinks)
                and all(getattr(p, "accepts_frames", False)
                        for p in self.plugins)):
            from veneur_tpu_torch.server.flusher import generate_frame
            generate = generate_frame
        else:
            generate = generate_intermetrics
        # degraded-aggregation correction: the interval staged set
        # members subsampled at 2^-shift (Aggregator._set_admit), so the
        # flushed estimate is multiplied back by 2^shift. Forward and
        # checkpoint carry the raw registers, untouched; a new dict and a
        # new array, because the checkpoint may still hold the originals.
        flush_degraded = False
        set_shift = int(stats.get("set_shift", 0))
        if set_shift > 0 and flush_arrays.get("set_estimate") is not None:
            flush_arrays = dict(flush_arrays)
            flush_arrays["set_estimate"] = (
                flush_arrays["set_estimate"] * (1 << set_shift))
            flush_degraded = True
        fb_t0 = time.perf_counter_ns()
        fbsp = stage("frame_build") if trace else None
        final = generate(
            flush_arrays, table,
            percentiles=self.cfg.percentiles,
            aggregates=self.cfg.aggregates,
            is_local=self.cfg.is_local,
            timestamp=ts, hostname=self.hostname)
        self._t_flush_phase.observe(time.perf_counter_ns() - fb_t0,
                                    phase="frame_build")
        if fbsp is not None:
            fbsp.set_tag("rows", str(len(final)))
            fbsp.client_finish(self.trace_client)
        # flush protection: at CRITICAL, low-priority rows are withheld
        # from the sinks and plugins; the device update, forward and
        # checkpoint above already ran, so no aggregated data is lost,
        # only its low-priority publication this interval
        if self._overload is not None and final \
                and self._overload.state >= CRITICAL:
            final, n_shed = self._flush_protect(final)
            if n_shed:
                self._overload.count_flush_shed(n_shed)
                flush_degraded = True
        if flush_degraded and self._overload is not None:
            self._overload.note_degraded_flush()
        if final:
            # parallel sink flushes + barrier with a per-interval join
            # budget (flusher.go:105-115). Slow-sink containment:
            # - a sink whose PREVIOUS flush is still running gets this
            #   interval skipped (counted) instead of a second thread —
            #   a wedged sink must not accrete a thread + metrics list
            #   per interval
            # - a thread that outlives the join budget is handed to the
            #   aux set so shutdown still joins it; daemon so a truly
            #   wedged one cannot block interpreter exit
            fan_t0 = time.perf_counter_ns()
            sinks_span = stage("sinks")
            sinks_span.set_tag("metrics", str(len(final)))
            threads = []
            for s in self.metric_sinks:
                # keyed by instance, not .name — names are class-level
                # constants and two same-named sinks must not share a
                # containment slot (instances live as long as the server,
                # so id() is stable)
                prev = self._sink_threads.get(id(s))
                if prev is not None and prev.is_alive():
                    self._c_sink_skips.inc()
                    log.warning("sink %s: previous flush still running; "
                                "skipping this interval", s.name)
                    continue
                t = threading.Thread(target=self._flush_sink,
                                     args=(s, final, sinks_span),
                                     daemon=True)
                self._sink_threads[id(s)] = t
                threads.append(t)
            for t in threads:
                t.start()
            # ONE shared interval budget for the whole barrier (a
            # per-thread timeout would give N slow sinks N intervals and
            # stale the watchdog's last_flush_done for merely-slow sinks)
            barrier_deadline = time.monotonic() + self.interval
            for t in threads:
                t.join(timeout=max(0.0,
                                   barrier_deadline - time.monotonic()))
                if t.is_alive():
                    with self._aux_lock:
                        self._aux_threads = [
                            x for x in self._aux_threads if x.is_alive()]
                        self._aux_threads.append(t)
            self._t_flush_phase.observe(time.perf_counter_ns() - fan_t0,
                                        phase="sink_fanout")
            sinks_span.client_finish(self.trace_client)
            # plugins run post-flush (flusher.go:117-131)
            psp = stage("plugins") if self.plugins else None
            from veneur_tpu_torch.server.flusher import MetricFrame
            is_frame = isinstance(final, MetricFrame)
            for p in self.plugins:
                try:
                    if is_frame:
                        p.flush_frame(final)
                    else:
                        p.flush(final)
                except Exception as e:
                    psp.error = True
                    log.warning("plugin %s flush failed: %s", p.name, e)
            if psp is not None:
                psp.client_finish(self.trace_client)
        # Self-telemetry is reported even for an empty interval — the
        # reference always tallies flush totals (flusher.go:300-336), and an
        # idle server must still bootstrap veneur.flush.* / packet counters
        # into its own pipeline.
        # per-interval native-ring poll (emit latency delta average)
        self._poll_ring_telemetry()
        self._report_self_metrics(len(final), time.perf_counter() - flush_t0,
                                  stats, final=final)
        # total = downstream work + the pipeline-thread swap it rode in on
        self._t_flush_phase.observe(
            (time.perf_counter() - flush_t0) * 1e9 + swap_ns, phase="total")
        if trace:
            root.set_tag("rows", str(len(final)))
            root.set_tag("h2d_bytes", str(h2d_delta))
        root.client_finish(self.trace_client)

    def _flush_protect(self, final):
        """Filter low-priority rows out of a flush result (MetricFrame or
        InterMetric list): keeps self-metrics and any row carrying a
        `shed_priority_tags` match. Returns (filtered, n_dropped)."""
        high = tuple(self.cfg.shed_priority_tags)

        def keep(name, tags):
            if name.startswith("veneur."):
                return True
            return any(h in t for h in high for t in tags)

        from veneur_tpu_torch.server.flusher import FrameSegment, MetricFrame
        if isinstance(final, MetricFrame):
            segs, dropped = [], 0
            for seg in final.segments:
                keep_idx = [i for i, m in enumerate(seg.metas)
                            if keep(seg.names[i], m.tags)]
                dropped += len(seg.names) - len(keep_idx)
                if not keep_idx:
                    continue
                if len(keep_idx) == len(seg.names):
                    segs.append(seg)
                    continue
                segs.append(FrameSegment(
                    [seg.names[i] for i in keep_idx],
                    seg.values[keep_idx], seg.mtype,
                    [seg.metas[i] for i in keep_idx], seg.is_status))
            return MetricFrame(final.timestamp, final.hostname,
                               segs), dropped
        kept = [m for m in final if keep(m.name, m.tags)]
        return kept, len(final) - len(kept)

    # -- durability (persistence/) ------------------------------------------
    def _build_snapshot(self, agg, flush_arrays, table, raw, ts) -> dict:
        """The checkpoint snapshot of one flushed interval, with the
        spill, forward, watch, history, tenant and key-table sidecars.
        `agg` owns the interval and its spec (across a grow boundary, the
        old spec, not self.aggregator's). The spill is read here, after the
        interval's unit was staged and before any send drains it."""
        from veneur_tpu_torch.persistence import build_snapshot
        spill_bytes, spill_n = None, 0
        if self.forward_spill is not None:
            spill_bytes = self.forward_spill.to_bytes()
            spill_n = len(self.forward_spill)
        n_shards = getattr(agg, "n_shards", 1)
        return build_snapshot(
            agg.spec, table, flush_arrays, raw,
            agg_kind="sharded" if n_shards > 1 else "single",
            n_shards=n_shards, interval_ts=ts, hostname=self.hostname,
            spill=spill_bytes, spill_entries=spill_n,
            forward_meta=self._forward_meta_snapshot(),
            watches=self._watch_snapshot(),
            history=self._history_snapshot(),
            tenants=self._tenant_snapshot(),
            keytables=self._tables_snapshot())

    def _checkpoint_interval(self, agg, flush_arrays, table, raw,
                             ts) -> None:
        """Hand this interval's snapshot to the async writer. A checkpoint
        that cannot be built degrades durability, never the flush."""
        ck_t0 = time.perf_counter_ns()
        try:
            self._ckpt_writer.submit(
                self._build_snapshot(agg, flush_arrays, table, raw, ts))
        except Exception:
            log.exception("checkpoint snapshot build failed; interval "
                          "not checkpointed")
        self._t_flush_phase.observe(time.perf_counter_ns() - ck_t0,
                                    phase="checkpoint_build")

    def _watch_snapshot(self) -> Optional[dict]:
        """Watch registrations and firing state for the checkpoint's
        sidecar chunk; None (chunk omitted) when the tier is off or no
        watch is registered."""
        if self.watch_engine is None:
            return None
        return self.watch_engine.snapshot()

    def _tables_snapshot(self) -> Optional[dict]:
        """Key-table growth state (the live per-kind capacities and the
        exact accounting) for the "keytables" sidecar chunk: a restore
        re-grows to these capacities before folding rows. None (chunk
        omitted) when growth is off."""
        if self.tables is None:
            return None
        return self.tables.snapshot_state(self.aggregator.spec)

    def _tenant_snapshot(self) -> Optional[dict]:
        """Tenant quarantine state (the engine table's mirror and the
        exact demoted-row totals) for the "tenants" sidecar chunk. None
        (chunk omitted) when tenancy is off."""
        if self.tenancy is None:
            return None
        return self.tenancy.snapshot_state()

    def _history_snapshot(self) -> Optional[dict]:
        """The history ring (arrays and host key index) for the
        checkpoint's sidecar chunks; None when the tier is off or the ring
        has not armed yet."""
        if self.history is None or not self.history.armed:
            return None
        return self.history.snapshot()

    def _forward_meta_snapshot(self) -> Optional[dict]:
        """Exactly-once forwarding state for the checkpoint: the sender
        identity (source_id + epoch + next seq) and/or this receiver's
        dedup window. None (chunk omitted) when the feature is off."""
        if self._fwd_source_id is None and self._dedup is None:
            return None
        meta: dict = {}
        if self._fwd_source_id is not None:
            with self._fwd_meta_lock:
                meta.update({"source_id": self._fwd_source_id,
                             "epoch": self._fwd_epoch,
                             "next_seq": self._fwd_next_seq})
        if self._dedup is not None:
            meta["dedup"] = self._dedup.snapshot()
        return meta

    def _restore_forward_meta(self, meta: dict) -> None:
        """Adopt a checkpoint's forwarding identity. The epoch bumps by
        one with seq reset: seqs minted after the checkpoint died with
        the process, and reusing them for new data would make the
        receiver suppress it as duplicates. Spill units restored
        alongside keep their original old-epoch envelopes: replays of
        possibly-folded payloads, which the receiver's window for the
        old epoch suppresses."""
        try:
            sid = str(meta.get("source_id") or "")
            if self._fwd_source_id is not None and sid:
                Envelope(sid, int(meta.get("epoch", 0)), 0).validate()
                with self._fwd_meta_lock:
                    self._fwd_source_id = sid
                    self._fwd_epoch = int(meta.get("epoch", 0)) + 1
                    self._fwd_next_seq = 0
                    self._fwd_acked_seq = -1
            if self._dedup is not None and meta.get("dedup"):
                self._dedup.restore(meta["dedup"])
        except (EnvelopeError, TypeError, ValueError) as e:
            log.warning("ignoring malformed forward metadata in "
                        "checkpoint: %s", e)

    def _restore_from_checkpoint(self) -> None:
        """Fold the newest valid snapshot into the live aggregator.
        Corrupt snapshots are quarantined and counted inside
        restore_latest; any other failure cold-starts: a bad checkpoint
        must never keep the server from serving. The "keytables" sidecar
        re-grows the tables before the fold; the "tenants" sidecar is
        stashed for the engine's tenant table, which the rings' start
        creates."""
        from veneur_tpu_torch.persistence import (fold_snapshot,
                                                  restore_latest,
                                                  restore_spill)
        try:
            found = restore_latest(self.cfg.checkpoint_dir,
                                   on_corrupt=self._c_ckpt_corrupt.inc)
            if found is None:
                log.info("no restorable checkpoint under %s; cold start",
                         self.cfg.checkpoint_dir)
                return
            snap, path = found
            if snap.get("keytables") and self.tables is not None:
                # re-grow to the checkpoint's per-kind capacities before
                # folding (startup: the pipeline is not running, so the
                # swap boundary is quiescent). fold_snapshot works at any
                # capacity; adopting first restores the headroom.
                from veneur_tpu_torch.tables import adopt_capacities
                kt = snap["keytables"]
                try:
                    adopt_capacities(self, dict(kt.get("capacities")
                                                or {}))
                    self.tables.restore_state(kt)
                except Exception:
                    log.exception("keytables sidecar not adopted; "
                                  "restoring at config capacities")
            fwd_meta = snap.get("forward") or None
            # skip re-folding forward-only rows iff their payloads travel
            # by the spill replay instead: an exactly-once sender staged
            # the export before the checkpoint, so the spill chunk holds
            # those rows under their envelopes, and this server replays
            # that spill. Folding them too would re-export the same data
            # under a fresh seq the receiver cannot correlate.
            skip_fwd = (fwd_meta is not None
                        and fwd_meta.get("source_id")
                        and self._fwd_source_id is not None
                        and self.forward_spill is not None)
            n = fold_snapshot(self.aggregator, snap,
                              skip_forwarded=bool(skip_fwd))
            if self.forward_spill is not None and snap.get("spill"):
                restore_spill(self.forward_spill, snap["spill"])
            if fwd_meta:
                self._restore_forward_meta(fwd_meta)
            if snap.get("watches") and self.watch_engine is not None:
                # monitors keep their debounce streaks and ALERT holds
                self.watch_engine.restore(snap["watches"])
            if snap.get("history") and self.history is not None:
                # the ring survives the restart byte for byte; a spec
                # mismatch keeps the fresh ring (history is a cache)
                self.history.restore(snap["history"])
            if snap.get("tenants") and self.tenancy is not None:
                # quarantine survives the restart: the entries are pushed
                # into the engine right after tenant_config creates its
                # table (start(), before the rings), so demotion resumes
                # from the first datagram
                self._tenant_restore_entries = \
                    self.tenancy.restore_state(snap["tenants"])
            self._c_ckpt_restores.inc()
            log.info("restored %d metrics from %s (interval_ts=%d)",
                     n, path, snap["interval_ts"])
        except Exception:
            log.exception("checkpoint restore failed; cold start")

    # -- forwarding (forward/; README §Exactly-once forwarding) -------------
    def _forward_traced(self, span, raw, table):
        try:
            self._forward(raw, table, span=span)
        finally:
            span.client_finish(self.trace_client)

    def _absorb_colocated(self, raw, table, span=None) -> bool:
        """Hand this interval's forwardable rows to the co-located
        collective tier (collective/tier.py) as device staging. True means
        the tier took the interval and the wire path must not run
        (staging it too would double-count the additive kinds); False
        means no tier or a failed absorb, and the caller falls back to the
        ordinary forward path. `span` is the local flush's forward stage
        span, which the tier's absorb span parents onto."""
        from veneur_tpu_torch.collective import tier as collective_tier
        t = collective_tier.lookup(self.cfg.collective_attach)
        if t is None:
            # no co-located tier in this process (yet): the wire path
            return False
        # the registry-backed phase timer (idempotent: every local
        # attaches the same server's timer)
        t.set_phase_timer(self._t_coll_phase)
        try:
            if self._collective_participant is None:
                self._collective_participant = t.assign_participant()
            n = t.absorb_raw(raw, table,
                             participant=self._collective_participant,
                             parent_span=span,
                             trace_client=self.trace_client)
        except Exception:
            self._c_coll_errors.inc()
            log.exception("co-located collective absorb failed; interval "
                          "falls back to the wire forward path")
            return False
        self._c_coll_rows.inc(n)
        return True

    def _pump_traced(self, span):
        try:
            self._pump_forward_units(span=span)
        finally:
            span.client_finish(self.trace_client)

    def _next_envelope(self) -> Envelope:
        with self._fwd_meta_lock:
            seq = self._fwd_next_seq
            self._fwd_next_seq += 1
            return Envelope(self._fwd_source_id, self._fwd_epoch, seq)

    def _stage_forward_unit(self, raw, table) -> None:
        """Export this interval's forwardable sketches and stage them as
        an immutable ack-gated unit under a fresh (epoch, seq), on the
        flush worker before the checkpoint build and the send.

        That order is the crash-exactly-once invariant: every
        checkpoint's forward-eligible rows are inside its spill chunk
        with their envelope, so a crash-restore replays the same bytes
        under the same seq (which the receiver's dedup window can
        suppress), while fold_snapshot(skip_forwarded=True) keeps those
        rows from re-exporting under a fresh seq it could not.

        Legacy (unenveloped) spill entries, restored from a checkpoint of
        a dedup-off run, fold into this unit so they travel enveloped."""
        from veneur_tpu_torch.forward.convert import export_metrics
        try:
            fresh = export_metrics(
                raw, table, compression=self.aggregator.spec.compression,
                hll_precision=self.aggregator.spec.hll_precision)
            legacy = [m for _, m in self.forward_spill.take_legacy()]
            if legacy:
                log.info("forward: folding %d legacy spilled payloads "
                         "into this interval's unit", len(legacy))
                fresh = legacy + fresh
            if fresh:
                env = self._next_envelope()
                self.forward_spill.add_unit(fresh, env.epoch, env.seq)
        except Exception:
            # a failed export degrades forwarding for this interval,
            # never the flush (errors surface at the pump)
            self._c_forward_errors.inc()
            log.exception("forward export/staging failed; interval not "
                          "staged")

    def _pump_forward_units(self, span=None) -> None:
        """Send every staged unit oldest-first; a successful send is the
        receiver's ack for that seq (the RPC or 202 returns only after
        the import was admitted, or recognized as a duplicate, which is
        acked too), so the unit is evicted. A failed or ambiguous send
        leaves the unit in place: the next interval's pump re-sends the
        same bytes under the same seq.

        Single-flight (non-blocking lock): a slow failing pump may
        overlap the next interval's, and a second concurrent pump would
        re-send units already in flight."""
        if not self._fwd_send_lock.acquire(blocking=False):
            return
        t0 = time.perf_counter_ns()
        n_metrics = 0
        try:
            if (self._forward_breaker is not None
                    and not self._forward_breaker.allow()):
                raise CircuitOpenError("forward: circuit open")
            for unit in self.forward_spill.pending_units():
                # trace context rides the envelope so the receiving
                # tier's absorb span parents onto this flush's forward
                # span; untraced (span=None) is wire-identical to a
                # legacy sender
                env = Envelope(self._fwd_source_id, unit.epoch, unit.seq,
                               trace_id=(span.trace_id
                                         if span is not None else None),
                               parent_span_id=(span.id
                                               if span is not None
                                               else None))
                n_metrics += len(unit.metrics)
                self._send_forward(unit.metrics, span, envelope=env)
                self.forward_spill.ack(unit.epoch, unit.seq)
                with self._fwd_meta_lock:
                    if (unit.epoch == self._fwd_epoch
                            and unit.seq > self._fwd_acked_seq):
                        self._fwd_acked_seq = unit.seq
                if self._forward_breaker is not None:
                    self._forward_breaker.record_success()
                self._c_forward_sends.inc()
        except Exception as e:
            if (self._forward_breaker is not None
                    and not isinstance(e, CircuitOpenError)):
                self._forward_breaker.record_failure()
            # no spill mutation here: the unsent units (the one that just
            # failed included) stay staged under their seqs
            self._c_forward_errors.inc()
            if span is not None:
                span.error = True
            log.warning("forward failed: %s", e)
        finally:
            dur_ns = time.perf_counter_ns() - t0
            self._t_flush_phase.observe(dur_ns, phase="forward")
            if span is not None and self._flush_trace:
                span.set_tag("rows", str(n_metrics))
            with self._sink_stats_lock:
                self._forward_stats.append((dur_ns, n_metrics))
            self._fwd_send_lock.release()

    def _forward(self, raw, table, span=None):
        """Serialize and ship forwardable sketch state without envelopes
        (flusher.go:474 forwardGRPC). Errors are counted, never fatal
        (flusher.go:512-524); with a spill buffer, a failed interval's
        payload merges into the next interval's send."""
        from veneur_tpu_torch.forward.convert import export_metrics
        t0 = time.perf_counter_ns()
        n_metrics = 0
        fresh = []
        spilled = []
        try:
            fresh = export_metrics(
                raw, table, compression=self.aggregator.spec.compression,
                hll_precision=self.aggregator.spec.hll_precision)
            n_metrics = len(fresh)
            if fresh or (self.forward_spill is not None
                         and len(self.forward_spill)):
                # breaker gate before the spill drain: while the circuit
                # is open, buffered payloads stay put and only this
                # interval's batch joins them in the except arm below
                if (self._forward_breaker is not None
                        and not self._forward_breaker.allow()):
                    raise CircuitOpenError("forward: circuit open")
                if self.forward_spill is not None:
                    # (spilled_at, metric) pairs of failed intervals ride
                    # ahead of this interval's batch; the global tier
                    # merges by key
                    spilled = self.forward_spill.drain()
                    if spilled:
                        log.info("forward: merging %d spilled payloads "
                                 "into this batch", len(spilled))
                metrics = [m for _, m in spilled] + fresh
                n_metrics = len(metrics)
                if metrics:
                    self._send_forward(metrics, span)
                    if self._forward_breaker is not None:
                        self._forward_breaker.record_success()
                    self._c_forward_sends.inc()
        except Exception as e:
            if (self._forward_breaker is not None
                    and not isinstance(e, CircuitOpenError)):
                self._forward_breaker.record_failure()
            if self.forward_spill is not None:
                # re-failed spilled entries keep their original stamps
                # (readd first: they are oldest), so max_age_s bounds
                # total staleness
                self.forward_spill.readd(spilled)
                self.forward_spill.add(fresh)
            self._c_forward_errors.inc()
            if span is not None:
                span.error = True
            log.warning("forward failed: %s", e)
        finally:
            # recorded on failure too: a timed-out send shows as a
            # latency spike, not as an absent metric
            dur_ns = time.perf_counter_ns() - t0
            self._t_flush_phase.observe(dur_ns, phase="forward")
            if span is not None and self._flush_trace:
                span.set_tag("rows", str(n_metrics))
            with self._sink_stats_lock:
                self._forward_stats.append((dur_ns, n_metrics))

    def _send_forward(self, metrics, span, envelope=None) -> None:
        """One forward send under the retry policy (clients that carry
        their own policy are not wrapped twice). Every retry re-sends
        the same envelope: an ambiguous failure (DEADLINE_EXCEEDED or
        CANCELLED, rpc.AmbiguousResultError) may have folded at the
        receiver, and only a same-seq re-send lets its dedup window
        suppress the duplicate. The envelope is passed only when set,
        so clients with the legacy send_metrics signature work."""
        kw = {}
        if envelope is not None:
            kw["envelope"] = envelope

        def once():
            self._forward_client.send_metrics(
                metrics, timeout=self.interval, parent_span=span,
                trace_client=self.trace_client, **kw)

        if (self.retry_policy is None
                or getattr(self._forward_client, "retry_policy", None)
                is not None):
            once()
            return

        def on_retry(attempt, exc, delay):
            self._c_forward_retries.inc()
            log.warning("forward attempt %d failed: %s; retrying in "
                        "%.3fs", attempt + 1, exc, delay)

        self.retry_policy.run(once, on_retry=on_retry)

    def _report_self_metrics(self, n_flushed: int, flush_seconds: float,
                             stats: dict, final=None):
        """Every stage emits self-metrics through the pipeline itself
        (SURVEY §5: worker counts worker.go:513, flush totals
        flusher.go:300-336), as deltas per interval. `stats` is the counter
        snapshot taken on the pipeline thread at swap time."""
        from veneur_tpu_torch.samplers import ssf_samples
        from veneur_tpu_torch.trace.client import report_batch

        cur = {"veneur.packets_received_total": stats["packets_received"],
               "veneur.packets_dropped_total":
                   stats.get("packets_dropped", 0),
               "veneur.packet.error_toolong_total":
                   stats.get("packets_toolong", 0),
               "veneur.parse_errors_total": stats["parse_errors"],
               "veneur.worker.metrics_processed_total": stats["processed"],
               "veneur.worker.metrics_dropped_total": stats["dropped"],
               "veneur.import.errors_total": stats.get("import_errors", 0),
               "veneur.pipeline.internal_errors_total":
                   stats.get("internal_errors", 0),
               "veneur.import.metrics_total": stats.get("imported_total", 0),
               # the reference emits both: import.metrics_total from the
               # import server and the worker-level alias
               "veneur.worker.metrics_imported_total":
                   stats.get("imported_total", 0),
               # untagged here; the log line carries the cause
               "veneur.forward.error_total":
                   stats.get("forward_errors", 0),
               "veneur.flush.intervals_deferred_total":
                   stats["intervals_deferred"],
               "veneur.flush.sink_flushes_skipped_total":
                   stats.get("sink_flushes_skipped", 0),
               # the short alias the fault-tolerance docs use; same
               # counter (slow-sink containment + breaker refusals)
               "veneur.flush.skipped_total":
                   stats.get("sink_flushes_skipped", 0),
               "veneur.spans_received_total": stats["spans_received"],
               "veneur.worker.span.hit_chan_cap":
                   stats.get("span_chan_cap_hits", 0)}
        # per-flush runtime gauges (flusher.go:36-43: span-chan depth,
        # GC count, heap bytes, flush timestamp)
        from veneur_tpu_torch.utils.statsd_emit import runtime_gauges
        rss, ngc = runtime_gauges()
        samples = [ssf_samples.timing("veneur.flush.total_duration_ns",
                                      flush_seconds),
                   ssf_samples.gauge("veneur.flush.metrics_total",
                                     n_flushed),
                   ssf_samples.gauge(
                       "veneur.worker.span_chan.total_elements",
                       float(self.span_pipeline.chan.qsize())),
                   ssf_samples.gauge(
                       "veneur.worker.span_chan.total_capacity",
                       float(self.span_pipeline.chan.maxsize)),
                   ssf_samples.gauge("veneur.gc.number", ngc),
                   ssf_samples.gauge("veneur.mem.heap_alloc_bytes", rss),
                   ssf_samples.gauge("veneur.flush.flush_timestamp_ns",
                                     float(time.time() * 1e9)),
                   # 1 = the C++ engine parses the wire path, 0 = the
                   # Python parser (native_ingest: false)
                   ssf_samples.gauge("veneur.parse.native_engine",
                                     1.0 if self._native else 0.0)]
        if self._unique_ts is not None:
            samples.append(ssf_samples.count(
                "veneur.flush.unique_timeseries_total", self._unique_ts,
                {"global_veneur": str(not self.cfg.is_local).lower()}))
            self._unique_ts = None
        # README §Monitoring names operators alert on:
        # worker.metrics_flushed_total by metric_type (unique name-tag-
        # type combos this interval), forward.duration_ns +
        # forward.post_metrics_total per send, flush.error_total for
        # sink POST errors
        if final is not None and len(final):
            from collections import Counter

            from veneur_tpu_torch.server.flusher import MetricFrame
            if isinstance(final, MetricFrame):
                by_type = Counter()
                for seg in final.segments:
                    by_type[seg.mtype] += len(seg.names)
            else:
                by_type = Counter(m.type for m in final)
            for mtype, n in sorted(by_type.items()):
                samples.append(ssf_samples.count(
                    "veneur.worker.metrics_flushed_total", n,
                    {"metric_type": mtype}))
        # per-(service, ssf_format) span intake (flusher.go:463-466):
        # ssf.spans.received_total + the root-span variant, which carries
        # veneurglobalonly so infrastructure-wide root counts aggregate
        # on the global tier exactly like the reference's
        for (service, fmt), (n, n_root) in sorted(
                self.span_pipeline.drain_service_counts().items()):
            tags = {"service": service, "ssf_format": fmt}
            samples.append(ssf_samples.count(
                "veneur.ssf.spans.received_total", n, tags))
            if n_root:
                samples.append(ssf_samples.count(
                    "veneur.ssf.spans.root.received_total", n_root,
                    dict(tags, veneurglobalonly="true")))
        with self._sink_stats_lock:
            fstats, self._forward_stats = self._forward_stats, []
        for dur_ns, n_metrics in fstats:
            samples.append(ssf_samples.timing(
                "veneur.forward.duration_ns", dur_ns / 1e9))
            samples.append(ssf_samples.count(
                "veneur.forward.post_metrics_total", n_metrics))
        # per-metric-sink conventions, measured centrally by the fan-out
        # (sinks/sinks.go:11-24; the previous interval's threads that
        # outlived the barrier settle into the NEXT interval's report)
        with self._sink_stats_lock:
            sink_stats, self._sink_flush_stats = self._sink_flush_stats, {}
            # swap-and-reset like _sink_flush_stats: stragglers from an
            # abandoned sink thread land in the next interval's dict
            sink_errs, self._sink_flush_errors = (
                self._sink_flush_errors, {})
        for sname, n in sink_errs.items():
            samples.append(ssf_samples.count(
                "veneur.flush.error_total", n, {"sink": sname}))
        for name, (rows, total_ns) in sink_stats.items():
            tags = {"sink": name}
            if rows:
                samples.append(ssf_samples.count(
                    "veneur.sink.metrics_flushed_total", rows, tags))
            samples.append(ssf_samples.timing(
                "veneur.sink.metric_flush_total_duration_ns", total_ns / 1e9,
                tags))
        # resilience telemetry, read from the SAME registry collectors a
        # /metrics scrape uses (one source of truth): retry counts as
        # deltas vs _last_stats so an idle configuration emits nothing,
        # breaker state as point-in-time gauges
        for lv, total in self.metrics.get(
                "veneur.sink.retries_total").samples():
            name = lv[0] if lv else ""
            key = f"veneur.sink.retries_total|{name}"
            delta = total - self._last_stats.get(key, 0)
            self._last_stats[key] = total
            if delta:
                samples.append(ssf_samples.count(
                    "veneur.sink.retries_total", delta, {"sink": name}))
        for lv, v in self.metrics.get("veneur.circuit.state").samples():
            samples.append(ssf_samples.gauge(
                "veneur.circuit.state", float(v),
                {"sink": lv[0] if lv else ""}))
        for name, total in cur.items():
            delta = total - self._last_stats.get(name, 0)
            self._last_stats[name] = total
            if delta:
                samples.append(ssf_samples.count(name, delta))
        self._normalize_self_samples(samples)
        report_batch(self.trace_client, samples)
        self._emit_stats_address(samples)

    def _report_span_worker_samples(self, samples) -> None:
        """Span-worker per-sink telemetry (worker.go:706-713), reported
        through the same normalize → pipeline → stats-mirror path as the
        flush self-metrics. Called from the flush worker's span-flush
        thread; everything downstream is thread-safe (channel client,
        UDP sendto)."""
        from veneur_tpu_torch.trace.client import report_batch
        self._normalize_self_samples(samples)
        report_batch(self.trace_client, samples)
        self._emit_stats_address(samples)

    def _emit_stats_address(self, samples) -> None:
        """Mirror self-metrics to an external statsd daemon when
        stats_address is configured (reference server.go:297 statsd.New +
        scopedstatsd — operators often point this at a plain DogStatsD
        agent, separate from the in-pipeline loop-back)."""
        if self._stats_sock is None:   # unconfigured, bad address, or
            return                     # already closed by shutdown
        from veneur_tpu_torch.proto import ssf_pb2
        from veneur_tpu_torch.utils.statsd_emit import format_line, send_lines
        type_ch = {ssf_pb2.SSFSample.COUNTER: "c",
                   ssf_pb2.SSFSample.GAUGE: "g",
                   ssf_pb2.SSFSample.HISTOGRAM: "h"}
        try:
            lines = []
            for s in samples:
                ch = type_ch.get(s.metric)
                if ch is None:
                    continue
                tags = ",".join(f"{k}:{v}" if v else k
                                for k, v in sorted(s.tags.items()))
                lines.append(format_line(s.name, s.value, ch, tags))
            send_lines(self._stats_sock, self._stats_dest, lines)
        except (OSError, ValueError) as e:
            log.warning("stats_address emit failed: %s", e)

    def _normalize_self_samples(self, samples):
        """veneur_metrics_scopes / veneur_metrics_additional_tags applied
        to self-telemetry (reference scopedstatsd/client.go:33-58 +
        normalizeSpans server.go:179-238)."""
        from veneur_tpu_torch.proto import ssf_pb2
        scopes = self.cfg.veneur_metrics_scopes or {}
        scope_by_type = {
            ssf_pb2.SSFSample.COUNTER: scopes.get("counter"),
            ssf_pb2.SSFSample.GAUGE: scopes.get("gauge"),
            ssf_pb2.SSFSample.HISTOGRAM: scopes.get("histogram"),
            ssf_pb2.SSFSample.SET: scopes.get("set"),
            ssf_pb2.SSFSample.STATUS: scopes.get("status"),
        }
        extra = [t.split(":", 1) if ":" in t else (t, "")
                 for t in self.cfg.veneur_metrics_additional_tags]
        for s in samples:
            want = scope_by_type.get(s.metric)
            if want == "local":
                s.scope = ssf_pb2.SSFSample.LOCAL
            elif want == "global":
                s.scope = ssf_pb2.SSFSample.GLOBAL
            for k, v in extra:
                s.tags[k] = v

    def _flush_sink(self, sink, metrics, parent=None):
        """metrics is a List[InterMetric] or a flusher.MetricFrame —
        frames only reach sinks that declared accepts_frames.

        Resilience split: a sink with its OWN configured harness
        (ResilientSink) retries and records breaker outcomes per network
        call internally, so the fan-out must neither gate on the shared
        breaker (it would consume the half-open probe the sink's own
        allow() then misses) nor wrap the flush in a second retry loop
        (attempts would multiply). Plain sinks get whole-flush retry and
        breaker accounting here."""
        own = (isinstance(sink, ResilientSink)
               and sink.resilience_configured)
        breaker = self._sink_breakers.get(id(sink))
        if not own and breaker is not None and not breaker.allow():
            self._c_sink_skips.inc()
            log.warning("sink %s: circuit %s; skipping this interval",
                        sink.name, breaker.state_name)
            return
        span = parent.child(f"flush.sink.{sink.name}") if parent else None
        if span is not None and self._flush_trace:
            span.set_tag("rows", str(len(metrics)))
        t0 = time.perf_counter_ns()
        ok = True
        try:
            if own or self.retry_policy is None:
                dispatch_flush(sink, metrics)
            else:
                def on_retry(attempt, exc, delay):
                    with self._sink_stats_lock:
                        self._fanout_retries[sink.name] = (
                            self._fanout_retries.get(sink.name, 0) + 1)
                    log.warning("sink %s flush attempt %d failed: %s; "
                                "retrying in %.3fs", sink.name,
                                attempt + 1, exc, delay)

                self.retry_policy.run(
                    lambda: dispatch_flush(sink, metrics),
                    on_retry=on_retry)
            if not own and breaker is not None:
                breaker.record_success()
        except Exception as e:
            ok = False
            if span is not None:
                span.error = True
            with self._sink_stats_lock:
                self._sink_flush_errors[sink.name] = (
                    self._sink_flush_errors.get(sink.name, 0) + 1)
            if not own and breaker is not None:
                breaker.record_failure()
            log.warning("sink %s flush failed: %s", sink.name, e)
        finally:
            # the centrally-measured sink.* conventions
            # (sinks/sinks.go:11-24: metrics_flushed_total +
            # metric_flush_total_duration_ns, tagged sink:<name>) — the
            # fan-out wraps every sink, so no sink can forget to emit
            ns = time.perf_counter_ns() - t0
            self._t_sink_flush.observe(ns, sink=sink.name)
            with self._sink_stats_lock:
                rows, total_ns = self._sink_flush_stats.get(
                    sink.name, (0, 0))
                self._sink_flush_stats[sink.name] = (
                    rows + (len(metrics) if ok else 0), total_ns + ns)
            if span is not None:
                span.client_finish(self.trace_client)

    def _spawn_aux(self, target, *args) -> threading.Thread:
        """Fire-and-forget helpers (the span-sink flush) are tracked so
        shutdown can join them — an orphaned thread still launching on
        the card at interpreter teardown can abort the process."""
        t = threading.Thread(target=target, args=args, daemon=True)
        t.start()
        with self._aux_lock:
            self._aux_threads = [x for x in self._aux_threads
                                 if x.is_alive()]
            self._aux_threads.append(t)
        return t

    def _watchdog(self):
        """reference server.go:900 FlushWatchdog: crash-only restart if
        flushes stall for N intervals. Two stall modes now that flush runs
        on its own thread: the pipeline stops swapping (last_flush stale)
        or the flush worker wedges inside a sink/plugin (last_flush_done
        stale while swaps continue)."""
        missed = self.cfg.flush_watchdog_missed_flushes
        while not self._shutdown.wait(self.interval / 2):
            stale = min(self.last_flush, self.last_flush_done)
            if time.time() - stale > missed * self.interval:
                log.critical(
                    "flush watchdog: no completed flush for %d intervals, "
                    "aborting", missed)
                os._exit(3)

    def _drain_admission_at_shutdown(self) -> None:
        """The last admission drain before the rings stop: decisions since
        the last poll tick land in the ledgers (per tenant too), and the
        quarantine mirror is current for the shutdown checkpoint."""
        if self._overload is not None:
            try:
                self._overload.fold_native_counts(
                    self.aggregator.admission_drain())
            except Exception:
                log.exception("native admission drain failed")
        elif self.tenancy is not None:
            try:
                drained = self.aggregator.admission_drain()
                if drained.get("tenants"):
                    self.tenancy.fold_native(drained["tenants"])
            except Exception:
                log.exception("tenant drain failed")
        if self.tenancy is not None:
            try:
                self.tenancy.update_table(self.aggregator.tenant_table())
            except Exception:
                log.exception("tenant table snapshot failed")

    def shutdown(self, device_timeout: float = 180.0):
        """reference server.go:1418 Shutdown (graceful).

        The joins on device-owning threads (pipeline, flush worker) use a
        generous budget, and the last step waits for the card: shutdown
        must leave no thread inside a launch, and no launch unfinished on
        the card, at interpreter teardown."""
        self._shutdown.set()
        # stop entering pump() on the pipeline thread's next pass; the
        # C++ reader threads themselves are joined AFTER the pipeline
        # thread exits (vr_stop frees the group a mid-flight vr_pump call
        # would still be reading). Fold the group's counters into the
        # Python ones FIRST: a FlushRequest already queued behind us will
        # snapshot packets_received, and losing the reader counts there
        # would emit a huge negative self-telemetry delta.
        with self._reader_fold_lock:
            stop_native_readers = self._native_readers_active
            if stop_native_readers:
                rc = self.aggregator.reader_counters()
                self._packets_received += rc["datagrams"]
                self._packets_dropped_py += rc["ring_dropped"]
                self._packets_toolong_py += rc["toolong"]
                self._drain_admission_at_shutdown()
            self._native_readers_active = False
        for s in self._sockets:
            try:
                s.close()
            except OSError:
                pass
        self._release_unix_locks()
        prof = getattr(self, "_profiler", None)
        if prof is not None:
            prof.disable()
            path = os.path.join(tempfile.gettempdir(),
                                "veneur_tpu_torch_profile.pstats")
            prof.dump_stats(path)
            log.info("CPU profile written to %s", path)
        # stop the feeders of packet_queue before _STOP so nothing enqueues
        # behind the sentinel: the span pipeline (extraction loop-back)
        self.trace_client.close()
        self.span_pipeline.stop()
        if self._overload is not None:
            self._overload.stop()
        if self._stats_sock is not None:
            self._stats_sock.close()   # eagerly created in __init__
            self._stats_sock = None
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()  # release the listening fd
        if self._grpc_server is not None:
            self._grpc_server.stop(grace=1.0).wait(5.0)
        if self.query_engine is not None:
            # before _STOP: the batcher thread enqueues snapshot/launch
            # requests on packet_queue; one racing in behind _STOP would
            # never run
            self.query_engine.close()
        if self.watch_engine is not None:
            # the engine launches on the device from its own thread; it
            # never touches packet_queue, so its order against _STOP is
            # free (a flush offered after this is not evaluated)
            self.watch_engine.close()
        self.packet_queue.put(_STOP)
        # drain order matters: the pipeline thread may still enqueue a final
        # flush job; only after it exits is it safe to stop the flush worker
        # (a _STOP racing ahead of that job would strand the last interval)
        if self._pipeline_thread is not None:
            self._pipeline_thread.join(timeout=device_timeout)
            if self._pipeline_thread.is_alive():
                log.error("pipeline thread did not exit within %.0fs",
                          device_timeout)
        # pipeline is out of pump(); now it is safe to join + free the
        # C++ reader group (skip if the pipeline thread is wedged — a
        # freed group under a live vr_pump would be use-after-free)
        if stop_native_readers and not (
                self._pipeline_thread is not None
                and self._pipeline_thread.is_alive()):
            try:
                self.aggregator.readers_stop()
            except Exception:
                log.exception("native reader shutdown failed")
        # bounded put: with a full queue AND a wedged worker, a blocking
        # put would hang shutdown forever (the watchdog is already
        # disarmed); drop one stale job to make room instead
        while True:
            try:
                self._flush_jobs.put_nowait(_STOP)
                break
            except queue.Full:  # vtlint: disable=accounting-flow -- unaccounted branches displace the _STOP sentinel or race an emptied queue; no interval data is lost on them
                try:
                    stale = self._flush_jobs.get_nowait()
                    if stale is not _STOP:
                        # the displaced interval is counted like any
                        # other interval that never reached the sinks
                        self._c_intervals_deferred.inc()
                        stale[-1].finish(False, "dropped at shutdown")
                except queue.Empty:
                    pass
        if self._flush_thread is not None:
            self._flush_thread.join(timeout=device_timeout)
            if self._flush_thread.is_alive():
                log.error("flush worker did not exit within %.0fs",
                          device_timeout)
        # graceful-exit durability: checkpoint the tail that never reached
        # a flush, synchronously and newest, so a graceful restart
        # restores only the tail (flushed intervals already left through
        # the sinks; restoring them too would double-count the additive
        # kinds downstream). With forward_dedup_window > 0 the tail's
        # export is staged as an ack-gated unit first, so the restart
        # replays it once under its original (source_id, epoch, seq).
        if self._ckpt_writer is not None:
            if self.cfg.checkpoint_on_shutdown:
                # a periodic snapshot still waiting for the writer thread
                # lands first, so the tail is the newest checkpoint
                self._ckpt_writer.wait_idle(device_timeout)
                try:
                    agg = self.aggregator
                    state, table = agg.swap()
                    flush_arrays, table, raw = agg.compute_flush(
                        state, table, self.cfg.percentiles, want_raw=True,
                        history=self.history)
                    # stage the tail's forward payload before the spill
                    # is serialized: the tail snapshot then carries the
                    # unit with its envelope, and fold_snapshot(
                    # skip_forwarded) keeps its rows from re-exporting
                    # under a second seq
                    absorbed = False
                    if self.cfg.collective_attach:
                        absorbed = self._absorb_colocated(raw, table)
                    if self._fwd_source_id is not None and not absorbed:
                        self._stage_forward_unit(raw, table)
                    self._ckpt_writer.write_sync(self._build_snapshot(
                        agg, flush_arrays, table, raw, int(time.time())))
                except Exception:
                    log.exception("final checkpoint failed; last periodic "
                                  "checkpoint remains newest")
            self._ckpt_writer.close()
        with self._aux_lock:
            aux = list(self._aux_threads)
        for t in aux:
            t.join(timeout=30.0)
        # the forward client closes only after the aux forward threads
        # using it have drained
        if self._forward_client is not None:
            self._forward_client.close()
        for t in self._threads:
            t.join(timeout=2.0)
        # quiesce the card: every launch the joined threads enqueued must
        # finish before teardown. The wait runs on a helper thread so a
        # wedged card costs at most device_timeout here.
        if self.device.type == "cuda":
            import torch
            # vtlint: disable=torch-hot-path -- shutdown quiesce: the full-device drain is the point here
            quiesce = threading.Thread(target=torch.cuda.synchronize,
                                       args=(self.device,), daemon=True)
            quiesce.start()
            quiesce.join(timeout=device_timeout)
            if quiesce.is_alive():
                log.error("device did not quiesce within %.0fs",
                          device_timeout)
        if self._collective_registered:
            from veneur_tpu_torch.collective import tier as collective_tier
            collective_tier.unregister(self._collective_registered,
                                       self.aggregator)
