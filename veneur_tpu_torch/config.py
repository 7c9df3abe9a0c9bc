"""YAML configuration with reference-compatible semantics.

Mirrors the reference's config surface (reference config.go:3-122, 115 yaml
keys) and parse pipeline (reference config_parse.go:100-148): strict-then-
loose YAML unmarshal that *warns* about unknown keys instead of failing,
``VENEUR_*`` environment-variable overrides (envconfig semantics: the env
var name is VENEUR_ + fieldname uppercased, underscores removed from the
yaml key's words — we use VENEUR_<YAML_KEY_UPPERCASED> which is what
envconfig produces for these field names), then defaults
(config_parse.go:150-230).

Device additions: table capacities, staging batch sizes and the
(replica, shard) mesh shape. They keep their `tpu_*` names, so one YAML
file configures either package; the comments name the JAX package's
modules for the features this package has not ported yet (ROADMAP A).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import re
from typing import List, Optional

import yaml

log = logging.getLogger("veneur_tpu_torch.config")


class UnknownConfigKeys(Warning):
    """Raised-as-warning analogue of reference config_parse.go:88
    UnknownConfigKeys: config parsed fine but contains unrecognized keys."""

    def __init__(self, keys):
        self.keys = sorted(keys)
        super().__init__(f"unknown config keys: {', '.join(self.keys)}")


_DURATION_RE = re.compile(r"(\d+(?:\.\d+)?)(ns|us|µs|ms|s|m|h)")
_DURATION_UNITS = {"ns": 1e-9, "us": 1e-6, "µs": 1e-6, "ms": 1e-3,
                   "s": 1.0, "m": 60.0, "h": 3600.0}


def parse_duration(s: str) -> float:
    """Go time.ParseDuration subset → seconds (reference config_parse.go:229
    ParseInterval)."""
    if not s:
        raise ValueError("empty duration")
    matches = list(_DURATION_RE.finditer(s))
    if not matches or "".join(m.group(0) for m in matches) != s:
        raise ValueError(f"invalid duration {s!r}")
    return sum(float(m.group(1)) * _DURATION_UNITS[m.group(2)]
               for m in matches)


@dataclasses.dataclass
class Config:
    """One server process's configuration (reference config.go Config).

    Keys the TPU build does not (yet) act on are still parsed and carried so
    existing reference YAML files load cleanly; sinks/features gate on them
    being non-empty exactly like reference server.go:472-678.
    """
    # core pipeline
    aggregates: List[str] = dataclasses.field(default_factory=list)
    interval: str = ""
    synchronize_with_interval: bool = False
    metric_max_length: int = 0
    trace_max_length_bytes: int = 0
    read_buffer_size_bytes: int = 0
    num_workers: int = 1
    num_readers: int = 1
    num_span_workers: int = 1
    span_channel_capacity: int = 0
    percentiles: List[float] = dataclasses.field(default_factory=list)
    count_unique_timeseries: bool = False
    hostname: str = ""
    omit_empty_hostname: bool = False
    tags: List[str] = dataclasses.field(default_factory=list)
    tags_exclude: List[str] = dataclasses.field(default_factory=list)
    # Go-runtime profiling knobs (server.go:331-344): accepted so
    # reference YAML loads cleanly, but they have no Python equivalent —
    # use /debug/pprof/profile (sampling) instead
    mutex_profile_fraction: int = 0
    block_profile_rate: int = 0
    sentry_dsn: str = ""
    stats_address: str = ""
    veneur_metrics_additional_tags: List[str] = dataclasses.field(
        default_factory=list)
    veneur_metrics_scopes: dict = dataclasses.field(default_factory=dict)

    # listeners
    statsd_listen_addresses: List[str] = dataclasses.field(
        default_factory=list)
    ssf_listen_addresses: List[str] = dataclasses.field(default_factory=list)
    http_address: str = ""
    grpc_address: str = ""
    http_quit: bool = False
    tls_key: str = ""
    tls_certificate: str = ""
    tls_authority_certificate: str = ""

    # forwarding / distributed tier
    forward_address: str = ""
    forward_use_grpc: bool = False
    flush_max_per_body: int = 0
    flush_file: str = ""
    flush_watchdog_missed_flushes: int = 0

    # resilience layer (veneur_tpu/reliability/; this framework's
    # addition). Reference-compatible defaults: 0 retries / threshold 0 /
    # 0 spill bytes keep every egress path single-attempt and
    # drop-on-failure, exactly today's behavior.
    sink_retry_max: int = 0            # retries per egress call (0 = off)
    sink_retry_base_ms: int = 100      # first backoff step
    circuit_failure_threshold: int = 0  # consecutive failures (0 = off)
    circuit_cooldown_s: float = 30.0   # open -> half-open probe delay
    forward_spill_max_bytes: int = 0   # merge-on-retry buffer (0 = off)
    forward_spill_max_age_s: float = 60.0
    fault_injection: str = ""          # chaos spec (reliability/faults.py)

    # exactly-once forwarding (forward/envelope.py; README §Exactly-once
    # forwarding). 0 = off: senders don't stamp envelopes, receivers
    # don't dedup — exactly the at-least-once behavior above. On a LOCAL
    # (> 0) every forwarded interval carries a (source_id, epoch, seq)
    # envelope and the spill becomes the ack-gated send queue; on a
    # GLOBAL/proxy (> 0) it is the per-source dedup window size in seqs —
    # replays more than `window` seqs behind a stream's high-water mark
    # are conservatively suppressed (the documented staleness bound).
    forward_dedup_window: int = 0
    forward_dedup_max_sources: int = 1024  # LRU bound on tracked streams

    # durability layer (veneur_tpu/persistence/; README §Durability).
    # An empty checkpoint_dir keeps the whole subsystem inert — no
    # writer thread, no restore scan, no behavior change.
    checkpoint_dir: str = ""           # checkpoint root ("" = off)
    checkpoint_interval_flushes: int = 1   # flushes between checkpoints
    checkpoint_retain: int = 3         # newest N checkpoints kept on disk
    restore_on_start: bool = False     # fold the newest valid snapshot
    checkpoint_on_shutdown: bool = True    # final snapshot of the tail

    # device kernels (veneur_tpu/ops/pallas_ingest.py; README §Device
    # kernels). True = probe-gated: the fused ingest kernel runs where
    # the backend compiles it (TPU), the XLA scatter chain everywhere
    # else (CPU tier-1 parity keeps the chain as the oracle). False
    # forces the chain even on TPU.
    pallas_ingest_enabled: bool = True

    # observability (veneur_tpu/observability/). Both switches default
    # OFF with zero hot-path overhead (a single attribute check / a 404):
    # the telemetry registry itself always runs — it IS the counter store.
    prometheus_metrics_enabled: bool = False  # serve GET /metrics
    flush_trace_enabled: bool = False  # per-phase span tree + row/byte tags
    self_timer_compression: float = 50.0  # t-digest delta for self-timers
    # serve GET /debug/profile?seconds=N — an on-demand jax.profiler
    # device trace written to a temp dir. Off by default: capture stalls
    # the runtime, so it must be an explicit operator decision.
    profile_capture_enabled: bool = False

    # overload management (veneur_tpu/reliability/overload.py; README
    # §Overload & health). Off by default: no controller, no poller
    # thread, no per-packet admission check — prior behavior exactly.
    overload_enabled: bool = False     # master switch for the controller
    overload_poll_interval_s: float = 0.25   # pressure sampling cadence
    overload_enter_pressured: float = 0.70   # state entry thresholds on
    overload_enter_shedding: float = 0.85    # max-normalized pressure
    overload_enter_critical: float = 0.95
    overload_exit_margin: float = 0.10  # hysteresis: exit below entry-margin
    overload_hold_s: float = 5.0       # min dwell before any downgrade
    overload_admit_rate: float = 0.0   # token bucket pkts/s (0 = no bucket)
    overload_admit_burst: float = 0.0  # bucket depth (0 = admit_rate)
    overload_timer_sample_rate: float = 0.5  # degraded timer admit fraction
    overload_set_shift: int = 2        # degraded HLL member-subsample bits
    shed_priority_tags: List[str] = dataclasses.field(
        default_factory=list)          # substrings shed LAST (e.g.
    #                                    "veneur.priority:high")
    overload_native_admission: bool = True  # run statsd admission inside
    #                                    the C++ reader ring (off = prior
    #                                    Python-side behavior: the native
    #                                    path bypasses admission)

    # multi-tenant fairness + quarantine (veneur_tpu/reliability/
    # tenancy.py; README §Multi-tenancy). Off by default: no identity
    # extraction, no per-tenant buckets, no quarantine — prior behavior
    # exactly.
    tenant_enabled: bool = False       # master switch for tenancy
    tenant_tag: str = "tenant:"        # datagram tag carrying the identity
    tenant_weights: dict = dataclasses.field(
        default_factory=dict)          # {tenant: weight}; unlisted -> 1.0
    tenant_fair_rate: float = 0.0      # admitted pkts/s per unit weight at
    #                                    SHEDDING+ (0 = fairness buckets off)
    tenant_fair_burst_mult: float = 2.0    # bucket depth = rate * mult
    tenant_quarantine_max_keys: int = 0    # distinct-key budget per tenant
    #                                    per flush window (0 = quarantine off)
    tenant_quarantine_decay: float = 0.5   # key-estimate decay per flush
    tenant_quarantine_readmit_frac: float = 0.5  # re-admit when the decayed
    #                                    estimate falls under frac * budget

    # TCP statsd hardening: connection cap + per-connection idle
    # deadline (a slowloris peer must not pin reader threads forever).
    tcp_max_connections: int = 0       # concurrent conns (0 = unlimited)
    tcp_idle_timeout_s: float = 0.0    # close idle conns (0 = no deadline)

    # debug
    debug: bool = False
    debug_flushed_metrics: bool = False
    debug_ingested_spans: bool = False
    enable_profiling: bool = False

    # datadog sink
    datadog_api_key: str = ""
    datadog_api_hostname: str = ""
    datadog_flush_max_per_body: int = 0
    datadog_metric_name_prefix_drops: List[str] = dataclasses.field(
        default_factory=list)
    datadog_exclude_tags_prefix_by_prefix_metric: dict = dataclasses.field(
        default_factory=dict)
    datadog_span_buffer_size: int = 0
    datadog_trace_api_address: str = ""

    # other sinks (parsed; gated on non-empty like the reference)
    signalfx_api_key: str = ""
    signalfx_endpoint_base: str = ""
    signalfx_endpoint_api: str = ""
    signalfx_hostname_tag: str = ""
    signalfx_flush_max_per_body: int = 0
    signalfx_vary_key_by: str = ""
    signalfx_per_tag_api_keys: List[dict] = dataclasses.field(
        default_factory=list)
    signalfx_dynamic_per_tag_api_keys_enable: bool = False
    signalfx_dynamic_per_tag_api_keys_refresh_period: str = ""
    signalfx_metric_name_prefix_drops: List[str] = dataclasses.field(
        default_factory=list)
    signalfx_metric_tag_prefix_drops: List[str] = dataclasses.field(
        default_factory=list)
    kafka_broker: str = ""
    kafka_metric_topic: str = ""
    kafka_span_topic: str = ""
    kafka_check_topic: str = ""
    kafka_event_topic: str = ""
    kafka_partitioner: str = ""
    kafka_metric_require_acks: str = ""
    kafka_span_require_acks: str = ""
    kafka_retry_max: int = 0
    kafka_metric_buffer_bytes: int = 0
    kafka_metric_buffer_messages: int = 0
    kafka_metric_buffer_frequency: str = ""
    kafka_span_buffer_bytes: int = 0
    kafka_span_buffer_mesages: int = 0  # sic — reference config.go typo kept
    kafka_span_buffer_frequency: str = ""
    kafka_span_serialization_format: str = ""
    kafka_span_sample_rate_percent: int = 0
    kafka_span_sample_tag: str = ""
    splunk_hec_address: str = ""
    splunk_hec_token: str = ""
    splunk_hec_batch_size: int = 0
    splunk_hec_submission_workers: int = 0
    splunk_hec_tls_validate_hostname: str = ""
    splunk_hec_send_timeout: str = ""
    splunk_hec_ingest_timeout: str = ""
    splunk_hec_max_connection_lifetime: str = ""
    splunk_hec_connection_lifetime_jitter: str = ""
    splunk_span_sample_rate: int = 0
    lightstep_access_token: str = ""
    lightstep_collector_host: str = ""
    lightstep_reconnect_period: str = ""
    lightstep_maximum_spans: int = 0
    lightstep_num_clients: int = 0
    # deprecated aliases the reference still parses with a warning
    # (config_parse.go:185-210): trace_lightstep_* fills lightstep_*
    # only when the canonical key is unset
    trace_lightstep_access_token: str = ""
    trace_lightstep_collector_host: str = ""
    trace_lightstep_reconnect_period: str = ""
    trace_lightstep_maximum_spans: int = 0
    trace_lightstep_num_clients: int = 0
    xray_address: str = ""
    xray_annotation_tags: List[str] = dataclasses.field(default_factory=list)
    xray_sample_percentage: float = 0.0
    falconer_address: str = ""
    grpsink_address: str = ""

    # span pipeline
    indicator_span_timer_name: str = ""
    objective_span_timer_name: str = ""
    ssf_buffer_size: int = 0

    # tag-frequency heavy hitters over spans (this framework's addition:
    # count-min sketch on device, BASELINE config 5)
    tag_frequency_enabled: bool = False
    tag_frequency_tag_keys: List[str] = dataclasses.field(
        default_factory=list)   # empty = every tag key
    tag_frequency_top_k: int = 100
    tag_frequency_depth: int = 4
    tag_frequency_width: int = 1 << 16
    tag_frequency_batch_size: int = 4096

    # plugins
    aws_access_key_id: str = ""
    aws_secret_access_key: str = ""
    aws_region: str = ""
    aws_s3_bucket: str = ""
    # local durable staging for S3 objects (empty = upload-only, the
    # reference behavior); see plugins/s3.py and README §Durability
    aws_s3_staging_dir: str = ""
    metric_prefix: str = ""

    # set by read_config: yaml keys that matched no field (strict-validate
    # callers fail on these; reference UnknownConfigKeys)
    unknown_keys: List[str] = dataclasses.field(default_factory=list)

    # TPU aggregation backend (this framework's addition)
    aggregation_backend: str = "tpu"
    native_ingest: bool = True   # C++ parse+key+stage path when buildable
    # C++ recvmmsg reader threads for UDP statsd (GIL-free socket reads;
    # requires native_ingest). Python reader threads otherwise.
    native_udp_readers: bool = True
    # Multi-ring host scale-out: one ring + parser + packed arena row per
    # reader core (requires native_udp_readers). 1 keeps the proven
    # single-ring engine; each SO_REUSEPORT reader fd owns its ring at
    # >1. See README "Host feed architecture".
    reader_rings: int = 1
    # Optional per-ring sched_affinity pinning: core id per ring (shorter
    # lists leave the remaining rings unpinned; empty = no pinning).
    reader_pin_cores: List[int] = dataclasses.field(default_factory=list)
    # Pre-sharded native emit on sharded/collective backends: staged rows
    # leave the engine grouped by route_digest owner shard so the
    # _split_shards argsort and the collective all_to_all shuffle are
    # no-ops on the native path. Flush output is byte-identical either
    # way (tests/test_native_preshard.py pins it).
    native_preshard_enabled: bool = False
    tpu_counter_capacity: int = 1 << 17
    tpu_gauge_capacity: int = 1 << 15
    tpu_status_capacity: int = 1 << 10
    tpu_set_capacity: int = 1 << 12
    tpu_histo_capacity: int = 1 << 14
    tpu_batch_counter: int = 8192
    tpu_batch_gauge: int = 2048
    tpu_batch_status: int = 256
    tpu_batch_set: int = 4096
    tpu_batch_histo: int = 8192
    tpu_n_shards: int = 0      # 0 = one shard per local device
    tpu_n_replicas: int = 1
    tpu_compact_every: int = 8
    # t-digest fidelity: δ (the reference's samplers.go:502 compression,
    # default 100 ≈ 157-centroid bound) and cells per k-unit (canonical
    # cells ≈ δ/2·cells_per_k + 2, ops/tdigest.py centroid_capacity;
    # higher = finer quantiles, more HBM per key)
    tpu_digest_compression: float = 100.0
    tpu_digest_cells_per_k: int = 3
    # bottom/top centroids kept exact through compression (per-key p99
    # tail accuracy; ops/tdigest.py DEFAULT_EXACT_EXTREMES)
    tpu_digest_exact_extremes: int = 64
    # collective global tier (veneur_tpu/collective/): the global tier as
    # a mesh resident over (tpu_n_replicas, shards). collective_enabled
    # makes THIS server the tier and registers it under collective_group;
    # collective_attach makes THIS (local) server hand its forwardable
    # flush rows to the co-located tier of that group as device arrays —
    # zero serialization — instead of gRPC. forward_address stays
    # authoritative for cross-host (DCN) peers.
    collective_enabled: bool = False
    collective_group: str = "default"
    collective_attach: str = ""
    # on-device query tier (veneur_tpu/query/): serve live quantile /
    # cardinality / counter reads from resident device state via
    # POST /query on the http API. Off by default — it spins up a
    # batcher thread and piggybacks snapshot requests on the ingest
    # pipeline queue. query_max_batch caps queries coalesced into one
    # device launch; query_timeout_ms is the coalescing window.
    query_enabled: bool = False
    query_max_batch: int = 64
    query_timeout_ms: float = 2.0
    # elastic live resharding (veneur_tpu/reshard/): grow/shrink the
    # shard mesh without a restart or flush gap. Off by default — the
    # coordinator object exists only when enabled, and the collective
    # tier (which manages its own mesh) always wins over this.
    # transfer_timeout_s bounds the whole move (drain visit, unit build,
    # and the fold completion a mid-move flush performs);
    # max_parallel_shards caps migration units folded per pipeline
    # visit, so transfer folds interleave with ingest instead of
    # monopolizing the pipeline thread.
    reshard_enabled: bool = False
    reshard_transfer_timeout_s: float = 10.0
    reshard_max_parallel_shards: int = 4
    # streaming watch tier (veneur_tpu/watch/): standing monitors
    # registered via POST /watch, evaluated as ONE fused device launch
    # per flush interval on the detached state, transitions streamed
    # over GET /watch/stream (SSE) and an optional webhook. Off by
    # default — it spins up an engine thread. watch_max_active caps the
    # registry (and therefore the packed evaluation's gather size);
    # watch_stream_max_subscribers caps concurrent SSE consumers;
    # watch_webhook_url, when set, POSTs each interval's transition
    # batch through the sink retry/breaker machinery.
    watch_enabled: bool = False
    watch_max_active: int = 1 << 17
    watch_stream_max_subscribers: int = 64
    watch_webhook_url: str = ""
    # on-device history tier (veneur_tpu/history/): keep the last
    # history_windows flush intervals device-resident per key (written
    # by the flush program itself), with history_decimation_tiers
    # levels of 2x-decimated older windows — history_windows *
    # 2^tiers intervals of total lookback. Range queries ride POST
    # /query (query tier) and `python -m veneur_tpu.cli.query --range`.
    # history_max_keys caps per-kind ring rows (HBM: see
    # history.HistorySpec.hbm_bytes; the veneur.history.hbm_bytes gauge
    # reports the resident figure).
    history_enabled: bool = False
    history_windows: int = 90
    history_decimation_tiers: int = 3
    history_max_keys: int = 1 << 20
    # self-adjusting key tables (veneur_tpu/tables/): per-kind capacity
    # growth at the flush swap boundary up to table_max_capacity rows
    # per kind, idle-key census TTL for exact eviction accounting, and
    # the SALSA merge-cell rung of the pressure ladder (Python key
    # tables only; counters). All default-off.
    table_grow_enabled: bool = False
    table_max_capacity: int = 1 << 24
    table_idle_ttl_s: float = 300.0
    table_salsa_enabled: bool = False

    def parse_interval(self) -> float:
        return parse_duration(self.interval)

    @property
    def is_local(self) -> bool:
        """Local ⇔ forwards to a global tier (reference server.go:1434),
        whether over the wire or into a co-located collective tier."""
        return self.forward_address != "" or self.collective_attach != ""


_DEFAULTS = {
    "aggregates": ["min", "max", "count"],
    "interval": "10s",
    "metric_max_length": 4096,
    "read_buffer_size_bytes": 2 * 1048576,
    "span_channel_capacity": 100,
    "splunk_hec_batch_size": 100,
    "splunk_hec_max_connection_lifetime": "10s",
    "datadog_flush_max_per_body": 25000,
    "percentiles": [0.5, 0.75, 0.99],
}

_FIELDS = {f.name: f for f in dataclasses.fields(Config)}


def _coerce(field: dataclasses.Field, raw: str):
    # resolve the runtime type from the default factory / default value
    if field.default_factory is not dataclasses.MISSING:  # type: ignore
        proto = field.default_factory()  # type: ignore
    else:
        proto = field.default
    if isinstance(proto, bool):
        return raw.lower() in ("1", "true", "yes", "on")
    if isinstance(proto, int):
        return int(raw)
    if isinstance(proto, float):
        return float(raw)
    if isinstance(proto, list):
        return [s for s in (x.strip() for x in raw.split(",")) if s]
    if isinstance(proto, dict):
        return yaml.safe_load(raw)
    return raw


def read_config(path_or_file, env: Optional[dict] = None,
                proxy: bool = False) -> Config:
    """YAML → Config with unknown-key warning, env override, defaults
    (reference config_parse.go:100 ReadConfig)."""
    if hasattr(path_or_file, "read"):
        data = yaml.safe_load(path_or_file.read()) or {}
    else:
        with open(path_or_file) as f:
            data = yaml.safe_load(f) or {}
    if not isinstance(data, dict):
        raise ValueError("config root must be a mapping")

    cfg = Config()
    unknown = []
    for k, v in data.items():
        if k in _FIELDS:
            if v is not None:
                setattr(cfg, k, v)
        else:
            unknown.append(k)
    cfg.unknown_keys = sorted(unknown)
    if unknown:
        # reference behavior: usable config, warn loudly; strict callers
        # check cfg.unknown_keys and fail (config_parse.go:113
        # unmarshalSemiStrictly returning UnknownConfigKeys)
        log.warning(str(UnknownConfigKeys(unknown)))

    env = os.environ if env is None else env
    prefix = "VENEUR_"
    for name, field in _FIELDS.items():
        var = prefix + name.upper().replace("_", "")
        # envconfig checks both the squashed and underscored forms
        for candidate in (var, prefix + name.upper()):
            if candidate in env:
                setattr(cfg, name, _coerce(field, env[candidate]))
                break

    for k, v in _DEFAULTS.items():
        cur = getattr(cfg, k)
        if cur == _FIELDS[k].default or (
                isinstance(cur, list) and not cur) or cur in ("", 0):
            setattr(cfg, k, v)
    for stem in ("access_token", "collector_host", "reconnect_period",
                 "maximum_spans", "num_clients"):
        dep = getattr(cfg, f"trace_lightstep_{stem}")
        if dep:
            log.warning("trace_lightstep_%s has been replaced by "
                        "lightstep_%s", stem, stem)
            if not getattr(cfg, f"lightstep_{stem}"):
                setattr(cfg, f"lightstep_{stem}", dep)
    if not cfg.hostname and not cfg.omit_empty_hostname:
        import socket
        cfg.hostname = socket.gethostname()
    return cfg
