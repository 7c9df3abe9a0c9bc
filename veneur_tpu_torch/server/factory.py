"""Server construction from config — sink/plugin wiring.

Mirrors reference server.go:261 NewFromConfig's gating: each sink exists iff
its config keys are set (server.go:472-678), plugins registered from
flush_file (server.go:683-731). This package ports the debug sinks and the
local-file plugin; the config keys of every other sink or plugin raise
NotImplementedError naming the ROADMAP item that ports them.
"""

from __future__ import annotations

import logging

from veneur_tpu_torch.config import Config
from veneur_tpu_torch.server.server import Server

log = logging.getLogger("veneur_tpu_torch.server.factory")

# (config key, is it set?, the sink or plugin it would build)
SINKS_NOT_PORTED = (
    ("datadog_api_key", lambda c: bool(c.datadog_api_key
                                       and c.datadog_api_hostname),
     "the Datadog metric sink"),
    ("signalfx_api_key", lambda c: bool(c.signalfx_api_key),
     "the SignalFx metric sink"),
    ("splunk_hec_address", lambda c: bool(c.splunk_hec_address
                                          or c.splunk_hec_token),
     "the Splunk span sink"),
    ("datadog_trace_api_address",
     lambda c: bool(c.ssf_listen_addresses and c.datadog_trace_api_address),
     "the Datadog span sink"),
    ("xray_address", lambda c: bool(c.ssf_listen_addresses
                                    and c.xray_address),
     "the X-Ray span sink"),
    ("falconer_address", lambda c: bool(c.ssf_listen_addresses
                                        and c.falconer_address),
     "the Falconer span sink"),
    ("grpsink_address", lambda c: bool(c.ssf_listen_addresses
                                       and c.grpsink_address),
     "the gRPC span sink"),
    ("kafka_broker", lambda c: bool(c.kafka_broker), "the Kafka sinks"),
    ("lightstep_access_token",
     lambda c: bool(c.ssf_listen_addresses and c.lightstep_access_token),
     "the LightStep span sink"),
    ("aws_s3_bucket", lambda c: bool(c.aws_s3_bucket and c.aws_region),
     "the S3 plugin"),
)


def new_from_config(cfg: Config, extra_metric_sinks=(), extra_span_sinks=(),
                    extra_plugins=(), device=None) -> Server:
    """The Server a config describes, on `device` (the card unless the
    caller names another)."""
    for key, is_set, what in SINKS_NOT_PORTED:
        if is_set(cfg):
            raise NotImplementedError(
                f"{key}: {what} is not ported to veneur_tpu_torch yet "
                "(ROADMAP A12)")
    metric_sinks = list(extra_metric_sinks)
    span_sinks = list(extra_span_sinks)
    plugins = list(extra_plugins)

    if cfg.debug_flushed_metrics:
        from veneur_tpu_torch.sinks.debug import DebugMetricSink
        metric_sinks.append(DebugMetricSink())
    if cfg.debug_ingested_spans:
        from veneur_tpu_torch.sinks.debug import DebugSpanSink
        span_sinks.append(DebugSpanSink())
    if cfg.flush_file:
        from veneur_tpu_torch.sinks.localfile import LocalFilePlugin
        plugins.append(LocalFilePlugin(
            cfg.flush_file, cfg.hostname,
            interval_s=int(cfg.parse_interval())))

    return Server(cfg, metric_sinks=metric_sinks, span_sinks=span_sinks,
                  plugins=plugins, device=device)
