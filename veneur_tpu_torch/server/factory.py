"""Server construction from config — sink/plugin wiring.

Mirrors reference server.go:261 NewFromConfig's gating: each sink exists iff
its config keys are set (server.go:472-678), plugins registered from
flush_file / aws_* (server.go:683-731).
"""

from __future__ import annotations

import logging

from veneur_tpu_torch.config import Config
from veneur_tpu_torch.server.server import Server

log = logging.getLogger("veneur_tpu_torch.server.factory")


def new_from_config(cfg: Config, extra_metric_sinks=(), extra_span_sinks=(),
                    extra_plugins=(), device=None) -> Server:
    """The Server a config describes, on `device` (the card unless the
    caller names another)."""
    metric_sinks = list(extra_metric_sinks)
    span_sinks = list(extra_span_sinks)
    plugins = list(extra_plugins)

    if cfg.debug_flushed_metrics:
        from veneur_tpu_torch.sinks.debug import DebugMetricSink
        metric_sinks.append(DebugMetricSink())
    if cfg.debug_ingested_spans:
        from veneur_tpu_torch.sinks.debug import DebugSpanSink
        span_sinks.append(DebugSpanSink())
    if cfg.datadog_api_key and cfg.datadog_api_hostname:
        from veneur_tpu_torch.sinks.datadog import DatadogMetricSink
        metric_sinks.append(DatadogMetricSink(
            api_key=cfg.datadog_api_key,
            hostname=cfg.hostname,
            api_url=cfg.datadog_api_hostname,
            interval_s=cfg.parse_interval(),
            flush_max_per_body=cfg.datadog_flush_max_per_body,
            tags=cfg.tags,
            metric_name_prefix_drops=cfg.datadog_metric_name_prefix_drops,
            exclude_tags_prefix_by_prefix_metric=(
                cfg.datadog_exclude_tags_prefix_by_prefix_metric)))
    if cfg.signalfx_api_key:
        # gate on the api key alone, like reference server.go:472; the
        # endpoint has the public default
        from veneur_tpu_torch.sinks.signalfx import SignalFxMetricSink
        per_tag = {}
        for e in cfg.signalfx_per_tag_api_keys:
            if "name" not in e or "api_key" not in e:
                raise ValueError(
                    f"signalfx_per_tag_api_keys entry needs name and "
                    f"api_key: {sorted(e)}")
            per_tag[e["name"]] = e["api_key"]
        from veneur_tpu_torch.config import parse_duration
        # reference server.go:482-486: empty period defaults to 10m
        refresh = parse_duration(
            cfg.signalfx_dynamic_per_tag_api_keys_refresh_period or "10m")
        metric_sinks.append(SignalFxMetricSink(
            api_key=cfg.signalfx_api_key,
            endpoint=cfg.signalfx_endpoint_base
            or "https://ingest.signalfx.com",
            hostname=cfg.hostname,
            hostname_tag=cfg.signalfx_hostname_tag or "host",
            vary_key_by=cfg.signalfx_vary_key_by,
            per_tag_api_keys=per_tag,
            flush_max_per_body=cfg.signalfx_flush_max_per_body or 5000,
            metric_name_prefix_drops=cfg.signalfx_metric_name_prefix_drops,
            metric_tag_prefix_drops=cfg.signalfx_metric_tag_prefix_drops,
            tags=cfg.tags,
            dynamic_per_tag_tokens_enable=(
                cfg.signalfx_dynamic_per_tag_api_keys_enable),
            dynamic_per_tag_tokens_refresh_s=refresh,
            api_endpoint=cfg.signalfx_endpoint_api
            or "https://api.signalfx.com"))
    if bool(cfg.splunk_hec_address) != bool(cfg.splunk_hec_token):
        # reference server.go:574-576: half a splunk config is an error
        raise ValueError(
            "both splunk_hec_address and splunk_hec_token must be set")

    # tracing sinks only exist when spans can arrive
    # (reference server.go:516 gates on ssf_listen_addresses)
    spans_enabled = bool(cfg.ssf_listen_addresses)
    if spans_enabled and cfg.datadog_trace_api_address:
        from veneur_tpu_torch.sinks.datadog_spans import DatadogSpanSink
        span_sinks.append(DatadogSpanSink(
            cfg.datadog_trace_api_address,
            buffer_size=cfg.datadog_span_buffer_size or 16384))
    if spans_enabled and cfg.splunk_hec_address:
        from veneur_tpu_torch.config import parse_duration
        from veneur_tpu_torch.sinks.splunk import SplunkSpanSink
        span_sinks.append(SplunkSpanSink(
            hec_address=cfg.splunk_hec_address,
            tls_validate_hostname=cfg.splunk_hec_tls_validate_hostname,
            token=cfg.splunk_hec_token,
            hostname=cfg.hostname,
            batch_size=cfg.splunk_hec_batch_size,
            sample_rate=cfg.splunk_span_sample_rate or 1,
            send_timeout=parse_duration(cfg.splunk_hec_send_timeout)
            if cfg.splunk_hec_send_timeout else 10.0,
            # reference example.yaml:500: workers default to 1
            workers=cfg.splunk_hec_submission_workers or 1,
            ingest_timeout=parse_duration(cfg.splunk_hec_ingest_timeout)
            if cfg.splunk_hec_ingest_timeout else 0.0,
            max_conn_lifetime=parse_duration(
                cfg.splunk_hec_max_connection_lifetime)
            if cfg.splunk_hec_max_connection_lifetime else 10.0,
            conn_lifetime_jitter=parse_duration(
                cfg.splunk_hec_connection_lifetime_jitter)
            if cfg.splunk_hec_connection_lifetime_jitter else 0.0))
    if spans_enabled and cfg.xray_address:
        if cfg.xray_sample_percentage <= 0:
            # reference server.go:535: 0% means no sink, loudly
            log.warning("xray_address set but xray_sample_percentage is 0; "
                        "not sending any segments")
        else:
            from veneur_tpu_torch.sinks.xray import XRaySpanSink
            span_sinks.append(XRaySpanSink(
                daemon_address=cfg.xray_address,
                sample_percentage=cfg.xray_sample_percentage,
                # annotation allowlist matches tag KEYS
                # (server.go:540-542 strips at ':')
                annotation_tags=[t.split(":")[0]
                                 for t in cfg.xray_annotation_tags]))
    if spans_enabled and cfg.falconer_address:
        from veneur_tpu_torch.sinks.grpsink import FalconerSpanSink
        span_sinks.append(FalconerSpanSink(cfg.falconer_address))
    if spans_enabled and cfg.grpsink_address:
        from veneur_tpu_torch.sinks.grpsink import GRPCSpanSink
        span_sinks.append(GRPCSpanSink(cfg.grpsink_address))
    if cfg.kafka_broker:
        from veneur_tpu_torch.sinks.kafka import KafkaMetricSink, KafkaSpanSink
        if cfg.kafka_metric_topic or cfg.kafka_check_topic:
            metric_sinks.append(KafkaMetricSink(
                cfg.kafka_broker,
                metric_topic=cfg.kafka_metric_topic,
                check_topic=cfg.kafka_check_topic))
        if spans_enabled and cfg.kafka_span_topic:
            span_sinks.append(KafkaSpanSink(
                cfg.kafka_broker, span_topic=cfg.kafka_span_topic,
                serialization=cfg.kafka_span_serialization_format
                or "protobuf",
                sample_rate_percent=cfg.kafka_span_sample_rate_percent,
                sample_tag=cfg.kafka_span_sample_tag))
    if spans_enabled and cfg.lightstep_access_token:
        from veneur_tpu_torch.sinks.lightstep import LightStepSpanSink
        span_sinks.append(LightStepSpanSink(
            access_token=cfg.lightstep_access_token,
            collector_host=cfg.lightstep_collector_host,
            num_clients=cfg.lightstep_num_clients or 1))
    if cfg.flush_file:
        from veneur_tpu_torch.sinks.localfile import LocalFilePlugin
        plugins.append(LocalFilePlugin(
            cfg.flush_file, cfg.hostname,
            interval_s=int(cfg.parse_interval())))
    if cfg.aws_s3_bucket and cfg.aws_region:
        from veneur_tpu_torch.plugins.s3 import S3Plugin
        plugins.append(S3Plugin(
            bucket=cfg.aws_s3_bucket, region=cfg.aws_region,
            access_key_id=cfg.aws_access_key_id,
            secret_access_key=cfg.aws_secret_access_key,
            hostname=cfg.hostname,
            interval_s=int(cfg.parse_interval()),
            staging_dir=cfg.aws_s3_staging_dir))

    return Server(cfg, metric_sinks=metric_sinks, span_sinks=span_sinks,
                  plugins=plugins, device=device)
