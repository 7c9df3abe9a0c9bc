"""`new_from_config` (ROADMAP A12): the port's factory builds from every
sink and plugin config key what the JAX package's factory builds, with
the same constructor settings, and raises where it raises.

This box has no Kafka client library, no `lightstep` package and no
`boto3`, so those three keys raise RuntimeError in both factories.
"""

import logging
import queue
import threading

import pytest

from tests.test_torch_server import SMALL
from veneur_tpu import config as jconfig
from veneur_tpu.server import factory as jfactory
from veneur_tpu_torch import config as tconfig
from veneur_tpu_torch.server import factory as tfactory

# one case for each key the factory used to refuse, each with the keys
# and defaults that shape what it builds
SINK_KEYS = {
    "datadog_api_key": dict(
        datadog_api_key="k", datadog_api_hostname="https://dd.example/",
        datadog_flush_max_per_body=123, tags=["a:b", "c:d"],
        datadog_metric_name_prefix_drops=["x."],
        datadog_exclude_tags_prefix_by_prefix_metric={"y.": ["team"]}),
    "signalfx_api_key": dict(
        signalfx_api_key="k", signalfx_vary_key_by="customer",
        signalfx_per_tag_api_keys=[{"name": "acme", "api_key": "t1"}],
        signalfx_hostname_tag="hn", signalfx_metric_name_prefix_drops=["x"],
        signalfx_metric_tag_prefix_drops=["zone"],
        signalfx_dynamic_per_tag_api_keys_enable=True,
        signalfx_dynamic_per_tag_api_keys_refresh_period="90s"),
    "splunk_hec_address": dict(
        splunk_hec_address="https://hec.example:8088", splunk_hec_token="t",
        splunk_hec_batch_size=17, splunk_span_sample_rate=3,
        splunk_hec_send_timeout="2s", splunk_hec_submission_workers=2,
        splunk_hec_ingest_timeout="50ms",
        splunk_hec_max_connection_lifetime="30s",
        splunk_hec_connection_lifetime_jitter="5s",
        splunk_hec_tls_validate_hostname="hec.internal"),
    "datadog_trace_api_address": dict(
        datadog_trace_api_address="http://127.0.0.1:1/",
        datadog_span_buffer_size=99),
    "xray_address": dict(xray_address="127.0.0.1:2000",
                         xray_sample_percentage=5.0,
                         xray_annotation_tags=["env:x", "team"]),
    "falconer_address": dict(falconer_address="127.0.0.1:1"),
    "grpsink_address": dict(grpsink_address="127.0.0.1:1"),
    "kafka_broker": dict(kafka_broker="x:1", kafka_metric_topic="m",
                         kafka_span_topic="s"),
    "lightstep_access_token": dict(lightstep_access_token="t",
                                   lightstep_num_clients=2),
    "aws_s3_bucket": dict(aws_s3_bucket="b", aws_region="r",
                          aws_s3_staging_dir="/nonexistent/stage"),
}
NO_LIBRARY = {"kafka_broker": "confluent_kafka",
              "lightstep_access_token": "lightstep",
              "aws_s3_bucket": "boto3"}

_PLAIN = (str, int, float, bool, type(None))


def _plain(v):
    """v with every value that is no plain datum left out (threads,
    sockets, locks, queues, channels, bound callables)."""
    if isinstance(v, _PLAIN):
        return v
    if isinstance(v, (list, tuple, set, frozenset)):
        return type(v)(_plain(x) for x in v if _is_plain(x))
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items() if _is_plain(x)}
    return None


def _is_plain(v):
    if isinstance(v, _PLAIN):
        return True
    if isinstance(v, (list, tuple, set, frozenset)):
        return all(_is_plain(x) for x in v)
    if isinstance(v, dict):
        return all(_is_plain(x) for x in v.values())
    return False


def _settings(obj):
    return (type(obj).__name__, obj.name,
            {k: _plain(v) for k, v in vars(obj).items() if _is_plain(v)})


def _built(srv):
    return ([_settings(s) for s in srv.metric_sinks],
            [_settings(s) for s in srv.span_sinks],
            [_settings(p) for p in srv.plugins])


def _close(srv):
    for s in srv.span_sinks:
        if hasattr(s, "stop") and type(s).__name__ == "SplunkSpanSink":
            s.stop()
        if hasattr(s, "close"):
            s.close()


def _build_both(kw):
    j = jfactory.new_from_config(jconfig.Config(**kw))
    t = tfactory.new_from_config(tconfig.Config(**kw), device="cpu")
    try:
        assert t.device.type == "cpu"
        return _built(j), _built(t)
    finally:
        _close(j)
        _close(t)


@pytest.mark.parametrize("key", sorted(SINK_KEYS))
def test_both_factories_build_the_same_sinks(key):
    kw = dict(SMALL, http_address="", **SINK_KEYS[key])
    if key in NO_LIBRARY:
        for factory, config, extra in (
                (jfactory, jconfig, {}),
                (tfactory, tconfig, {"device": "cpu"})):
            with pytest.raises(RuntimeError, match=NO_LIBRARY[key]):
                factory.new_from_config(config.Config(**kw), **extra)
        return
    j, t = _build_both(kw)
    assert j == t
    names = [n for group in t for _cls, n, _s in group]
    want = {"datadog_api_key": "datadog", "signalfx_api_key": "signalfx",
            "splunk_hec_address": "splunk",
            "datadog_trace_api_address": "datadog", "xray_address": "xray",
            "falconer_address": "falconer",
            "grpsink_address": "grpc_span_sink"}[key]
    assert want in names


def test_the_settings_carry_the_config_keys():
    kw = dict(SMALL, http_address="", **SINK_KEYS["splunk_hec_address"],
              **SINK_KEYS["signalfx_api_key"], **SINK_KEYS["xray_address"])
    _j, (metric, span, _p) = _build_both(kw)
    sfx = {cls: s for cls, _n, s in metric}["SignalFxMetricSink"]
    assert sfx["per_tag_api_keys"] == {"acme": "t1"}
    assert sfx["dynamic_per_tag_tokens_refresh_s"] == 90.0
    assert sfx["endpoint"] == "https://ingest.signalfx.com"
    by = {cls: s for cls, _n, s in span}
    splunk = by["SplunkSpanSink"]
    assert (splunk["batch_size"], splunk["sample_rate"], splunk["workers"],
            splunk["send_timeout"], splunk["ingest_timeout"],
            splunk["max_conn_lifetime"], splunk["conn_lifetime_jitter"]) \
        == (17, 3, 2, 2.0, 0.05, 30.0, 5.0)
    assert by["XRaySpanSink"]["annotation_tags"] == ["env", "team"]


@pytest.mark.parametrize("half", [dict(splunk_hec_address="https://x"),
                                  dict(splunk_hec_token="t")],
                         ids=["address", "token"])
def test_half_a_splunk_config_raises_in_both(half):
    kw = dict(SMALL, http_address="", **half)
    with pytest.raises(ValueError, match="splunk_hec_address"):
        jfactory.new_from_config(jconfig.Config(**kw))
    with pytest.raises(ValueError, match="splunk_hec_address"):
        tfactory.new_from_config(tconfig.Config(**kw), device="cpu")


def test_xray_at_zero_percent_warns_and_builds_no_sink(caplog):
    kw = dict(SMALL, http_address="", xray_address="127.0.0.1:2000",
              xray_sample_percentage=0.0)
    with caplog.at_level(logging.WARNING):
        j, t = _build_both(kw)
    assert j == t
    assert not [n for _c, n, _s in t[1] if n == "xray"]
    assert sum("xray_sample_percentage is 0" in r.getMessage()
               for r in caplog.records) == 2


def test_a_per_tag_key_without_a_name_raises_in_both():
    kw = dict(SMALL, http_address="", signalfx_api_key="k",
              signalfx_per_tag_api_keys=[{"api_key": "t1"}])
    with pytest.raises(ValueError, match="name and api_key"):
        jfactory.new_from_config(jconfig.Config(**kw))
    with pytest.raises(ValueError, match="name and api_key"):
        tfactory.new_from_config(tconfig.Config(**kw), device="cpu")


def test_span_sinks_need_ssf_listen_addresses():
    kw = dict(SMALL, http_address="", ssf_listen_addresses=[],
              **SINK_KEYS["falconer_address"], **SINK_KEYS["xray_address"],
              **SINK_KEYS["datadog_trace_api_address"])
    j, t = _build_both(kw)
    assert j == t
    assert not [n for _c, n, _s in t[1]
                if n in ("falconer", "xray", "datadog")]


def test_injected_sinks_and_plugins_come_first():
    """extra_metric_sinks, extra_span_sinks and extra_plugins are how
    the Kafka, LightStep and S3 clients go in where no library is."""
    from veneur_tpu_torch.plugins.s3 import S3Plugin
    from veneur_tpu_torch.sinks.kafka import KafkaMetricSink
    from veneur_tpu_torch.sinks.lightstep import LightStepSpanSink
    sent = queue.SimpleQueue()
    kafka = KafkaMetricSink("x:1", "m",
                            producer=lambda *a: sent.put(a))
    ls = LightStepSpanSink("t", client_factory=threading.Event)
    s3 = S3Plugin("b", "r", "h", client=object())
    srv = tfactory.new_from_config(
        tconfig.Config(**dict(SMALL, http_address="",
                              debug_flushed_metrics=True)),
        extra_metric_sinks=[kafka], extra_span_sinks=[ls],
        extra_plugins=[s3], device="cpu")
    assert srv.metric_sinks[0] is kafka
    assert type(srv.metric_sinks[1]).__name__ == "DebugMetricSink"
    assert ls in srv.span_sinks and srv.plugins == [s3]
