"""Kafka metric + span sink (reference sinks/kafka/kafka.go).

The reference uses sarama async producers; this image carries no Kafka
client library, so the producer is injectable: any callable
`produce(topic: str, key: bytes, value: bytes)` (e.g.
confluent_kafka.Producer(...).produce). Without one, construction tries
`kafka-python` / `confluent_kafka` and raises a clear error if neither
exists — the factory only wires this sink when kafka_broker is set.

Serialization mirrors the reference: metrics as JSON, spans as protobuf or
JSON (kafka_span_serialization_format), hash-partitioned by trace id via
the message key (kafka.go:228-306), span sampling by tag/rate.
"""

from __future__ import annotations

import json
import logging
import math
from typing import Callable, Optional

from veneur_tpu_torch.reliability.policy import CircuitOpenError
from veneur_tpu_torch.sinks.base import (MetricSink, ResilientSink,
                                         SpanSink, filter_acceptable)

log = logging.getLogger("veneur_tpu_torch.sinks.kafka")


def _default_producer(broker: str) -> Callable:
    try:
        from confluent_kafka import Producer  # type: ignore

        p = Producer({"bootstrap.servers": broker})

        def produce(topic, key, value):
            p.produce(topic, key=key, value=value)
            p.poll(0)

        return produce
    except ImportError:
        pass
    try:
        from kafka import KafkaProducer  # type: ignore

        p = KafkaProducer(bootstrap_servers=broker)
        return lambda topic, key, value: p.send(topic, key=key, value=value)
    except ImportError:
        raise RuntimeError(
            "kafka sink requires confluent_kafka or kafka-python, or an "
            "injected producer callable")


class KafkaMetricSink(ResilientSink, MetricSink):
    name = "kafka"

    def __init__(self, broker: str, metric_topic: str,
                 check_topic: str = "", producer: Optional[Callable] = None):
        self.metric_topic = metric_topic
        self.check_topic = check_topic
        self.produce = producer or _default_producer(broker)
        self.flushed = 0

    # the reference produces json.Marshal(InterMetric) with NO field
    # tags (kafka.go:205): Go-default capitalized keys, the MetricType
    # iota as a NUMBER, and Sinks as a key-only map (null = every sink).
    # Consumers built against that schema must keep working.
    _TYPE_NUM = {"counter": 0, "gauge": 1, "status": 2}

    def flush(self, metrics):
        for m in filter_acceptable(metrics, self.name):
            if not math.isfinite(m.value):
                # Go's json.Marshal errors on non-finite floats, and the
                # reference ABORTS the whole flush on that error
                # (kafka.go:205-210). Deliberate deviation: drop only the
                # bad message — one NaN must not wipe the interval's batch
                # — while still never emitting Python's bare NaN literal,
                # which strict consumers reject.
                log.warning("kafka: dropping non-finite metric %s", m.name)
                continue
            topic = (self.check_topic
                     if m.type == "status" and self.check_topic
                     else self.metric_topic)
            value = json.dumps({
                "Name": m.name, "Timestamp": m.timestamp,
                "Value": m.value, "Tags": list(m.tags),
                "Type": self._TYPE_NUM.get(m.type, 1),
                "Message": m.message, "HostName": m.hostname,
                "Sinks": ({s: {} for s in sorted(m.sinks)}
                          if m.sinks is not None else None),
            }).encode()
            try:
                self.resilient_post(
                    lambda: self.produce(topic, m.name.encode(), value),
                    what="produce")
                self.flushed += 1
            except CircuitOpenError as e:
                # the breaker refuses every remaining message in the
                # batch too — one warning, not thousands of error lines
                log.warning("kafka: %s; skipping rest of batch", e)
                break
            except Exception as e:
                log.error("kafka produce failed: %s", e)


class KafkaSpanSink(ResilientSink, SpanSink):
    name = "kafka"

    def __init__(self, broker: str, span_topic: str,
                 serialization: str = "protobuf",
                 sample_rate_percent: int = 100, sample_tag: str = "",
                 producer: Optional[Callable] = None):
        self.span_topic = span_topic
        self.serialization = serialization
        self.sample_rate_percent = sample_rate_percent
        self.sample_tag = sample_tag
        self.produce = producer or _default_producer(broker)
        self.sent = 0
        self.skipped = 0

    def ingest(self, span) -> None:
        # sampling: by tag value hash when a sample tag is configured,
        # else by trace id (kafka.go:228-306). The hash must be stable
        # across restarts and fleet members so a sampled trace stays whole
        # — builtin hash() is PYTHONHASHSEED-randomized, fnv1a is not.
        if self.sample_rate_percent < 100:
            from veneur_tpu_torch.utils.hashing import fnv1a_64
            basis = (fnv1a_64(span.tags.get(self.sample_tag, "").encode())
                     if self.sample_tag else span.trace_id)
            if (basis % 100) >= self.sample_rate_percent:
                self.skipped += 1
                return
        key = b"%016x" % (span.trace_id & ((1 << 64) - 1))
        if self.serialization == "json":
            value = json.dumps({
                "trace_id": span.trace_id, "id": span.id,
                "parent_id": span.parent_id, "name": span.name,
                "service": span.service, "error": span.error,
                "start_timestamp": span.start_timestamp,
                "end_timestamp": span.end_timestamp,
                "tags": dict(span.tags),
            }).encode()
        else:
            value = span.SerializeToString()
        try:
            self.resilient_post(
                lambda: self.produce(self.span_topic, key, value),
                what="produce")
            self.sent += 1
        except Exception as e:
            log.error("kafka span produce failed: %s", e)
