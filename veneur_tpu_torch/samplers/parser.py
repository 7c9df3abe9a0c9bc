"""DogStatsD / SSF parsing with reference-identical semantics.

Behavioral contract mirrors the reference's samplers/parser.go:
- ParseMetric (parser.go:298): ``name:value|type[|@rate][|#tags]``; type
  bytes c/g/d/h/ms/s; strict malformed-packet rejection; each section at
  most once; sample rate in (0, 1]; tags sorted then joined with ","; the
  32-bit FNV-1a digest over name+type+joined-tags is the sharding key.
- Magic tags (parser.go:397-407): the FIRST sorted tag with prefix
  "veneurlocalonly"/"veneurglobalonly" is stripped and becomes the scope
  (note: prefix match, first match only — both present means the
  lexicographically-earlier "veneurglobalonly" wins and the local tag
  remains in the tag list; we reproduce that).
- ParseEvent (parser.go:431): ``_e{tl,tx}:title|text|...`` with d:/h:/k:/
  p:/s:/t:/#tags metadata, producing an SSF sample carrying the
  vdogstatsd_* conduit tags.
- ParseServiceCheck (parser.go:579): ``_sc|name|status|...`` with d:/h:/
  #tags/m: (message must be last); digest stays 0 (the reference never
  digests service checks — they all land on worker 0, server.go:973).
- ParseMetricSSF (parser.go:239): SSFSample -> UDPMetric, where the
  sample's map tags become sorted "k:v" strings and zero sample rates were
  already normalized to 1 by the wire layer.

The value of keeping these semantics bit-exact is shard compatibility: a
mixed fleet of reference instances and this framework hashes every key to
the same digest, so proxies can route to either.
"""

from __future__ import annotations

import copy
import dataclasses
import random
import struct
import time
from typing import Optional, Union

from veneur_tpu_torch.proto import ssf_pb2
from veneur_tpu_torch.protocol.wire import valid_trace
from veneur_tpu_torch.samplers import ssf_samples
from veneur_tpu_torch.utils.hashing import FNV32_OFFSET, FNV32_PRIME

# MetricScope (reference parser.go:66-70)
MIXED_SCOPE = 0
LOCAL_ONLY = 1
GLOBAL_ONLY = 2

# DogStatsD event conduit tags (reference protocol/dogstatsd/protocol.go)
EVENT_IDENTIFIER_KEY = "vdogstatsd_ev"
EVENT_AGGREGATION_KEY_TAG_KEY = "vdogstatsd_ak"
EVENT_ALERT_TYPE_TAG_KEY = "vdogstatsd_at"
EVENT_HOSTNAME_TAG_KEY = "vdogstatsd_hostname"
EVENT_PRIORITY_TAG_KEY = "vdogstatsd_pri"
EVENT_SOURCE_TYPE_TAG_KEY = "vdogstatsd_st"


class ParseError(ValueError):
    pass


@dataclasses.dataclass
class UDPMetric:
    """A parsed sample; the MetricKey is (name, type, joined_tags)."""
    name: str = ""
    type: str = ""
    value: Union[float, str, int, None] = None
    digest: int = 0
    sample_rate: float = 1.0
    tags: tuple = ()
    joined_tags: str = ""
    scope: int = MIXED_SCOPE
    timestamp: int = 0
    message: str = ""
    hostname: str = ""

    def key(self):
        return (self.name, self.type, self.joined_tags)


def _fnv_add(h: int, data: bytes) -> int:
    for b in data:
        h = ((h ^ b) * FNV32_PRIME) & 0xFFFFFFFF
    return h


_TYPE_BY_BYTE = {
    ord("c"): "counter",
    ord("g"): "gauge",
    ord("d"): "histogram",  # DogStatsD "distribution" -> histogram
    ord("h"): "histogram",
    ord("m"): "timer",      # "ms"; trailing 's' ignored
    ord("s"): "set",
}


def _strip_magic_tags(tags: list) -> tuple:
    """Sorted-first-prefix-match magic tag stripping; returns (tags, scope)."""
    scope = MIXED_SCOPE
    for i, tag in enumerate(tags):
        if tag.startswith("veneurlocalonly"):
            del tags[i]
            scope = LOCAL_ONLY
            break
        if tag.startswith("veneurglobalonly"):
            del tags[i]
            scope = GLOBAL_ONLY
            break
    return tags, scope


# Key-level parse cache: digest (3 sequential per-byte FNV passes — the
# dominant pure-Python cost), decoded name, sorted/joined tags and scope
# depend only on (name bytes, type, raw tag section), which a steady-state
# server sees over and over (the reference pays the same work per sample
# in Go, worker.go:344; the C++ engine caches nothing because its FNV is
# ~free). Bounded: cleared wholesale when full, so a cardinality attack
# costs a re-warm, not memory.
_KEY_CACHE: dict = {}
_KEY_CACHE_MAX = 1 << 16
# same idea for the SSF converter (parse_metric_ssf): digest keyed by
# (name, type, joined_tags), bounded by wholesale clear
_SSF_DIGEST_CACHE: dict = {}


def _cache_put(cache: dict, key, value):
    """The shared bounded-insert idiom: wholesale clear when full, so a
    cardinality attack costs a re-warm, not memory."""
    if len(cache) >= _KEY_CACHE_MAX:
        cache.clear()
    cache[key] = value


def _pb_str(b: bytes) -> str:
    """Decode bytes destined for an SSF protobuf STRING field. Protobuf
    rejects surrogates (assignment raises, which killed the pipeline
    thread for one corrupt event datagram — the set-member DoS class),
    so invalid UTF-8 becomes U+FFFD here — the same replacement Go's
    encoding/json applies to invalid bytes when the reference marshals
    events downstream. Metric-path decodes keep surrogateescape — key
    identity must round-trip to the original bytes — and the forward
    path applies the same replacement at ITS protobuf boundary
    (forward/convert.py _wire_str)."""
    return b.decode("utf-8", "replace")


def _f32(x: float) -> float:
    """Round-trip through float32 — SSFSample.value/sample_rate are proto
    `float` fields, so every cold-path metric is f32-quantized; hot
    template paths must quantize identically or warm keys would emit
    different bits than cold keys for the same span."""
    return struct.unpack("f", struct.pack("f", x))[0]


def _key_info(name_b: bytes, mtype: str, tags_chunk):
    ck = (name_b, mtype, tags_chunk)
    info = _KEY_CACHE.get(ck)
    if info is None:
        h = _fnv_add(FNV32_OFFSET, name_b)
        h = _fnv_add(h, mtype.encode())
        if tags_chunk is None:
            tags, joined, scope = (), "", MIXED_SCOPE
        else:
            tl = sorted(
                tags_chunk[1:].decode("utf-8", "surrogateescape")
                .split(","))
            tl, scope = _strip_magic_tags(tl)
            tags = tuple(tl)
            joined = ",".join(tl)
            h = _fnv_add(h, joined.encode("utf-8", "surrogateescape"))
        info = (h, name_b.decode("utf-8", "surrogateescape"), tags,
                joined, scope)
        _cache_put(_KEY_CACHE, ck, info)
    return info


def parse_metric(packet: bytes) -> UDPMetric:
    """Parse one DogStatsD datagram line into a UDPMetric."""
    chunks = packet.split(b"|")
    first = chunks[0]
    colon = first.find(b":")
    if colon == -1:
        raise ParseError("need at least 1 colon")
    name_b = first[:colon]
    value_b = first[colon + 1:]
    if not name_b:
        raise ParseError("name cannot be empty")
    if len(chunks) < 2:
        raise ParseError("need at least 1 pipe for type")
    type_b = chunks[1]
    if not type_b:
        raise ParseError("metric type not specified")

    mtype = _TYPE_BY_BYTE.get(type_b[0])
    if mtype is None:
        raise ParseError("invalid type for metric")

    m = UDPMetric(type=mtype)

    if mtype == "set":
        m.value = value_b.decode("utf-8", "surrogateescape")
    else:
        # Go's strconv.ParseFloat is stricter than Python float(): no
        # surrounding whitespace, no underscores.
        if value_b != value_b.strip() or b"_" in value_b:
            raise ParseError("invalid number for metric value")
        try:
            v = float(value_b)
        except ValueError:
            raise ParseError("invalid number for metric value")
        if v != v or v in (float("inf"), float("-inf")):
            raise ParseError("invalid number for metric value")
        m.value = v

    found_rate = False
    tags_chunk = None
    for chunk in chunks[2:]:
        if not chunk:
            raise ParseError("empty string after/between pipes")
        lead = chunk[0]
        if lead == 0x40:  # '@'
            if found_rate:
                raise ParseError("multiple sample rates specified")
            rate_b = chunk[1:]
            # same strictness as the value: no underscores (Python float
            # accepts '0.2_5', the wire format does not) and finite — a
            # NaN rate would pass the range checks below (NaN comparisons
            # are false) and poison counters with value*(1/NaN)
            if b"_" in rate_b or rate_b != rate_b.strip():
                raise ParseError("invalid float for sample rate")
            try:
                rate = float(rate_b)
            except ValueError:
                raise ParseError("invalid float for sample rate")
            if rate != rate or not (0 < rate <= 1):
                raise ParseError("sample rate must be >0 and <=1")
            m.sample_rate = rate
            found_rate = True
        elif lead == 0x23:  # '#'
            if tags_chunk is not None:
                raise ParseError("multiple tag sections specified")
            tags_chunk = chunk
        else:
            raise ParseError("contains unknown section")

    m.digest, m.name, m.tags, m.joined_tags, m.scope = _key_info(
        name_b, mtype, tags_chunk)
    return m


def parse_tags_to_map(tags) -> dict:
    """Split "k:v" tag strings into a dict (reference parser.go:696)."""
    out = {}
    for tag in tags:
        k, _, v = tag.partition(":")
        out[k] = v
    return out


def parse_event(packet: bytes, now: Optional[int] = None) -> ssf_pb2.SSFSample:
    """Parse a DogStatsD event into an SSF sample with vdogstatsd_* tags."""
    chunks = packet.split(b"|")
    first = chunks[0]
    colon = first.find(b":")
    if colon == -1:
        raise ParseError("event needs at least 1 colon")
    lengths = first[:colon]
    if not lengths.startswith(b"_e{") or not lengths.endswith(b"}"):
        raise ParseError("event must have _e{} wrapper around length section")
    lengths = lengths[3:-1]
    comma = lengths.find(b",")
    if comma == -1:
        raise ParseError("event length section requires comma divider")
    try:
        title_len = int(lengths[:comma])
        text_len = int(lengths[comma + 1:])
    except ValueError:
        raise ParseError("event lengths must be integers")
    if title_len <= 0 or text_len <= 0:
        raise ParseError("event lengths must be positive")

    title = first[colon + 1:]
    if len(title) != title_len:
        raise ParseError("actual title length did not match encoded length")
    if len(chunks) < 2:
        raise ParseError("event must have at least 1 pipe for text")
    text = chunks[1]
    if len(text) != text_len:
        raise ParseError("actual text length did not match encoded length")

    sample = ssf_pb2.SSFSample(
        name=_pb_str(title),
        message=_pb_str(text).replace("\\n", "\n"),
        timestamp=now if now is not None else int(time.time()),
    )
    sample.tags[EVENT_IDENTIFIER_KEY] = ""

    seen = set()

    def once(key):
        if key in seen:
            raise ParseError(f"multiple {key} sections")
        seen.add(key)

    for chunk in chunks[2:]:
        if not chunk:
            raise ParseError("empty string after/between pipes")
        if chunk.startswith(b"d:"):
            once("date")
            try:
                sample.timestamp = int(chunk[2:])
            except ValueError:
                raise ParseError("could not parse date as unix timestamp")
        elif chunk.startswith(b"h:"):
            once("hostname")
            sample.tags[EVENT_HOSTNAME_TAG_KEY] = _pb_str(chunk[2:])
        elif chunk.startswith(b"k:"):
            once("aggregation")
            sample.tags[EVENT_AGGREGATION_KEY_TAG_KEY] = _pb_str(chunk[2:])
        elif chunk.startswith(b"p:"):
            once("priority")
            pri = _pb_str(chunk[2:])
            if pri not in ("normal", "low"):
                raise ParseError("priority must be normal or low")
            sample.tags[EVENT_PRIORITY_TAG_KEY] = pri
        elif chunk.startswith(b"s:"):
            once("source")
            sample.tags[EVENT_SOURCE_TYPE_TAG_KEY] = _pb_str(chunk[2:])
        elif chunk.startswith(b"t:"):
            once("alert")
            alert = _pb_str(chunk[2:])
            if alert not in ("error", "warning", "info", "success"):
                raise ParseError(
                    "alert level must be error, warning, info or success")
            sample.tags[EVENT_ALERT_TYPE_TAG_KEY] = alert
        elif chunk[0] == 0x23:  # '#'
            once("tags")
            tags = _pb_str(chunk[1:]).split(",")
            for k, v in parse_tags_to_map(tags).items():
                sample.tags[k] = v
        else:
            raise ParseError("unrecognized event metadata section")
    return sample


def parse_service_check(packet: bytes, now: Optional[int] = None) -> UDPMetric:
    """Parse a DogStatsD service check into a status-typed UDPMetric."""
    chunks = packet.split(b"|")
    if chunks[0] != b"_sc":
        raise ParseError("service check needs _sc prefix")
    if len(chunks) < 2:
        raise ParseError("service check needs name section")
    if not chunks[1]:
        raise ParseError("service check name cannot be empty")
    if len(chunks) < 3:
        raise ParseError("service check needs status section")

    status_map = {b"0": ssf_pb2.SSFSample.OK, b"1": ssf_pb2.SSFSample.WARNING,
                  b"2": ssf_pb2.SSFSample.CRITICAL,
                  b"3": ssf_pb2.SSFSample.UNKNOWN}
    if chunks[2] not in status_map:
        raise ParseError("service check status must be 0, 1, 2, or 3")

    m = UDPMetric(
        type="status",
        name=chunks[1].decode("utf-8", "surrogateescape"),
        value=int(status_map[chunks[2]]),
        timestamp=now if now is not None else int(time.time()),
    )

    found = set()
    found_message = False
    for chunk in chunks[3:]:
        if not chunk:
            raise ParseError("empty string after/between pipes")
        if found_message:
            raise ParseError("message must be the last metadata section")
        if chunk.startswith(b"d:"):
            if "date" in found:
                raise ParseError("multiple date sections")
            found.add("date")
            try:
                m.timestamp = int(chunk[2:])
            except ValueError:
                raise ParseError("could not parse date as unix timestamp")
        elif chunk.startswith(b"h:"):
            if "hostname" in found:
                raise ParseError("multiple hostname sections")
            found.add("hostname")
            m.hostname = chunk[2:].decode("utf-8", "surrogateescape")
        elif chunk.startswith(b"m:"):
            m.message = chunk[2:].decode(
                "utf-8", "surrogateescape").replace("\\n", "\n")
            found_message = True
        elif chunk[0] == 0x23:  # '#'
            if "tags" in found:
                raise ParseError("multiple tag sections")
            found.add("tags")
            tags = sorted(chunk[1:].decode("utf-8", "surrogateescape").split(","))
            # exact-equality magic tags here (unlike metric prefix match)
            scope = MIXED_SCOPE
            for i, tag in enumerate(tags):
                if tag == "veneurlocalonly":
                    del tags[i]
                    scope = LOCAL_ONLY
                    break
                if tag == "veneurglobalonly":
                    del tags[i]
                    scope = GLOBAL_ONLY
                    break
            m.scope = scope
            m.tags = tuple(tags)
            m.joined_tags = ",".join(tags)
        else:
            raise ParseError("unrecognized service check metadata section")
    return m


_SSF_TYPE = {
    ssf_pb2.SSFSample.COUNTER: "counter",
    ssf_pb2.SSFSample.GAUGE: "gauge",
    ssf_pb2.SSFSample.HISTOGRAM: "histogram",
    ssf_pb2.SSFSample.SET: "set",
    ssf_pb2.SSFSample.STATUS: "status",
}


def parse_metric_ssf(sample: ssf_pb2.SSFSample) -> UDPMetric:
    """Convert an SSF sample to a UDPMetric (reference parser.go:239)."""
    mtype = _SSF_TYPE.get(sample.metric)
    if mtype is None:
        raise ParseError("invalid type for metric")
    m = UDPMetric(type=mtype, name=sample.name)

    if sample.metric == ssf_pb2.SSFSample.SET:
        m.value = sample.message
    elif sample.metric == ssf_pb2.SSFSample.STATUS:
        m.value = int(sample.status)
    else:
        m.value = float(sample.value)

    if sample.scope == ssf_pb2.SSFSample.LOCAL:
        m.scope = LOCAL_ONLY
    elif sample.scope == ssf_pb2.SSFSample.GLOBAL:
        m.scope = GLOBAL_ONLY

    m.sample_rate = sample.sample_rate
    tags = []
    for k, v in sample.tags.items():
        if k == "veneurlocalonly":
            m.scope = LOCAL_ONLY
            continue
        if k == "veneurglobalonly":
            m.scope = GLOBAL_ONLY
            continue
        tags.append(f"{k}:{v}")
    tags.sort()
    m.tags = tuple(tags)
    m.joined_tags = ",".join(tags)
    # the three sequential per-byte FNV passes dominate this converter's
    # pure-Python cost (the dogstatsd text path caches the same way,
    # _key_info above); extraction workloads repeat (name, type, tags)
    # shapes heavily — SLI timers vary only by service/error tags
    ck = (m.name, mtype, m.joined_tags)
    h = _SSF_DIGEST_CACHE.get(ck)
    if h is None:
        h = _fnv_add(FNV32_OFFSET,
                     m.name.encode("utf-8", "surrogateescape"))
        h = _fnv_add(h, mtype.encode())
        h = _fnv_add(h, m.joined_tags.encode("utf-8", "surrogateescape"))
        _cache_put(_SSF_DIGEST_CACHE, ck, h)
    m.digest = h
    return m


def valid_metric(m: UDPMetric) -> bool:
    """reference parser.go ValidMetric."""
    return bool(m.name) and m.value is not None


def convert_metrics(span):
    """Extract the span's embedded SSF samples as UDPMetrics (reference
    parser.go:103 ConvertMetrics). Returns (metrics, invalid_samples)."""
    metrics, invalid = [], []
    for sample in span.metrics:
        try:
            m = parse_metric_ssf(sample)
        except ParseError:
            invalid.append(sample)
            continue
        if not valid_metric(m):
            invalid.append(sample)
            continue
        metrics.append(m)
    return metrics, invalid


def _clone_metric(tpl: UDPMetric) -> UDPMetric:
    """Shallow template clone. copy.copy routes through __reduce_ex__
    (~8x the cost); every UDPMetric field is an immutable scalar/tuple,
    so a __dict__ copy is safe and this sits on the span-firehose hot
    path."""
    m = object.__new__(UDPMetric)
    m.__dict__.update(tpl.__dict__)
    return m


_INDICATOR_TPL_CACHE: dict = {}


def convert_indicator_metrics(span, indicator_timer_name: str,
                              objective_timer_name: str):
    """Indicator spans -> SLI timers (reference parser.go:129
    ConvertIndicatorMetrics): duration as an indicator timer tagged
    service/error, and an objective timer additionally tagged with the
    span name (overridable via the ssf_objective tag) and
    veneurglobalonly.

    Everything except the duration is a pure function of
    (service, error, objective) — tiny cardinality on a real span
    firehose — so the built UDPMetrics are cached as templates and
    cloned per span; the SSFSample-protobuf + parse path runs only on a
    cold key (measured ~5x on the extraction hot loop, which is the
    host floor of BASELINE config 5's span firehose)."""
    if not span.indicator or not valid_trace(span):
        return []
    duration_s = (span.end_timestamp - span.start_timestamp) / 1e9
    err = "true" if span.error else "false"
    objective = (span.tags.get("ssf_objective") or span.name) \
        if objective_timer_name else ""
    ck = (indicator_timer_name, objective_timer_name, span.service, err,
          objective)
    tpls = _INDICATOR_TPL_CACHE.get(ck)
    if tpls is None:
        out = []
        if indicator_timer_name:
            t = ssf_samples.timing(indicator_timer_name, duration_s,
                                   {"service": span.service, "error": err})
            out.append(parse_metric_ssf(t))
        if objective_timer_name:
            t = ssf_samples.timing(objective_timer_name, duration_s,
                                   {"service": span.service,
                                    "objective": objective,
                                    "error": err,
                                    "veneurglobalonly": "true"})
            out.append(parse_metric_ssf(t))
        # cache COPIES: the returned metrics must never alias templates
        _cache_put(_INDICATOR_TPL_CACHE, ck,
                   tuple(copy.copy(m) for m in out))
        return out
    # same arithmetic as the cold path, INCLUDING the f32 quantization
    # the SSFSample proto value field imposes, so hot and cold spans
    # are bit-identical
    value = _f32(duration_s * 1e9)
    out = []
    for tpl in tpls:
        m = _clone_metric(tpl)
        m.value = value
        out.append(m)
    return out


_UNIQUENESS_TPL_CACHE: dict = {}


def convert_span_uniqueness_metrics(span, rate: float = 0.01):
    """Unique span-name Sets per service at a sampling rate (reference
    parser.go:187 ConvertSpanUniquenessMetrics).

    The sampling roll runs FIRST (same Bernoulli semantics as
    RandomlySample, samples.go:128) so the 99% of spans that sample out
    never pay the protobuf construction, and kept samples clone a cached
    template keyed by the span's tag shape — only the set member (the
    span name) and the effective sample rate vary."""
    if not span.service:
        return []
    if rate < 1.0 and random.random() >= rate:
        return []
    ck = (span.service, bool(span.indicator), span.id == span.trace_id)
    tpl = _UNIQUENESS_TPL_CACHE.get(ck)
    if tpl is None:
        s = ssf_samples.set_("ssf.names_unique", span.name, {
            "indicator": "true" if span.indicator else "false",
            "service": span.service,
            "root_span": "true" if span.id == span.trace_id else "false",
        })
        if rate < 1.0:
            s.sample_rate = rate      # RandomlySample's marking
        m = parse_metric_ssf(s)
        # cache a COPY: the returned metric must never alias the template
        _cache_put(_UNIQUENESS_TPL_CACHE, ck, copy.copy(m))
        return [m]
    m = _clone_metric(tpl)
    m.value = span.name
    # f32 like the cold path's proto sample_rate field
    m.sample_rate = _f32(rate) if rate < 1.0 else 1.0
    return [m]
