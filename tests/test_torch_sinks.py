"""The port's sinks and S3 plugin (ROADMAP A12) against the JAX
package's, on the CPU.

Each case feeds the same InterMetrics, frames, events and spans (made
from a numpy seed) through the JAX sink and the port's, each against
its own local fake: an HTTP server, a UDP socket, an in-process gRPC
server, an injected Kafka producer, LightStep client or S3 client. The
decompressed bodies, datagrams, protobuf bytes, Kafka keys and values
and gzip-decoded CSV must be byte-equal. The behaviours are those that
tests/test_sinks.py, tests/test_csv_plugin.py and
tests/test_persistence.py's S3 staging test hold on the reference.
"""

import gzip
import http.server
import importlib
import itertools
import json
import os
import socket
import threading
import time
import zlib

import numpy as np
import pytest

from tests.test_spans import make_span
from veneur_tpu.proto import ssf_pb2 as jssf
from veneur_tpu_torch.proto import ssf_pb2 as tssf

ROOTS = ("veneur_tpu", "veneur_tpu_torch")
TS = 1476119058


def _mod(root, name):
    return importlib.import_module(f"{root}.{name}")


# -- inputs from a seed ------------------------------------------------------

_TAGS = ["env:prod", "team:sre", "customer:acme", "customer:other",
         "novalue", "host:peer-7", "device:sda1", "secret:x",
         "veneursinkonly:datadog", "veneursinkonly:signalfx", "zone:b"]


def metric_rows(seed, n=48):
    """(name, value, type, tags, hostname, message) rows: counters,
    gauges and status checks over a few name prefixes and tag mixes."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        kind = ("counter", "gauge", "status")[int(rng.choice(
            3, p=[0.45, 0.4, 0.15]))]
        prefix = ("api", "db", "drop.me", "web")[int(rng.integers(4))]
        tags = [t for t in _TAGS if rng.random() < 0.25]
        if kind == "status":
            value = float(rng.integers(0, 4))
        elif kind == "counter":
            value = float(rng.integers(1, 10_000))
        else:
            value = float(np.round(rng.normal(50, 20), 3))
        rows.append((f"{prefix}.m{i}", value, kind, tags,
                     "peer" if rng.random() < 0.2 else "",
                     f"msg {i}" if kind == "status" else ""))
    return rows


def intermetrics(root, rows):
    im = _mod(root, "samplers.intermetric")
    return [im.InterMetric(name=n, timestamp=TS, value=v, tags=list(t),
                           type=k, message=msg, hostname=h,
                           sinks=im.route_info(t))
            for n, v, k, t, h, msg in rows]


def events(root, n=3):
    """DogStatsD events and a non-event sample, as the parser hands them
    to flush_other_samples."""
    pb = jssf if root == "veneur_tpu" else tssf
    out = []
    for i in range(n):
        s = pb.SSFSample(name=f"deploy {i}" + "x" * (150 * i),
                         timestamp=TS + i,
                         message="%%% \n" + "body " * (30 * i) + "\n %%%")
        s.tags["vdogstatsd_ev"] = ""
        s.tags["vdogstatsd_at"] = "warning"
        s.tags["vdogstatsd_pri"] = "low" if i % 2 else ""
        s.tags["team"] = "sre"
        s.tags["secret"] = "nope"
        out.append(s)
    out.append(pb.SSFSample(name="not.an.event", timestamp=TS, message="m"))
    return out


def span_pair(seed, n=24):
    """The same spans as JAX and as port protobufs: some indicators,
    errors, metric-only carriers (id 0) and tag mixes."""
    rng = np.random.default_rng(seed)
    js = []
    for i in range(n):
        sp = make_span(trace_id=int(rng.integers(1, 2**62)),
                       span_id=0 if i % 11 == 5 else i + 1,
                       service=("api", "db", "")[i % 3], name=f"op{i % 4}",
                       indicator=bool(i % 7 == 0), error=bool(i % 5 == 0),
                       start=1518279577 + i, end=1518279577 + i + 0.25)
        for t in ("env:prod", "resource:GET /x", "type:web", "farts:1"):
            if rng.random() < 0.4:
                k, v = t.split(":")
                sp.tags[k] = v
        js.append(sp.SerializeToString())
    # both sides parse the same bytes, so their tag maps iterate alike
    return ([jssf.SSFSpan.FromString(b) for b in js],
            [tssf.SSFSpan.FromString(b) for b in js])


def _canon(span):
    """A span's bytes with its tag map in key order: protobuf leaves the
    order of a map's entries on the wire open."""
    return span.SerializeToString(deterministic=True)


# -- fakes -------------------------------------------------------------------

_SINK_HEADERS = {"content-type", "content-encoding", "x-sf-token",
                 "authorization"}


class _Capture(http.server.BaseHTTPRequestHandler):
    captured = None
    pages = None

    def log_message(self, *a):
        pass

    def do_POST(self):
        n = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(n)
        if self.headers.get("Content-Encoding") == "deflate":
            body = zlib.decompress(body)
        # the headers a sink sets (Host names each fake's own port)
        type(self).captured.append(
            (self.path, {k.lower(): v for k, v in self.headers.items()
                         if k.lower() in _SINK_HEADERS}, body))
        self.send_response(200)
        self.send_header("Content-Length", "2")
        self.end_headers()
        self.wfile.write(b"ok")

    def do_GET(self):
        from urllib.parse import parse_qs, urlparse
        q = parse_qs(urlparse(self.path).query, keep_blank_values=True)
        type(self).captured.append(("GET", self.headers.get("X-SF-Token"),
                                    int(q["offset"][0])))
        body = json.dumps({"results": type(self).pages.get(
            int(q["offset"][0]), [])}).encode()
        self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


@pytest.fixture
def fake_http():
    """A factory of local HTTP endpoints: each call -> (url, captured)."""
    servers = []

    def make(pages=None):
        handler = type("H", (_Capture,), {"captured": [],
                                          "pages": pages or {}})
        srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        servers.append(srv)
        return f"http://127.0.0.1:{srv.server_address[1]}", handler.captured

    yield make
    for srv in servers:
        srv.shutdown()
        srv.server_close()


def _both_http(fake_http, run, **kw):
    """run(root, url) on each package against its own endpoint; -> the
    two captures, each sorted (chunk posts run on parallel threads)."""
    out = []
    for root in ROOTS:
        url, captured = fake_http(**kw)
        run(root, url)
        out.append(sorted(captured, key=repr))
    return out


# -- Datadog -----------------------------------------------------------------

def _dd(root, url, **kw):
    sink = _mod(root, "sinks.datadog").DatadogMetricSink(
        api_key="k", hostname="box", api_url=url, interval_s=10,
        flush_max_per_body=kw.pop("flush_max_per_body", 7),
        tags=["veneur:yes", "secret:sink"],
        metric_name_prefix_drops=["drop."],
        exclude_tags_prefix_by_prefix_metric={"db.": ["team"]}, **kw)
    sink.set_excluded_tags(["secret"])
    return sink


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_datadog_series_and_checks_match_jax(fake_http, seed):
    rows = metric_rows(seed)
    j, t = _both_http(fake_http, lambda root, url: _dd(root, url).flush(
        intermetrics(root, rows)))
    assert j == t and t
    series = [s for p, _h, b in t if p.startswith("/api/v1/series")
              for s in json.loads(b)["series"]]
    checks = [c for p, _h, b in t if p.startswith("/api/v1/check_run")
              for c in json.loads(b)]
    want = [r for r in rows if not r[0].startswith("drop.")
            and (not any(x.startswith("veneursinkonly:") for x in r[3])
                 or "veneursinkonly:datadog" in r[3])]
    assert len(series) + len(checks) == len(want)
    assert len(checks) == sum(r[2] == "status" for r in want)
    assert all(len(json.loads(b)["series"]) <= 7 for p, _h, b in t
               if p.startswith("/api/v1/series"))
    for s in series:
        assert not any(x.startswith(("secret", "host:", "device:"))
                       for x in s["tags"])
        if s["metric"].startswith("db."):
            assert not any(x.startswith("team") for x in s["tags"])
    by = {r[0]: r for r in want}
    for s in series:
        if s["type"] == "rate":
            assert s["points"][0][1] == by[s["metric"]][1] / 10
            assert s["interval"] == 10


def _frame(lines, hostname="box"):
    """A port MetricFrame from a tiny CPU Aggregator's flush."""
    from veneur_tpu_torch.aggregation.state import TableSpec
    from veneur_tpu_torch.samplers.parser import (parse_metric,
                                                  parse_service_check)
    from veneur_tpu_torch.server.aggregator import Aggregator
    from veneur_tpu_torch.server.flusher import generate_frame
    agg = Aggregator(TableSpec(counter_capacity=64, gauge_capacity=32,
                               status_capacity=16, set_capacity=16,
                               histo_capacity=32), device="cpu")
    for line in lines:
        agg.process_metric(parse_service_check(line, now=TS)
                           if line.startswith(b"_sc") else parse_metric(line))
    res, table = agg.flush([0.5, 0.99])
    return generate_frame(res, table, percentiles=[0.5, 0.99],
                          aggregates=["min", "max", "count"],
                          is_local=False, timestamp=TS, hostname=hostname)


def _frame_lines(seed, n=120):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        k = int(rng.integers(4))
        tags = ",".join(t for t in ("env:prod", "team:sre",
                                    "veneursinkonly:signalfx", "host:h2",
                                    "secret:x")
                        if rng.random() < 0.3)
        tail = f"|#{tags}" if tags else ""
        if k == 0:
            out.append(f"fr.c{i % 9}:{int(rng.integers(1, 50))}|c{tail}")
        elif k == 1:
            out.append(f"fr.g{i % 5}:{rng.normal():.4f}|g{tail}")
        elif k == 2:
            out.append(f"fr.t{i % 4}:{rng.gamma(2, 10):.3f}|ms{tail}")
        else:
            out.append(f"drop.s{i % 3}:u{i}|s{tail}")
    out.append("_sc|fr.check|1|#env:prod|m:degraded")
    return [x.encode() for x in out]


@pytest.mark.parametrize("sink", ["datadog", "signalfx"])
def test_columnar_frame_bodies_match_the_jax_object_path(fake_http, sink):
    """flush_frame over the port's frame posts what the JAX sink's object
    path posts over the same frame's InterMetrics."""
    frame = _frame(_frame_lines(4))
    jrows = [(m.name, m.value, m.type, m.tags, m.hostname, m.message)
             for m in frame.intermetrics()]
    make = _dd if sink == "datadog" else _sfx

    def run(root, url):
        s = make(root, url)
        if root == "veneur_tpu":
            s.flush(intermetrics(root, jrows))
        else:
            s.flush_frame(frame)

    j, t = _both_http(fake_http, run)
    assert j == t and len(t) >= 2


def test_datadog_events_go_to_intake(fake_http):
    j, t = _both_http(fake_http, lambda root, url: _dd(
        root, url).flush_other_samples(events(root)))
    assert j == t
    ((path, _h, body),) = t
    assert path == "/intake?api_key=k"
    evs = json.loads(body)["events"]
    assert [e["title"] for e in evs] == [f"deploy {i}" + "x" * (150 * i)
                                         for i in range(3)]
    assert evs[0]["alert_type"] == "warning" and "priority" not in evs[0]
    assert evs[1]["priority"] == "low"


# -- SignalFx ----------------------------------------------------------------

def _sfx(root, url, **kw):
    sink = _mod(root, "sinks.signalfx").SignalFxMetricSink(
        api_key="default", endpoint=url, hostname="box",
        vary_key_by="customer", per_tag_api_keys={"acme": "acme-token"},
        flush_max_per_body=kw.pop("flush_max_per_body", 6),
        metric_name_prefix_drops=["drop."],
        metric_tag_prefix_drops=["zone"], tags=["common:1"], **kw)
    sink.set_excluded_tags(["secret"])
    return sink


@pytest.mark.parametrize("seed", [5, 6])
def test_signalfx_datapoints_match_jax(fake_http, seed):
    rows = metric_rows(seed)
    j, t = _both_http(fake_http, lambda root, url: _sfx(root, url).flush(
        intermetrics(root, rows)))
    assert j == t and t
    tokens = {h["x-sf-token"] for _p, h, _b in t}
    assert tokens <= {"acme-token", "default"} and "default" in tokens
    n = 0
    for _p, h, b in t:
        body = json.loads(b)
        assert len(body["counter"]) + len(body["gauge"]) <= 6
        for dp in body["counter"] + body["gauge"]:
            n += 1
            assert "veneursinkonly" not in dp["dimensions"]
            assert "secret" not in dp["dimensions"]
            assert "zone" not in dp["dimensions"]
    assert n == sum(1 for r in rows if not r[0].startswith("drop.")
                    and (not any(x.startswith("veneursinkonly:")
                                 for x in r[3])
                         or "veneursinkonly:signalfx" in r[3]))


def test_signalfx_status_is_a_gauge_and_the_sinkonly_dim_is_stripped():
    got = []
    for root in ROOTS:
        s = _mod(root, "sinks.signalfx").SignalFxMetricSink(
            api_key="k", endpoint="http://x", hostname="glooblestoots",
            tags=["yay:pie"])
        posted = []
        s._post = lambda token, body: posted.append((token, body))
        im = _mod(root, "samplers.intermetric")
        s.flush([im.InterMetric("a.b.c", TS, 3.0,
                                ["foo:bar", "novalue",
                                 "veneursinkonly:signalfx"], "status")])
        got.append(posted)
    assert got[0] == got[1]
    ((token, body),) = got[1]
    assert token == "k" and body["counter"] == []
    assert body["gauge"][0]["dimensions"] == {
        "host": "glooblestoots", "foo": "bar", "novalue": "", "yay": "pie"}


_PAGES = {0: [{"name": "fill-%d" % i, "secret": "tok-fill-%d" % i}
              for i in range(198)]
          + [{"name": "acme", "secret": "tok-acme-2"},
             {"name": "newco", "secret": "tok-newco"}],
          200: [{"name": "late", "secret": "tok-late"}]}


def test_signalfx_token_refresh_matches_jax(fake_http):
    got = []
    for root in ROOTS:
        url, captured = fake_http(pages=_PAGES)
        sink = _mod(root, "sinks.signalfx").SignalFxMetricSink(
            api_key="default", endpoint="http://unused", hostname="box",
            vary_key_by="customer",
            per_tag_api_keys={"acme": "tok-acme-1", "legacy": "tok-legacy"},
            dynamic_per_tag_tokens_enable=True, api_endpoint=url)
        assert sink.refresh_tokens_once()
        got.append((captured, [sink._token_for([f"customer:{c}"]) for c in
                               ("acme", "newco", "legacy", "unknown",
                                "late")]))
    assert got[0] == got[1]
    assert got[1] == ([("GET", "default", 0), ("GET", "default", 200)],
                      ["tok-acme-2", "tok-newco", "tok-legacy", "default",
                       "tok-late"])


def test_signalfx_token_refresh_failure_keeps_the_last_good_tokens():
    for root in ROOTS:
        sink = _mod(root, "sinks.signalfx").SignalFxMetricSink(
            api_key="default", endpoint="http://unused", hostname="box",
            vary_key_by="customer", per_tag_api_keys={"acme": "tok-1"},
            dynamic_per_tag_tokens_enable=True,
            api_endpoint="http://127.0.0.1:1")   # nothing listens here
        assert not sink.refresh_tokens_once()
        assert sink._token_for(["customer:acme"]) == "tok-1"


def test_signalfx_events_truncate_before_the_fence_chop(fake_http):
    j, t = _both_http(fake_http, lambda root, url: _sfx(
        root, url).flush_other_samples(events(root)))
    assert j == t
    ((path, headers, body),) = t
    assert path == "/v2/event" and headers["x-sf-token"] == "default"
    evs = json.loads(body)
    assert len(evs) == 3
    assert len(evs[2]["eventType"]) == 256
    # message 2 is longer than 256: its closing fence fell to truncation
    assert evs[2]["properties"]["description"] == ("body " * 60)[:251]
    assert evs[0]["properties"]["description"] == ""
    assert evs[0]["dimensions"] == {"common": "1", "host": "box",
                                    "vdogstatsd_at": "warning",
                                    "vdogstatsd_pri": "", "team": "sre"}


def test_signalfx_no_events_no_post(fake_http):
    j, t = _both_http(fake_http, lambda root, url: _sfx(
        root, url).flush_other_samples(events(root)[-1:]))
    assert j == t == []


# -- Kafka -------------------------------------------------------------------

def _recorder():
    sent = []
    return sent, lambda topic, key, value: sent.append((topic, key, value))


def test_kafka_metric_messages_match_jax():
    rows = metric_rows(9) + [("bad.nan", float("nan"), "gauge", [], "", "")]
    got = []
    for root in ROOTS:
        sent, produce = _recorder()
        sink = _mod(root, "sinks.kafka").KafkaMetricSink(
            "broker:9092", metric_topic="metrics", check_topic="checks",
            producer=produce)
        sink.flush(intermetrics(root, rows))
        got.append((sent, sink.flushed))
    assert got[0] == got[1]
    sent, flushed = got[1]
    assert flushed == len(sent) == sum(
        1 for r in rows if r[1] == r[1] and
        (not any(x.startswith("veneursinkonly:") for x in r[3])
         or "veneursinkonly:kafka" in r[3]))
    for topic, key, value in sent:
        body = json.loads(value)
        assert key == body["Name"].encode()
        assert topic == ("checks" if body["Type"] == 2 else "metrics")


@pytest.mark.parametrize("fmt,rate,tag", [
    ("protobuf", 100, ""), ("json", 100, ""), ("protobuf", 40, ""),
    ("json", 50, "env")])
def test_kafka_span_messages_match_jax(fmt, rate, tag):
    jspans, tspans = span_pair(11, n=60)
    got = []
    for root, spans in zip(ROOTS, (jspans, tspans)):
        sent, produce = _recorder()
        sink = _mod(root, "sinks.kafka").KafkaSpanSink(
            "broker:9092", span_topic="spans", serialization=fmt,
            sample_rate_percent=rate, sample_tag=tag, producer=produce)
        for sp in spans:
            sink.ingest(sp)
        if fmt == "protobuf":
            sent = [(topic, key, _canon(tssf.SSFSpan.FromString(value)))
                    for topic, key, value in sent]
        got.append((sent, sink.sent, sink.skipped))
    assert got[0] == got[1]
    sent, n_sent, skipped = got[1]
    assert n_sent + skipped == 60 and (skipped > 0) == (rate < 100)
    for _topic, key, value in sent:
        tid = (tssf.SSFSpan.FromString(value).trace_id if fmt == "protobuf"
               else json.loads(value)["trace_id"])
        assert key == b"%016x" % tid


def test_kafka_without_a_client_library_raises_in_both():
    for root in ROOTS:
        kafka = _mod(root, "sinks.kafka")
        with pytest.raises(RuntimeError, match="confluent_kafka"):
            kafka.KafkaMetricSink("broker:9092", metric_topic="m")
        with pytest.raises(RuntimeError, match="confluent_kafka"):
            kafka.KafkaSpanSink("broker:9092", span_topic="s")


# -- S3 and the CSV it archives ----------------------------------------------

class _Client:
    def __init__(self, fail_first=False):
        self.puts = []
        self.fail_first = fail_first

    def put_object(self, Bucket, Key, Body):
        if self.fail_first and not self.puts:
            self.puts.append(None)
            raise RuntimeError("s3 down")
        self.puts.append((Bucket, Key, gzip.decompress(Body)))


def _im(root, name, mtype, tags, value=100.0):
    return _mod(root, "samplers.intermetric").InterMetric(
        name=name, timestamp=TS, value=value, tags=list(tags), type=mtype)


# the reference CSV cases (tests/test_csv_plugin.py): braced tags and a
# gauge, a counter as a rate, a tab inside a tag, status rows skipped,
# non-finite values, and the seeded rows
_CSV_CASES = {
    "gauge": lambda r: [_im(r, "a.b.c.max", "gauge", ["foo:bar", "baz:q"])],
    "rate": lambda r: [_im(r, "a.b.c.max", "counter", ["foo:bar"])],
    "tab": lambda r: [_im(r, "a.b.c.count", "counter", ["foo:b\tar"])],
    "status": lambda r: [_im(r, "ok.g", "gauge", []), _im(r, "st", "status",
                                                          []),
                         _im(r, "ok.c", "counter", [])],
    "nonfinite": lambda r: [_im(r, "g.nan", "gauge", [], float("nan")),
                            _im(r, "g.inf", "gauge", [], float("inf"))],
    "seeded": lambda r: intermetrics(r, metric_rows(13)),
}


@pytest.mark.parametrize("case", sorted(_CSV_CASES))
@pytest.mark.parametrize("interval", [10, 0])
def test_s3_objects_match_jax(monkeypatch, case, interval):
    monkeypatch.setattr(time, "time", lambda: float(TS))
    got = []
    for root in ROOTS:
        client = _Client()
        plug = _mod(root, "plugins.s3").S3Plugin(
            "bucket", "us-east-1", "testbox-c3eac9", interval_s=interval,
            client=client)
        plug.flush(_CSV_CASES[case](root))
        got.append(client.puts)
    assert got[0] == got[1]
    ((bucket, key, body),) = got[1]
    assert (bucket, key) == ("bucket", f"testbox-c3eac9/{TS}.tsv.gz")
    want = _mod("veneur_tpu_torch", "sinks.localfile").encode_intermetrics_csv(
        _CSV_CASES[case]("veneur_tpu_torch"), "testbox-c3eac9", interval)
    assert body == want
    if case == "gauge" and interval == 10:
        assert body.decode() == (
            "a.b.c.max\t{foo:bar,baz:q}\tgauge\ttestbox-c3eac9\t10\t"
            "2016-10-10 05:04:18\t100\t20161010\n")


def test_csv_header_row_matches_jax():
    got = [_mod(r, "sinks.localfile").encode_intermetrics_csv(
        [_im(r, "h1", "gauge", [])], "h", 10, partition_ts=TS,
        headers=True) for r in ROOTS]
    assert got[0] == got[1]
    assert got[1].decode().splitlines()[0] == (
        "Name\tTags\tMetricType\tVeneurHostname\tInterval\tTimestamp"
        "\tValue\tPartition")


def test_s3_staging_keeps_the_object_of_a_failed_put(tmp_path, monkeypatch):
    clock = itertools.count(TS)
    monkeypatch.setattr(time, "time", lambda: float(next(clock)))
    for root in ROOTS:
        client = _Client(fail_first=True)
        stage = tmp_path / root
        plug = _mod(root, "plugins.s3").S3Plugin(
            "bucket", "us-east-1", "box", client=client,
            staging_dir=str(stage))
        metrics = [_im(root, "s.count", "counter", [], 2.0)]
        with pytest.raises(RuntimeError, match="s3 down"):
            plug.flush(metrics)
        (kept,) = os.listdir(stage)
        body = gzip.decompress((stage / kept).read_bytes())
        plug.flush(metrics)
        # the failed put's object stays whole; the acked one is unlinked
        assert os.listdir(stage) == [kept]
        assert client.puts[1][2] == body


def test_s3_without_boto3_raises_in_both():
    for root in ROOTS:
        with pytest.raises(RuntimeError, match="boto3"):
            _mod(root, "plugins.s3").S3Plugin("b", "r", "h")


# -- span sinks --------------------------------------------------------------

def test_datadog_spans_match_jax(fake_http):
    jspans, tspans = span_pair(17)
    got = []
    for root, spans in zip(ROOTS, (jspans, tspans)):
        url, captured = fake_http()
        sink = _mod(root, "sinks.datadog_spans").DatadogSpanSink(
            url, buffer_size=16)
        for sp in spans:
            sink.ingest(sp)
        sink.flush()
        got.append((captured, sink.flushed))
    assert got[0] == got[1]
    ((path, _h, body),), flushed = got[1]
    assert path == "/v0.3/traces"
    spans = [s for trace in json.loads(body) for s in trace]
    # metric-only carriers (id 0) are no traces; the bounded buffer
    # keeps the newest 16 of the rest
    valid = [s for s in tspans if s.id]
    assert len(valid) < len(tspans)
    assert flushed == len(spans) == 16
    assert sorted(s["span_id"] for s in spans) == sorted(
        s.id for s in valid[-16:])


def test_splunk_batches_sampling_indicators_and_exclusions(fake_http):
    jspans, tspans = span_pair(19, n=40)
    got = []
    for root, spans in zip(ROOTS, (jspans, tspans)):
        url, captured = fake_http()
        sink = _mod(root, "sinks.splunk").SplunkSpanSink(
            hec_address=url, token="tok", hostname="box", batch_size=4,
            sample_rate=3, max_conn_lifetime=60.0)
        sink.set_excluded_tags(["farts"])
        for sp in spans:
            sink.ingest(sp)
        sink.stop()
        got.append(([b for _p, _h, b in captured], sink.submitted,
                     sink.skipped))
    assert got[0] == got[1]
    bodies, submitted, skipped = got[1]
    evs = [json.loads(line) for b in bodies for line in b.splitlines()]
    assert submitted == len(evs) and skipped > 0
    assert all(len(b.splitlines()) <= 4 for b in bodies)
    by_id = {(s.trace_id, s.id): s for s in tspans}
    for e in evs:
        sp = by_id[(int(e["event"]["trace_id"], 16),
                    int(e["event"]["id"], 16))]
        assert "farts" not in sp.tags
        if sp.trace_id % 3:
            assert sp.indicator and e["event"]["partial"] is True


def test_splunk_ingest_never_blocks_on_a_stalled_hec():
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(128)
    try:
        for root in ROOTS:
            sink = _mod(root, "sinks.splunk").SplunkSpanSink(
                hec_address=f"http://127.0.0.1:{srv.getsockname()[1]}",
                token="t", hostname="h", batch_size=2, sample_rate=1,
                send_timeout=0.3, workers=1, queue_capacity=8)
            t0 = time.monotonic()
            for sp in span_pair(21, n=50)[ROOTS.index(root)]:
                sink.ingest(sp)
            assert time.monotonic() - t0 < 0.25
            assert sink.dropped > 0
            sink.stop()
    finally:
        srv.close()


def test_splunk_posts_a_partial_batch_when_its_lifetime_expires(fake_http):
    got = []
    for root, spans in zip(ROOTS, span_pair(23, n=1)):
        url, captured = fake_http()
        sink = _mod(root, "sinks.splunk").SplunkSpanSink(
            hec_address=url, token="t", hostname="h", batch_size=100,
            max_conn_lifetime=0.2, conn_lifetime_jitter=0.1)
        sink.ingest(spans[0])
        deadline = time.monotonic() + 3.0
        while not captured and time.monotonic() < deadline:
            time.sleep(0.02)
        got.append([b for _p, _h, b in captured])
        sink.stop()
    assert got[0] == got[1] and len(got[1]) == 1


def _udp():
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.bind(("127.0.0.1", 0))
    s.settimeout(5)
    return s


def test_xray_segments_match_jax():
    got = []
    for root, spans in zip(ROOTS, span_pair(29, n=40)):
        recv = _udp()
        sink = _mod(root, "sinks.xray").XRaySpanSink(
            daemon_address=f"127.0.0.1:{recv.getsockname()[1]}",
            sample_percentage=60.0, annotation_tags=["env", "type"])
        for sp in spans:
            sink.ingest(sp)
        grams = [recv.recv(65536) for _ in range(sink.sent)]
        recv.close()
        got.append((grams, sink.sent, sink.skipped))
    assert got[0] == got[1]
    grams, sent, skipped = got[1]
    assert sent + skipped == 40 and sent and skipped
    header, payload = grams[0].split(b"\n", 1)
    assert json.loads(header) == {"format": "json", "version": 1}
    assert json.loads(payload)["trace_id"].startswith("1-")


def test_xray_trace_ids_are_stable_and_sampling_is_crc():
    for root in ROOTS:
        xray = _mod(root, "sinks.xray")
        pb = jssf if root == "veneur_tpu" else tssf
        s = xray.XRaySpanSink(daemon_address="127.0.0.1:1",
                              sample_percentage=50.0)
        a = pb.SSFSpan(trace_id=4601851300195147788, id=1,
                       start_timestamp=1518279577 * 10**9)
        b = pb.SSFSpan(trace_id=4601851300195147788, id=2,
                       start_timestamp=(1518279577 + 30) * 10**9)
        assert s.trace_id(a) == s.trace_id(b)
        kept = [i for i in range(1, 200) if zlib.crc32(str(i).encode())
                <= int(50.0 * 0xFFFFFFFF / 100)]
        for i in range(1, 200):
            s.ingest(pb.SSFSpan(trace_id=i, id=i, start_timestamp=1,
                                end_timestamp=2))
        assert s.sent == len(kept) and s.skipped == 199 - len(kept)


@pytest.mark.parametrize("cls", ["GRPCSpanSink", "FalconerSpanSink"])
def test_grpc_span_sinks_deliver_the_same_bytes(cls):
    got = []
    for root, spans in zip(ROOTS, span_pair(31, n=12)):
        grp = _mod(root, "sinks.grpsink")
        recv = []
        server, port = grp.serve_span_sink(
            lambda sp: recv.append(_canon(sp)))
        sink = getattr(grp, cls)(f"127.0.0.1:{port}")
        for sp in spans:
            sink.ingest(sp)
        sink.close()
        server.stop(grace=1)
        got.append((sink.name, sink.sent, sink.errors, recv))
    assert got[0] == got[1]
    assert got[1][0] == ("falconer" if cls == "FalconerSpanSink"
                         else "grpc_span_sink")
    assert got[1][3] == [_canon(s) for s in span_pair(31, 12)[1]]


def test_grpc_span_sink_crosses_the_packages():
    """The port's client to the JAX server and back: the wire is one."""
    from veneur_tpu.sinks import grpsink as jg
    from veneur_tpu_torch.sinks import grpsink as tg
    jspans, tspans = span_pair(37, n=5)
    for serve, client, spans in ((jg.serve_span_sink, tg.GRPCSpanSink,
                                  tspans),
                                 (tg.serve_span_sink, jg.GRPCSpanSink,
                                  jspans)):
        recv = []
        server, port = serve(lambda sp: recv.append(_canon(sp)))
        sink = client(f"127.0.0.1:{port}")
        for sp in spans:
            sink.ingest(sp)
        sink.close()
        server.stop(grace=1)
        assert recv == [_canon(s) for s in spans]


class _LSClient:
    def __init__(self, log, idx):
        self.log, self.idx = log, idx

    def report(self, d):
        self.log.append((self.idx, d))

    def flush(self):
        self.log.append((self.idx, "flush"))


def test_lightstep_round_robins_by_trace_id_as_jax_does():
    got = []
    for root, spans in zip(ROOTS, span_pair(41, n=30)):
        log, made = [], []

        def factory():
            made.append(_LSClient(log, len(made)))
            return made[-1]
        sink = _mod(root, "sinks.lightstep").LightStepSpanSink(
            access_token="t", num_clients=3, client_factory=factory)
        for sp in spans:
            sink.ingest(sp)
        sink.flush()
        got.append((log, sink.sent))
    assert got[0] == got[1]
    log, sent = got[1]
    assert sent == 30 and {i for i, _ in log} == {0, 1, 2}
    for idx, d in log:
        if d != "flush":
            assert d["trace_id"] % 3 == idx


def test_lightstep_without_the_package_raises_in_both():
    for root in ROOTS:
        with pytest.raises(RuntimeError, match="lightstep"):
            _mod(root, "sinks.lightstep").LightStepSpanSink(
                access_token="t")


# -- the slice end to end ----------------------------------------------------

def _slice_server(root, url, flush_file):
    """A Server with a Datadog sink and a local-file plugin: the port's
    from its factory on the CPU, the JAX one the step-synced test
    subclass (C-watch 4) with the same sink and plugin."""
    from tests.test_torch_import import _DropSpans
    from tests.test_torch_server import SMALL, _SyncedJServer
    kw = dict(SMALL, interval="3600s", statsd_listen_addresses=[],
              ssf_listen_addresses=[], http_address="",
              datadog_api_key="k", datadog_api_hostname=url,
              datadog_flush_max_per_body=64, flush_file=flush_file)
    cfg = _mod(root, "config").Config(**kw)
    if root == "veneur_tpu":
        srv = _SyncedJServer(cfg, metric_sinks=[_mod(
            root, "sinks.datadog").DatadogMetricSink(
                api_key="k", hostname=cfg.hostname, api_url=url,
                interval_s=cfg.parse_interval(), flush_max_per_body=64)],
            plugins=[_mod(root, "sinks.localfile").LocalFilePlugin(
                flush_file, cfg.hostname,
                interval_s=int(cfg.parse_interval()))])
    else:
        srv = _mod(root, "server.factory").new_from_config(cfg,
                                                           device="cpu")
    srv.trace_client.backend = _DropSpans()
    return srv


def _is_quantile(name):
    tail = name.rsplit(".", 1)[-1]
    return tail.endswith("percentile") or tail == "median"


def test_the_slice_end_to_end_matches_jax(fake_http, tmp_path):
    """Both Servers take the same lines and flush them through the
    columnar frame path into a Datadog sink and a local file: the series
    and rows agree, exact but for quantiles (rtol/atol 2e-5)."""
    from tests.test_torch_server import _wait
    from tests.test_torch_sharded import _lines
    lines = _lines(77, n=1500, names=12)
    lines += [b"tagged.c%d:%d|c|#env:prod,team:%d" % (i % 5, i, i % 3)
              for i in range(60)]
    got = []
    for root in ROOTS:
        url, captured = fake_http()
        flush_file = str(tmp_path / f"{root}.tsv")
        srv = _slice_server(root, url, flush_file)
        srv.start()
        try:
            assert {type(s).__name__ for s in srv.metric_sinks} == {
                "DatadogMetricSink"}
            for k in range(0, len(lines), 60):
                srv.packet_queue.put(b"\n".join(lines[k:k + 60]))
            _wait(lambda: srv.aggregator.processed >= len(lines), "lines")
            assert srv.trigger_flush(timeout=120)
        finally:
            srv.shutdown()
        series = [s for p, _h, b in captured if p.startswith("/api/v1/series")
                  for s in json.loads(b)["series"]]
        assert all(len(json.loads(b)["series"]) <= 64
                   for p, _h, b in captured if p.startswith("/api/v1/series"))
        rows = [r.split("\t") for r in open(flush_file).read().splitlines()]
        got.append((
            sorted(((s["metric"], tuple(s["tags"]), s["type"], s["host"]),
                    s["points"][0][1]) for s in series
                   if not s["metric"].startswith("veneur.")),
            sorted(((r[0], r[1], r[2], r[3]), float(r[6])) for r in rows
                   if not r[0].startswith("veneur."))))
    (jser, jrows), (tser, trows) = got
    for want, have in ((jser, tser), (jrows, trows)):
        assert [k for k, _v in have] == [k for k, _v in want] and have
        for (key, w), (_k, h) in zip(want, have):
            if _is_quantile(key[0]):
                np.testing.assert_allclose(h, w, rtol=2e-5, atol=2e-5,
                                           err_msg=key[0])
            else:
                assert h == w, key
    names = {k[0] for k, _v in got[1][0]}
    assert {"c0", "g0", "t0.99percentile", "s0", "tagged.c0"} <= names
