"""veneur-prometheus: poll a Prometheus /metrics endpoint and translate to
statsd (reference cmd/veneur-prometheus: main.go polling loop,
translate.go type translation with counter delta cache).

Translation rules (translate.go):
- counter  -> statsd count of the DELTA since the last poll (first poll
  primes the cache, emits nothing)
- gauge / untyped -> statsd gauge
- histogram -> each bucket count delta as a count tagged le=<bound>, plus
  _sum/_count deltas
- summary -> quantile values as gauges tagged quantile=<q>, plus
  _sum/_count deltas

Scrape transport (cmd/veneur-prometheus/config.go newHTTPClient):
- `-cert`/`-key` present a client certificate (mTLS); `-cacert` trusts
  ONLY the given CA for the server certificate (the reference builds a
  dedicated x509.CertPool, not the system roots)
- `-socket` tunnels the HTTP scrape over a unix domain socket
  (unixtripper.go), for proxy-sidecar setups
"""

from __future__ import annotations

import argparse
import logging
import re
import socket
import sys
import time
import urllib.request

log = logging.getLogger("veneur_tpu_torch.prometheus")

_LINE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?\s+(?P<value>[^ ]+)(?:\s+\d+)?$")
_LABEL = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def parse_exposition(text: str):
    """-> (types: {name: type}, samples: [(name, labels dict, value)])."""
    types = {}
    samples = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("# TYPE "):
            parts = line.split()
            if len(parts) >= 4:
                types[parts[2]] = parts[3]
            continue
        if line.startswith("#"):
            continue
        m = _LINE.match(line)
        if not m:
            continue
        labels = dict(_LABEL.findall(m.group("labels") or ""))
        try:
            value = float(m.group("value"))
        except ValueError:
            continue
        samples.append((m.group("name"), labels, value))
    return types, samples


def _series_key(name, labels):
    return (name, tuple(sorted(labels.items())))


def make_fetcher(url, cert=None, key=None, cacert=None, socket_path=None,
                 timeout=10.0):
    """Build the scrape callable (config.go:42 newHTTPClient): plain
    HTTP(S), mTLS with a dedicated trust pool, or HTTP over a unix
    socket (unixtripper.go)."""
    if socket_path:
        import http.client
        from urllib.parse import urlsplit
        parts = urlsplit(url)
        path = (parts.path or "/metrics") + \
            (f"?{parts.query}" if parts.query else "")
        host_hdr = parts.netloc or "localhost"

        class _UnixConn(http.client.HTTPConnection):
            def __init__(self):
                super().__init__("localhost", timeout=timeout)

            def connect(self):
                s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                s.settimeout(timeout)
                s.connect(socket_path)
                self.sock = s

        def fetch():
            conn = _UnixConn()
            try:
                conn.request("GET", path, headers={"Host": host_hdr})
                resp = conn.getresponse()
                if resp.status != 200:
                    raise RuntimeError(f"HTTP {resp.status} over unix "
                                       f"socket {socket_path}")
                return resp.read().decode()
            finally:
                conn.close()
        return fetch

    ctx = None
    if url.startswith("https") or cert or cacert:
        import ssl
        # cafile given -> trust ONLY that CA (the reference's dedicated
        # x509.NewCertPool); otherwise the default system roots
        ctx = ssl.create_default_context(cafile=cacert or None)
        if cert:
            ctx.load_cert_chain(cert, key or None)

    def fetch():
        with urllib.request.urlopen(url, timeout=timeout,
                                    context=ctx) as resp:
            return resp.read().decode()
    return fetch


def scrape_once(fetch, translator):
    """One poll: fetch → parse → translate → statsd packets. The first
    call primes the translator's delta cache, so counters emit nothing
    until the second poll (translate.go cache semantics). Shared by the
    polling loop below and the server's own /metrics round-trip test —
    a veneur-tpu server can scrape ITSELF through this path."""
    types, samples = parse_exposition(fetch())
    return translator.translate(types, samples)


class Translator:
    """Stateful poll-to-statsd translation with the counter delta cache
    (translate.go cache semantics)."""

    def __init__(self, added_tags=(), prefix="", ignored_labels=(),
                 ignored_metrics=()):
        self.cache = {}
        self.added_tags = list(added_tags)
        # reference -p prefix ("include a trailing period") and the
        # ignored-labels / ignored-metrics regex lists (main.go:17-19,
        # prometheus.go:63 shouldExportMetric, translate.go:186)
        self.prefix = prefix
        self.ignored_labels = [re.compile(p) for p in ignored_labels]
        self.ignored_metrics = [re.compile(p) for p in ignored_metrics]
        self.primed = False

    def _ignored(self, name) -> bool:
        return any(p.search(name) for p in self.ignored_metrics)

    def _tags(self, labels, extra=()):
        tags = [f"{k}:{v}" for k, v in sorted(labels.items())
                if not any(p.search(k) for p in self.ignored_labels)]
        tags += self.added_tags
        tags += list(extra)
        return tags

    def _pkt(self, name, value, mtype, tags):
        s = f"{self.prefix}{name}:{value}|{mtype}"
        if tags:
            s += "|#" + ",".join(tags)
        return s.encode()

    def _delta(self, key, value):
        prev = self.cache.get(key)
        self.cache[key] = value
        if prev is None or value < prev:  # reset detection
            return None
        return value - prev

    def translate(self, types, samples):
        packets = []
        for name, labels, value in samples:
            base = name
            for suffix in ("_bucket", "_sum", "_count"):
                if name.endswith(suffix) and base[:-len(suffix)] in types:
                    base = name[:-len(suffix)]
                    break
            if self._ignored(base) or (base != name and self._ignored(name)):
                continue
            mtype = types.get(name) or types.get(base, "untyped")
            if mtype == "counter":
                d = self._delta(_series_key(name, labels), value)
                if d is not None and d > 0:
                    packets.append(self._pkt(name, f"{d:g}", "c",
                                             self._tags(labels)))
            elif mtype in ("gauge", "untyped"):
                packets.append(self._pkt(name, f"{value:g}", "g",
                                         self._tags(labels)))
            elif mtype == "histogram":
                # bucket/count/sum are all cumulative -> deltas as counts
                d = self._delta(_series_key(name, labels), value)
                if d is not None and d > 0:
                    packets.append(self._pkt(name, f"{d:g}", "c",
                                             self._tags(labels)))
            elif mtype == "summary":
                if name.endswith(("_sum", "_count")):
                    d = self._delta(_series_key(name, labels), value)
                    if d is not None and d > 0:
                        packets.append(self._pkt(name, f"{d:g}", "c",
                                                 self._tags(labels)))
                else:  # quantile gauge
                    packets.append(self._pkt(name, f"{value:g}", "g",
                                             self._tags(labels)))
        return packets


def main(argv=None):
    ap = argparse.ArgumentParser(prog="veneur-tpu-prometheus")
    ap.add_argument("-p", dest="prometheus_url",
                    default="http://localhost:9090/metrics",
                    help="Prometheus metrics endpoint to poll")
    ap.add_argument("-h2", "--statsd-host", dest="statsd",
                    default="127.0.0.1:8126")
    ap.add_argument("-i", dest="interval", default="10s")
    ap.add_argument("-a", dest="added_tags", default="",
                    help="comma-separated tags added to every metric")
    ap.add_argument("-prefix", default="",
                    help="prefix for every emitted metric name; include "
                         "the trailing period (reference -p)")
    ap.add_argument("-ignored-labels", dest="ignored_labels", default="",
                    help="comma-separated label-name regexes to drop")
    ap.add_argument("-ignored-metrics", dest="ignored_metrics", default="",
                    help="comma-separated metric-name regexes to skip")
    ap.add_argument("-cert", default="",
                    help="client cert to present (mTLS scrape)")
    ap.add_argument("-key", default="",
                    help="client private key for -cert")
    ap.add_argument("-cacert", default="",
                    help="CA cert that alone validates the server")
    ap.add_argument("-socket", default="",
                    help="unix socket path to tunnel the scrape through")
    ap.add_argument("-once", action="store_true",
                    help="poll once (two fetches for deltas) and exit")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    from veneur_tpu_torch.config import parse_duration
    interval = parse_duration(args.interval)
    host, _, port = args.statsd.partition(":")
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    addr = (host, int(port or 8126))

    tr = Translator(
        [t for t in args.added_tags.split(",") if t],
        prefix=args.prefix,
        ignored_labels=[p for p in args.ignored_labels.split(",") if p],
        ignored_metrics=[p for p in args.ignored_metrics.split(",") if p])
    fetch = make_fetcher(args.prometheus_url, cert=args.cert or None,
                         key=args.key or None, cacert=args.cacert or None,
                         socket_path=args.socket or None)
    polls = 0
    while True:
        try:
            packets = scrape_once(fetch, tr)
            for p in packets:
                sock.sendto(p, addr)
            log.info("poll %d: %d packets", polls, len(packets))
        except Exception as e:
            log.warning("poll failed: %s", e)
        polls += 1
        if args.once and polls >= 2:
            return 0
        time.sleep(interval)


if __name__ == "__main__":
    sys.exit(main())
