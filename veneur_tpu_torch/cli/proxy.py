"""veneur-proxy daemon CLI (reference cmd/veneur-proxy/main.go):
`python -m veneur_tpu_torch.cli.proxy -f proxy.yaml`. The proxy holds no
tensors, so it takes no device; SIGINT/SIGTERM stop it with exit 0."""

from __future__ import annotations

import argparse
import logging
import signal
import sys
import threading


def main(argv=None):
    ap = argparse.ArgumentParser(prog="veneur-tpu-torch-proxy")
    ap.add_argument("-f", dest="config", required=True)
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    from veneur_tpu_torch.config import parse_duration
    from veneur_tpu_torch.config_proxy import read_proxy_config
    from veneur_tpu_torch.forward.discovery import (
        ConsulDiscoverer, StaticDiscoverer)
    from veneur_tpu_torch.forward.proxysrv import ProxyServer

    cfg = read_proxy_config(args.config)
    service = (cfg.consul_forward_grpc_service_name
               or cfg.consul_forward_service_name)
    static = cfg.grpc_forward_address or cfg.forward_address
    if service:
        disc = ConsulDiscoverer(cfg.consul_url)
    elif static:
        disc = StaticDiscoverer([static])
    else:
        print("proxy needs a discovery service name or a static "
              "forward address", file=sys.stderr)
        return 1

    # handlers first: a SIGTERM during startup still stops cleanly
    stop = threading.Event()
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    refresh = (parse_duration(cfg.consul_refresh_interval)
               if cfg.consul_refresh_interval else 0.0)
    proxy = ProxyServer(disc, service=service or "static",
                        refresh_interval=refresh,
                        dedup_window=cfg.forward_dedup_window)
    proxy.start(cfg.grpc_address)
    if cfg.stats_address:
        # runtime-metrics ticker to an external statsd daemon
        # (reference proxy.go:213-217, :354-365 ReportRuntimeMetrics)
        proxy.start_stats(
            cfg.stats_address,
            parse_duration(cfg.runtime_metrics_interval or "10s"))
    if cfg.http_address:
        # v1 HTTP routing surface (reference proxy.go:518): POST /import
        # consistent-hashes a JSONMetric array across the same ring
        proxy.start_http(cfg.http_address)
    logging.getLogger("veneur_tpu_torch").info(
        "veneur-tpu-torch-proxy listening on port %s (http %s)", proxy.port,
        proxy.http_port)

    stop.wait()
    proxy.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
