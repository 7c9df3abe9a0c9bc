"""veneur-proxy configuration (reference config_proxy.go: 26-key
ProxyConfig; same parse pipeline as the server config)."""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import List

import yaml

log = logging.getLogger("veneur_tpu_torch.config")


@dataclasses.dataclass
class ProxyConfig:
    debug: bool = False
    enable_profiling: bool = False
    http_address: str = ""
    grpc_address: str = "127.0.0.1:8128"
    grpc_forward_address: str = ""        # static single destination
    forward_address: str = ""             # legacy static destination
    consul_forward_service_name: str = ""
    consul_forward_grpc_service_name: str = ""
    consul_refresh_interval: str = ""
    consul_url: str = "http://127.0.0.1:8500"
    forward_timeout: str = "10s"
    sentry_dsn: str = ""
    stats_address: str = ""
    runtime_metrics_interval: str = "10s"
    max_idle_conns: int = 0
    max_idle_conns_per_host: int = 100    # config_parse.go:25 default
    idle_connection_timeout: str = ""
    tracing_client_capacity: int = 1024
    tracing_client_flush_interval: str = "500ms"
    tracing_client_metrics_interval: str = "1s"
    ssf_destination_address: str = ""
    trace_address: str = ""
    trace_api_address: str = ""
    # Consul service name for trace-forwarding destinations
    # (reference proxy.go:122 ConsulTraceService; parsed for config
    # compatibility — span routing rides ssf_destination_address here)
    consul_trace_service_name: str = ""
    # exactly-once relay window (forward/envelope.py): > 0 makes the
    # proxy honor sender envelopes — pin per-destination groupings
    # across retries and pass the idempotency key through to globals.
    # Match the globals' forward_dedup_window.
    forward_dedup_window: int = 0
    unknown_keys: List[str] = dataclasses.field(default_factory=list)


_FIELDS = {f.name for f in dataclasses.fields(ProxyConfig)}


def read_proxy_config(path_or_file, env=None) -> ProxyConfig:
    if hasattr(path_or_file, "read"):
        data = yaml.safe_load(path_or_file.read()) or {}
    else:
        with open(path_or_file) as f:
            data = yaml.safe_load(f) or {}
    cfg = ProxyConfig()
    unknown = []
    for k, v in data.items():
        if k in _FIELDS:
            if v is not None:
                setattr(cfg, k, v)
        else:
            unknown.append(k)
    cfg.unknown_keys = sorted(unknown)
    if unknown:
        log.warning("proxy config contains unknown keys: %s",
                    ", ".join(cfg.unknown_keys))
    env = os.environ if env is None else env
    for name in _FIELDS:
        for candidate in (f"VENEUR_PROXY_{name.upper().replace('_', '')}",
                          f"VENEUR_PROXY_{name.upper()}"):
            if candidate in env:
                cur = getattr(cfg, name)
                raw = env[candidate]
                if isinstance(cur, bool):
                    raw = raw.lower() in ("1", "true", "yes", "on")
                elif isinstance(cur, int):
                    raw = int(raw)
                setattr(cfg, name, raw)
                break
    return cfg
