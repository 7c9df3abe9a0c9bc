"""Service discovery for the proxy tier.

reference discoverer.go:5 Discoverer interface + consul.go:29 (healthy
instances via /v1/health/service) + kubernetes.go:32 (pod list by label).

Fail-static: a transient discovery failure (Consul restart, apiserver
blip, DNS hiccup) serves the LAST KNOWN GOOD destination set instead of
an empty list. Fail-empty at the proxy means every refresh outage
becomes a full traffic outage; stale-but-routable destinations degrade
to individual connection errors, which the per-destination breakers
already contain. Staleness is visible: each discoverer exposes
`stale` (0/1), surfaced as the `veneur.discovery.stale` gauge by the
proxy's registry.
"""

from __future__ import annotations

import json
import logging
import urllib.request
from typing import List

log = logging.getLogger("veneur_tpu_torch.forward.discovery")


class StaticDiscoverer:
    """Fixed destination list (the reference's non-discovery config path)."""

    def __init__(self, destinations: List[str]):
        self.destinations = list(destinations)
        self.stale = 0  # a static list is never stale

    def get_destinations_for_service(self, service: str) -> List[str]:
        return list(self.destinations)


class _FailStatic:
    """Last-known-good fallback shared by the network discoverers."""

    def __init__(self):
        self.last_good: List[str] = []
        self.stale = 0

    def _fetched(self, dests: List[str]) -> List[str]:
        self.last_good = list(dests)
        self.stale = 0
        return dests

    def _failed(self, service: str, err: Exception) -> List[str]:
        if self.last_good:
            self.stale = 1
            log.warning(
                "discovery for %r failed (%s); serving %d last-known-good "
                "destinations", service, err, len(self.last_good))
            return list(self.last_good)
        # nothing to fall back to: propagate so the caller's own
        # keep-last-ring logic (proxysrv.refresh) can decide
        raise err


class ConsulDiscoverer(_FailStatic):
    """Healthy-instance lookup (reference consul.go:29
    GetDestinationsForService: /v1/health/service/<name>?passing)."""

    def __init__(self, consul_url: str = "http://127.0.0.1:8500",
                 opener=None):
        super().__init__()
        self.consul_url = consul_url.rstrip("/")
        self._open = opener or urllib.request.urlopen

    def get_destinations_for_service(self, service: str) -> List[str]:
        url = f"{self.consul_url}/v1/health/service/{service}?passing"
        try:
            with self._open(url, timeout=10) as resp:
                entries = json.loads(resp.read())
            dests = []
            for e in entries:
                svc = e.get("Service", {})
                node = e.get("Node", {})
                host = svc.get("Address") or node.get("Address")
                port = svc.get("Port")
                if host and port:
                    dests.append(f"{host}:{port}")
        except Exception as e:
            return self._failed(service, e)
        return self._fetched(dests)


class KubernetesDiscoverer(_FailStatic):
    """Pod-list lookup (reference kubernetes.go:32: label
    app=veneur-global). Requires in-cluster credentials; reads the
    service-account token mounted by k8s."""

    def __init__(self, namespace: str = "default",
                 label_selector: str = "app=veneur-global",
                 api_base: str = "https://kubernetes.default.svc",
                 opener=None):
        super().__init__()
        self.namespace = namespace
        self.label_selector = label_selector
        self.api_base = api_base
        self._open = opener or urllib.request.urlopen

    def get_destinations_for_service(self, service: str) -> List[str]:
        import ssl
        token_path = "/var/run/secrets/kubernetes.io/serviceaccount/token"
        try:
            with open(token_path) as f:
                token = f.read()
        except OSError as e:
            # no in-cluster credentials is a config condition, not a
            # transient failure — but last-known-good still beats empty
            # (e.g. a token briefly unreadable during rotation)
            log.warning("not running in-cluster; k8s discovery unavailable")
            if self.last_good:
                return self._failed(service, e)
            return []
        url = (f"{self.api_base}/api/v1/namespaces/{self.namespace}/pods"
               f"?labelSelector={self.label_selector}")
        req = urllib.request.Request(
            url, headers={"Authorization": f"Bearer {token}"})
        try:
            ctx = ssl.create_default_context(
                cafile="/var/run/secrets/kubernetes.io/"
                       "serviceaccount/ca.crt")
            with self._open(req, timeout=10, context=ctx) as resp:
                pods = json.loads(resp.read())
            dests = []
            for pod in pods.get("items", []):
                ip = pod.get("status", {}).get("podIP")
                if ip and pod.get("status", {}).get("phase") == "Running":
                    dests.append(f"{ip}:8128")
        except Exception as e:
            return self._failed(service, e)
        return self._fetched(dests)
