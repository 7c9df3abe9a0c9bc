"""Crash reporting (reference sentry.go).

`consume_panic` mirrors ConsumePanic (sentry.go:16-51): synchronously ship
the exception to Sentry, then re-raise — crash-only design; process
supervision restarts. `SentryLogHandler` is the logrus-hook analogue
(sentry.go:54+): Error-and-above log records also ship.

The Sentry client is a minimal store-API POST (no raven dependency): DSN
`https://<key>@<host>/<project>` → POST /api/<project>/store/ with
X-Sentry-Auth. Failures to report are swallowed — crash reporting must
never mask the crash itself.
"""

from __future__ import annotations

import json
import logging
import socket
import sys
import time
import traceback
import urllib.request
from typing import Optional
from urllib.parse import urlparse

log = logging.getLogger("veneur_tpu_torch.crash")


class SentryClient:
    def __init__(self, dsn: str):
        u = urlparse(dsn)
        if not (u.scheme and u.username and u.path.strip("/")):
            raise ValueError("invalid sentry DSN")
        self.key = u.username
        self.project = u.path.strip("/")
        port = f":{u.port}" if u.port else ""
        self.store_url = (f"{u.scheme}://{u.hostname}{port}"
                          f"/api/{self.project}/store/")

    def capture_exception(self, exc: BaseException,
                          level: str = "fatal") -> None:
        frames = [{"filename": f.filename, "function": f.name,
                   "lineno": f.lineno}
                  for f in traceback.extract_tb(exc.__traceback__)]
        self._send({
            "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S"),
            "level": level,
            "platform": "python",
            "server_name": socket.gethostname(),
            "exception": {"values": [{
                "type": type(exc).__name__,
                "value": str(exc),
                "stacktrace": {"frames": frames},
            }]},
        })

    def capture_message(self, message: str, level: str = "error") -> None:
        self._send({
            "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S"),
            "level": level,
            "platform": "python",
            "server_name": socket.gethostname(),
            "message": message,
        })

    def _send(self, event: dict) -> None:
        auth = (f"Sentry sentry_version=7, sentry_key={self.key}, "
                f"sentry_client=veneur-tpu/0.1")
        req = urllib.request.Request(
            self.store_url, data=json.dumps(event).encode(), method="POST",
            headers={"Content-Type": "application/json",
                     "X-Sentry-Auth": auth})
        try:
            with urllib.request.urlopen(req, timeout=5) as resp:
                resp.read()
        except Exception as e:  # never mask the original failure
            log.debug("sentry report failed: %s", e)


_client: Optional[SentryClient] = None


def setup(dsn: str) -> Optional[SentryClient]:
    """Install the global client + the Error-and-above logging hook."""
    global _client
    if not dsn:
        return None
    _client = SentryClient(dsn)
    logging.getLogger().addHandler(SentryLogHandler(_client))
    return _client


class SentryLogHandler(logging.Handler):
    def __init__(self, client: SentryClient):
        super().__init__(level=logging.ERROR)
        self.client = client

    def emit(self, record):
        try:
            self.client.capture_message(
                self.format(record),
                level="fatal" if record.levelno >= logging.CRITICAL
                else "error")
        except Exception:
            pass


def consume_panic(exc: BaseException) -> None:
    """reference sentry.go:16 ConsumePanic: synchronous capture, then
    re-raise (the process dies; supervision restarts it)."""
    if _client is not None:
        try:
            _client.capture_exception(exc)
        except Exception:
            pass
    raise exc


def hook_threads() -> None:
    """Ship uncaught thread exceptions before the default handling —
    the goroutine-wrapping the reference does in every `go` callsite."""
    prev = getattr(sys, "__veneur_prev_threadhook__", None)
    if prev is not None:
        return
    import threading
    original = threading.excepthook
    sys.__veneur_prev_threadhook__ = original

    def hooked(args):
        if _client is not None and args.exc_value is not None:
            try:
                _client.capture_exception(args.exc_value)
            except Exception:
                pass
        original(args)

    threading.excepthook = hooked
