"""Generic gRPC span sink + the Falconer wrapper.

reference sinks/grpsink/grpsink.go: a client for the `grpsink.SpanSink`
service (`rpc SendSpan(ssf.SSFSpan) returns (Empty)`, grpc_sink.proto),
with channel-state watching and reconnection handled by grpc-core;
falconer/falconer.go:13 is a named wrapper. Hand-wired method path like
forward/rpc.py — wire-compatible with the reference service.
"""

from __future__ import annotations

import logging
from concurrent import futures
from typing import Callable

import grpc

from veneur_tpu_torch.proto import ssf_pb2
from veneur_tpu_torch.sinks.base import SpanSink

log = logging.getLogger("veneur_tpu_torch.sinks.grpsink")

METHOD = "/grpsink.SpanSink/SendSpan"


class _Empty:
    """grpsink.Empty — a zero-field message; serializes to b''."""

    @staticmethod
    def SerializeToString() -> bytes:
        return b""

    @staticmethod
    def FromString(_data: bytes) -> "_Empty":
        return _Empty()


class GRPCSpanSink(SpanSink):
    name = "grpc_span_sink"

    def __init__(self, target: str, name: str = None):
        if name:
            self.name = name
        self.target = target
        self._channel = grpc.insecure_channel(target)
        self._send = self._channel.unary_unary(
            METHOD,
            request_serializer=ssf_pb2.SSFSpan.SerializeToString,
            response_deserializer=_Empty.FromString)
        self.sent = 0
        self.errors = 0

    def ingest(self, span) -> None:
        try:
            self._send(span, timeout=9.0)  # per-span sink budget
            self.sent += 1
        except Exception as e:
            self.errors += 1
            log.debug("grpsink send failed: %s", e)

    def close(self):
        self._channel.close()


class FalconerSpanSink(GRPCSpanSink):
    """reference sinks/falconer/falconer.go:13 — grpsink under the
    falconer name."""
    name = "falconer"


def serve_span_sink(handler: Callable, address: str = "127.0.0.1:0"):
    """A SpanSink gRPC server for tests / downstream collectors; calls
    handler(span) per received span. Returns (server, port)."""

    def send_span(request: ssf_pb2.SSFSpan, context):
        handler(request)
        return _Empty()

    rpc_handler = grpc.method_handlers_generic_handler(
        "grpsink.SpanSink",
        {"SendSpan": grpc.unary_unary_rpc_method_handler(
            send_span,
            request_deserializer=ssf_pb2.SSFSpan.FromString,
            response_serializer=lambda e: e.SerializeToString())})
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=2))
    server.add_generic_rpc_handlers((rpc_handler,))
    port = server.add_insecure_port(address)
    server.start()
    return server, port
