"""gRPC bindings for the Forward service, hand-wired (no generated service
stubs). The method path `/forwardrpc.Forward/SendMetrics` and message
types match the reference's forwardrpc/forward.proto, so this client can
forward to a reference global veneur and this server can accept from a
reference local one."""

from __future__ import annotations

import logging
import threading
from concurrent import futures
from typing import Callable, List

import grpc
from google.protobuf import empty_pb2

from veneur_tpu_torch.forward.envelope import Envelope, EnvelopeError
from veneur_tpu_torch.proto import forwardrpc_pb2 as fpb
from veneur_tpu_torch.reliability.faults import FAULTS, FORWARD_ACK, FORWARD_SEND

log = logging.getLogger("veneur_tpu_torch.forward.rpc")

METHOD = "/forwardrpc.Forward/SendMetrics"


class AmbiguousResultError(Exception):
    """The send MAY have been applied: DEADLINE_EXCEEDED/CANCELLED land
    after the request left this process, so the receiver could have
    folded the batch before the deadline fired. Retrying must re-send
    the SAME (source_id, epoch, seq) — never a re-merged payload — so
    the receiver's dedup window can suppress the possible duplicate."""

    def __init__(self, code, cause: Exception):
        super().__init__(f"ambiguous forward result ({code}): {cause}")
        self.code = code
        self.cause = cause


# status codes where the request may have reached (and been folded by)
# the receiver even though the caller saw an error
_AMBIGUOUS_CODES = (grpc.StatusCode.DEADLINE_EXCEEDED,
                    grpc.StatusCode.CANCELLED)


class ForwardClient:
    """Forwarding client (reference flusher.go:474 forwardGRPC; single Dial
    at Start, server.go:843-851).

    Unlike the reference's one-Dial-forever channel, a send that fails
    with UNAVAILABLE tears the channel down and redials before the next
    attempt: grpc-python channels can wedge permanently after the peer
    restarts, and a local that never re-resolves its global is an outage
    that survives the outage. `wait_for_ready` queues RPCs while the
    channel (re)connects instead of failing fast."""

    def __init__(self, address: str, wait_for_ready: bool = False):
        self.address = address
        self.wait_for_ready = wait_for_ready
        self.reconnects_total = 0
        self._lock = threading.Lock()
        self._connect()

    def _connect(self) -> None:
        self._channel = grpc.insecure_channel(self.address)
        self._send = self._channel.unary_unary(
            METHOD,
            request_serializer=fpb.MetricList.SerializeToString,
            response_deserializer=empty_pb2.Empty.FromString)
        self._send_raw = None   # rebuilt lazily against the new channel

    def reconnect(self) -> None:
        """Replace the channel (and its cached callables) with a fresh
        dial. Safe under concurrent sends: they hold a reference to the
        old callable and merely fail once more."""
        with self._lock:
            old = self._channel
            self._connect()
            self.reconnects_total += 1
        log.warning("forward channel to %s recreated after UNAVAILABLE "
                    "(%d reconnects)", self.address, self.reconnects_total)
        try:
            old.close()
        except Exception as e:
            log.debug("closing stale forward channel: %s", e)

    def send_metrics(self, metrics: List, timeout: float = 10.0,
                     parent_span=None, trace_client=None,
                     envelope: Envelope = None) -> None:
        # parent_span/trace_client accepted for interface parity with the
        # HTTP client; the reference's gRPC forward doesn't propagate
        # trace headers either (flusher.go:474 forwardGRPC has no Inject)
        FAULTS.inject(FORWARD_SEND, name=self.address)
        md = envelope.to_metadata() if envelope is not None else None
        try:
            self._send(fpb.MetricList(metrics=metrics), timeout=timeout,
                       metadata=md, wait_for_ready=self.wait_for_ready)
        except grpc.RpcError as e:
            code = e.code() if hasattr(e, "code") else None
            if code == grpc.StatusCode.UNAVAILABLE:
                self.reconnect()
                raise
            if code in _AMBIGUOUS_CODES:
                # the receiver may have folded this batch; surface it as
                # ambiguous so the retry layer re-sends the same seq
                raise AmbiguousResultError(code, e) from e
            raise
        # a lost ack: the RPC succeeded (receiver folded) but the armed
        # fault makes this sender see a failure and retry the same seq
        FAULTS.inject(FORWARD_ACK, name=self.address)

    def send_serialized(self, data: bytes, timeout: float = 10.0,
                        wait: bool = True, envelope: Envelope = None):
        """Send an ALREADY-serialized MetricList (sustained-absorption
        benchmarking: client-side marshal cost out of the timed loop).
        With wait=False returns a grpc future — callers overlap requests
        the way a whole local fleet does against one global."""
        with self._lock:
            if self._send_raw is None:
                self._send_raw = self._channel.unary_unary(
                    METHOD, request_serializer=bytes,
                    response_deserializer=empty_pb2.Empty.FromString)
            send_raw = self._send_raw
        md = envelope.to_metadata() if envelope is not None else None
        if wait:
            send_raw(data, timeout=timeout, metadata=md)
            return None
        return send_raw.future(data, timeout=timeout, metadata=md)

    def close(self):
        with self._lock:
            self._channel.close()


class HTTPForwardClient:
    """HTTP-era forwarding (reference flusher.go:338 flushForward →
    POST /import): a zlib-deflated JSON array of JSONMetric objects whose
    value bytes are the reference's own sampler encodings (gob digests,
    LE scalars, axiomhq HLLs — veneur_tpu/forward/{jsonmetric,gob}.py),
    so the peer may be a reference global or this framework's. Pass
    json_body=False for the deflated-protobuf MetricList body instead
    (this framework's compact v2-over-HTTP variant)."""

    def __init__(self, address: str, json_body: bool = True,
                 retry_policy=None):
        self.address = address.rstrip("/")
        self.json_body = json_body
        # reliability.policy.RetryPolicy (or None = single attempt);
        # applied per-POST inside traced_post so every attempt re-runs
        # the whole connect/send/status pipeline
        self.retry_policy = retry_policy
        if not self.address.startswith(("http://", "https://")):
            self.address = "http://" + self.address

    def send_metrics(self, metrics: List, timeout: float = 10.0,
                     parent_span=None, trace_client=None,
                     envelope: Envelope = None) -> None:
        import json

        if self.json_body:
            from veneur_tpu_torch.forward.jsonmetric import to_json_metrics
            payload = to_json_metrics(metrics)
            if envelope is not None:
                # the envelope rides in the JSON import body itself (and
                # the headers, below) so a peer that re-serializes the
                # body — the proxy — keeps the idempotency key attached
                payload = {"envelope": envelope.to_json(),
                           "metrics": payload}
            body = json.dumps(payload).encode()
            ctype = "application/json"
        else:
            body = fpb.MetricList(metrics=metrics).SerializeToString()
            ctype = "application/x-protobuf"
        self._post(body, ctype, timeout, parent_span, trace_client,
                   envelope=envelope)
        # lost-ack injection point: the POST got its 202 (receiver
        # folded) but this sender is made to see a failure and retry
        FAULTS.inject(FORWARD_ACK, name=self.address)

    def send_json(self, json_metrics: List[dict], timeout: float = 10.0,
                  envelope: Envelope = None) -> None:
        """POST an already-formed JSONMetric array unchanged — the proxy
        re-routing path (proxy.go:622 doPost forwards the incoming
        samplers.JSONMetric values verbatim). With an envelope the body
        is the wrapped form {"envelope": ..., "metrics": [...]}."""
        import json
        payload = json_metrics
        if envelope is not None:
            payload = {"envelope": envelope.to_json(),
                       "metrics": json_metrics}
        self._post(json.dumps(payload).encode(), "application/json",
                   timeout, envelope=envelope)

    def _post(self, body: bytes, ctype: str, timeout: float,
              parent_span=None, trace_client=None,
              envelope: Envelope = None) -> None:
        import zlib

        headers = {"Content-Type": ctype, "Content-Encoding": "deflate"}
        if envelope is not None:
            headers.update(envelope.to_metadata())
        if parent_span is not None:
            # propagate the caller's flush trace like the reference's
            # instrumented PostHelper (http/http.go InjectRequest): the
            # global's /import child spans join the local's flush tree
            from veneur_tpu_torch.trace.opentracing import GLOBAL_TRACER
            GLOBAL_TRACER.inject_header(parent_span, headers)
        # per-connection-event span chain (http/http.go TraceRoundTripper)
        from veneur_tpu_torch.forward.tracedhttp import traced_post
        traced_post(f"{self.address}/import", zlib.compress(body), headers,
                    timeout=timeout, parent_span=parent_span,
                    trace_client=trace_client, action="forward",
                    retry_policy=self.retry_policy)

    def close(self):
        pass


def make_forward_service(handler: Callable[[List], None],
                         raw: bool = False, with_metadata: bool = False,
                         on_reject: Callable[[], None] = None):
    """A generic gRPC handler for the Forward service calling
    `handler(metrics)` per request (the shape of reference
    internal/forwardtest/server.go). With `raw`, the request is NOT
    deserialized — `handler(serialized_bytes)` receives the wire
    MetricList for the native import decoder (vi_import), skipping the
    Python protobuf object layer entirely.

    With `with_metadata`, the exactly-once contract applies: the call is
    `handler(payload, envelope=Envelope|None)`; a malformed envelope
    aborts INVALID_ARGUMENT (rejected, never folded; `on_reject` is
    called first so the server can account it — handler-raised
    EnvelopeErrors are NOT re-counted, the handler already did), and a
    handler returning False (shed/unadmitted) aborts RESOURCE_EXHAUSTED
    so the sender does NOT take the RPC as an ack and keeps the unit
    spilled."""

    def _dispatch(payload, context):
        if not with_metadata:
            handler(payload)
            return empty_pb2.Empty()
        try:
            env = Envelope.from_mapping(dict(context.invocation_metadata()))
        except EnvelopeError as e:
            if on_reject is not None:
                on_reject()
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
        try:
            ok = handler(payload, envelope=env)
        except EnvelopeError as e:
            # window-skip rejection; the handler counted it — the sender
            # must not take this as an ack either
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
        if ok is False:
            context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED,
                          "import not admitted")
        return empty_pb2.Empty()

    def send_metrics(request: fpb.MetricList, context):
        return _dispatch(list(request.metrics), context)

    def send_metrics_raw(request: bytes, context):
        return _dispatch(request, context)

    rpc_handler = grpc.method_handlers_generic_handler(
        "forwardrpc.Forward",
        {"SendMetrics": grpc.unary_unary_rpc_method_handler(
            send_metrics_raw if raw else send_metrics,
            request_deserializer=(bytes if raw
                                  else fpb.MetricList.FromString),
            response_serializer=empty_pb2.Empty.SerializeToString)})
    return rpc_handler


def serve(handler: Callable[[List], None], address: str = "127.0.0.1:0",
          max_workers: int = 4, raw: bool = False,
          with_metadata: bool = False,
          on_reject: Callable[[], None] = None):
    """Start a Forward gRPC server; returns (server, bound_port)."""
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=max_workers))
    server.add_generic_rpc_handlers(
        (make_forward_service(handler, raw=raw,
                              with_metadata=with_metadata,
                              on_reject=on_reject),))
    port = server.add_insecure_port(address)
    server.start()
    return server, port
