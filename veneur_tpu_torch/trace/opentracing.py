"""OpenTracing-compatible surface (reference trace/opentracing.go).

The reference implements the opentracing-go interfaces; Python has no
equivalent dependency baked in, so this module provides the same
capabilities idiomatically: a `SpanContext` carrying baggage, a tracer
that injects/extracts trace identity across the reference's FOUR
supported header conventions (opentracing.go:38-66 HeaderFormats) with
the same precedence and number bases, and request helpers mirroring
InjectRequest/ExtractRequestChild (:486-523).

Header formats, tried in order on extract (case-insensitive):
  1. Envoy/Lightstep  ot-tracer-traceid / ot-tracer-spanid   (hex)
  2. OpenTracing      Trace-Id / Span-Id                     (decimal)
  3. Ruby             X-Trace-Id / X-Span-Id                 (decimal)
  4. Veneur           Traceid / Spanid                       (decimal)
Inject writes format 1 (the default, opentracing.go:69) plus its
static outgoing headers (ot-tracer-sampled: true).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

from veneur_tpu_torch.trace.tracer import Span, Tracer

RESOURCE_KEY = "resource"


@dataclass
class HeaderGroup:
    trace_id: str
    span_id: str
    hexadecimal: bool = False
    outgoing: Dict[str, str] = field(default_factory=dict)


HEADER_FORMATS = [
    HeaderGroup("ot-tracer-traceid", "ot-tracer-spanid", hexadecimal=True,
                outgoing={"ot-tracer-sampled": "true"}),
    HeaderGroup("Trace-Id", "Span-Id"),
    HeaderGroup("X-Trace-Id", "X-Span-Id"),
    HeaderGroup("Traceid", "Spanid"),
]
DEFAULT_HEADER_FORMAT = HEADER_FORMATS[0]


class SpanContext:
    """Trace identity + baggage (opentracing.go:128 spanContext). Keys
    are case-insensitive like the reference's parseBaggageInt64."""

    def __init__(self, baggage: Optional[Dict[str, str]] = None):
        self.baggage: Dict[str, str] = dict(baggage or {})

    def _get(self, key: str) -> str:
        kl = key.lower()
        for k, v in self.baggage.items():
            if k.lower() == kl:
                return v
        return ""

    def _get_int(self, key: str) -> int:
        try:
            return int(self._get(key) or 0)
        except ValueError:
            return 0

    @property
    def trace_id(self) -> int:
        return self._get_int("traceid")

    @property
    def span_id(self) -> int:
        return self._get_int("spanid")

    @property
    def parent_id(self) -> int:
        return self._get_int("parentid")

    @property
    def resource(self) -> str:
        return self._get(RESOURCE_KEY)

    def set_baggage_item(self, key: str, value: str) -> "SpanContext":
        self.baggage[key] = value
        return self

    def baggage_item(self, key: str) -> str:
        return self._get(key)

    @classmethod
    def from_span(cls, span: Span) -> "SpanContext":
        bag = {"traceid": str(span.trace_id),
               "spanid": str(span.id),
               "parentid": str(span.parent_id),
               RESOURCE_KEY: span.tags.get(RESOURCE_KEY, "")}
        # span-level baggage rides into the context (opentracing.go:265
        # contextAsParent + :324 SetBaggageItem); identity keys win
        for k, v in getattr(span, "baggage", {}).items():
            bag.setdefault(k, v)
        return cls(bag)


def span_context(span: Span) -> SpanContext:
    """span.Context() in the reference (opentracing.go:256)."""
    return SpanContext.from_span(span)


class OpenTracingTracer(Tracer):
    """Tracer + carrier inject/extract. Subclasses the core tracer so
    the server's existing start_span surface is unchanged."""

    def start_span_ot(self, operation_name: str = "", *, child_of=None,
                      follows_from=None, tags: Optional[Dict] = None,
                      start_time_ns: Optional[int] = None) -> Span:
        """The reference's opentracing StartSpan (opentracing.go:403):

        - no reference -> a new root trace;
        - child_of / follows_from (a Span or SpanContext) -> a child of
          the referenced context. FollowsFrom is treated IDENTICALLY to
          ChildOf, as the reference does ("Datadog treats children and
          follow-children the same way", opentracing.go:430);
        - a `name` tag overrides the operation name (:466);
        - an empty name falls back to the caller's function name (:473
          runtime.Caller), so bare spans remain attributable;
        - start_time_ns overrides the span clock (customSpanStart).
        """
        ref = child_of if child_of is not None else follows_from
        if isinstance(ref, Span):
            ref = SpanContext.from_span(ref)
        if ref is not None:
            span = Span(operation_name, service=self.service,
                        trace_id=ref.trace_id or None,
                        parent_id=ref.span_id or None)
            if ref.resource:
                span.set_tag(RESOURCE_KEY, ref.resource)
            # parent baggage propagates to the child's context
            for k, v in ref.baggage.items():
                if k.lower() not in ("traceid", "spanid", "parentid",
                                     RESOURCE_KEY):
                    span.set_baggage_item(k, v)
        else:
            span = Span(operation_name, service=self.service)
        for k, v in (tags or {}).items():
            span.set_tag(k, v)
            if k == "name":
                span.name = str(v)
        if not span.name:
            import sys as _sys
            frame = _sys._getframe(1)
            span.name = frame.f_code.co_name
        if start_time_ns is not None:
            span.start_ns = start_time_ns
        return span

    # -- carriers ------------------------------------------------------------
    def inject(self, ctx, carrier: Dict[str, str],
               header_format: HeaderGroup = DEFAULT_HEADER_FORMAT) -> None:
        """Write trace identity into a dict-like carrier
        (opentracing.go:525 Inject + :486 InjectRequest)."""
        if isinstance(ctx, Span):
            ctx = SpanContext.from_span(ctx)
        trace_id, span_id = ctx.trace_id, ctx.span_id
        if header_format.hexadecimal:
            carrier[header_format.trace_id] = format(trace_id, "x")
            carrier[header_format.span_id] = format(span_id, "x")
        else:
            carrier[header_format.trace_id] = str(trace_id)
            carrier[header_format.span_id] = str(span_id)
        for k, v in header_format.outgoing.items():
            carrier[k] = v

    def extract_context(self, carrier: Dict[str, str]
                        ) -> Optional[SpanContext]:
        """Read trace identity from a carrier, trying each header
        convention in precedence order (opentracing.go:581 Extract).
        Returns None when no convention matches (the reference returns
        an error). Named distinctly from the base Tracer.extract, which
        keeps its always-succeeds Span-producing contract."""
        found = self._extract_ids(carrier)
        if found is None:
            return None
        trace_id, span_id = found
        return SpanContext({"traceid": str(trace_id),
                            "spanid": str(span_id)})

    @staticmethod
    def _carrier_get(carrier: Dict[str, str], key: str) -> str:
        kl = key.lower()
        for k, v in carrier.items():
            if k.lower() == kl:
                return v
        return ""

    def _extract_ids(self, carrier) -> Optional[Tuple[int, int]]:
        for fmt in HEADER_FORMATS:
            raw_t = self._carrier_get(carrier, fmt.trace_id)
            raw_s = self._carrier_get(carrier, fmt.span_id)
            if not raw_t and not raw_s:
                continue
            base = 16 if fmt.hexadecimal else 10
            try:
                trace_id, span_id = int(raw_t, base), int(raw_s, base)
            except ValueError:
                continue   # try the next convention, like the reference
            # the reference parses with strconv.ParseInt(..., 64): ids
            # outside int64 range are rejected and the next convention
            # tried — SSFSpan fields are int64 and would overflow
            if not (0 <= trace_id < 2 ** 63 and 0 <= span_id < 2 ** 63):
                continue
            return trace_id, span_id
        return None

    # -- request helpers -----------------------------------------------------
    def inject_header(self, span_or_ctx, headers: Dict[str, str]) -> None:
        """InjectHeader (opentracing.go:492)."""
        self.inject(span_or_ctx, headers)

    def extract_request_child(self, resource: str, headers: Dict[str, str],
                              name: str) -> Optional[Span]:
        """Continue an incoming request's trace as a child span
        (opentracing.go:499 ExtractRequestChild); None when the request
        carries no recognizable trace headers."""
        ctx = self.extract_context(headers)
        if ctx is None:
            return None
        span = Span(name, service=self.service,
                    trace_id=ctx.trace_id or None,
                    parent_id=ctx.span_id or None)
        if resource:
            span.set_tag(RESOURCE_KEY, resource)
        return span


GLOBAL_TRACER = OpenTracingTracer(service="veneur")
