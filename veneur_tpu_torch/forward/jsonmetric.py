"""JSONMetric <-> metricpb.Metric conversion for the HTTP-era forward path.

The reference's v1 forwarding body is a JSON array of JSONMetric
(samplers/samplers.go:102-108): `{name, type, tagstring, tags, value}`
where `value` is base64 bytes of Go-native sampler state (flusher.go:338
flushForward builds it from each sampler's Export; worker.go:394
ImportMetric merges via Combine). The byte formats are implemented in
veneur_tpu/forward/gob.py (digests, scalars) and veneur_tpu/ops/hll.py
(axiomhq sets), so a mixed fleet of reference locals and this global —
or the reverse — interoperates over plain HTTP.

Internally both forward paths (gRPC and HTTP) speak metricpb.Metric;
this module converts at the HTTP boundary only.
"""

from __future__ import annotations

import base64
from typing import Dict, List

from veneur_tpu_torch.forward import gob
from veneur_tpu_torch.proto import metricpb_pb2 as mpb

_JSON_TYPE = {mpb.Counter: "counter", mpb.Gauge: "gauge",
              mpb.Histogram: "histogram", mpb.Set: "set",
              mpb.Timer: "timer"}
_TYPE_JSON = {v: k for k, v in _JSON_TYPE.items()}


def to_json_metrics(metrics: List[mpb.Metric]) -> List[Dict]:
    """metricpb.Metric list -> JSONMetric dicts (the reference local's
    flushForward wire shape, flusher.go:350-415)."""
    out = []
    for m in metrics:
        which = m.WhichOneof("value")
        if which == "counter":
            value = gob.encode_counter(m.counter.value)
        elif which == "gauge":
            value = gob.encode_gauge(m.gauge.value)
        elif which == "set":
            value = m.set.hyper_log_log   # already axiomhq MarshalBinary
        elif which == "histogram":
            td = m.histogram.t_digest
            value = gob.encode_digest(
                [c.mean for c in td.main_centroids],
                [c.weight for c in td.main_centroids],
                td.compression, td.min, td.max, td.reciprocalSum)
        else:
            continue
        out.append({
            "name": m.name,
            "type": _JSON_TYPE[m.type],
            "tagstring": ",".join(m.tags),
            "tags": list(m.tags),
            "value": base64.b64encode(bytes(value)).decode(),
        })
    return out


def from_json_metric(jm: Dict) -> mpb.Metric:
    """One JSONMetric dict -> metricpb.Metric (the global's HTTP import,
    handlers_global.go:115 + worker.go:394 Combine semantics). Raises
    ValueError/KeyError/gob.GobError on malformed input."""
    name = jm.get("name") or ""
    jtype = jm.get("type") or ""
    if not name or jtype not in _TYPE_JSON:
        raise ValueError(f"bad JSONMetric key: name={name!r} type={jtype!r}")
    tags = jm.get("tags") or []
    if not isinstance(tags, list):
        raise ValueError("JSONMetric tags must be a list")
    raw = base64.b64decode(jm.get("value") or "")

    m = mpb.Metric(name=name, tags=[str(t) for t in tags],
                   type=_TYPE_JSON[jtype], scope=mpb.Mixed)
    if jtype == "counter":
        m.counter.value = gob.decode_counter(raw)
    elif jtype == "gauge":
        m.gauge.value = gob.decode_gauge(raw)
    elif jtype == "set":
        m.set.hyper_log_log = raw   # validated downstream by hll.deserialize
    else:
        d = gob.decode_digest(raw)
        td = m.histogram.t_digest
        td.compression = d["compression"]
        td.min = d["min"]
        td.max = d["max"]
        td.reciprocalSum = d["recip"]
        for mean, wt in zip(d["means"], d["weights"]):
            td.main_centroids.add(mean=float(mean), weight=float(wt))
    return m
