"""Minimal encoding/gob codec for the reference's HTTP-era forward payloads.

The reference's v1 forwarding path ships sampler state as JSONMetric
objects whose `value` bytes are Go-native encodings
(samplers/samplers.go:102-108 JSONMetric, flusher.go:338 flushForward →
handlers_global.go:115 unmarshalMetricsFromHTTP → worker.go:394
ImportMetric):

  - counter:            little-endian int64           (samplers.go:161 Export)
  - gauge/statuscheck:  little-endian float64         (samplers.go:245/:327)
  - set:                axiomhq HLL MarshalBinary     (samplers.go:406; decoded
                        by veneur_tpu/ops/hll.py)
  - histogram/timer:    encoding/gob of the t-digest  (merging_digest.go:393
                        GobEncode: []Centroid, compression, min, max,
                        reciprocalSum — five separate Encode calls)

This module implements the subset of the gob wire format those payloads
need — self-describing type definitions, struct/slice/float/int/uint/
bytes/string values — so a reference *local* veneur can HTTP-forward into
this global tier and vice versa, with no Go runtime anywhere.

Format notes (verified byte-for-byte against the reference's checked-in
fixtures `testdata/import.uncompressed` and `tdigest/testdata/
oldgob.base64`, which the tests replay):

  - unsigned int: < 128 one byte; else minimal big-endian bytes preceded
    by a byte holding the negated byte count.
  - signed int: bit 0 is the sign flag (u = x<<1, complemented if x<0).
  - float64: math.Float64bits, byte-reversed, sent as unsigned int.
  - message: uvarint byte length, then a signed type id. Negative id ⇒
    a wireType definition for type -id follows; positive id ⇒ a value.
  - struct value: (uvarint field delta, field value)* terminated by 0,
    field numbers starting from -1; zero-valued fields omitted.
  - non-struct top-level value: preceded by one 0x00 byte.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Tuple

# builtin gob type ids (the bootstrap types every stream assumes)
T_BOOL, T_INT, T_UINT, T_FLOAT, T_BYTES, T_STRING = 1, 2, 3, 4, 5, 6
T_COMPLEX, T_INTERFACE = 7, 8
T_WIRETYPE, T_ARRAYTYPE, T_COMMONTYPE, T_SLICETYPE = 16, 17, 18, 19
T_STRUCTTYPE, T_FIELDTYPE, T_FIELDTYPE_SLICE, T_MAPTYPE = 20, 21, 22, 23

# descriptors: ("struct", [(name, typeid)...]) | ("slice", elem) |
# ("array", elem, length) | ("map", key, elem) | ("builtin",)
_BOOTSTRAP = {
    T_WIRETYPE: ("struct", [("ArrayT", T_ARRAYTYPE),
                            ("SliceT", T_SLICETYPE),
                            ("StructT", T_STRUCTTYPE),
                            ("MapT", T_MAPTYPE)]),
    T_ARRAYTYPE: ("struct", [("CommonType", T_COMMONTYPE),
                             ("Elem", T_INT), ("Len", T_INT)]),
    T_COMMONTYPE: ("struct", [("Name", T_STRING), ("Id", T_INT)]),
    T_SLICETYPE: ("struct", [("CommonType", T_COMMONTYPE),
                             ("Elem", T_INT)]),
    T_STRUCTTYPE: ("struct", [("CommonType", T_COMMONTYPE),
                              ("Field", T_FIELDTYPE_SLICE)]),
    T_FIELDTYPE: ("struct", [("Name", T_STRING), ("Id", T_INT)]),
    T_FIELDTYPE_SLICE: ("slice", T_FIELDTYPE),
    T_MAPTYPE: ("struct", [("CommonType", T_COMMONTYPE),
                           ("Key", T_INT), ("Elem", T_INT)]),
}


class GobError(ValueError):
    pass


# -- primitive readers --------------------------------------------------------

def _read_uint(data: bytes, pos: int) -> Tuple[int, int]:
    if pos >= len(data):
        raise GobError("truncated gob: expected unsigned int")
    b = data[pos]
    if b < 0x80:
        return b, pos + 1
    n = 0x100 - b   # negated byte count
    if n > 8 or pos + 1 + n > len(data):
        raise GobError("truncated/overlong gob unsigned int")
    return int.from_bytes(data[pos + 1:pos + 1 + n], "big"), pos + 1 + n


def _read_int(data: bytes, pos: int) -> Tuple[int, int]:
    u, pos = _read_uint(data, pos)
    return (~(u >> 1) if u & 1 else u >> 1), pos


def _read_float(data: bytes, pos: int) -> Tuple[float, int]:
    u, pos = _read_uint(data, pos)
    rev = int.from_bytes(u.to_bytes(8, "big")[::-1], "big")
    return struct.unpack(">d", rev.to_bytes(8, "big"))[0], pos


# -- primitive writers --------------------------------------------------------

def _w_uint(out: bytearray, u: int) -> None:
    if u < 0x80:
        out.append(u)
        return
    b = u.to_bytes((u.bit_length() + 7) // 8, "big")
    out.append(0x100 - len(b))
    out.extend(b)


def _w_int(out: bytearray, x: int) -> None:
    _w_uint(out, (~x << 1) | 1 if x < 0 else x << 1)


def _w_float(out: bytearray, f: float) -> None:
    bits = struct.unpack(">Q", struct.pack(">d", f))[0]
    _w_uint(out, int.from_bytes(bits.to_bytes(8, "big")[::-1], "big"))


def _w_string(out: bytearray, s: str) -> None:
    b = s.encode()
    _w_uint(out, len(b))
    out.extend(b)


# -- decoder ------------------------------------------------------------------

class Decoder:
    """Decodes one gob stream (a sequence of Encode calls by one
    encoder). Each call to the Go side's Encode produced zero or more
    type-definition messages then one value message; decode_all returns
    the list of top-level values in order."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.types: Dict[int, tuple] = dict(_BOOTSTRAP)

    def at_end(self) -> bool:
        return self.pos >= len(self.data)

    def decode_all(self) -> List[Any]:
        out = []
        while not self.at_end():
            out.append(self._next_value())
        return out

    def _next_value(self) -> Any:
        while True:
            length, p = _read_uint(self.data, self.pos)
            if p + length > len(self.data):
                raise GobError("truncated gob message")
            end = p + length
            tid, p = _read_int(self.data, p)
            if tid < 0:
                # type definition for id -tid: a wireType value follows
                wire, p = self._decode_value(T_WIRETYPE, p)
                self._register(-tid, wire)
                if p != end:
                    raise GobError("trailing bytes in type definition")
                self.pos = end
                continue
            desc = self.types.get(tid)
            if desc is None and tid > T_INTERFACE:
                raise GobError(f"value of undefined gob type {tid}")
            if desc is None or desc[0] != "struct":
                delta, p = _read_uint(self.data, p)
                if delta != 0:
                    raise GobError("non-struct value missing 0x00 prefix")
            val, p = self._decode_value(tid, p)
            if p != end:
                raise GobError("trailing bytes in value message")
            self.pos = end
            return val

    def _register(self, tid: int, wire: Dict[str, Any]) -> None:
        if "StructT" in wire:
            st = wire["StructT"]
            fields = [(f.get("Name", ""), f.get("Id", 0))
                      for f in st.get("Field", [])]
            self.types[tid] = ("struct", fields)
        elif "SliceT" in wire:
            self.types[tid] = ("slice", wire["SliceT"].get("Elem", 0))
        elif "ArrayT" in wire:
            at = wire["ArrayT"]
            self.types[tid] = ("array", at.get("Elem", 0), at.get("Len", 0))
        elif "MapT" in wire:
            mt = wire["MapT"]
            self.types[tid] = ("map", mt.get("Key", 0), mt.get("Elem", 0))
        else:
            raise GobError(f"unsupported wireType for id {tid}: {wire}")

    def _decode_value(self, tid: int, p: int) -> Tuple[Any, int]:
        data = self.data
        if tid == T_BOOL:
            u, p = _read_uint(data, p)
            return bool(u), p
        if tid == T_INT:
            return _read_int(data, p)
        if tid == T_UINT:
            return _read_uint(data, p)
        if tid == T_FLOAT:
            return _read_float(data, p)
        if tid in (T_BYTES, T_STRING):
            n, p = _read_uint(data, p)
            if p + n > len(data):
                raise GobError("truncated gob bytes/string")
            raw = data[p:p + n]
            return (raw.decode() if tid == T_STRING else raw), p + n
        desc = self.types.get(tid)
        if desc is None:
            raise GobError(f"undefined gob type id {tid}")
        kind = desc[0]
        if kind == "struct":
            fields = desc[1]
            val: Dict[str, Any] = {}
            fieldnum = -1
            while True:
                delta, p = _read_uint(data, p)
                if delta == 0:
                    return val, p
                fieldnum += delta
                if fieldnum >= len(fields):
                    raise GobError(f"field number {fieldnum} out of range "
                                   f"for gob type {tid}")
                name, ftid = fields[fieldnum]
                val[name], p = self._decode_value(ftid, p)
        if kind == "slice":
            n, p = _read_uint(data, p)
            if n > len(data) - p:   # each element is ≥ 1 byte
                raise GobError("gob slice length exceeds buffer")
            items = []
            for _ in range(n):
                item, p = self._decode_value(desc[1], p)
                items.append(item)
            return items, p
        if kind == "array":
            n, p = _read_uint(data, p)
            if n != desc[2]:
                raise GobError("gob array length mismatch")
            items = []
            for _ in range(n):
                item, p = self._decode_value(desc[1], p)
                items.append(item)
            return items, p
        raise GobError(f"unsupported gob kind {kind!r}")


# -- encoder ------------------------------------------------------------------

class Encoder:
    """Produces gob streams for a fixed schema. Type ids are allocated
    from 65 upward in definition order, mirroring a fresh Go encoder (the
    canonical MergingDigest stream's prefix is asserted byte-identical to
    the reference fixture in tests/test_reference_compat.py)."""

    def __init__(self):
        self.out = bytearray()

    def _message(self, payload: bytes) -> None:
        _w_uint(self.out, len(payload))
        self.out.extend(payload)

    def _encode_by_desc(self, out: bytearray, desc: tuple, val: Any) -> None:
        kind = desc[0]
        if kind == "builtin":
            tid = desc[1]
            if tid == T_INT:
                _w_int(out, val)
            elif tid == T_UINT:
                _w_uint(out, val)
            elif tid == T_FLOAT:
                _w_float(out, val)
            elif tid == T_STRING:
                _w_string(out, val)
            elif tid == T_BYTES:
                _w_uint(out, len(val))
                out.extend(val)
            elif tid == T_BOOL:
                _w_uint(out, 1 if val else 0)
            else:
                raise GobError(f"cannot encode builtin {tid}")
        elif kind == "struct":
            fieldnum = -1
            for i, (name, fdesc) in enumerate(desc[1]):
                fval = val.get(name)
                if fval is None or fval == 0 or fval == "" or fval == []:
                    continue   # gob omits zero-valued fields
                _w_uint(out, i - fieldnum)
                self._encode_by_desc(out, fdesc, fval)
                fieldnum = i
            _w_uint(out, 0)
        elif kind == "slice":
            _w_uint(out, len(val))
            for item in val:
                self._encode_by_desc(out, desc[1], item)
        else:
            raise GobError(f"cannot encode kind {kind!r}")

    def write_value(self, tid: int, desc: tuple, val: Any) -> None:
        payload = bytearray()
        _w_int(payload, tid)
        if desc[0] != "struct":
            _w_uint(payload, 0)   # non-struct top-level marker
        self._encode_by_desc(payload, desc, val)
        self._message(bytes(payload))

    def write_typedef(self, tid: int, wire_field: str, body: bytes) -> None:
        """Emit a type-definition message: wireType{<field>: <body>}."""
        field_index = {"ArrayT": 0, "SliceT": 1, "StructT": 2,
                       "MapT": 3}[wire_field]
        payload = bytearray()
        _w_int(payload, -tid)
        _w_uint(payload, field_index + 1)   # delta from -1
        payload.extend(body)
        _w_uint(payload, 0)                  # end wireType
        self._message(bytes(payload))


def _common_type(name: str, tid: int) -> bytes:
    out = bytearray()
    if name:
        _w_uint(out, 1)          # field 0 Name
        _w_string(out, name)
        _w_uint(out, 1)          # delta 1 -> field 1 Id
    else:
        _w_uint(out, 2)          # skip Name: delta 2 -> field 1 Id
    _w_int(out, tid)
    _w_uint(out, 0)
    return bytes(out)


# -- the MergingDigest schema -------------------------------------------------

# Fresh-encoder id allocation for MergingDigest.GobEncode (verified
# against tdigest/testdata/oldgob.base64): 65 Centroid, 66 []float64,
# 67 []Centroid. The first Encode([]Centroid) emits defs 67, 65, 66.
_ID_CENTROID, _ID_FLOATS, _ID_CENTROIDS = 65, 66, 67

_CENTROID_DESC = ("struct", [("Mean", ("builtin", T_FLOAT)),
                             ("Weight", ("builtin", T_FLOAT)),
                             ("Samples", ("slice", ("builtin", T_FLOAT)))])
_CENTROIDS_DESC = ("slice", _CENTROID_DESC)
_FLOAT_DESC = ("builtin", T_FLOAT)


def _digest_typedefs(enc: Encoder) -> None:
    # []Centroid (unnamed slice): wireType{SliceT:{CommonType{Id:67},Elem:65}}
    body = bytearray()
    _w_uint(body, 1)                         # field 0 CommonType
    body.extend(_common_type("", _ID_CENTROIDS))
    _w_uint(body, 1)                         # field 1 Elem
    _w_int(body, _ID_CENTROID)
    _w_uint(body, 0)
    enc.write_typedef(_ID_CENTROIDS, "SliceT", bytes(body))

    # Centroid struct
    body = bytearray()
    _w_uint(body, 1)
    body.extend(_common_type("Centroid", _ID_CENTROID))
    _w_uint(body, 1)                         # field 1 Field: 3 fieldTypes
    _w_uint(body, 3)
    for fname, ftid in (("Mean", T_FLOAT), ("Weight", T_FLOAT),
                        ("Samples", _ID_FLOATS)):
        _w_uint(body, 1)
        _w_string(body, fname)
        _w_uint(body, 1)
        _w_int(body, ftid)
        _w_uint(body, 0)
    _w_uint(body, 0)
    enc.write_typedef(_ID_CENTROID, "StructT", bytes(body))

    # []float64 named slice
    body = bytearray()
    _w_uint(body, 1)
    body.extend(_common_type("[]float64", _ID_FLOATS))
    _w_uint(body, 1)
    _w_int(body, T_FLOAT)
    _w_uint(body, 0)
    enc.write_typedef(_ID_FLOATS, "SliceT", bytes(body))


def encode_digest(means, weights, compression: float, minimum: float,
                  maximum: float, reciprocal_sum: float = 0.0) -> bytes:
    """MergingDigest.GobEncode-compatible bytes (merging_digest.go:393):
    []Centroid, compression, min, max, reciprocalSum."""
    enc = Encoder()
    _digest_typedefs(enc)
    centroids = [{"Mean": float(m), "Weight": float(w), "Samples": []}
                 for m, w in zip(means, weights)]
    enc.write_value(_ID_CENTROIDS, _CENTROIDS_DESC, centroids)
    for f in (compression, minimum, maximum, reciprocal_sum):
        enc.write_value(T_FLOAT, _FLOAT_DESC, float(f))
    return bytes(enc.out)


def decode_digest(data: bytes) -> Dict[str, Any]:
    """Decode MergingDigest.GobEncode bytes into centroid arrays +
    scalars. reciprocalSum is EOF-tolerant (merging_digest.go:433: older
    peers don't send it)."""
    values = Decoder(data).decode_all()
    if len(values) < 4:
        raise GobError(f"digest gob has {len(values)} values, expected >=4")
    centroids, compression, minimum, maximum = values[:4]
    recip = values[4] if len(values) > 4 else 0.0
    if not isinstance(centroids, list):
        raise GobError("digest gob: first value is not a centroid list")
    means = [c.get("Mean", 0.0) for c in centroids]
    wts = [c.get("Weight", 0.0) for c in centroids]
    return {"means": means, "weights": wts, "compression": compression,
            "min": minimum, "max": maximum, "recip": recip}


# -- JSONMetric scalar payloads ----------------------------------------------

def encode_counter(value: int) -> bytes:
    """little-endian int64 (samplers.go:161-167)."""
    return struct.pack("<q", int(value))


def decode_counter(data: bytes) -> int:
    if len(data) != 8:
        raise GobError(f"counter payload must be 8 bytes, got {len(data)}")
    return struct.unpack("<q", data)[0]


def encode_gauge(value: float) -> bytes:
    """little-endian float64 (samplers.go:245-251, :327-333)."""
    return struct.pack("<d", float(value))


def decode_gauge(data: bytes) -> float:
    if len(data) != 8:
        raise GobError(f"gauge payload must be 8 bytes, got {len(data)}")
    return struct.unpack("<d", data)[0]
