"""ctypes binding of the native DogStatsD ingest engine (dogstatsd.cpp).

The engine parses, keys and stages wire lines in C++ and writes staged
rows straight into the packed i32 batch layout of aggregation/step.py.
It is host code on every device. The shared library is built with g++ at
the first `NativeIngest(...)`, never at import, into the git-ignored
``veneur_tpu_torch/_build/`` under a name keyed by the source and flags,
written to a temporary name and renamed, so processes that race to build
it never load a half-written file. A failed build or load raises with the
compiler's message: nothing falls back to the Python parser.

``VENEUR_NATIVE_SANITIZE=1`` (the JAX package's switch) builds it with
AddressSanitizer and UndefinedBehaviorSanitizer instead, as
``libdogstatsd_san_<key>.so``: the key covers the flags, so sanitized and
plain processes never share a file. CPython is not instrumented, so the
loading process must have the sanitizer runtimes preloaded
(``LD_PRELOAD`` of libasan and libubsan; tests/test_torch_native_sanitize.py
and chip_smoke.py phase 17 start such a child).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import List, Optional

import numpy as np

_SRC = Path(__file__).resolve().parent / "dogstatsd.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
GXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")
SANITIZE_FLAGS = ("-g", "-fsanitize=address,undefined",
                  "-fno-sanitize-recover=all", "-fno-omit-frame-pointer")

# rings_inject verdicts (dogstatsd.cpp ring_push2): BACKPRESSURE means a
# full ring refused the datagram WITHOUT counting it — pace and retry;
# REJECTED means it was counted (toolong or admission shed) and is gone.
INJECT_OK = 1
INJECT_REJECTED = 0
INJECT_BACKPRESSURE = -1

KIND_NAMES = {0: "counter", 1: "gauge", 2: "histogram", 3: "set",
              4: "timer"}
KIND_IDS = {v: k for k, v in KIND_NAMES.items()}


def sanitized() -> bool:
    """True when this process builds and loads the sanitized engine."""
    return os.environ.get("VENEUR_NATIVE_SANITIZE") == "1"


def library(sanitize: Optional[bool] = None) -> tuple:
    """(g++ flags, library path) of the plain or sanitized build (by
    default as VENEUR_NATIVE_SANITIZE says); builds nothing."""
    if sanitize is None:
        sanitize = sanitized()
    flags = GXX_FLAGS + SANITIZE_FLAGS if sanitize else GXX_FLAGS
    stem = "libdogstatsd_san_" if sanitize else "libdogstatsd_"
    key = hashlib.sha256(" ".join(flags).encode()
                         + _SRC.read_bytes()).hexdigest()[:16]
    return flags, BUILD_DIR / f"{stem}{key}.so"


def build(sanitize: Optional[bool] = None) -> Path:
    """Compile (or reuse) the engine's shared library, plain or sanitized
    (by default as VENEUR_NATIVE_SANITIZE says); returns its path."""
    flags, so = library(sanitize)
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp")
    res = subprocess.run(["g++", *flags, "-o", str(tmp), str(_SRC)],
                         capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed to build {_SRC.name}:\n"
                           f"{res.stdout}{res.stderr}")
    os.replace(tmp, so)
    return so


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build if needed, load once per process, declare every entry point
    the binding calls."""
    lib = ctypes.CDLL(str(build()))
    vp, u32, u64 = ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint64
    i32p, u32p = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(u32)
    u64p, cint = ctypes.POINTER(u64), ctypes.c_int
    sigs = {
        "vt_new": (vp, [u32] * 5 + [cint] + [u32] * 4),
        "vt_free": (None, [vp]),
        "vt_feed": (cint, [vp, ctypes.c_char_p, cint, cint,
                           ctypes.POINTER(cint)]),
        "vt_emit_packed": (None, [vp, i32p, i32p, u32p, u32p]),
        "vt_emit": (None, [vp] + [vp] * 10 + [u32p]),
        "vt_emit_sharded": (None, [vp] + [vp] * 10 + [i32p, u32p]),
        "vrm_emit_sharded": (None, [vp, cint] + [vp] * 10 + [i32p, u32p]),
        "vt_route_digest": (u32, [ctypes.c_char_p, cint, ctypes.c_char_p,
                                  cint, ctypes.c_char_p, cint]),
        "vt_new_keys": (cint, [vp, ctypes.c_char_p, cint]),
        "vt_next_special": (cint, [vp, ctypes.c_char_p, cint]),
        "vt_slot_for": (ctypes.c_int32, [vp, cint, cint, ctypes.c_char_p,
                                         cint, ctypes.c_char_p, cint, u32,
                                         ctypes.POINTER(cint)]),
        "vt_reset": (None, [vp]),
        "vt_stats": (None, [vp, u64p]),
        "vr_start": (vp, [vp, ctypes.POINTER(cint), cint, cint, cint]),
        "vr_pump": (cint, [vp, cint, u64p]),
        "vr_counters": (None, [vp, u64p]),
        "vr_stats": (None, [vp, u64p]),
        "vr_admission_set": (None, [vp, cint, cint, ctypes.c_double,
                                    ctypes.c_double, ctypes.c_char_p, cint]),
        "vr_admission_counters": (None, [vp, u64p]),
        "vr_stop": (None, [vp]),
        "vrm_start": (vp, [vp, ctypes.POINTER(cint), cint, cint, cint,
                           ctypes.POINTER(cint)]),
        "vrm_inject": (cint, [vp, cint, ctypes.c_char_p, cint]),
        "vrm_wait": (cint, [vp, cint]),
        "vrm_emit": (None, [vp, cint, i32p, i32p, u32p, u32p]),
        "vrm_pause": (None, [vp]),
        "vrm_resume": (None, [vp]),
        "vrm_reset": (None, [vp]),
        "vrm_counters": (None, [vp, cint, u64p]),
        "vrm_ring_stats": (None, [vp, cint, u64p]),
        "vrm_admission_set": (None, [vp, cint, cint, ctypes.c_double,
                                     ctypes.c_double, ctypes.c_char_p,
                                     cint]),
        "vrm_admission_counters": (None, [vp, cint, u64p]),
        "vrm_stats": (None, [vp, u64p]),
        "vrm_stop": (None, [vp]),
        "vt_tenant_config": (None, [vp, cint, ctypes.c_char_p, cint,
                                    ctypes.c_double, u32, ctypes.c_double,
                                    ctypes.c_double]),
        "vt_tenant_params": (None, [vp, ctypes.c_double, ctypes.c_char_p,
                                    cint]),
        "vt_tenant_names": (cint, [vp, ctypes.c_char_p, cint]),
        "vt_tenant_table": (cint, [vp, ctypes.c_char_p, cint]),
        "vt_tenant_restore": (cint, [vp, ctypes.c_char_p, cint]),
        "vt_tenant_rows": (cint, [vp, i32p, u64p, cint]),
        "vrm_tenant_counters": (cint, [vp, cint, i32p, u64p, cint]),
        "vt_capacity_set": (None, [vp, u32, u32, u32, u32]),
        "vt_shard_map_set": (None, [vp, u32]),
        "vrm_shard_map_set": (None, [vp, u32]),
        "vt_hash64_batch": (None, [ctypes.c_char_p,
                                   ctypes.POINTER(ctypes.c_int64), cint,
                                   u64p]),
        "vt_table_stats": (None, [vp, u64p]),
        "vrm_capacity_set": (None, [vp, u32, u32, u32, u32]),
        "vrm_table_stats": (None, [vp, u64p]),
        "vt_set_tenant": (None, [vp, ctypes.c_char_p, cint]),
        "vt_tenant_extract": (cint, [ctypes.c_char_p, cint, ctypes.c_char_p,
                                     cint, ctypes.c_char_p, cint]),
        "vi_import": (cint, [vp, ctypes.c_char_p, cint, cint,
                             ctypes.POINTER(cint), i32p, i32p, cint,
                             ctypes.POINTER(cint), ctypes.POINTER(cint)]),
        "vi_stats": (cint, [vp, i32p, ctypes.POINTER(ctypes.c_float),
                            ctypes.POINTER(ctypes.c_float),
                            ctypes.POINTER(ctypes.c_float), cint]),
    }
    for name, (restype, argtypes) in sigs.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def tenant_extract(tag: str, data: bytes) -> Optional[str]:
    """The engine's tenant-tag extraction (vt_tenant_extract) on its own:
    the value of the first well-formed `tag` occurrence in a raw
    datagram, or None for every default-tenant outcome (missing tag,
    empty, oversized or invalid-UTF-8 value, a tag cut by truncation).
    reliability/tenancy.py extract_tenant is its Python mirror."""
    lib = load()
    tag_b = tag.encode("utf-8", "surrogateescape")
    out = ctypes.create_string_buffer(256)
    n = lib.vt_tenant_extract(tag_b, len(tag_b), data, len(data), out,
                              len(out))
    if n <= 0:
        return None
    return out.raw[:n].decode("utf-8", "surrogateescape")


def hash64_batch(members: List[bytes]) -> np.ndarray:
    """FNV-1a 64 of each byte string in one call (vt_hash64_batch),
    bit-identical to utils/hashing.py fnv1a_64: the count-min sketch's
    member hashes."""
    lib = load()
    n = len(members)
    offs = np.zeros(n + 1, np.int64)
    if n:
        np.cumsum([len(m) for m in members], out=offs[1:])
    out = np.empty(n, np.uint64)
    lib.vt_hash64_batch(
        b"".join(members),
        offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)))
    return out


def route_digest(kind: str, name: str, joined_tags: str) -> int:
    """The engine's routing digest (vt_route_digest: fnv1a-32 over name,
    kind, joined tags), byte-identical to collective/keytable.py
    route_digest."""
    lib = load()
    name_b = name.encode("utf-8", "surrogateescape")
    kind_b = kind.encode("utf-8")
    tags_b = joined_tags.encode("utf-8", "surrogateescape")
    return int(lib.vt_route_digest(name_b, len(name_b), kind_b,
                                   len(kind_b), tags_b, len(tags_b)))


def _ptrs(arrays) -> list:
    return [a.ctypes.data_as(ctypes.c_void_p) for a in arrays]


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _u32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))


def _tenant_merge(acc: dict, one: dict) -> None:
    """Accumulate one ring's per-tenant drain into a host-wide fold
    (ring_tenant_drain_one layout: nested admitted/shed class dicts plus
    a demoted_rows scalar)."""
    for tenant, ent in one.items():
        dst = acc.setdefault(tenant, {})
        for side in ("admitted", "shed"):
            for cls, n in ent.get(side, {}).items():
                d = dst.setdefault(side, {})
                d[cls] = d.get(cls, 0) + n
        if ent.get("demoted_rows"):
            dst["demoted_rows"] = (dst.get("demoted_rows", 0)
                                   + ent["demoted_rows"])


_CLASSES = ("self", "high", "low")
_RING_STATS = ("ring_depth", "ring_highwater", "pump_batches", "pump_stalls",
               "emit_packed_calls", "emit_packed_ns", "datagrams",
               "ring_dropped")


class NativeIngest:
    """One parser + key table + stager instance (the C++ counterpart of
    aggregation/host.py KeyTable + Batcher). Its slot space is split into
    `n_shards` shards by the host.py rule (slot = shard·per_shard +
    local, shard = digest % n_shards)."""

    def __init__(self, spec, bspec, n_shards: int = 1):
        self._lib = load()
        self.spec = spec
        self.bspec = bspec
        self._h = self._lib.vt_new(
            spec.counter_capacity, spec.gauge_capacity, spec.set_capacity,
            spec.histo_capacity, n_shards, spec.hll_precision,
            bspec.counter, bspec.gauge, bspec.set, bspec.histo)
        self._keybuf = ctypes.create_string_buffer(1 << 20)
        self._specialbuf = ctypes.create_string_buffer(1 << 16)
        self._readers = None
        self._rings = None
        self._n_rings = 0

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.vt_free(h)
            self._h = None

    def feed(self, data: bytes, start: int = 0) -> tuple:
        """Parse a packet buffer from byte offset `start`. Returns
        (full, consumed): full means a staging lane filled and an emit
        should run; consumed is the absolute offset of the first
        unhandled byte — resume with feed(data, consumed) after emitting.
        The same bytes object is passed back unsliced, so a lane-full
        stop never copies the remainder."""
        consumed = ctypes.c_int(0)
        rc = self._lib.vt_feed(self._h, data, len(data), start,
                               ctypes.byref(consumed))
        return bool(rc), consumed.value

    def emit_packed(self, flat: np.ndarray, lane_offs: np.ndarray,
                    prev_counts: np.ndarray) -> tuple:
        """Zero-copy emit into a caller-owned flat i32 buffer laid out
        exactly like aggregation/step.py pack_batch. `lane_offs` is the
        int32[10] word offsets of the ten native lanes in that layout;
        `prev_counts` is this buffer's uint32[4] counts from ITS previous
        emit (updated in place — the engine re-sentinels only the rows the
        previous emit dirtied past the new counts). Returns (nc, ng, ns,
        nh) and resets staging."""
        counts = (ctypes.c_uint32 * 4)()
        self._lib.vt_emit_packed(self._h, _i32p(flat), _i32p(lane_offs),
                                 _u32p(prev_counts), counts)
        return tuple(counts)

    def emit_into(self, batcher_arrays) -> tuple:
        """Copy the staged rows into numpy arrays and reset staging.
        batcher_arrays is (c_slot, c_inc, g_slot, g_val, s_slot, s_reg,
        s_rho, h_slot, h_val, h_wt); rows past each returned count are
        left as they were. Returns (nc, ng, ns, nh)."""
        counts = (ctypes.c_uint32 * 4)()
        self._lib.vt_emit(self._h, *_ptrs(batcher_arrays), counts)
        return tuple(counts)

    def emit_sharded(self, batcher_arrays, bounds: np.ndarray) -> tuple:
        """emit_into with the rows grouped by owner shard (stable, so
        arrival order -- gauge last write -- holds within a shard) and
        slots rebased shard-local. `bounds` (int32[4·(n_shards+1)], kinds
        in counter/gauge/set/histo order) receives each kind's shard
        prefix bounds. Returns (nc, ng, ns, nh)."""
        counts = (ctypes.c_uint32 * 4)()
        self._lib.vt_emit_sharded(self._h, *_ptrs(batcher_arrays),
                                  _i32p(bounds), counts)
        return tuple(counts)

    def slot_for(self, kind: str, name: str, joined_tags: str, scope: int,
                 digest: int):
        """(slot, was_new) for a Python-side caller sharing the native slot
        space; slot is None at capacity."""
        was_new = ctypes.c_int(0)
        name_b = name.encode("utf-8", "surrogateescape")
        tags_b = joined_tags.encode("utf-8", "surrogateescape")
        slot = self._lib.vt_slot_for(
            self._h, KIND_IDS[kind], scope, name_b, len(name_b),
            tags_b, len(tags_b), digest & 0xFFFFFFFF,
            ctypes.byref(was_new))
        return (None if slot < 0 else slot), bool(was_new.value)

    def drain_new_keys(self) -> List[tuple]:
        """[(kind, slot, scope, name, joined_tags, imported)] allocated
        since the last drain. The scope byte's bit 7 marks slots first
        created by the native import path (imported_only labelling)."""
        n = self._lib.vt_new_keys(self._h, self._keybuf, len(self._keybuf))
        if n < 0:
            self._keybuf = ctypes.create_string_buffer(-n * 2)
            n = self._lib.vt_new_keys(self._h, self._keybuf,
                                      len(self._keybuf))
        out = []
        raw = self._keybuf.raw[:n]
        off = 0
        while off < n:
            kind = raw[off]
            slot = int.from_bytes(raw[off + 1:off + 5], "little",
                                  signed=True)
            scope = raw[off + 5] & 0x7F
            imported = bool(raw[off + 5] & 0x80)
            nl = int.from_bytes(raw[off + 6:off + 8], "little")
            name = raw[off + 8:off + 8 + nl].decode(
                "utf-8", "surrogateescape")
            off += 8 + nl
            tl = int.from_bytes(raw[off:off + 2], "little")
            tags = raw[off + 2:off + 2 + tl].decode(
                "utf-8", "surrogateescape")
            off += 2 + tl
            out.append((KIND_NAMES[kind], slot, scope, name, tags,
                        imported))
        return out

    def import_metriclist(self, data: bytes, offset: int = 0):
        """Decode and stage a serialized forwardrpc.MetricList from
        `offset` (the whole buffer is passed without a copy; a re-entry
        never re-slices the remainder). Returns (handled, consumed_abs,
        fallback_spans, lane_full): consumed_abs is the absolute offset
        fully handled (re-enter there after emitting when lane_full), and
        fallback_spans the [(abs_off, length)] of Metric submessages for
        the Python path."""
        consumed = ctypes.c_int(0)
        n_fb = ctypes.c_int(0)
        full_stop = ctypes.c_int(0)
        fb_cap = 1024
        fb_off = (ctypes.c_int32 * fb_cap)()
        fb_len = (ctypes.c_int32 * fb_cap)()
        staged = self._lib.vi_import(
            self._h, data, len(data), offset, ctypes.byref(consumed),
            fb_off, fb_len, fb_cap, ctypes.byref(n_fb),
            ctypes.byref(full_stop))
        spans = [(fb_off[i], fb_len[i]) for i in range(n_fb.value)]
        return staged, consumed.value, spans, bool(full_stop.value)

    def drain_import_stats(self):
        """(slots, mins, maxes, recip_corrs) numpy arrays of the
        per-imported-histogram scalar stats import_metriclist staged."""
        cap = 4096
        slots = np.empty(cap, np.int32)
        mns = np.empty(cap, np.float32)
        mxs = np.empty(cap, np.float32)
        rc = np.empty(cap, np.float32)
        f32p = ctypes.POINTER(ctypes.c_float)
        out = [[], [], [], []]
        while True:
            n = self._lib.vi_stats(
                self._h, slots.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                mns.ctypes.data_as(f32p), mxs.ctypes.data_as(f32p),
                rc.ctypes.data_as(f32p), cap)
            if n <= 0:
                break
            for dst, src in zip(out, (slots, mns, mxs, rc)):
                dst.append(src[:n].copy())
            if n < cap:
                break
        if not out[0]:
            z = np.empty(0, np.float32)
            return np.empty(0, np.int32), z, z, z
        return tuple(np.concatenate(x) for x in out)

    def drain_specials(self) -> List[bytes]:
        """Event/service-check lines the C++ parser escalated."""
        out = []
        while True:
            n = self._lib.vt_next_special(self._h, self._specialbuf,
                                          len(self._specialbuf))
            if n == 0:
                break
            if n < 0:
                self._specialbuf = ctypes.create_string_buffer(-n * 2)
                continue
            out.append(self._specialbuf.raw[:n])
        return out

    def reset(self):
        if self._rings:
            # clears the master tables AND every ring's key-replica cache;
            # callers hold the rings_pause() quiesce across this
            self._lib.vrm_reset(self._rings)
        else:
            self._lib.vt_reset(self._h)

    def shard_map_set(self, n_shards: int) -> None:
        """Stage a new shard count; it takes effect at the next reset(),
        inside the swap's quiesce, never at once. reshard/quiesce.py is
        the one caller."""
        if self._rings:
            self._lib.vrm_shard_map_set(self._rings, int(n_shards))
        else:
            self._lib.vt_shard_map_set(self._h, int(n_shards))

    def capacity_set(self, counter: int, gauge: int, set_: int,
                     histo: int) -> None:
        """Stage new per-kind table capacities (0 keeps one); they take
        effect at the next reset(), inside the swap's quiesce, never
        at once. tables/growth.py is the one caller."""
        args = (int(counter), int(gauge), int(set_), int(histo))
        if self._rings:
            self._lib.vrm_capacity_set(self._rings, *args)
        else:
            self._lib.vt_capacity_set(self._h, *args)

    def table_stats(self) -> dict:
        """Per-kind key-table occupancy for the growth planner:
        {kind: (allocated, cumulative dropped, capacity)} over the
        engine's four tables. Takes the key tables' lock shared, so it is
        safe beside ring parsing."""
        s = (ctypes.c_uint64 * 12)()
        if self._rings:
            self._lib.vrm_table_stats(self._rings, s)
        else:
            self._lib.vt_table_stats(self._h, s)
        return {k: (int(s[i * 3]), int(s[i * 3 + 1]), int(s[i * 3 + 2]))
                for i, k in enumerate(("counter", "gauge", "set", "histo"))}

    def stats(self) -> dict:
        s = (ctypes.c_uint64 * 3)()
        if self._rings:
            self._lib.vrm_stats(self._rings, s)  # ring parsers + master
        else:
            self._lib.vt_stats(self._h, s)
        return {"processed": s[0], "parse_errors": s[1], "dropped": s[2]}

    # -- native UDP reader group (vr_* in dogstatsd.cpp) --------------------

    def readers_start(self, fds: List[int], max_len: int = 65536,
                      ring_cap: int = 65536) -> None:
        """Spawn one C++ recvmmsg thread per fd, feeding the shared
        datagram ring drained by pump(). Each fd is dup()ed into C++
        ownership, so the Python sockets may be closed at any time after
        this returns; the dups are released by readers_stop()."""
        arr = (ctypes.c_int * len(fds))(*fds)
        self._readers = self._lib.vr_start(self._h, arr, len(fds), max_len,
                                           ring_cap)

    def pump(self, max_wait_ms: int) -> tuple:
        """Drain queued datagrams into staging (blocks in C++ with the GIL
        released while the ring is idle). Returns (full, stats) where full
        means a staging lane filled — emit and call pump(0) again — and
        stats is {parsed, ring_depth, ring_dropped, datagrams}."""
        out = (ctypes.c_uint64 * 4)()
        full = self._lib.vr_pump(self._readers, max_wait_ms, out)
        return bool(full), {"parsed": out[0], "ring_depth": out[1],
                            "ring_dropped": out[2], "datagrams": out[3]}

    def reader_counters(self) -> dict:
        """Live reader counters, callable from any thread. With the
        multi-ring engine the totals are exact sums over every ring."""
        agg = {"datagrams": 0, "ring_dropped": 0, "ring_depth": 0,
               "toolong": 0}
        out = (ctypes.c_uint64 * 4)()
        if self._rings:
            for i in range(self._n_rings):
                self._lib.vrm_counters(self._rings, i, out)
                for j, k in enumerate(agg):
                    agg[k] += out[j]
        elif self._readers:
            self._lib.vr_counters(self._readers, out)
            agg = {k: out[j] for j, k in enumerate(agg)}
        return agg

    def ring_stats(self) -> dict:
        """Deep ring/emit telemetry snapshot, callable from any thread:
        ring depth + high-water, pump batch/stall counts, emit_packed
        call/ns totals, datagram and ring-drop totals. Zeros when no
        reader group runs. With the multi-ring engine, counters are exact
        cross-ring sums and the high-water is the per-ring max."""
        if self._rings:
            agg = dict.fromkeys(_RING_STATS, 0)
            for per in self.ring_stats_per_ring():
                for k in _RING_STATS:
                    agg[k] = (max(agg[k], per[k]) if k == "ring_highwater"
                              else agg[k] + per[k])
            return agg
        if not self._readers:
            return dict.fromkeys(_RING_STATS, 0)
        out = (ctypes.c_uint64 * 8)()
        self._lib.vr_stats(self._readers, out)
        return dict(zip(_RING_STATS, out))

    def admission_set(self, enabled: bool, state: int, rate: float,
                      burst: float, high_tags) -> None:
        """Push an overload controller's statsd admission knobs into the
        reader ring. high_tags is an iterable of priority tag strings.
        With the multi-ring engine, rate/burst split evenly across rings
        inside the C++ so the host-level admit rate is the single-ring
        one."""
        joined = "\n".join(high_tags).encode("utf-8", "surrogateescape")
        args = (1 if enabled else 0, int(state), float(rate), float(burst),
                joined, len(joined))
        if self._rings:
            self._lib.vrm_admission_set(self._rings, *args)
        elif self._readers:
            self._lib.vr_admission_set(self._readers, *args)

    def admission_drain(self) -> dict:
        """Drain-and-reset exact per-class ring admission deltas:
        {"admitted": {class: n}, "shed": {class: n}} with zero entries
        omitted (classes self/high/low). With the multi-ring engine the
        deltas are drained from EVERY ring and summed, so sent == toolong
        + admitted + shed holds host-wide."""
        if self._rings:
            adm, shed, tenants = [0, 0, 0], [0, 0, 0], {}
            for i in range(self._n_rings):
                one = self.ring_admission_drain_one(i)
                for c, name in enumerate(_CLASSES):
                    adm[c] += one["admitted"].get(name, 0)
                    shed[c] += one["shed"].get(name, 0)
                _tenant_merge(tenants, one.get("tenants", {}))
            d = {"admitted": {n: v for n, v in zip(_CLASSES, adm) if v},
                 "shed": {n: v for n, v in zip(_CLASSES, shed) if v}}
            if tenants:
                d["tenants"] = tenants
            return d
        if not self._readers:
            return {"admitted": {}, "shed": {}}
        out = (ctypes.c_uint64 * 6)()
        self._lib.vr_admission_counters(self._readers, out)
        return _class_counts(out)

    def readers_stop(self) -> None:
        if self._readers:
            self._lib.vr_stop(self._readers)
            self._readers = None
        if self._rings:
            self._lib.vrm_stop(self._rings)
            self._rings = None
            self._n_rings = 0

    # -- multi-ring engine (vrm_* in dogstatsd.cpp) -------------------------

    @property
    def n_rings(self) -> int:
        """Rings in the multi-ring engine; 0 when it isn't running."""
        return self._n_rings if self._rings else 0

    def rings_start(self, n_rings: int, fds=None, max_len: int = 65536,
                    ring_cap: int = 65536, pin_cores=None) -> None:
        """Start the multi-ring engine: one ring + parser thread pair per
        entry, all sharing this instance's key tables. fds[i] >= 0
        attaches a dup()ed SO_REUSEPORT socket to ring i; None/-1 entries
        make inject-only rings (rings_inject places datagrams). pin_cores[i]
        >= 0 pins ring i's reader and worker threads to that core."""
        fd_arr = (ctypes.c_int * n_rings)(
            *[(fds[i] if fds is not None and i < len(fds)
               and fds[i] is not None else -1) for i in range(n_rings)])
        pin_arr = None
        if pin_cores:
            pin_arr = (ctypes.c_int * n_rings)(
                *[(pin_cores[i] if i < len(pin_cores) else -1)
                  for i in range(n_rings)])
        self._rings = self._lib.vrm_start(self._h, fd_arr, n_rings, max_len,
                                          ring_cap, pin_arr)
        self._n_rings = n_rings

    def rings_inject(self, ring: int, data: bytes) -> int:
        """Queue one datagram onto ring i through the socket path's
        toolong/admission/ring-cap accounting. Returns INJECT_OK (queued),
        INJECT_REJECTED (counted and dropped: toolong or shed) or
        INJECT_BACKPRESSURE (the ring is full and NOTHING was counted —
        the caller still owns the datagram; pace, then retry)."""
        return int(self._lib.vrm_inject(self._rings, ring, data, len(data)))

    def rings_wait(self, max_wait_ms: int) -> int:
        """Block (GIL released) until a ring stalls on full staging or
        staging runs rich, or the timeout passes. Returns the number of
        stalled rings."""
        return self._lib.vrm_wait(self._rings, max_wait_ms)

    def rings_emit(self, ring: int, flat: np.ndarray, lane_offs: np.ndarray,
                   prev_counts: np.ndarray) -> tuple:
        """emit_packed for ring i's staging into its row of the packed
        arena (same layout and sentinel contract as emit_packed)."""
        counts = (ctypes.c_uint32 * 4)()
        self._lib.vrm_emit(self._rings, ring, _i32p(flat), _i32p(lane_offs),
                           _u32p(prev_counts), counts)
        return tuple(counts)

    def rings_emit_sharded(self, ring: int, batcher_arrays,
                           bounds: np.ndarray) -> tuple:
        """emit_sharded for ring i's staging: the sharded backend's
        per-ring drain."""
        counts = (ctypes.c_uint32 * 4)()
        self._lib.vrm_emit_sharded(self._rings, ring,
                                   *_ptrs(batcher_arrays), _i32p(bounds),
                                   counts)
        return tuple(counts)

    def rings_pause(self) -> None:
        """Swap-boundary quiesce: no ring worker parses again until
        rings_resume(). Emit every ring, then reset(), inside this."""
        self._lib.vrm_pause(self._rings)

    def rings_resume(self) -> None:
        self._lib.vrm_resume(self._rings)

    def ring_stats_per_ring(self) -> List[dict]:
        """Per-ring deep telemetry (ring_stats layout), [] when the
        multi-ring engine is not running."""
        if not self._rings:
            return []
        out = (ctypes.c_uint64 * 8)()
        rows = []
        for i in range(self._n_rings):
            self._lib.vrm_ring_stats(self._rings, i, out)
            rows.append(dict(zip(_RING_STATS, out)))
        return rows

    def ring_admission_drain_one(self, ring: int) -> dict:
        """Drain-and-reset ring i's exact per-class admission deltas
        (admission_drain layout), plus — when the tenant table is live —
        a "tenants" sub-dict drained through the same per-ring fold
        point. Callers fold across ALL rings (admission_drain does)."""
        out = (ctypes.c_uint64 * 6)()
        self._lib.vrm_admission_counters(self._rings, ring, out)
        d = _class_counts(out)
        if getattr(self, "_tenant_names", None) is not None:
            tenants = self.ring_tenant_drain_one(ring)
            if tenants:
                d["tenants"] = tenants
        return d

    # -- multi-tenant identity / fairness / quarantine ----------------------

    def tenant_config(self, enabled: bool, tag: str = "tenant:",
                      burst_mult: float = 2.0, q_max_keys: int = 0,
                      q_decay: float = 0.5,
                      q_readmit_frac: float = 0.5) -> None:
        """Create/configure the tenant table on the master parser. Must
        run before rings_start — the tag is read lock-free on the
        admission path. Interns the default tenant as id 0."""
        tag_b = tag.encode("utf-8", "surrogateescape")
        self._lib.vt_tenant_config(self._h, 1 if enabled else 0, tag_b,
                                   len(tag_b), float(burst_mult),
                                   int(q_max_keys), float(q_decay),
                                   float(q_readmit_frac))
        if getattr(self, "_tenant_names", None) is None:
            self._tenant_names = {0: "default"}

    def tenant_params(self, base_rate: float, weights: dict) -> None:
        """Per-poll push: base admit rate (tokens/s per unit weight; <=0
        disables the fairness buckets) and {tenant: weight} overrides.
        Unknown names are interned so weights precede first traffic."""
        blob = "".join(
            f"{name}\t{float(w)}\n" for name, w in weights.items()
        ).encode("utf-8", "surrogateescape")
        self._lib.vt_tenant_params(self._h, float(base_rate), blob,
                                   len(blob))

    def _grow_call(self, fn, cap: int):
        """Call fn(cap) until its buffer is large enough (a negative
        return asks for -n units)."""
        while True:
            res = fn(cap)
            if res[0] >= 0:
                return res
            cap = -res[0] * 2

    def _tenant_refresh_names(self) -> None:
        """Drain newly interned (id, name) pairs into the local map."""
        def call(cap):
            buf = ctypes.create_string_buffer(cap)
            return self._lib.vt_tenant_names(self._h, buf, cap), buf.raw
        n, raw = self._grow_call(call, 4096)
        off = 0
        for _ in range(n):
            tid = int.from_bytes(raw[off:off + 4], "little", signed=True)
            ln = int.from_bytes(raw[off + 4:off + 6], "little")
            self._tenant_names[tid] = raw[off + 6:off + 6 + ln].decode(
                "utf-8", "surrogateescape")
            off += 6 + ln

    def _tenant_name(self, tid: int) -> str:
        name = self._tenant_names.get(tid)
        if name is None:
            self._tenant_refresh_names()
            name = self._tenant_names.get(tid, f"tenant#{tid}")
        return name

    def tenant_table(self) -> dict:
        """Non-destructive snapshot of every interned tenant:
        {name: {"demoted": bool, "key_est": float}}."""
        def call(cap):
            buf = ctypes.create_string_buffer(cap)
            return self._lib.vt_tenant_table(self._h, buf, cap), buf.raw
        n, raw = self._grow_call(call, 1 << 16)
        out = {}
        off = 0
        for _ in range(n):
            tid = int.from_bytes(raw[off:off + 4], "little", signed=True)
            demoted = raw[off + 4] != 0
            est = np.frombuffer(raw[off + 5:off + 13], "<f8")[0]
            ln = int.from_bytes(raw[off + 13:off + 15], "little")
            name = raw[off + 15:off + 15 + ln].decode(
                "utf-8", "surrogateescape")
            off += 15 + ln
            self._tenant_names[tid] = name
            out[name] = {"demoted": demoted, "key_est": float(est)}
        return out

    def tenant_restore(self, entries) -> int:
        """Restore quarantine state from a checkpoint: entries is an
        iterable of (name, demoted, key_est) in snapshot order — names
        re-intern in that order, reproducing the snapshot's ids. Returns
        entries applied."""
        parts = []
        for name, demoted, est in entries:
            nb = name.encode("utf-8", "surrogateescape")
            parts += [bytes([1 if demoted else 0]),
                      np.float64(est).tobytes(),
                      len(nb).to_bytes(2, "little"), nb]
        blob = b"".join(parts)
        n = int(self._lib.vt_tenant_restore(self._h, blob, len(blob)))
        self._tenant_refresh_names()
        return n

    def set_tenant(self, name: str) -> None:
        """Parse context of the feed path: later feed() calls parse as
        tenant `name` (empty: the default tenant). The ring engine
        resolves the tenant of each datagram itself."""
        nb = name.encode("utf-8", "surrogateescape")
        self._lib.vt_set_tenant(self._h, nb, len(nb))

    def tenant_rows_drain(self) -> dict:
        """Drain-and-reset the master parser's exact demoted-row counts
        ({tenant: rows}) staged by the feed path."""
        def call(cap):
            ids = (ctypes.c_int32 * cap)()
            counts = (ctypes.c_uint64 * cap)()
            return (self._lib.vt_tenant_rows(self._h, ids, counts, cap),
                    ids, counts)
        n, ids, counts = self._grow_call(call, 64)
        return {self._tenant_name(ids[i]): int(counts[i])
                for i in range(n)}

    def ring_tenant_drain_one(self, ring: int) -> dict:
        """Drain-and-reset ring i's exact per-tenant deltas:
        {tenant: {"admitted": {class: n}, "shed": {class: n},
        "demoted_rows": n}} with zero entries omitted. Callers fold
        across ALL rings (admission_drain does)."""
        def call(cap):
            ids = (ctypes.c_int32 * cap)()
            counts = (ctypes.c_uint64 * (cap * 7))()
            n = self._lib.vrm_tenant_counters(self._rings, ring, ids,
                                              counts, cap)
            return n, ids, counts
        n, ids, counts = self._grow_call(call, 64)
        out = {}
        for i in range(n):
            row = counts[i * 7:(i + 1) * 7]
            ent = {k: v for k, v in _class_counts(row).items() if v}
            if row[6]:
                ent["demoted_rows"] = int(row[6])
            if ent:
                out[self._tenant_name(ids[i])] = ent
        return out


def _class_counts(row) -> dict:
    """{"admitted": {class: n}, "shed": {class: n}} from six counters
    (admitted self/high/low, then shed), zero entries omitted."""
    return {"admitted": {_CLASSES[c]: int(row[c]) for c in range(3)
                         if row[c]},
            "shed": {_CLASSES[c]: int(row[3 + c]) for c in range(3)
                     if row[3 + c]}}
