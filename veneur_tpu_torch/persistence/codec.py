"""Versioned, chunked, CRC-checksummed on-disk snapshot format.

One checkpoint is a DIRECTORY holding two files:

  chunks.bin      every chunk's raw bytes, concatenated
  MANIFEST.json   format version, schema hash, spec, per-kind row counts,
                  and the chunk index {name, offset, length, crc32, dtype,
                  shape}; written LAST via temp-file + atomic rename, so
                  its presence certifies every chunk byte already fsynced

The chunk payloads are the COMPACT per-live-row aggregation snapshot (row
i of each array pairs with entry i of the same kind's key-table chunk) —
the same pairing contract as Aggregator.compute_flush — plus the interned
key-table strings as one JSON chunk and the ForwardSpillBuffer's wire
bytes as one opaque chunk. Full-capacity DeviceState arrays are NOT
stored: at the default TableSpec that would be ~130MB per checkpoint
regardless of occupancy.

Schema drift is detected, not silently misread: the manifest pins a hash
over DeviceState._fields + TableSpec's field names, and load refuses a
snapshot whose hash differs. The format, its version and its pins are
the JAX package's (veneur_tpu/persistence/codec.py), so a checkpoint
written by either package loads in the other; the port's DeviceState and
TableSpec carry the JAX field names, so schema_hash() is the same
(tests/test_torch_persistence.py holds both to the pin).
"""

from __future__ import annotations

import json
import logging
import os
import re
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from veneur_tpu_torch.utils.atomicio import atomic_write_bytes, fsync_dir

log = logging.getLogger("veneur_tpu_torch.persistence.codec")

SNAPSHOT_FORMAT_VERSION = 2

# schema_hash() pinned per format version (the JAX package's pins)
_SCHEMA_PINS = {
    1: "f2901f08f86fee1c56067eb6c0668195cac0ad5cd042ea50ecad364d6baab4a2",
    2: "fc98f22981986f4c0706c52de3c9a659d66d29e7f943267b51adaa18d8fac7c5",
}

# Older format versions this build still READS, with the layout change
# each bump made. read_manifest accepts a listed version iff the
# snapshot's hash matches that version's frozen pin, and restore.py owns
# the forward conversion; an unlisted old version stays CorruptSnapshot.
_SCHEMA_MIGRATIONS = {
    1: "HLL array chunk was dense uint8[rows, 2^p] registers; v2 stores "
       "6-bit packed int32[rows, ceil(2^p*6/32)] words. Dense rows fold "
       "through the normal restore merge path (ops/hll.py merge_rows_"
       "packed), so v1 restores remain byte-exact.",
}

MANIFEST_NAME = "MANIFEST.json"
CHUNKS_NAME = "chunks.bin"

# the per-kind key-table chunks and their paired array chunks
TABLE_KINDS = ("counter", "gauge", "status", "set", "histo")
ARRAY_FIELDS = ("counter", "gauge", "status", "hll", "h_mean", "h_weight",
                "h_min", "h_max", "h_recip")

_CKPT_RE = re.compile(r"^ckpt-(\d{8})$")


class CorruptSnapshot(Exception):
    """A checkpoint that failed validation (bad CRC, truncated manifest,
    unknown version, schema-hash mismatch). Callers quarantine and fall
    back — never crash on one (restore.py restore_latest)."""


def schema_hash() -> str:
    """Hash over the structures the snapshot's meaning depends on:
    DeviceState's field list (order included — it defines what state
    exists to snapshot) and TableSpec's field names (they define the
    capacities/sketch parameters the manifest records)."""
    import dataclasses
    import hashlib

    from veneur_tpu_torch.aggregation.state import DeviceState, TableSpec
    payload = {
        "format_version": SNAPSHOT_FORMAT_VERSION,
        "device_state_fields": list(DeviceState._fields),
        "table_spec_fields": sorted(
            f.name for f in dataclasses.fields(TableSpec)),
    }
    return hashlib.sha256(
        json.dumps(payload, sort_keys=True).encode()).hexdigest()


def _tables_json(tables: Dict[str, list]) -> bytes:
    # ensure_ascii keeps lone surrogates (non-UTF-8 interned names round-
    # trip host-side via surrogateescape) representable: they escape to
    # \udcXX, which json.loads restores exactly
    return json.dumps(tables, ensure_ascii=True,
                      separators=(",", ":")).encode("ascii")


def encode_to_dir(dirpath: str, snap: dict, fsync: bool = True) -> int:
    """Serialize an in-memory snapshot (persistence/snapshot.py layout)
    into `dirpath` (which must exist and be empty-ish — the writer hands
    us a fresh temp dir). Returns total bytes written."""
    chunks: List[Tuple[str, bytes, Optional[str], Optional[list]]] = []
    for name in ARRAY_FIELDS:
        arr = np.ascontiguousarray(snap["arrays"][name])
        chunks.append((f"array:{name}", arr.tobytes(), str(arr.dtype),
                       list(arr.shape)))
    chunks.append(("tables", _tables_json(snap["tables"]), None, None))
    chunks.append(("spill", snap.get("spill") or b"", None, None))
    # exactly-once forwarding identity + dedup window (JSON; optional —
    # readers of older checkpoints see no "forward" chunk and old readers
    # ignore unknown chunk names, so no format-version bump is needed)
    if snap.get("forward"):
        chunks.append(("forward",
                       json.dumps(snap["forward"],
                                  separators=(",", ":")).encode(),
                       None, None))
    # watch registrations + firing state (JSON sidecar; optional under
    # the same unknown-chunk compatibility rule as "forward")
    if snap.get("watches"):
        chunks.append(("watches",
                       json.dumps(snap["watches"],
                                  separators=(",", ":")).encode(),
                       None, None))
    # tenant quarantine + demoted-row sidecar (JSON; same rule)
    if snap.get("tenants"):
        chunks.append(("tenants",
                       json.dumps(snap["tenants"],
                                  separators=(",", ":")).encode(),
                       None, None))
    # self-adjusting key-table sidecar (veneur_tpu/tables/): live
    # per-kind capacities + growth accounting (JSON; same rule). Named
    # "keytables" — "tables" is the key-table metadata rows chunk.
    if snap.get("keytables"):
        chunks.append(("keytables",
                       json.dumps(snap["keytables"],
                                  separators=(",", ":")).encode(),
                       None, None))
    # history ring sidecar (veneur_tpu/history/): one JSON meta chunk
    # (spec + seq + key index) plus one raw-bytes chunk per ring array.
    # Same unknown-chunk rule — old readers skip all of them.
    if snap.get("history"):
        hist = snap["history"]
        chunks.append(("history",
                       json.dumps(hist["meta"],
                                  separators=(",", ":")).encode(),
                       None, None))
        for name in sorted(hist["arrays"]):
            arr = np.ascontiguousarray(hist["arrays"][name])
            chunks.append((f"history:{name}", arr.tobytes(),
                           str(arr.dtype), list(arr.shape)))

    index = []
    offset = 0
    chunk_path = os.path.join(dirpath, CHUNKS_NAME)
    with open(chunk_path, "wb") as f:
        for name, data, dtype, shape in chunks:
            f.write(data)
            entry = {"name": name, "offset": offset, "length": len(data),
                     "crc32": zlib.crc32(data)}
            if dtype is not None:
                entry["dtype"] = dtype
                entry["shape"] = shape
            index.append(entry)
            offset += len(data)
        if fsync:
            f.flush()
            os.fsync(f.fileno())

    manifest = {
        "format_version": SNAPSHOT_FORMAT_VERSION,
        "schema_hash": schema_hash(),
        "agg_kind": snap["agg_kind"],
        "n_shards": int(snap["n_shards"]),
        "spec": snap["spec"],
        "created_at": float(snap["created_at"]),
        "interval_ts": int(snap["interval_ts"]),
        "hostname": snap.get("hostname", ""),
        "rows": {k: len(snap["tables"][k]) for k in TABLE_KINDS},
        "spill_entries": int(snap.get("spill_entries", 0)),
        "chunks": index,
        "total_bytes": offset,
    }
    # the manifest lands LAST and atomically: a crash between chunk bytes
    # and manifest leaves a directory load/list treat as non-existent
    atomic_write_bytes(os.path.join(dirpath, MANIFEST_NAME),
                       json.dumps(manifest, indent=1).encode(),
                       fsync=fsync)
    return offset


def read_manifest(dirpath: str) -> dict:
    """Parse + structurally validate a checkpoint's manifest."""
    path = os.path.join(dirpath, MANIFEST_NAME)
    try:
        with open(path, "rb") as f:
            manifest = json.loads(f.read())
    except FileNotFoundError:
        raise CorruptSnapshot(f"{dirpath}: no {MANIFEST_NAME}")
    except (ValueError, OSError) as e:
        raise CorruptSnapshot(f"{dirpath}: unreadable manifest: {e}")
    if not isinstance(manifest, dict) or "chunks" not in manifest:
        raise CorruptSnapshot(f"{dirpath}: manifest missing chunk index")
    version = manifest.get("format_version")
    if version == SNAPSHOT_FORMAT_VERSION:
        if manifest.get("schema_hash") != schema_hash():
            raise CorruptSnapshot(
                f"{dirpath}: schema hash {manifest.get('schema_hash')!r} "
                f"does not match this build's {schema_hash()!r} — "
                "DeviceState or TableSpec changed shape since the "
                "snapshot was written")
    elif version in _SCHEMA_MIGRATIONS:
        # a migratable older format: the hash must match that version's
        # FROZEN pin (same drift protection the current version gets)
        if manifest.get("schema_hash") != _SCHEMA_PINS.get(version):
            raise CorruptSnapshot(
                f"{dirpath}: v{version} snapshot with schema hash "
                f"{manifest.get('schema_hash')!r}, expected the frozen "
                f"v{version} pin {_SCHEMA_PINS.get(version)!r}")
    else:
        raise CorruptSnapshot(
            f"{dirpath}: format version {version!r}, this build reads "
            f"{SNAPSHOT_FORMAT_VERSION} (+ migratable "
            f"{sorted(_SCHEMA_MIGRATIONS)})")
    return manifest


def _read_chunks(dirpath: str, manifest: dict) -> Dict[str, bytes]:
    path = os.path.join(dirpath, CHUNKS_NAME)
    try:
        with open(path, "rb") as f:
            blob = f.read()
    except OSError as e:
        raise CorruptSnapshot(f"{dirpath}: unreadable chunks: {e}")
    out = {}
    for entry in manifest["chunks"]:
        lo, hi = entry["offset"], entry["offset"] + entry["length"]
        if hi > len(blob):
            raise CorruptSnapshot(
                f"{dirpath}: chunk {entry['name']} extends to byte {hi} "
                f"but {CHUNKS_NAME} holds {len(blob)}")
        data = blob[lo:hi]
        if zlib.crc32(data) != entry["crc32"]:
            raise CorruptSnapshot(
                f"{dirpath}: chunk {entry['name']} failed CRC")
        out[entry["name"]] = data
    return out


def verify_dir(dirpath: str) -> dict:
    """Full validation without materializing arrays: manifest structure,
    version, schema hash, every chunk's CRC. Returns the manifest.
    Raises CorruptSnapshot on any failure (the CLI `verify` command)."""
    manifest = read_manifest(dirpath)
    _read_chunks(dirpath, manifest)
    return manifest


def load_dir(dirpath: str) -> dict:
    """Read + validate one checkpoint directory back into the in-memory
    snapshot layout (persistence/snapshot.py)."""
    manifest = read_manifest(dirpath)
    chunks = _read_chunks(dirpath, manifest)
    arrays = {}
    by_name = {e["name"]: e for e in manifest["chunks"]}
    for name in ARRAY_FIELDS:
        entry = by_name.get(f"array:{name}")
        if entry is None:
            raise CorruptSnapshot(f"{dirpath}: missing array chunk {name}")
        try:
            arrays[name] = np.frombuffer(
                chunks[f"array:{name}"],
                dtype=np.dtype(entry["dtype"])).reshape(entry["shape"])
        except (TypeError, ValueError) as e:
            raise CorruptSnapshot(
                f"{dirpath}: array chunk {name}: {e}")
    try:
        tables = json.loads(chunks["tables"])
    except (KeyError, ValueError) as e:
        raise CorruptSnapshot(f"{dirpath}: tables chunk: {e}")
    for kind in TABLE_KINDS:
        if kind not in tables:
            raise CorruptSnapshot(f"{dirpath}: tables chunk lacks {kind}")
    forward = None
    if chunks.get("forward"):
        try:
            forward = json.loads(chunks["forward"])
        except ValueError as e:
            raise CorruptSnapshot(f"{dirpath}: forward chunk: {e}")
    watches = None
    if chunks.get("watches"):
        try:
            watches = json.loads(chunks["watches"])
        except ValueError as e:
            raise CorruptSnapshot(f"{dirpath}: watches chunk: {e}")
    tenants = None
    if chunks.get("tenants"):
        try:
            tenants = json.loads(chunks["tenants"])
        except ValueError as e:
            raise CorruptSnapshot(f"{dirpath}: tenants chunk: {e}")
    keytables = None
    if chunks.get("keytables"):
        try:
            keytables = json.loads(chunks["keytables"])
        except ValueError as e:
            raise CorruptSnapshot(f"{dirpath}: keytables chunk: {e}")
    history = None
    if chunks.get("history"):
        try:
            h_arrays = {}
            for entry in manifest["chunks"]:
                name = entry["name"]
                if not name.startswith("history:"):
                    continue
                h_arrays[name[len("history:"):]] = np.frombuffer(
                    chunks[name],
                    dtype=np.dtype(entry["dtype"])).reshape(entry["shape"])
            history = {"meta": json.loads(chunks["history"]),
                       "arrays": h_arrays}
        except (KeyError, TypeError, ValueError) as e:
            raise CorruptSnapshot(f"{dirpath}: history chunks: {e}")
    return {
        "agg_kind": manifest["agg_kind"],
        "n_shards": manifest["n_shards"],
        "spec": manifest["spec"],
        "created_at": manifest["created_at"],
        "interval_ts": manifest["interval_ts"],
        "hostname": manifest.get("hostname", ""),
        "tables": tables,
        "arrays": arrays,
        "spill": chunks.get("spill", b""),
        "forward": forward,
        "watches": watches,
        "history": history,
        "tenants": tenants,
        "keytables": keytables,
    }


def list_checkpoints(root: str) -> List[Tuple[int, str]]:
    """(seq, path) for every complete checkpoint under `root`, oldest
    first. A directory without a manifest (in-flight or crashed write)
    is not a checkpoint."""
    try:
        names = os.listdir(root)
    except OSError:
        return []
    out = []
    for name in names:
        m = _CKPT_RE.match(name)
        if not m:
            continue
        path = os.path.join(root, name)
        if os.path.isfile(os.path.join(path, MANIFEST_NAME)):
            out.append((int(m.group(1)), path))
    return sorted(out)


def checkpoint_dirname(seq: int) -> str:
    return f"ckpt-{seq:08d}"


def quarantine(root: str, dirpath: str) -> str:
    """Move a rejected checkpoint aside so restore never retries it and
    an operator can post-mortem the bytes. Returns the new path."""
    qdir = os.path.join(root, "quarantine")
    os.makedirs(qdir, exist_ok=True)
    base = os.path.basename(dirpath.rstrip("/"))
    dest = os.path.join(qdir, base)
    n = 1
    while os.path.exists(dest):
        dest = os.path.join(qdir, f"{base}.{n}")
        n += 1
    os.replace(dirpath, dest)
    fsync_dir(root)
    log.warning("quarantined corrupt checkpoint %s -> %s", dirpath, dest)
    return dest
