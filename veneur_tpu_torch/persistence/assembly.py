"""Multi-host snapshot assembly: one logical checkpoint built from
per-process shard chunks.

A multi-host collective tier has no single process that can see the whole
mesh's live rows: each process gathers (and can address) only its own
devices' shards. Instead of electing a writer and hauling every shard's
sketch bytes over DCN, each process writes its OWN rows as an ordinary
codec checkpoint directory — a *part* — under one assembly directory:

  ckpt-00000042-assembly/
    part-0000/   chunks.bin + MANIFEST.json   (process 0's rows)
    part-0001/   ...                          (process 1's rows)
    ASSEMBLY.json                             written LAST, atomically

ASSEMBLY.json is the unifying manifest: it lands only after every part's
own manifest validated, so its presence certifies the whole set the same
way MANIFEST.json certifies chunks.bin. A crash mid-assembly leaves a
directory restore treats as non-existent.

Restore is re-sharding by construction: load_assembly concatenates the
parts back into one in-memory snapshot and fold_snapshot re-enters every
row through restore_metric, whose routing digest (restore.py _digest ==
collective/keytable.py route_digest) re-derives the owner shard on the
CURRENT mesh — the part layout never constrains the restoring topology.
Hash routing keeps part key sets disjoint (each process persists the keys
its shards own), so concatenation is a union, and additive kinds cannot
double-count.

Per-process identity does NOT assemble: spill bytes and forward envelope
state belong to the process that minted them (source_id semantics), so
parts carry them but load_assembly deliberately drops both.
"""

from __future__ import annotations

import json
import logging
import os
import re
import time
from typing import List, Tuple

import numpy as np

from veneur_tpu_torch.persistence import codec
from veneur_tpu_torch.utils.atomicio import atomic_write_bytes, fsync_dir

log = logging.getLogger("veneur_tpu_torch.persistence.assembly")

ASSEMBLY_NAME = "ASSEMBLY.json"
ASSEMBLY_FORMAT_VERSION = 1

_ASM_RE = re.compile(r"^ckpt-(\d{8})-assembly$")
_PART_RE = re.compile(r"^part-(\d{4})$")


def assembly_dirname(seq: int) -> str:
    return f"{codec.checkpoint_dirname(seq)}-assembly"


def part_dirname(rank: int) -> str:
    return f"part-{rank:04d}"


def is_assembly(dirpath: str) -> bool:
    return os.path.isfile(os.path.join(dirpath, ASSEMBLY_NAME))


def write_part(root: str, seq: int, rank: int, snap: dict,
               fsync: bool = True) -> str:
    """Persist one process's rows as part `rank` of assembly `seq`.
    `snap` is an ordinary build_snapshot dict holding ONLY this
    process's shards' rows. Safe to call concurrently from different
    processes (distinct ranks). Returns the part path."""
    if rank < 0 or rank > 9999:
        raise ValueError(f"assembly rank {rank} out of range")
    asm = os.path.join(root, assembly_dirname(seq))
    os.makedirs(asm, exist_ok=True)
    part = os.path.join(asm, part_dirname(rank))
    os.makedirs(part, exist_ok=True)
    codec.encode_to_dir(part, snap, fsync=fsync)
    if fsync:
        fsync_dir(asm)
    return part


def finalize_assembly(root: str, seq: int, n_parts: int,
                      fsync: bool = True) -> str:
    """Validate all `n_parts` parts and write ASSEMBLY.json (atomically,
    LAST — the completeness certificate). Run by one designated process
    (rank 0) after a barrier confirms every part landed. Raises
    CorruptSnapshot if any part is missing or invalid."""
    asm = os.path.join(root, assembly_dirname(seq))
    parts = []
    for rank in range(n_parts):
        part = os.path.join(asm, part_dirname(rank))
        manifest = codec.read_manifest(part)  # raises CorruptSnapshot
        parts.append({
            "rank": rank,
            "dir": part_dirname(rank),
            "hostname": manifest.get("hostname", ""),
            "n_shards": int(manifest.get("n_shards", 1)),
            "rows": manifest.get("rows", {}),
        })
    doc = {
        "assembly_format_version": ASSEMBLY_FORMAT_VERSION,
        "format_version": codec.SNAPSHOT_FORMAT_VERSION,
        "seq": int(seq),
        "n_parts": int(n_parts),
        "parts": parts,
        "created_at": time.time(),
    }
    atomic_write_bytes(os.path.join(asm, ASSEMBLY_NAME),
                       json.dumps(doc, indent=1).encode(), fsync=fsync)
    return asm


def _read_assembly_doc(dirpath: str) -> dict:
    path = os.path.join(dirpath, ASSEMBLY_NAME)
    try:
        with open(path, "rb") as f:
            doc = json.loads(f.read())
    except FileNotFoundError:
        raise codec.CorruptSnapshot(f"{dirpath}: no {ASSEMBLY_NAME}")
    except (ValueError, OSError) as e:
        raise codec.CorruptSnapshot(
            f"{dirpath}: unreadable assembly manifest: {e}")
    if (not isinstance(doc, dict) or "parts" not in doc
            or "n_parts" not in doc):
        raise codec.CorruptSnapshot(
            f"{dirpath}: assembly manifest missing parts index")
    if doc.get("assembly_format_version") != ASSEMBLY_FORMAT_VERSION:
        raise codec.CorruptSnapshot(
            f"{dirpath}: assembly format version "
            f"{doc.get('assembly_format_version')!r}, this build reads "
            f"{ASSEMBLY_FORMAT_VERSION}")
    return doc


def load_assembly(dirpath: str) -> dict:
    """Read + validate every part and concatenate them into one
    in-memory snapshot (fold_snapshot's input layout). HLL rows are
    normalized to dense uint8 registers so parts written by different
    format versions concatenate; fold_snapshot unions them through the
    same merge path either way."""
    from veneur_tpu_torch.ops.hll import unpack_registers_np
    doc = _read_assembly_doc(dirpath)
    snaps = []
    for entry in doc["parts"]:
        part = os.path.join(dirpath, str(entry.get("dir", "")))
        if os.path.dirname(os.path.relpath(part, dirpath)):
            raise codec.CorruptSnapshot(
                f"{dirpath}: part dir {entry.get('dir')!r} escapes the "
                "assembly")
        snaps.append(codec.load_dir(part))
    if not snaps:
        raise codec.CorruptSnapshot(f"{dirpath}: assembly with no parts")
    precisions = {int(s["spec"]["hll_precision"]) for s in snaps}
    if len(precisions) > 1:
        raise codec.CorruptSnapshot(
            f"{dirpath}: parts disagree on hll_precision {precisions}")
    precision = precisions.pop()

    tables = {k: [] for k in codec.TABLE_KINDS}
    arrays = {name: [] for name in codec.ARRAY_FIELDS}
    for s in snaps:
        for k in codec.TABLE_KINDS:
            tables[k].extend(s["tables"][k])
        hll = np.asarray(s["arrays"]["hll"])
        if hll.dtype != np.uint8:
            hll = unpack_registers_np(hll.astype(np.int32),
                                      precision=precision)
        for name in codec.ARRAY_FIELDS:
            arr = (np.asarray(hll, np.uint8) if name == "hll"
                   else np.asarray(s["arrays"][name]))
            arrays[name].append(arr)

    def _cat(chunks):
        live = [c for c in chunks if len(c)]
        if not live:
            return chunks[0]
        return np.concatenate(live, axis=0)

    base = snaps[0]
    return {
        "agg_kind": "assembly",
        "n_shards": max(int(s["n_shards"]) for s in snaps),
        "spec": base["spec"],
        "created_at": max(float(s["created_at"]) for s in snaps),
        "interval_ts": max(int(s["interval_ts"]) for s in snaps),
        "hostname": base.get("hostname", ""),
        "tables": tables,
        "arrays": {k: _cat(v) for k, v in arrays.items()},
        # per-process identity: spill payloads and forward envelopes
        # belong to the process that minted them, never to the assembly
        "spill": b"",
        "forward": None,
    }


def list_assemblies(root: str) -> List[Tuple[int, str]]:
    """(seq, path) for every COMPLETE assembly under root, oldest first
    (ASSEMBLY.json present == finalized)."""
    try:
        names = os.listdir(root)
    except OSError:
        return []
    out = []
    for name in names:
        m = _ASM_RE.match(name)
        if not m:
            continue
        path = os.path.join(root, name)
        if is_assembly(path):
            out.append((int(m.group(1)), path))
    return sorted(out)
