"""veneur-tpu-checkpoint: operator tooling for the durability layer
(veneur_tpu/persistence/; README §Durability).

  inspect <path>   print what a checkpoint (or every checkpoint under a
                   checkpoint_dir root) claims to hold: manifest fields,
                   per-kind row counts, spill entries, byte sizes, age —
                   WITHOUT validating chunk bytes
  verify <path>    full validation: manifest structure, format version,
                   schema hash, every chunk CRC. Exit 0 only when every
                   checkpoint examined is loadable.

`<path>` may be one ckpt-NNNNNNNN directory or a checkpoint_dir root;
roots examine every complete checkpoint, oldest first. Quarantined
snapshots (root/quarantine/) are never examined — they already failed.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time

from veneur_tpu_torch.persistence.codec import (CorruptSnapshot, MANIFEST_NAME,
                                          list_checkpoints, read_manifest,
                                          verify_dir)

log = logging.getLogger("veneur_tpu_torch.cli.checkpoint")


def _targets(path: str):
    """-> [(label, dirpath)] — the one directory if it is itself a
    checkpoint, else every complete checkpoint under it."""
    if os.path.isfile(os.path.join(path, MANIFEST_NAME)):
        return [(os.path.basename(path.rstrip("/")), path)]
    return [(f"ckpt-{seq:08d}", p) for seq, p in list_checkpoints(path)]


def _describe(manifest: dict, dirpath: str) -> dict:
    try:
        disk_bytes = sum(
            os.path.getsize(os.path.join(dirpath, f))
            for f in os.listdir(dirpath)
            if os.path.isfile(os.path.join(dirpath, f)))
    except OSError:
        disk_bytes = None
    return {
        "path": dirpath,
        "format_version": manifest.get("format_version"),
        "agg_kind": manifest.get("agg_kind"),
        "n_shards": manifest.get("n_shards"),
        "hostname": manifest.get("hostname", ""),
        "interval_ts": manifest.get("interval_ts"),
        "created_at": manifest.get("created_at"),
        "age_s": round(time.time() - float(manifest.get("created_at", 0)),
                       1),
        "rows": manifest.get("rows", {}),
        "live_keys": sum((manifest.get("rows") or {}).values()),
        "spill_entries": manifest.get("spill_entries", 0),
        "chunk_bytes": manifest.get("total_bytes"),
        "disk_bytes": disk_bytes,
    }


def cmd_inspect(path: str, as_json: bool) -> int:
    targets = _targets(path)
    if not targets:
        print(f"no checkpoints under {path}", file=sys.stderr)
        return 1
    out = []
    rc = 0
    for label, dirpath in targets:
        try:
            out.append(_describe(read_manifest(dirpath), dirpath))
        except CorruptSnapshot as e:
            rc = 1
            out.append({"path": dirpath, "error": str(e)})
    if as_json:
        print(json.dumps(out, indent=1))
        return rc
    for d in out:
        if "error" in d:
            print(f"{d['path']}: CORRUPT: {d['error']}")
            continue
        print(f"{d['path']}: {d['agg_kind']} x{d['n_shards']} "
              f"host={d['hostname'] or '-'} "
              f"interval_ts={d['interval_ts']} age={d['age_s']}s")
        rows = " ".join(f"{k}={v}" for k, v in sorted(d["rows"].items()))
        print(f"  rows: {rows} (total {d['live_keys']}) "
              f"spill_entries={d['spill_entries']}")
        print(f"  bytes: chunks={d['chunk_bytes']} disk={d['disk_bytes']}")
    return rc


def cmd_verify(path: str, as_json: bool) -> int:
    targets = _targets(path)
    if not targets:
        print(f"no checkpoints under {path}", file=sys.stderr)
        return 1
    results = []
    rc = 0
    for label, dirpath in targets:
        try:
            verify_dir(dirpath)
            results.append({"path": dirpath, "ok": True})
        except CorruptSnapshot as e:
            rc = 1
            results.append({"path": dirpath, "ok": False,
                            "error": str(e)})
    if as_json:
        print(json.dumps(results, indent=1))
        return rc
    for r in results:
        if r["ok"]:
            print(f"{r['path']}: OK")
        else:
            print(f"{r['path']}: CORRUPT: {r['error']}")
    return rc


def main(argv=None):
    ap = argparse.ArgumentParser(prog="veneur-tpu-checkpoint")
    sub = ap.add_subparsers(dest="command", required=True)
    for name in ("inspect", "verify"):
        sp = sub.add_parser(name)
        sp.add_argument("path",
                        help="one checkpoint directory or a "
                             "checkpoint_dir root")
        sp.add_argument("--json", action="store_true", dest="as_json",
                        help="machine-readable output")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.WARNING)
    if args.command == "inspect":
        return cmd_inspect(args.path, args.as_json)
    return cmd_verify(args.path, args.as_json)


if __name__ == "__main__":
    sys.exit(main())
