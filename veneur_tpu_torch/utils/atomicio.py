"""Crash-safe file writes: temp file in the target directory + os.replace.

POSIX rename is atomic within a filesystem, so readers observe either the
old file or the complete new one — never a torn write. The temp file MUST
live in the destination's directory (rename across filesystems is a
copy, not atomic), and durability additionally needs an fsync of the file
before the rename and of the directory after it (the rename itself is
metadata the directory owns). Shared by the checkpoint codec's manifest
(persistence/codec.py), the localfile sink, and the S3 plugin's local
staging.
"""

from __future__ import annotations

import os
import tempfile


def fsync_dir(path: str) -> None:
    """Flush a directory's metadata (new/renamed entries) to disk.
    Best-effort: some filesystems refuse O_RDONLY fsync on directories."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write_bytes(path: str, data: bytes, fsync: bool = True) -> None:
    """Write `data` to `path` such that a crash at any instant leaves
    either the previous content or the full new content."""
    dirpath = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(prefix=".tmp.", suffix=".partial",
                               dir=dirpath)
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            if fsync:
                f.flush()
                os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    if fsync:
        fsync_dir(dirpath)


def atomic_append_bytes(path: str, data: bytes, fsync: bool = True) -> None:
    """Append with the same all-or-nothing guarantee: existing content +
    `data` land via one rename, so a crash mid-append can never leave a
    half-written record at the tail (a plain "ab" write can). Costs a
    read of the existing file — appropriate for interval-cadence flush
    files, not per-sample logs."""
    try:
        with open(path, "rb") as f:
            prev = f.read()
    except FileNotFoundError:
        prev = b""
    atomic_write_bytes(path, prev + data, fsync=fsync)
