"""vtlint pass: the checkpoint snapshot schema cannot drift silently.

Unlike the AST passes this one runs the live code: the port's on-disk
checkpoint format (veneur_tpu_torch/persistence/codec.py) pins a hash
over the structures its meaning depends on — DeviceState's field list
and TableSpec's field names — and this pass compares the live hash
against the pin for the current SNAPSHOT_FORMAT_VERSION. A mismatch
means old checkpoints would be misread: bump the version, pin the new
hash, and decide whether read_manifest rejects or migrates the previous
version. The pins are the JAX package's, byte for byte: a checkpoint
written by either package restores into the other.

Runs only against the installed veneur_tpu_torch package (a --root
pointed at a fixture tree skips it: there is nothing to import there).
"""

from __future__ import annotations

from typing import List

from veneur_tpu_torch.analysis.core import REPO, Finding, Project

NAME = "snapshot-schema"
DOC = ("live schema_hash() matches the pinned hash for "
       "SNAPSHOT_FORMAT_VERSION")

CODEC_REL = "veneur_tpu_torch/persistence/codec.py"


def run(project: Project) -> List[Finding]:
    if project.root != REPO and not project.exists(CODEC_REL):
        return []   # fixture tree: nothing to import
    from veneur_tpu_torch.persistence.codec import (
        SNAPSHOT_FORMAT_VERSION, _SCHEMA_MIGRATIONS, _SCHEMA_PINS,
        schema_hash)
    findings = []
    live = schema_hash()
    pinned = _SCHEMA_PINS.get(SNAPSHOT_FORMAT_VERSION)
    if pinned is None:
        findings.append(Finding(
            NAME, CODEC_REL, 0,
            f"SNAPSHOT_FORMAT_VERSION={SNAPSHOT_FORMAT_VERSION} has no "
            f"pin in codec._SCHEMA_PINS — add one: "
            f"{SNAPSHOT_FORMAT_VERSION}: \"{live}\""))
    elif live != pinned:
        findings.append(Finding(
            NAME, CODEC_REL, 0,
            f"snapshot schema DRIFTED (pinned {pinned}, live {live}). "
            "DeviceState._fields or TableSpec changed shape; old "
            "checkpoints would be misread. Bump "
            "SNAPSHOT_FORMAT_VERSION, pin the new hash in "
            "_SCHEMA_PINS, and decide what read_manifest does with "
            "the previous version: reject (default) or migrate"))
    # every superseded pin must carry an explicit migration entry: a
    # version bump without one silently ORPHANS the old checkpoints
    # (read_manifest would reject them), and a migration entry without a
    # frozen pin cannot be hash-verified at read time
    for old in _SCHEMA_PINS:
        if old == SNAPSHOT_FORMAT_VERSION:
            continue
        if old not in _SCHEMA_MIGRATIONS:
            findings.append(Finding(
                NAME, CODEC_REL, 0,
                f"superseded format v{old} has a pin but no "
                "_SCHEMA_MIGRATIONS entry — add one describing the "
                "layout change (read_manifest only accepts migratable "
                "versions), or drop the pin if v%d checkpoints are "
                "intentionally orphaned" % old))
    for old in _SCHEMA_MIGRATIONS:
        if old not in _SCHEMA_PINS:
            findings.append(Finding(
                NAME, CODEC_REL, 0,
                f"_SCHEMA_MIGRATIONS lists v{old} but _SCHEMA_PINS has "
                "no frozen hash for it — read_manifest cannot verify "
                f"v{old} snapshots"))
    return findings
