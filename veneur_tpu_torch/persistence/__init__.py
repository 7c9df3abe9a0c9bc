"""Durability subsystem: versioned on-disk checkpoints of the full
aggregation snapshot, an async double-buffered writer, and merge-based
warm restart (README §Durability). The on-disk format is the JAX
package's byte for byte (same format version and schema hash), so a
checkpoint written by either package restores into the other.

  codec     chunked CRC-checksummed format + manifest + schema hash
  snapshot  build the in-memory snapshot from a flush's outputs
  writer    background serialize/fsync/rename/GC, off the flush path
  restore   validate, quarantine-on-corrupt, fold via sketch merges
  assembly  multi-host checkpoints: per-process parts, one manifest
"""

from veneur_tpu_torch.persistence.assembly import (  # noqa: F401
    finalize_assembly, list_assemblies, load_assembly, write_part)
from veneur_tpu_torch.persistence.codec import (  # noqa: F401
    SNAPSHOT_FORMAT_VERSION, CorruptSnapshot, list_checkpoints,
    load_dir, read_manifest, schema_hash, verify_dir)
from veneur_tpu_torch.persistence.snapshot import build_snapshot  # noqa: F401
from veneur_tpu_torch.persistence.writer import CheckpointWriter  # noqa: F401
from veneur_tpu_torch.persistence.restore import (  # noqa: F401
    fold_snapshot, restore_latest, restore_spill)
