"""Collective global tier: hash-routed key table, replica-axis sketch
merges, and the co-located forward with no serialization.

- ops.py      replica-axis sketch merges (one process or a
              torch.distributed group)
- keytable.py deterministic hash-routed key table (route by key
              identity, the owner assigns slots)
- router.py   the routed ingest (the all_to_all as a transpose) and the
              replica-merged state
- tier.py     CollectiveGlobalTier server backend and the process-local
              tier registry
"""

from veneur_tpu_torch.collective.keytable import (
    CollectiveKeyTable, route_digest, route_shard)
from veneur_tpu_torch.collective.ops import (
    digest_axis_merge, extremes_axis_merge, hll_axis_max, lww_axis_merge,
    merge_replica_block, twofloat_axis_sum)

__all__ = [
    "CollectiveKeyTable", "route_digest", "route_shard",
    "merge_replica_block", "twofloat_axis_sum", "hll_axis_max",
    "lww_axis_merge", "digest_axis_merge", "extremes_axis_merge",
]
