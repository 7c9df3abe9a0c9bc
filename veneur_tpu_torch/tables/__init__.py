"""Self-adjusting key tables: live, per-kind key-table growth and pressure
management, so a cardinality explosion is absorbed without a restart and
without unaccounted loss.

Three pieces, three failure ladders:

- growth.py: the one grow site. Per-kind capacity changes execute at the
  pipeline-thread swap boundary: staged on the C++ engine, applied by
  the reset inside the swap's quiesce while its tables are empty. The
  new interval's device state is allocated at the grown widths, and the
  detached interval still flushes against the old aggregator's spec.
- pressure.py: the ladder below hard capacity for Python key tables:
  SALSA-style merge cells for long-tail counters (arXiv:2102.12531,
  pinned additive error bound), tag-explosion demotion to aggregate-only
  rollup rows, and exact counted drops as the last rung. Every row not
  admitted is accounted.
- manager.py: occupancy census, grow/shrink planning, idle-TTL eviction
  accounting, and the checkpoint sidecar state ("keytables" chunk) that
  lets a restore re-grow before folding rows.

Host code, the same on every device: a copy of the JAX package's
tables/, whose plans, accounting and sidecar it reproduces.
"""

from veneur_tpu_torch.tables.growth import (adopt_capacities, grow_swap,
                                            grown_spec)
from veneur_tpu_torch.tables.manager import TableManager
from veneur_tpu_torch.tables.pressure import TablePressure

__all__ = ["TableManager", "TablePressure", "adopt_capacities",
           "grow_swap", "grown_spec"]
