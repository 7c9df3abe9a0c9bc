"""Elastic live resharding: grow and shrink the mesh under fire.

The routing digest (collective/keytable.py `route_digest`, byte-identical
to the engine's vt_route_digest) is deterministic, so the set of keys
that move when the shard count changes follows from (old_n, new_n)
alone: no key enumeration between peers. The pieces:

- plan.py         the residue math: which keys move, and how a drained
                  interval's rows split into one migration unit per
                  destination shard.
- quiesce.py      the one place the engine's shard map changes, at a
                  swap boundary.
- coordinator.py  the live protocol: drain the old mesh at a flush
                  boundary, rebuild the serving aggregator on the new
                  shard map around the same engine, and fold the drained
                  rows back under exactly-once envelopes.
"""

from veneur_tpu_torch.reshard.coordinator import (ReshardCoordinator,
                                                  ReshardError)
from veneur_tpu_torch.reshard.plan import (ReshardPlan, key_moved,
                                           moved_fraction, partition_units)

__all__ = ["ReshardCoordinator", "ReshardError", "ReshardPlan",
           "key_moved", "moved_fraction", "partition_units"]
