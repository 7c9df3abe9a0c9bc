"""Deterministic hash-routed key table for the collective global tier.

The base KeyTable routes a key to a shard from whatever digest the
caller hands it (the datagram parser, the protobuf importer and the
checkpoint restorer each hash differently), so the first arrival's
digest decides placement. The collective tier derives the routing
digest from the key identity itself -- fnv1a-32 over (name, kind,
joined tags), the restore recipe -- so every participant, in every
process, across restarts, computes the same owner shard for the same
key. Slots within the owner shard are still assigned in arrival order by
the tier, the single slot authority.
"""

from __future__ import annotations

from veneur_tpu_torch.aggregation.host import KeyTable
from veneur_tpu_torch.utils.hashing import fnv1a_32


def route_digest(kind: str, name: str, joined_tags: str) -> int:
    """Routing digest over the key identity alone: the restore recipe
    (persistence/restore.py), so restored and absorbed rows agree, and
    the engine's vt_route_digest byte for byte. Histogram and timer are
    distinct keys; the caller passes the actual kind."""
    h = fnv1a_32(name.encode("utf-8", "surrogateescape"))
    h = fnv1a_32(kind.encode(), h)
    return fnv1a_32(joined_tags.encode("utf-8", "surrogateescape"), h)


def route_shard(kind: str, name: str, joined_tags: str,
                n_shards: int) -> int:
    return route_digest(kind, name, joined_tags) % n_shards


class CollectiveKeyTable(KeyTable):
    """KeyTable whose shard routing is a pure function of key identity.

    slot_for_routed ignores the caller's digest and recomputes the
    routing digest from (kind, name, joined_tags); the inherited
    slot_for stays for paths that already agree on digests (restore uses
    the same recipe, so both land the same)."""

    def slot_for_routed(self, kind: str, name: str, tags, scope: int,
                        hostname: str = "", imported: bool = False,
                        joined_tags=None):
        if joined_tags is None:
            joined_tags = ",".join(tags)
        digest = route_digest(kind, name, joined_tags)
        return self.slot_for(kind, name, tags, scope, digest,
                             hostname=hostname, imported=imported,
                             joined_tags=joined_tags)

    def routing_signature(self) -> int:
        """Stable hash of the whole (key -> owner shard) mapping, to check
        that routing is the same across restarts. Slot order within a
        shard follows arrival and is left out."""
        per = {k: t.per_shard for k, t in self.tables.items()}
        items = []
        for kind, tbl in self.tables.items():
            for (k_kind, k_name, k_joined), slot in tbl.by_key.items():
                items.append((kind, k_kind, k_name, k_joined,
                              slot // per[kind]))
        h = fnv1a_32(b"route-sig")
        for item in sorted(items):
            for part in item[:4]:
                h = fnv1a_32(str(part).encode("utf-8",
                                              "surrogateescape"), h)
            h = fnv1a_32(str(item[4]).encode(), h)
        return h
