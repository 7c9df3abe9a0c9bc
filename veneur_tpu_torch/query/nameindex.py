"""Sorted name index over a snapshot's key-table prefix.

Resolution never touches the ingest hot path: the index is built lazily
on the query (or watch) engine's thread from the meta list references
the snapshot pinned on the pipeline thread (append-only within an
interval, and CPython list append is atomic, so slicing `[:count]`
off-thread is safe while the pipeline keeps appending; no `get_meta`
call happens off-thread, which matters on native tables, where get_meta
drains the C++ key records). The engine caches one index per (table
identity, counts), so a dashboard polling the same interval pays the
sort once.

Three lookup modes per kind table:

- exact: all tag variants of one metric name (bisect on the sorted name
  column),
- prefix: every name in `[prefix, prefix+inf)`, a bisect range scan,
- match: `fnmatch`-style wildcard; the literal prefix before the first
  metacharacter narrows the scan range, then fnmatch filters.

Entries come back as (position, slot, meta), where `position` is the
row's index in the snapshot's meta-list prefix (the positional contract
the flush output arrays follow) and `slot` the device-table slot the
gather reads.
"""

from __future__ import annotations

import bisect
from fnmatch import fnmatchcase
from typing import Dict, List, Tuple

from veneur_tpu_torch.query.snapshot import COUNT_TABLES

_WILD = frozenset("*?[")


def literal_prefix(pattern: str) -> str:
    """The leading run of a wildcard pattern with no metacharacters."""
    for i, ch in enumerate(pattern):
        if ch in _WILD:
            return pattern[:i]
    return pattern


class NameIndex:
    """Per-kind sorted (name, position, slot, meta) columns."""

    def __init__(self, metas_by_table: Dict[str, list],
                 counts: Dict[str, int]) -> None:
        self._tables: Dict[str, Tuple[List[str], List[tuple]]] = {}
        for tname in COUNT_TABLES:
            n = counts.get(tname, 0)
            metas = metas_by_table[tname][:n]
            entries = sorted(
                ((m.name, pos, slot, m)
                 for pos, (slot, m) in enumerate(metas)),
                key=lambda e: e[0])
            self._tables[tname] = ([e[0] for e in entries], entries)

    def _span(self, tname: str, lo: str, hi: str) -> List[tuple]:
        names, entries = self._tables[tname]
        a = bisect.bisect_left(names, lo)
        b = bisect.bisect_left(names, hi) if hi is not None else len(names)
        return entries[a:b]

    def exact(self, tname: str, name: str) -> List[tuple]:
        """All tag variants of `name` -> [(position, slot, meta)]."""
        return [e[1:] for e in self._span(tname, name, name + "\0")]

    def prefix(self, tname: str, prefix: str) -> List[tuple]:
        hi = prefix + "\U0010ffff" if prefix else None
        return [e[1:] for e in self._span(tname, prefix, hi)]

    def match(self, tname: str, pattern: str) -> List[tuple]:
        lit = literal_prefix(pattern)
        hi = lit + "\U0010ffff" if lit else None
        return [e[1:] for e in self._span(tname, lit, hi)
                if fnmatchcase(e[0], pattern)]
