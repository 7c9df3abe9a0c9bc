"""Shape contract for the history tier.

The history tier keeps the last K flush intervals device-resident as a
packed per-key ring: two-float counters, last-writer-wins gauges/status,
6-bit packed HLL rows and per-window merged digest centroids.
`HistorySpec` is the frozen, hashable shape descriptor of one ring, kept
apart from `TableSpec` so that turning history on or off never changes
the live table's layout. Its fields and derived sizes are those of the
JAX package's HistorySpec, so snapshots cross between the packages.

Ring layout (per kind, per row):

    col = tier * windows + (slot % windows)

Tier 0 holds raw flush intervals; tier t >= 1 holds 2x-decimated merges
of tier t-1 (slot m covers tier-(t-1) slots 2m and 2m+1), so `windows`
instants per tier buy `windows * 2^tiers` intervals of lookback in
`windows * (tiers + 1)` resident columns. Counters and histogram
count/sum merge with compensated two-float adds, HLL registers by max
(exact union), digests through the same k-cell compression as ingest at
this spec's compression, gauges/status last-writer-wins.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass

from veneur_tpu_torch.ops import hll
from veneur_tpu_torch.ops import tdigest as td


@dataclass(frozen=True)
class HistorySpec:
    """Static shape parameters of one history ring."""

    windows: int = 90           # ring length per tier, in windows
    tiers: int = 3              # decimation tiers beyond tier 0
    counter_rows: int = 1 << 10
    gauge_rows: int = 1 << 9
    status_rows: int = 1 << 8
    set_rows: int = 1 << 8
    histo_rows: int = 1 << 8
    # history digests are re-merged once per decimation level and once
    # per range query, so they run a smaller compression than the live
    # table: 32 centroids per window
    compression: float = 20.0
    cells_per_k: int = 2
    exact_extremes: int = 4
    hll_precision: int = hll.DEFAULT_PRECISION

    @property
    def total_cols(self) -> int:
        return self.windows * (self.tiers + 1)

    @property
    def centroids(self) -> int:
        return td.centroid_capacity(self.compression, self.cells_per_k,
                                    self.exact_extremes)

    @property
    def hll_words(self) -> int:
        return hll.packed_words(self.hll_precision)

    @property
    def span_intervals(self) -> int:
        """Total lookback in flush intervals: tier `tiers` retains
        `windows` slots of 2^tiers intervals each."""
        return self.windows * (1 << self.tiers)

    def rows_for(self, kind_idx: int) -> int:
        return (self.counter_rows, self.gauge_rows, self.status_rows,
                self.set_rows, self.histo_rows)[kind_idx]

    def hbm_bytes(self) -> int:
        """Device bytes of one HistoryState, equal to its allocation."""
        w = self.total_cols
        f32 = 4
        counter = self.counter_rows * w * 2 * f32          # hi + lo
        gauge = self.gauge_rows * w * f32
        status = self.status_rows * w * f32
        sets = self.set_rows * w * self.hll_words * f32
        # mean + weight centroid planes, plus min/max/count-pair/sum-pair
        histo = self.histo_rows * w * (2 * self.centroids + 6) * f32
        return counter + gauge + status + sets + histo

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "HistorySpec":
        return cls(**{k: d[k] for k in cls.__dataclass_fields__
                      if k in d})

    @classmethod
    def for_table(cls, table_spec, *, windows: int = 90, tiers: int = 3,
                  max_keys: int | None = None) -> "HistorySpec":
        """A ring spec for a live TableSpec: the HLL precision matches
        (the ring stores the flush's packed rows verbatim), and each
        kind's rows are its live capacity clamped to `max_keys` and to a
        per-kind ceiling (a p=14 packed set row costs 12 KiB per resident
        window, so sets get the smallest ring)."""
        cap = max_keys if max_keys is not None else 1 << 20

        def rows(n, ceiling):
            return max(64, min(int(n), int(ceiling), cap))

        return cls(
            windows=int(windows), tiers=int(tiers),
            counter_rows=rows(table_spec.counter_capacity, 1 << 20),
            gauge_rows=rows(table_spec.gauge_capacity, 1 << 18),
            status_rows=rows(table_spec.status_capacity, 1 << 16),
            set_rows=rows(table_spec.set_capacity, 1 << 8),
            histo_rows=rows(table_spec.histo_capacity, 1 << 14),
            hll_precision=table_spec.hll_precision,
        )
