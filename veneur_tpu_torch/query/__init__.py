"""Query tier: live percentiles, cardinalities and counters read from the
resident device state, and range reads over the history ring.

The write path exports once per flush interval; dashboards read many
times in between. This package answers those reads from the SAME state
the next flush exports, without touching the flush path:

- `snapshot`: the read discipline. Query requests ride the pipeline's
  packet queue (FIFO with ingest and FlushRequest): a SnapshotRequest
  pins a coherent naming view between steps, and a PipelineCall later
  enqueues the device gather from the pipeline thread itself, on the
  stream the in-place ingest steps use, before any later step.
- `nameindex`: sorted-name resolution (exact / prefix / wildcard) over a
  snapshot's key-table prefix, built on the query thread.
- `engine`: the batching engine. Concurrent HTTP queries coalesce into
  one snapshot and one launch of the flush program
  (`flush_live_in_packed`), which makes query answers value-exact
  against the flush; range queries run the history tier's range program
  (K3 for sets, K2 for digests).
"""

from veneur_tpu_torch.query.engine import (QueryEngine, QueryError,
                                           parse_request)
from veneur_tpu_torch.query.snapshot import (PipelineCall, PipelineRequest,
                                             QuerySnapshot, SnapshotRequest)

__all__ = ["PipelineCall", "PipelineRequest", "QueryEngine", "QueryError",
           "QuerySnapshot", "SnapshotRequest", "parse_request"]
