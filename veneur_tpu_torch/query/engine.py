"""Batching query engine: many concurrent reads, one device launch.

Dashboard reads arrive as independent HTTP requests; the engine
coalesces everything that shows up within a `query_timeout_ms` window
(capped at `query_max_batch` queries) into ONE pipeline snapshot and
ONE instant launch. The launch IS the flush program,
`flush_live_in_packed`, the function `compute_flush` tiles over, fed
with the union of the batch's quantile vectors and the per-kind slot
gathers the batch resolved. Running the same program on the same state
is what makes query answers value-exact against what the next flush
exports:

- histogram/timer quantiles go through the digest kernel (K2,
  ops/cuda_digest.py) on the card and its plain version on the CPU,
  exactly as the flush does;
- HLL cardinalities come from the 6-bit packed rows on the device
  (ops/hll.estimate_packed_rows, no host unpack);
- counters and histogram count/sum/recip scalars leave the device as
  two-float (hi, lo) pairs and are folded in float64 by
  combine_flush_scalars, the flush's own fold;
- live-interval set estimates are scaled by 2^active_set_shift here,
  mirroring the latched-shift correction the flush applies.

An instant batch takes TWO pipeline-queue visits (query/snapshot.py
says why): SnapshotRequest pins the interval's naming view, the engine
resolves names to slots on its own thread and copies the packed inputs
to the device, then a PipelineCall enqueues `_launch` FROM the pipeline
thread, on the stream the ingest steps use, before any later step
updates the live state in place. Only the enqueue runs on the pipeline
thread; the copy back, unpacking and response assembly run on the
engine's thread. A swap() between the two visits is detected by table
identity and the batch retries against the fresh interval, so a
response never mixes two intervals.

Range queries read the history ring (history/merge.py range_in_packed:
K3 merges the set windows, K2 the re-compressed digests). The ring is
written by the flush worker, never by the pipeline thread, and the range
program is hundreds of host-launched ops, so it runs on the engine's
thread: planned against the writer's `seq`, then enqueued under the
writer's read lock with a seq re-check. A flush that landed since the
planning raises _IntervalRolled (the batch replans) instead of reading
a re-purposed column; a ring write enqueued after the lock is released
runs after the read, by stream order. A mixed batch costs two launches,
the instant one on the pipeline thread and the range one here.

Launch cost accumulates under `dispatch_ns` (enqueue only); device
completion is sampled through observability/runtime.SampledSync every
`_SYNC_EVERY` launches, on the engine thread, never the pipeline's.
"""

from __future__ import annotations

import logging
import queue as queue_mod
import threading
import time
from fnmatch import fnmatchcase
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from veneur_tpu_torch.observability.runtime import SampledSync
from veneur_tpu_torch.query.nameindex import NameIndex
from veneur_tpu_torch.query.snapshot import (COUNT_TABLES, PipelineCall,
                                             SnapshotRequest, take_snapshot)

log = logging.getLogger("veneur_tpu_torch.query")

_SYNC_EVERY = 64            # sampled device-sync cadence (1 in N launches)
_SNAPSHOT_TIMEOUT_S = 30.0  # pipeline round-trip budget (a flush storm
                            # can hold the queue for seconds)
_SUBMIT_TIMEOUT_S = 30.0    # end-to-end budget an HTTP thread waits
_MAX_MATCHES = 1024         # per-query resolution cap (truncated flag set)
_MAX_QUANTILES = 64         # per-query quantile-vector cap

KINDS = ("counter", "gauge", "status", "set", "histogram", "timer")
_KIND_TABLE = {"counter": "counter", "gauge": "gauge", "status": "status",
               "set": "set", "histogram": "histo", "timer": "histo"}
_DEFAULT_QS = (0.5, 0.9, 0.99)


class QueryError(ValueError):
    """Client error in a /query request body (HTTP 400)."""


class _IntervalRolled(Exception):
    """swap() ran between the naming snapshot and the launch visit, or a
    flush advanced the history ring since the range plan; the batch
    retries against the fresh interval."""


def _parse_one(q) -> dict:
    if not isinstance(q, dict):
        raise QueryError("each query must be a JSON object")
    modes = [k for k in ("name", "prefix", "match") if k in q]
    if len(modes) != 1:
        raise QueryError(
            "each query needs exactly one of name/prefix/match")
    mode = modes[0]
    arg = q[mode]
    if not isinstance(arg, str):
        raise QueryError(f"{mode} must be a string")
    kinds = q.get("kinds")
    if kinds is None and "kind" in q:
        kinds = [q["kind"]]
    if kinds is not None:
        if (not isinstance(kinds, (list, tuple)) or not kinds
                or any(k not in KINDS for k in kinds)):
            raise QueryError(f"kind(s) must be drawn from {KINDS}")
        kinds = tuple(kinds)
    qs = q.get("quantiles")
    if qs is not None:
        if not isinstance(qs, (list, tuple)) or not qs \
                or len(qs) > _MAX_QUANTILES:
            raise QueryError(
                f"quantiles must be a list of 1..{_MAX_QUANTILES} floats")
        try:
            qs = tuple(sorted({float(v) for v in qs}))
        except (TypeError, ValueError):
            raise QueryError("quantiles must be numbers")
        if any(not (0.0 <= v <= 1.0) for v in qs):
            raise QueryError("quantiles must lie in [0, 1]")
    tags = q.get("tags")
    if tags is not None:
        if not isinstance(tags, (list, tuple)) \
                or any(not isinstance(t, str) for t in tags):
            raise QueryError("tags must be a list of strings")
        tags = tuple(tags)

    def _seconds(field):
        v = q.get(field)
        if v is None:
            return None
        try:
            v = float(v)
        except (TypeError, ValueError):
            raise QueryError(f"{field} must be a number of seconds")
        if not (0.0 < v < float("inf")):
            raise QueryError(f"{field} must be positive seconds")
        return v

    rng = _seconds("range")
    window = _seconds("window")
    step = _seconds("step")
    if rng is None and (window is not None or step is not None):
        raise QueryError("window/step only apply with range")
    return {"mode": mode, "arg": arg, "kinds": kinds,
            "quantiles": qs, "tags": tags,
            "range": rng, "window": window, "step": step}


def parse_request(body, max_queries: int) -> List[dict]:
    """POST /query body -> validated query list. Accepts
    {"queries": [...]} or a single bare query object."""
    if isinstance(body, dict) and "queries" in body:
        raw = body["queries"]
        if not isinstance(raw, list):
            raise QueryError("queries must be a list")
    elif isinstance(body, dict) and body:
        raw = [body]
    else:
        raise QueryError("empty query request")
    if not raw:
        raise QueryError("empty query request")
    if len(raw) > max_queries:
        raise QueryError(f"too many queries in one request "
                         f"(max {max_queries})")
    return [_parse_one(q) for q in raw]


def stage_inputs(flat: np.ndarray, device: torch.device) -> torch.Tensor:
    """A packed i32 input buffer on `device`. On the card the copy is
    enqueued from pinned memory without waiting on the stream (a plain
    copy from pageable memory would wait for every step queued before
    it); the launch that reads it is enqueued later on the same stream."""
    t = torch.from_numpy(flat)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


class _Item:
    """One HTTP request's parsed queries and its completion slot."""

    __slots__ = ("queries", "done", "result", "error")

    def __init__(self, queries: List[dict]) -> None:
        self.queries = queries
        self.done = threading.Event()
        self.result: Optional[dict] = None
        self.error: Optional[Exception] = None


class QueryEngine:
    """Leader thread that batches, snapshots, launches and assembles."""

    def __init__(self, server, *, max_batch: int = 64,
                 timeout_ms: float = 2.0, requests=None, batched=None,
                 duration=None, stale_reads=None, history=None) -> None:
        self._server = server
        self.spec = server.aggregator.spec
        self.device = server.aggregator.device
        self._history = history                      # HistoryWriter | None
        self.max_batch = max(1, int(max_batch))
        self.timeout_s = max(0.0, float(timeout_ms)) / 1000.0
        self._c_requests = requests
        self._c_batched = batched
        self._t_duration = duration
        self._c_stale_reads = stale_reads
        self._queue: "queue_mod.Queue[Optional[_Item]]" = queue_mod.Queue()
        self._stop = threading.Event()
        self._sync = SampledSync(_SYNC_EVERY)
        self.dispatch_ns = 0
        self.launches_total = 0
        self.rolled_total = 0      # batches replanned after a swap or flush
        # one name index per (table identity, counts): a dashboard
        # polling the same interval pays the sort once
        self._index: Optional[NameIndex] = None
        self._index_key: Optional[tuple] = None
        self._index_table = None
        self._thread = threading.Thread(
            target=self._serve_loop, name="query-batcher", daemon=True)
        self._thread.start()

    # -- public API ----------------------------------------------------------
    def submit(self, body, timeout: float = _SUBMIT_TIMEOUT_S) -> dict:
        """Parse, join the current batch, wait for the leader. Raises
        QueryError (400) on a bad body, TimeoutError/RuntimeError (503)
        when the pipeline or the device cannot serve."""
        queries = parse_request(body, self.max_batch)
        if self._history is None \
                and any(q["range"] is not None for q in queries):
            raise QueryError("range queries need the history tier "
                             "(history_enabled: false)")
        if self._c_requests is not None:
            self._c_requests.inc(len(queries))
        if self._stop.is_set():
            raise RuntimeError("query engine stopped")
        item = _Item(queries)
        self._queue.put(item)
        if not item.done.wait(timeout):
            raise TimeoutError("query timed out")
        if item.error is not None:
            raise item.error
        assert item.result is not None
        return item.result

    def close(self) -> None:
        self._stop.set()
        self._queue.put(None)
        self._thread.join(timeout=5.0)
        # wake anything still parked (shutdown race)
        while True:
            try:
                it = self._queue.get_nowait()
            except queue_mod.Empty:
                break
            if it is not None:
                it.error = RuntimeError("query engine stopped")
                it.done.set()

    # -- batching loop -------------------------------------------------------
    def _serve_loop(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                if self._stop.is_set():
                    return
                continue
            batch = [item]
            total = len(item.queries)
            deadline = time.monotonic() + self.timeout_s
            while total < self.max_batch:
                rem = deadline - time.monotonic()
                if rem <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=rem)
                except queue_mod.Empty:
                    break
                if nxt is None:
                    break
                batch.append(nxt)
                total += len(nxt.queries)
            try:
                self._execute(batch, total)
            except Exception as e:  # noqa: BLE001 - waiters must wake
                log.exception("query batch failed")
                for it in batch:
                    if not it.done.is_set():
                        it.error = e
                        it.done.set()
            if self._stop.is_set():
                return

    # -- snapshot + index ----------------------------------------------------
    def _snapshot(self):
        req = SnapshotRequest()
        self._pipeline_put(req, "snapshot")
        if not req.wait(_SNAPSHOT_TIMEOUT_S):
            raise RuntimeError("snapshot timed out")
        if not req.ok:
            raise RuntimeError(req.detail or "snapshot failed")
        return req.snapshot

    def _index_for(self, snap) -> NameIndex:
        key = (id(snap.table),
               tuple(snap.counts[t] for t in COUNT_TABLES))
        if self._index is not None and self._index_key == key:
            return self._index
        idx = NameIndex(snap.metas, snap.counts)
        # hold the table reference so the id() cache key stays unique
        self._index, self._index_key, self._index_table = idx, key, snap.table
        return idx

    def _pipeline_put(self, item, what: str = "query") -> None:
        try:
            self._server.packet_queue.put(item, timeout=1.0)
        except queue_mod.Full:
            raise RuntimeError(f"pipeline backlogged; {what} not scheduled")

    # -- resolution ----------------------------------------------------------
    def _resolve(self, index: NameIndex, q: dict) -> List[tuple]:
        if q["kinds"] is not None:
            tables = list(dict.fromkeys(
                _KIND_TABLE[k] for k in q["kinds"]))
        else:
            tables = list(COUNT_TABLES)
        out = []
        for tname in tables:
            if q["mode"] == "name":
                ent = index.exact(tname, q["arg"])
            elif q["mode"] == "prefix":
                ent = index.prefix(tname, q["arg"])
            else:
                ent = index.match(tname, q["arg"])
            for pos, slot, meta in ent:
                if q["kinds"] is not None and tname == "histo" \
                        and meta.kind not in q["kinds"]:
                    continue
                if q["tags"] is not None \
                        and tuple(meta.tags) != q["tags"]:
                    continue
                out.append((tname, pos, slot, meta))
        return out

    def _plan(self, index: NameIndex, batch: List[_Item]):
        """Resolve every instant query in the batch against one name
        index: per-item render plans, the deduped per-table slot gathers,
        and the union quantile vector."""
        need: Dict[str, List[int]] = {t: [] for t in COUNT_TABLES}
        rowof: Dict[Tuple[str, int], int] = {}
        plans = []   # [(item, [(rows, truncated, q), ...])]
        union_qs = set()
        for item in batch:
            per_q = []
            for q in item.queries:
                if q["range"] is not None:
                    # range queries resolve against the HISTORY writer's
                    # key index (_plan_ranges), not the live interval
                    per_q.append(([], False, q))
                    continue
                ms = self._resolve(index, q)
                truncated = len(ms) > _MAX_MATCHES
                if truncated:
                    ms = ms[:_MAX_MATCHES]
                rows = []
                histo_hit = False
                for tname, pos, slot, meta in ms:
                    key = (tname, pos)
                    r = rowof.get(key)
                    if r is None:
                        r = len(need[tname])
                        rowof[key] = r
                        need[tname].append(slot)
                    rows.append((tname, r, meta))
                    histo_hit = histo_hit or tname == "histo"
                if histo_hit:
                    union_qs.update(q["quantiles"] or _DEFAULT_QS)
                per_q.append((rows, truncated, q))
            plans.append((item, per_q))
        return plans, need, union_qs

    def _build_inputs(self, need, union_qs):
        """Slot gathers + union quantiles -> the flush program's packed
        input buffer and shape arguments (the layout lives with the flush
        program in aggregation/step.py)."""
        from veneur_tpu_torch.aggregation.step import pack_query_inputs
        return pack_query_inputs(
            self.spec, [need[t] for t in COUNT_TABLES], union_qs)

    # -- device launches -----------------------------------------------------
    def _launch(self, state, inputs, n_q: int, buckets: tuple):
        """The instant half's device launch, on the pipeline thread: the
        flush program over the live state, into fresh output tensors."""
        from veneur_tpu_torch.aggregation.step import flush_live_in_packed
        t0 = time.perf_counter_ns()
        out = flush_live_in_packed(state, inputs, spec=self.spec, n_q=n_q,
                                   buckets=buckets)
        self.dispatch_ns += time.perf_counter_ns() - t0
        self.launches_total += 1
        return out

    def _launch_on_pipeline(self, aggregator, table, inputs, n_q: int,
                            buckets: tuple):
        """Visit #2 body, pipeline-thread-only: re-drain staging, check
        that the interval the slots were resolved against is still live
        (swap() installs a fresh table object), and enqueue the gather
        before the next ingest step. Returns (packed, live set_shift)."""
        if aggregator.table is not table:
            raise _IntervalRolled()
        state, _table, set_shift = aggregator.query_snapshot()
        flat = aggregator.query_flat_state(state)
        return self._launch(flat, inputs, n_q, buckets), int(set_shift)

    def _launch_range(self, hflat, hn_q: int, hsteps: int, hbuckets: tuple,
                      seq: Optional[int]):
        """The range half's device launch, on the engine thread, under
        the writer's read lock. With `seq` (the plan's ring seq) a flush
        that advanced the ring since the plan raises _IntervalRolled;
        without it the caller planned under the lock already."""
        from veneur_tpu_torch.history import merge as hmerge
        ring = self._history.acquire_read()
        try:
            if seq is not None and self._history.seq != seq:
                raise _IntervalRolled()
            t0 = time.perf_counter_ns()
            out = hmerge.range_in_packed(
                ring, hflat, hspec=self._history.spec, n_q=hn_q,
                n_steps=hsteps, buckets=hbuckets)
            self.dispatch_ns += time.perf_counter_ns() - t0
            self.launches_total += 1
        finally:
            self._history.release_read()
        return out

    # -- batch execution -----------------------------------------------------
    def _execute(self, batch: List[_Item], total: int) -> None:
        t0 = time.perf_counter_ns()
        for _attempt in range(2):
            try:
                out = self._evaluate(batch, atomic=False)
                break
            except _IntervalRolled:
                # swap() landed between the two pipeline visits, or a
                # flush advanced the ring since the range plan: retry once
                # against the fresh interval, then escalate
                self.rolled_total += 1
                continue
        else:
            # a flush storm keeps landing inside the window (manual
            # trigger_flush loops; a timer interval cannot): resolve and
            # launch with no gap to roll into
            out = self._evaluate(batch, atomic=True)
        plans, res, qcol, set_shift, rinfo, rres, rqcol = out
        dur = time.perf_counter_ns() - t0
        # stale-bounded availability during a live reshard: the serving
        # table answers before every moved row has folded, so rows in
        # flight may be missing for at most one flush interval. The
        # answer is served all the same, and marked, so consumers can
        # pin the guarantee. A range answer carries the mark too; only
        # its newest window can miss rows (older ring columns predate
        # the move).
        stale = bool(getattr(self._server, "reshard_active", False))
        if stale and self._c_stale_reads is not None:
            self._c_stale_reads.inc(len(batch))
        for item, per_q in plans:
            results = []
            for qi, (rows, truncated, q) in enumerate(per_q):
                if q["range"] is not None:
                    entry = self._render_range_entry(item, qi, q, rinfo,
                                                     rres, rqcol)
                else:
                    matches = [self._render(tname, r, meta, q, res, qcol)
                               for tname, r, meta in rows]
                    entry = {"matches": matches}
                    if truncated:
                        entry["truncated"] = True
                results.append(entry)
            item.result = {"results": results, "batched": total,
                           "set_shift": set_shift}
            if stale:
                item.result["stale_bounded"] = True
            if self._t_duration is not None:
                self._t_duration.observe(dur)
            item.done.set()

    def _evaluate(self, batch: List[_Item], atomic: bool):
        """The instant half, then the range half. Two-visit by default;
        with `atomic`, the instant half's snapshot, resolution and launch
        run in ONE pipeline visit (swap() cannot interleave) and the
        range half plans under the writer's read lock (no flush can
        advance the ring between plan and launch). The atomic form costs
        resolution time on the pipeline thread, so it is the escalation
        path, never the default."""
        plans, packed, shape, set_shift = self._instant_half(batch, atomic)
        rinfo, rpacked, rshape = self._range_half(batch, atomic)
        res = rres = None
        qcol: dict = {}
        rqcol: dict = {}
        if packed is not None:
            n_q, buckets, qcol = shape
            res = self._materialize(packed, n_q, buckets, set_shift)
        if rpacked is not None:
            hn_q, hsteps, hbuckets, rqcol = rshape
            rres = self._materialize_range(rpacked, hn_q, hsteps, hbuckets,
                                           count_batch=packed is None)
        return plans, res, qcol, set_shift, rinfo, rres, rqcol

    def _instant_half(self, batch: List[_Item], atomic: bool):
        """-> (plans, packed | None, (n_q, buckets, qcol), set_shift)."""
        if atomic:
            def fn(agg):
                state, snap = take_snapshot(agg)
                plans, need, union_qs = self._plan(self._index_for(snap),
                                                   batch)
                if not any(need[t] for t in COUNT_TABLES):
                    return plans, None, None, snap.set_shift
                inputs, n_q, buckets, qcol = self._build_inputs(need,
                                                                union_qs)
                packed = self._launch(
                    agg.query_flat_state(state),
                    stage_inputs(inputs, self.device), n_q, buckets)
                return plans, packed, (n_q, buckets, qcol), snap.set_shift
            call = PipelineCall(fn)
            self._pipeline_put(call)
            if not call.wait(_SNAPSHOT_TIMEOUT_S):
                raise RuntimeError("query launch timed out")
            if not call.ok:
                raise RuntimeError(call.detail or "query launch failed")
            return call.result
        snap = self._snapshot()
        plans, need, union_qs = self._plan(self._index_for(snap), batch)
        if not any(need[t] for t in COUNT_TABLES):
            return plans, None, None, snap.set_shift
        inputs, n_q, buckets, qcol = self._build_inputs(need, union_qs)
        dev_inputs = stage_inputs(inputs, self.device)
        call = PipelineCall(lambda agg: self._launch_on_pipeline(
            agg, snap.table, dev_inputs, n_q, buckets))
        self._pipeline_put(call)
        if not call.wait(_SNAPSHOT_TIMEOUT_S):
            raise RuntimeError("query launch timed out")
        if not call.ok:
            if isinstance(call.exc, _IntervalRolled):
                raise call.exc
            raise RuntimeError(call.detail or "query launch failed")
        packed, set_shift = call.result
        return plans, packed, (n_q, buckets, qcol), set_shift

    def _range_half(self, batch: List[_Item], atomic: bool):
        """-> (rinfo | None, packed | None, (hn_q, hsteps, hbuckets,
        rqcol))."""
        if self._history is None or not any(
                q["range"] is not None for it in batch
                for q in it.queries):
            return None, None, None
        if atomic:
            self._history.acquire_read()
        try:
            rinfo = self._plan_ranges(batch)
            if rinfo["empty"]:
                return rinfo, None, None
            (hflat, hn_q, hsteps, hbuckets,
             rqcol) = self._build_range_inputs(rinfo)
            rpacked = self._launch_range(
                stage_inputs(hflat, self._history.device), hn_q, hsteps,
                hbuckets, None if atomic else rinfo["seq"])
        finally:
            if atomic:
                self._history.release_read()
        return rinfo, rpacked, (hn_q, hsteps, hbuckets, rqcol)

    def _materialize(self, packed, n_q, buckets, set_shift):
        """ENGINE-thread finish: sampled device sync, host copy, unpack,
        two-float fold, live set-shift correction."""
        from veneur_tpu_torch.aggregation.step import (combine_flush_scalars,
                                                       flush_live_shapes,
                                                       unpack_flush)
        self._sync.tick(packed)
        out = unpack_flush(packed.cpu().numpy(),
                           flush_live_shapes(self.spec, *buckets, n_q))
        if self._c_batched is not None:
            self._c_batched.inc()
        res = combine_flush_scalars(out)
        # live-interval set estimates: the degrade ladder's sampling
        # shift has not been latched yet, so apply 2^active_set_shift
        # here, the correction the flush applies after the swap
        if set_shift:
            res = dict(res)
            res["set_estimate"] = (res["set_estimate"]
                                   * float(1 << set_shift))
        return res

    # -- range planning (history tier) ---------------------------------------
    def _resolve_range(self, keys, q: dict) -> List[tuple]:
        """Match one range query against the writer's key index snapshot
        ([(kind_idx, (kind, name, joined_tags), row)]): the instant
        resolver's name/prefix/match + kinds + tags semantics, over the
        RING's population (which outlives interval tables)."""
        mode, arg = q["mode"], q["arg"]
        tags_j = ",".join(q["tags"]) if q["tags"] is not None else None
        kinds = q["kinds"]
        out = []
        for k, key, row in keys:
            kind, name, jt = key
            if kinds is not None and kind not in kinds:
                continue
            if tags_j is not None and jt != tags_j:
                continue
            if mode == "name":
                ok = name == arg
            elif mode == "prefix":
                ok = name.startswith(arg)
            else:
                ok = fnmatchcase(name, arg)
            if ok:
                out.append((k, row, kind, name, jt))
        out.sort(key=lambda e: (e[0], e[3], e[4], e[1]))
        return out

    def _plan_ranges(self, batch: List[_Item]):
        """Resolve and plan every range query in the batch: one shared
        ring-row gather per kind, one concatenated step-selection mask
        (each query's steps occupy a contiguous slice), capped at
        merge.MAX_STEPS in all."""
        from veneur_tpu_torch.history import merge as hmerge
        rqs = [(item, qi, q) for item in batch
               for qi, q in enumerate(item.queries)
               if q["range"] is not None]
        hist = self._history
        keys = hist.iter_keys()
        need: List[List[int]] = [[] for _ in range(5)]
        rowof: Dict[Tuple[int, int], int] = {}
        union_qs: set = set()
        specs: dict = {}
        sel_rows: list = []
        all_steps: list = []
        per_q: dict = {}
        rank = np.zeros(hist.spec.total_cols, np.float32)
        planned_seq = hist.seq
        for item, qi, q in rqs:
            matches = self._resolve_range(keys, q)
            truncated = len(matches) > _MAX_MATCHES
            if truncated:
                matches = matches[:_MAX_MATCHES]
            rows = []
            histo_hit = False
            for k, row, kind, name, jt in matches:
                key = (k, row)
                r = rowof.get(key)
                if r is None:
                    r = len(need[k])
                    rowof[key] = r
                    need[k].append(row)
                rows.append((k, r, kind, name, jt))
                histo_hit = histo_hit or k == 4
            if histo_hit:
                union_qs.update(q["quantiles"] or _DEFAULT_QS)
            skey = (q["range"], q["window"], q["step"])
            ent = specs.get(skey)
            if ent is None:
                room = hmerge.MAX_STEPS - len(all_steps)
                if room <= 0:
                    # step budget spent by earlier specs in the batch:
                    # this query renders empty + truncated rather than
                    # growing the launch past its step cap
                    ent = (0, [], True)
                else:
                    plan = hist.plan_range(skey[0], skey[1], skey[2],
                                           room)
                    ent = (len(all_steps), plan.steps, False)
                    all_steps.extend(plan.steps)
                    sel_rows.append(plan.sel)
                    rank = plan.rank
                specs[skey] = ent
            per_q[(id(item), qi)] = (rows, truncated or ent[2],
                                     ent[0], ent[1])
        sel = (np.concatenate(sel_rows, axis=0) if sel_rows
               else np.zeros((1, hist.spec.total_cols), np.float32))
        return {"per_q": per_q, "need": need, "union_qs": union_qs,
                "sel": sel, "rank": rank, "seq": planned_seq,
                "empty": not any(need)}

    def _build_range_inputs(self, rinfo):
        from veneur_tpu_torch.history import merge as hmerge
        return hmerge.pack_range_inputs(
            self._history.spec, rinfo["need"], rinfo["sel"],
            rinfo["rank"], rinfo["union_qs"])

    def _materialize_range(self, rpacked, hn_q, hsteps, hbuckets,
                           count_batch: bool = False):
        """ENGINE-thread finish for the range half: sampled sync, host
        copy, unpack, f64 two-float folds. Set estimates come back
        UNSCALED: history windows were written from their own intervals'
        raw registers, and a degrade-ladder sampling shift is not
        retroactive."""
        from veneur_tpu_torch.aggregation.step import unpack_flush
        from veneur_tpu_torch.history import merge as hmerge
        self._sync.tick(rpacked)
        out = unpack_flush(
            rpacked.cpu().numpy(),
            hmerge.range_shapes(self._history.spec, hbuckets, hsteps,
                                hn_q))
        if count_batch and self._c_batched is not None:
            self._c_batched.inc()
        f64 = np.float64
        return {
            "counter": (out["r_counter_hi"].astype(f64)
                        + out["r_counter_lo"].astype(f64)),
            "gauge": out["r_gauge"],
            "status": out["r_status"],
            "set_estimate": out["r_set_estimate"],
            "histo_quantiles": out["r_histo_quantiles"],
            "histo_min": out["r_histo_min"],
            "histo_max": out["r_histo_max"],
            "histo_count": (out["r_histo_count_hi"].astype(f64)
                            + out["r_histo_count_lo"].astype(f64)),
            "histo_sum": (out["r_histo_sum_hi"].astype(f64)
                          + out["r_histo_sum_lo"].astype(f64)),
        }

    # -- response assembly ---------------------------------------------------
    @staticmethod
    def _f(v):
        v = float(v)
        return v if np.isfinite(v) else None

    def _render(self, tname: str, r: int, meta, q: dict, res, qcol) -> dict:
        out = {"name": meta.name, "kind": meta.kind,
               "tags": list(meta.tags)}
        if tname == "counter":
            out["value"] = self._f(res["counter"][r])
        elif tname == "gauge":
            out["value"] = self._f(res["gauge"][r])
        elif tname == "status":
            out["value"] = self._f(res["status"][r])
            out["message"] = getattr(meta, "message", "") or ""
        elif tname == "set":
            out["estimate"] = self._f(res["set_estimate"][r])
        else:
            qs = q["quantiles"] or _DEFAULT_QS
            out["quantiles"] = {str(float(v)):
                                self._f(res["histo_quantiles"][r, qcol[v]])
                                for v in qs}
            out["median"] = self._f(res["histo_median"][r])
            out["min"] = self._f(res["histo_min"][r])
            out["max"] = self._f(res["histo_max"][r])
            out["count"] = self._f(res["histo_count"][r])
            out["sum"] = self._f(res["histo_sum"][r])
            out["avg"] = self._f(res["histo_avg"][r])
            out["hmean"] = self._f(res["histo_hmean"][r])
        return out

    def _render_range_entry(self, item, qi: int, q: dict, rinfo, rres,
                            rqcol) -> dict:
        if rinfo is None:
            return {"matches": [], "range": True}
        rows, truncated, soff, steps = rinfo["per_q"][(id(item), qi)]
        matches = [self._render_range(k, r, kind, name, jt, q, rres,
                                      rqcol, steps, soff)
                   for k, r, kind, name, jt in rows]
        entry = {"matches": matches, "range": True,
                 "interval_s": self._history.interval_s}
        if truncated:
            entry["truncated"] = True
        return entry

    def _render_range(self, k: int, r: int, kind: str, name: str,
                      jt: str, q: dict, rres, rqcol, steps,
                      soff: int) -> dict:
        """One range match -> its point series, OLDEST first. Counters
        add a per-point rate (value over the step's wall span); scalar
        kinds add the delta against the previous rendered point."""
        out = {"name": name, "kind": kind,
               "tags": jt.split(",") if jt else []}
        iv = self._history.interval_s
        pts = []
        for j, stp in enumerate(steps):
            s = soff + j
            p = {"ts": stp.ts_hi, "ts_start": stp.ts_lo,
                 "seq": [stp.seq_lo, stp.seq_hi],
                 "complete": bool(stp.complete)}
            if k == 0:
                v = self._f(rres["counter"][r, s])
                p["value"] = v
                span = max(stp.seq_hi - stp.seq_lo + 1, 1) * iv
                p["rate"] = (v / span) if v is not None else None
            elif k == 1:
                p["value"] = self._f(rres["gauge"][r, s])
            elif k == 2:
                p["value"] = self._f(rres["status"][r, s])
            elif k == 3:
                p["estimate"] = self._f(rres["set_estimate"][r, s])
            else:
                qs = q["quantiles"] or _DEFAULT_QS
                p["quantiles"] = {
                    str(float(v)):
                    self._f(rres["histo_quantiles"][r, s, rqcol[v]])
                    for v in qs}
                p["min"] = self._f(rres["histo_min"][r, s])
                p["max"] = self._f(rres["histo_max"][r, s])
                p["count"] = self._f(rres["histo_count"][r, s])
                p["sum"] = self._f(rres["histo_sum"][r, s])
            pts.append(p)
        pts.reverse()   # plan_range steps back from now; serve oldest first
        if k in (0, 1, 2):
            prev = None
            for p in pts:
                v = p.get("value")
                p["delta"] = (v - prev if v is not None
                              and prev is not None else None)
                prev = v
        out["points"] = pts
        return out
