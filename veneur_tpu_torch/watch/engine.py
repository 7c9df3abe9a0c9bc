"""Watch engine: one fused device evaluation per flush interval.

The engine owns its OWN thread and evaluates on the flush's DETACHED
interval state, which is what keeps 100k standing monitors off the hot
paths:

- swap() ran on the pipeline thread before the flush job was queued and
  installed a freshly allocated live state, so no later ingest step ever
  writes the detached state the flush worker hands to `offer()` (the
  query tier's two-visit pipeline protocol exists because the LIVE state
  is updated in place; detached state needs none of it, so watch
  evaluation never touches the packet queue);
- `offer()` is non-blocking by contract (bounded queue, drop-oldest with
  exact accounting), so the flush worker's deadline is untouched even
  while the watch thread is mid-launch; the bound also caps the detached
  states held for evaluation (each is the full state, ~114 MB at the
  default widths);
- the evaluation itself is ONE `flush_live_in_packed` launch (the
  program the flush and query tiers run, with K2 for the digests) over
  the compiler's deduped packed gather, then host-side state-machine
  steps over the unpacked rows.

Accounting invariant (pinned by the storm tests): per active watch,
every interval the flush worker OFFERS is either evaluated
(`evaluated_total`) or counted as suppressed (`suppressed_total`: a
dropped-oldest backlog interval or an engine failure); per breaching
evaluated interval, exactly one of `fired_total` (a transition into
ALERT) or `suppressed_total` (debounce pending / hysteresis hold)
increments. Nothing is silent.

Launch cost accumulates under `dispatch_ns` (enqueue only) and device
completion is sampled through observability/runtime.SampledSync on this
thread, never the pipeline's or the flush worker's.
"""

from __future__ import annotations

import logging
import math
import queue as queue_mod
import threading
import time
from typing import Dict, List, Optional

from veneur_tpu_torch.observability.runtime import SampledSync
from veneur_tpu_torch.query.engine import stage_inputs
from veneur_tpu_torch.query.nameindex import NameIndex
from veneur_tpu_torch.query.snapshot import _META_KIND, COUNT_TABLES
from veneur_tpu_torch.watch.compiler import WatchPlan, compile_watches
from veneur_tpu_torch.watch.model import (WATCH_KINDS, Watch, WatchError,
                                          WatchLimitError, parse_watch)
from veneur_tpu_torch.watch.notify import StreamHub, WebhookNotifier

log = logging.getLogger("veneur_tpu_torch.watch")

_SYNC_EVERY = 64       # sampled device-sync cadence (1 in N launches)
_JOB_DEPTH = 2         # detached intervals queued before drop-oldest
_CLOSE_TIMEOUT_S = 10.0


class WatchEngine:
    """Registry + evaluator + notifier for the streaming watch tier."""

    def __init__(self, server, *, max_active: int = 1 << 17,
                 max_subscribers: int = 64, webhook_url: str = "",
                 retry_policy=None, evaluated=None, fired=None,
                 suppressed=None, dropped=None, eval_ns=None,
                 active=None, history=None) -> None:
        self._server = server
        self.spec = server.aggregator.spec
        self.device = server.aggregator.device
        self._history = history          # HistoryWriter | None
        self.max_active = max(1, int(max_active))
        self._c_evaluated = evaluated
        self._c_fired = fired
        self._c_suppressed = suppressed
        self._c_eval_ns = eval_ns
        self._g_active = active
        # registry: wid -> Watch; mutations under _lock, state-machine
        # steps on the engine thread only
        self._lock = threading.Lock()
        self._watches: Dict[int, Watch] = {}
        # per-kind census maintained incrementally: the gauge update and
        # the skipped-interval accounting must stay O(kinds), not
        # O(active) — a 100k-watch bulk registration recounting the
        # whole registry per admit is O(n^2)
        self._active_by_kind: Dict[str, int] = {}
        self._next_id = 1
        self._generation = 0
        # packed-plan cache: one compile per (interval table, watch set)
        self._plan: Optional[WatchPlan] = None
        self._plan_key = None
        self._plan_table = None
        self._jobs: "queue_mod.Queue" = queue_mod.Queue(maxsize=_JOB_DEPTH)
        self._stop = threading.Event()
        self._sync = SampledSync(_SYNC_EVERY)
        self.dispatch_ns = 0
        self.launches_total = 0
        self.intervals_evaluated = 0
        self.intervals_skipped = 0
        self.hub = StreamHub(max_subscribers, dropped=dropped)
        self.webhook: Optional[WebhookNotifier] = None
        if webhook_url:
            self.webhook = WebhookNotifier(webhook_url, dropped=dropped)
            if retry_policy is not None:
                self.webhook.configure_resilience(retry_policy)
        self._thread = threading.Thread(
            target=self._run, name="watch-engine", daemon=True)
        self._thread.start()

    # -- registry ------------------------------------------------------------
    def register(self, body) -> dict:
        """Parse + admit one watch. Raises WatchError (400) on a bad
        body, WatchLimitError (429) at watch_max_active."""
        spec = parse_watch(body)
        with self._lock:
            if len(self._watches) >= self.max_active:
                raise WatchLimitError(
                    f"watch_max_active={self.max_active} reached")
            wid = self._next_id
            self._next_id += 1
            w = Watch(wid, spec)
            self._watches[wid] = w
            self._active_by_kind[w.kind] = \
                self._active_by_kind.get(w.kind, 0) + 1
            self._generation += 1
        self._update_active_gauge()
        return w.to_dict()

    def delete(self, wid: int) -> bool:
        with self._lock:
            w = self._watches.pop(int(wid), None)
            found = w is not None
            if found:
                self._active_by_kind[w.kind] -= 1
                self._generation += 1
        if found:
            self._update_active_gauge()
        return found

    def list_watches(self) -> List[dict]:
        with self._lock:
            watches = sorted(self._watches.values(), key=lambda w: w.wid)
            return [w.describe() for w in watches]

    @property
    def n_active(self) -> int:
        with self._lock:
            return len(self._watches)

    def _update_active_gauge(self) -> None:
        if self._g_active is None:
            return
        with self._lock:
            by_kind = dict(self._active_by_kind)
        for k in WATCH_KINDS:
            self._g_active.set(float(by_kind.get(k, 0)), kind=k)

    # -- flush-worker hooks (non-blocking by contract) ------------------------
    def offer(self, state, table, set_shift: int, ts: int,
              hist_seq: Optional[int] = None) -> None:
        """Hand one DETACHED interval to the engine thread. Called by
        server._do_flush after compute_flush; swap() gave the pipeline a
        fresh live state, so nothing writes this one again.
        `hist_seq` is the history-ring window seq this interval landed
        in (the flush wrote it before offering), pinned HERE because a
        later flush may advance the ring before the engine thread
        evaluates; None when the history tier is off."""
        if self._stop.is_set():
            return
        with self._lock:
            if not self._watches:
                return
        job = (state, table, int(set_shift), int(ts), hist_seq)
        try:
            self._jobs.put_nowait(job)
        except queue_mod.Full:
            # drop the OLDEST queued interval — the newest state is the
            # one standing monitors want — and account every active
            # watch's lost evaluation as suppressed (exact: one per
            # watch per skipped interval)
            try:
                stale = self._jobs.get_nowait()
            except queue_mod.Empty:
                stale = None
            if stale is not None:
                self.intervals_skipped += 1
                self._count_skipped_interval()
            try:
                self._jobs.put_nowait(job)
            except queue_mod.Full:
                # engine wedged mid-drain and the queue refilled: THIS
                # interval is the one skipped, same exact accounting
                self.intervals_skipped += 1
                self._count_skipped_interval()

    def skip_interval(self, reason: str) -> None:
        """Overload-CRITICAL skip: the flush worker sheds the watch
        evaluation instead of offering the interval. Counted (one
        suppressed per active watch), never silent."""
        with self._lock:
            if not self._watches:
                return
        self.intervals_skipped += 1
        self._count_skipped_interval()
        log.debug("watch evaluation skipped for one interval: %s", reason)

    def _count_skipped_interval(self) -> None:
        if self._c_suppressed is None:
            return
        with self._lock:
            by_kind = {k: n for k, n in self._active_by_kind.items() if n}
        for k, n in by_kind.items():
            self._c_suppressed.inc(n, kind=k)

    # -- engine thread -------------------------------------------------------
    def _run(self) -> None:
        while True:
            job = self._jobs.get()
            if job is None:
                if self._stop.is_set():
                    return
                continue
            state, table, set_shift, ts, hist_seq = job
            try:
                self._evaluate_interval(state, table, set_shift, ts,
                                        hist_seq)
            except Exception:  # noqa: BLE001 — the engine must survive
                log.exception("watch evaluation failed; interval counted "
                              "as skipped")
                self.intervals_skipped += 1
                self._count_skipped_interval()
            if self._stop.is_set():
                return

    def _index_and_plan(self, table, watches):
        """Selector→row resolution against the detached table's sorted
        NameIndex. swap() installs a fresh KeyTable per interval, so
        the cache key (table identity, per-kind counts, watch-set
        generation) re-resolves exactly when the naming view or the
        watch set changed."""
        metas = {t: table.get_meta(_META_KIND[t]) for t in COUNT_TABLES}
        counts = {t: len(metas[t]) for t in COUNT_TABLES}
        with self._lock:
            gen = self._generation
        key = (id(table), tuple(counts[t] for t in COUNT_TABLES), gen)
        if self._plan_key == key and self._plan_table is table:
            return self._plan
        index = NameIndex(metas, counts)
        plan = compile_watches(self.spec, index, watches)
        self._plan, self._plan_key, self._plan_table = plan, key, table
        return plan

    def _launch(self, state, plan: WatchPlan):
        """The watch tier's ONE device launch per interval: enqueue cost
        lands in dispatch_ns; the sampled completion sync runs in
        _materialize on this same engine thread."""
        from veneur_tpu_torch.aggregation.step import flush_live_in_packed
        from veneur_tpu_torch.parallel.sharded import flat_view
        agg = self._server.aggregator
        # by the interval's own layout ([R, S, K, ...] leaves sharded,
        # [K, ...] on one device): a live reshard may have resized the
        # mesh since the flush detached it
        sharded = state.counter_hi.dim() == 3
        if sharded == hasattr(agg, "layout"):
            flat = agg.query_flat_state(state)
        else:
            flat = flat_view(state) if sharded else state
        inputs = stage_inputs(plan.inputs, self.device)
        t0 = time.perf_counter_ns()
        out = flush_live_in_packed(flat, inputs, spec=self.spec,
                                   n_q=plan.n_q, buckets=plan.buckets)
        self.dispatch_ns += time.perf_counter_ns() - t0
        self.launches_total += 1
        return out

    def _materialize(self, packed, plan: WatchPlan, set_shift: int):
        from veneur_tpu_torch.aggregation.step import (
            combine_flush_scalars, flush_live_shapes, unpack_flush)
        self._sync.tick(packed)
        out = unpack_flush(
            packed.cpu().numpy(),
            flush_live_shapes(self.spec, *plan.buckets, plan.n_q))
        res = combine_flush_scalars(out)
        # detached-interval set estimates carry the degrade ladder's
        # latched sampling shift — the same 2^shift correction
        # server._do_flush applies to the flush export
        if set_shift:
            res = dict(res)
            res["set_estimate"] = (res["set_estimate"]
                                   * float(1 << set_shift))
        return res

    def _value_for(self, w: Watch, plan: Optional[WatchPlan],
                   res) -> Optional[float]:
        if plan is None or res is None:
            return None
        vals: List[float] = []
        for tname, r in plan.rows.get(w.wid, ()):
            if tname == "counter":
                v = res["counter"][r]
            elif tname == "gauge":
                v = res["gauge"][r]
            elif tname == "status":
                v = res["status"][r]
            elif tname == "set":
                v = res["set_estimate"][r]
            else:
                v = res["histo_quantiles"][r,
                                           plan.qcol[float(w.quantile)]]
            v = float(v)
            if math.isfinite(v):
                vals.append(v)
        return w.reduce(vals)

    def _delta_baselines(self, watches,
                         hist_seq: Optional[int]) -> Optional[dict]:
        """Previous-interval baselines for delta watches, read from the
        HISTORY RING in one batched device gather: {wid: value | None}.
        None (no dict) when the tier is off / unarmed / there is no
        previous window — callers then fall back to the watch's own
        retained last_value (the pre-history behavior)."""
        if (self._history is None or hist_seq is None or hist_seq < 1
                or not self._history.armed):
            return None
        deltas = [w for w in watches if w.kind == "delta"]
        if not deltas:
            return None
        from fnmatch import fnmatchcase
        keys = self._history.iter_keys()
        items: List[tuple] = []
        slots: Dict[int, List[int]] = {}
        for w in deltas:
            allowed = w.metric_kinds or ("counter", "gauge", "status")
            tags_j = ",".join(w.tags) if w.tags is not None else None
            matched = []
            for k, key, row in keys:
                kind, name, jt = key
                if k > 2 or kind not in allowed:
                    continue
                if tags_j is not None and jt != tags_j:
                    continue
                if w.mode == "name":
                    ok = name == w.arg
                elif w.mode == "prefix":
                    ok = name.startswith(w.arg)
                else:
                    ok = fnmatchcase(name, w.arg)
                if ok:
                    matched.append(len(items))
                    items.append((k, row))
            slots[w.wid] = matched
        out: Dict[int, Optional[float]] = {}
        vals = self._history.read_values(hist_seq - 1, items)
        for w in deltas:
            vs = [float(vals[i]) for i in slots[w.wid]
                  if math.isfinite(vals[i])]
            out[w.wid] = w.reduce(vs)
        return out

    def _evaluate_interval(self, state, table, set_shift: int,
                           ts: int, hist_seq: Optional[int] = None
                           ) -> None:
        t0 = time.perf_counter_ns()
        with self._lock:
            watches = sorted(self._watches.values(), key=lambda w: w.wid)
        if not watches:
            return
        plan = self._index_and_plan(table, watches)
        res = None
        if plan is not None:
            packed = self._launch(state, plan)
            res = self._materialize(packed, plan, set_shift)
        # delta lookback: the ring window written by the PREVIOUS flush
        # is the baseline of record when the history tier is on
        baselines = self._delta_baselines(watches, hist_seq)
        # evaluated while a reshard's moved rows may still be folding
        stale = bool(getattr(self._server, "reshard_active", False))
        events: List[dict] = []
        n_eval: Dict[str, int] = {}
        n_fired: Dict[str, int] = {}
        n_supp: Dict[str, int] = {}
        with self._lock:
            for w in watches:
                if self._watches.get(w.wid) is not w:
                    continue   # deleted (or replaced) mid-interval
                value = self._value_for(w, plan, res)
                if w.kind == "delta" and baselines is not None:
                    transition, suppressed = w.observe(
                        value, ts, prev_override=baselines.get(w.wid))
                else:
                    transition, suppressed = w.observe(value, ts)
                n_eval[w.kind] = n_eval.get(w.kind, 0) + 1
                if suppressed:
                    n_supp[w.kind] = n_supp.get(w.kind, 0) + 1
                if transition is None:
                    continue
                old, new = transition
                if new == "ALERT":
                    n_fired[w.kind] = n_fired.get(w.kind, 0) + 1
                ev = {"id": w.wid, "kind": w.kind, w.mode: w.arg,
                      "from": old, "to": new, "ts": int(ts),
                      "threshold": w.threshold}
                if w.value is not None:
                    ev["value"] = w.value
                if stale:
                    ev["stale_bounded"] = True
                events.append(ev)
        for k, n in n_eval.items():
            if self._c_evaluated is not None:
                self._c_evaluated.inc(n, kind=k)
        for k, n in n_fired.items():
            if self._c_fired is not None:
                self._c_fired.inc(n, kind=k)
        for k, n in n_supp.items():
            if self._c_suppressed is not None:
                self._c_suppressed.inc(n, kind=k)
        self.intervals_evaluated += 1
        if events:
            self.hub.publish(events)
            if self.webhook is not None:
                self.webhook.post_events(events)
        # _materialize's copy back waited for the launch, so this wall
        # time covers the device work; dispatch_ns holds the enqueue alone
        dur = time.perf_counter_ns() - t0
        if self._c_eval_ns is not None:
            self._c_eval_ns.inc(dur)

    # -- persistence ---------------------------------------------------------
    def snapshot(self) -> Optional[dict]:
        """Deterministic registration + firing-state dict for the
        checkpoint sidecar chunk. None (chunk omitted) when no watches
        are registered. Byte-reproducible: snapshot → restore →
        snapshot serializes identically."""
        with self._lock:
            if not self._watches:
                return None
            return {"next_id": self._next_id,
                    "watches": [{"spec": w.to_dict(),
                                 "state": w.state_dict()}
                                for _wid, w in sorted(
                                    self._watches.items())]}

    def restore(self, data: dict) -> None:
        """Adopt a checkpoint's watch chunk (replacing any current
        registrations — restore runs before the HTTP API serves). A
        malformed chunk is logged and ignored: a bad checkpoint must
        never keep the server from serving."""
        try:
            ws: Dict[int, Watch] = {}
            for ent in data.get("watches", []):
                spec = dict(ent["spec"])
                wid = int(spec.pop("id"))
                w = Watch(wid, parse_watch(spec))
                w.load_state(ent.get("state") or {})
                ws[wid] = w
            next_id = max([int(data.get("next_id", 1))]
                          + [wid + 1 for wid in ws])
        except (WatchError, KeyError, TypeError, ValueError) as e:
            log.warning("ignoring malformed watch chunk in checkpoint: "
                        "%s", e)
            return
        by_kind: Dict[str, int] = {}
        for w in ws.values():
            by_kind[w.kind] = by_kind.get(w.kind, 0) + 1
        with self._lock:
            self._watches = ws
            self._active_by_kind = by_kind
            self._next_id = next_id
            self._generation += 1
        self._update_active_gauge()
        log.info("restored %d watches from checkpoint", len(ws))

    # -- lifecycle -----------------------------------------------------------
    def close(self) -> None:
        """Stop the engine thread (it launches on the device). Queued
        intervals that never ran are counted."""
        self._stop.set()
        while True:
            try:
                self._jobs.put_nowait(None)
                break
            except queue_mod.Full:
                # displace a queued interval to make room for the
                # sentinel; its lost evaluations are accounted like any
                # other skipped interval
                try:
                    stale = self._jobs.get_nowait()
                except queue_mod.Empty:
                    continue
                if stale is not None:
                    self.intervals_skipped += 1
                    self._count_skipped_interval()
        self._thread.join(timeout=_CLOSE_TIMEOUT_S)
        if self._thread.is_alive():
            log.error("watch engine thread did not exit within %.0fs",
                      _CLOSE_TIMEOUT_S)
        # the thread exits on the first job it sees after _stop, which
        # can strand later queued intervals — account them too
        while True:
            try:
                job = self._jobs.get_nowait()
            except queue_mod.Empty:
                break
            if job is not None:
                self.intervals_skipped += 1
                self._count_skipped_interval()
