"""Live shard-migration protocol: resize the mesh while ingest, flush,
forward and the query tier keep running.

The protocol has four phases, each visible in /readyz's `phase` field
and the veneur.reshard.* instruments:

ANNOUNCE   the Server enters the resharding sub-state: /readyz stays 200
           so peers keep sending, but its phase tells a prober and a
           dashboard that a move is under way.
DRAIN      one pipeline visit builds the new aggregator at the new shard
           count (around the same C++ engine on the native backends, so
           reader sockets, rings and parse threads never restart; its
           device state allocated first, so a card that cannot hold it
           changes nothing), detaches the old interval at a flush
           boundary through reshard/quiesce.py (the rings re-learn the
           shard map inside the same quiesce, so no packed batch
           straddles two maps) and installs the new aggregator. Ingest
           goes on into the new mesh as soon as the visit returns.
TRANSFER   a mover thread computes the drained interval's rows off the
           pipeline thread (the want_raw compute_flush the flush worker
           runs on a detached state) and splits them into one migration
           unit per destination shard (reshard/plan.py). Units fold
           through the pipeline queue in waves of
           reshard_max_parallel_shards a visit, between packets, flushes
           and queries. Each unit carries an exactly-once envelope
           (source id, migration epoch, seq = destination shard): a
           crash mid-move replays the same seqs, and the DedupWindow
           suppresses every unit that already folded. Rows fold through
           persistence/restore.py fold_snapshot, the restore's merge.
CUTOVER    a flush that arrives mid-transfer first folds the remaining
           units on the pipeline thread, which bounds the transition at
           one flush interval; otherwise the mover finishes and leaves
           the announce state.

What each phase loses on failure:
- announce/drain: nothing moved; the old aggregator keeps serving;
  failed_total counts it.
- a fold fault: the whole epoch replays from seq 0; folded units come
  back DUPLICATE and are skipped: exactly once, no double count.
- units not ready at a flush boundary within the timeout: the flush goes
  on with what has folded; the rest of the drained interval is dropped
  and counted (failed_total and a log line), rather than wedging the
  flush.
- a process crash: the checkpoint restore re-shards the newest snapshot
  onto whatever mesh restarts.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import List, Optional

from veneur_tpu_torch.forward.envelope import (FRESH, DedupWindow, Envelope,
                                               mint_source_id)
from veneur_tpu_torch.query.snapshot import PipelineCall, PipelineRequest
from veneur_tpu_torch.reliability.faults import FAULTS, RESHARD_FOLD
from veneur_tpu_torch.reshard import quiesce
from veneur_tpu_torch.reshard.plan import ReshardPlan, partition_units

log = logging.getLogger("veneur_tpu_torch.reshard")

# replays of a faulted transfer before the move is declared failed
_MAX_REPLAYS = 3

# The floor under both the resize-level wait and the first fold wave's
# budget. Neither waits for the transfer alone: the drain visit and the
# first wave queue behind whatever the pipeline queue holds when they are
# put (up to its 4,096 datagrams under fire), and the first wave's folds
# stage and step the new mesh's first rows. The per-wave budget
# (reshard_transfer_timeout_s) then bounds a lack of progress only.
_FIRST_WAIT_FLOOR_S = 120.0


class ReshardError(RuntimeError):
    """A resize that could not start or did not complete: the feature
    off, another move in progress, a bad target shard count, or a
    transfer that failed or timed out."""


class _Transfer:
    """Shared state of one resize: the drained interval, the migration
    units and the fold cursor. Units fold only on the pipeline thread
    (in PipelineCalls or at a flush boundary), so the cursor takes the
    lock only against the mover thread's progress reads."""

    def __init__(self, new_n: int, epoch: int):
        self.new_n = int(new_n)
        self.epoch = int(epoch)
        self.plan: Optional[ReshardPlan] = None
        self.lock = threading.Lock()
        self.units: List[dict] = []
        self.units_ready = threading.Event()
        self.next_i = 0
        self.replays = 0
        self.rows_folded = 0
        self.rows_moved = 0
        self.dup_suppressed = 0
        self.failed = False
        self.detail = ""
        self.done = threading.Event()
        self.t0_ns = 0
        self.duration_ns = 0
        # the mover's unit build, and each fold visit's wall time
        self.build_ns = 0
        self.fold_ns: List[int] = []
        # the detached interval, held until the transfer finishes
        self.state = None
        self.table = None
        self.old_agg = None

    def fail(self, detail: str) -> None:
        with self.lock:
            self.failed = True
            self.detail = self.detail or detail

    def remaining(self) -> int:
        with self.lock:
            return max(0, len(self.units) - self.next_i)

    def summary(self) -> dict:
        return {"plan": self.plan.signature if self.plan else "",
                "epoch": self.epoch,
                "units": len(self.units),
                "rows_folded": self.rows_folded,
                "rows_moved": self.rows_moved,
                "dup_suppressed": self.dup_suppressed,
                "replays": self.replays,
                "failed": self.failed,
                "detail": self.detail,
                "duration_ns": self.duration_ns,
                "build_ns": self.build_ns,
                "fold_ns": list(self.fold_ns)}


class _BeginRequest(PipelineRequest):
    """The DRAIN phase as one pipeline-queue visit: rebuild, swap
    boundary with the shard-map re-learn, install."""

    __slots__ = ("coord", "transfer")

    def __init__(self, coord: "ReshardCoordinator", transfer: _Transfer):
        super().__init__()
        self.coord = coord
        self.transfer = transfer

    def run(self, aggregator) -> None:
        try:
            self.coord._begin_on_pipeline(self.transfer)
            self.ok = True
        except Exception as e:  # noqa: BLE001 - the waiter must wake
            self.detail = f"reshard begin failed: {e}"
            self.transfer.fail(self.detail)
        finally:
            self.done.set()


class ReshardCoordinator:
    """One a Server. Its surface: resize() (any thread),
    complete_pending_folds() (pipeline thread, from the flush handler)
    and `active`, for the health phase and the stale marks."""

    def __init__(self, server, dedup_window: int = 256):
        self._server = server
        # migration units get an exactly-once stream of their own: a
        # source identity and one epoch per resize attempt, so a replay
        # after a crash mid-move re-presents the original seqs and the
        # window answers DUPLICATE for anything already folded
        self._source_id = mint_source_id()
        self._epoch = -1
        self.dedup = DedupWindow(dedup_window)
        self._lock = threading.Lock()
        self._transfer: Optional[_Transfer] = None
        self.moves_total = 0
        self.failed_total = 0

    @property
    def active(self) -> bool:
        t = self._transfer
        return t is not None and not t.done.is_set()

    # -- public API ----------------------------------------------------------
    def resize(self, new_n_shards: int, wait: bool = True,
               timeout_s: Optional[float] = None):
        """Resize the mesh to `new_n_shards`. With wait=True, block until
        the transfer finished and return its summary dict; with
        wait=False, return the live transfer handle."""
        srv = self._server
        cfg = srv.cfg
        if not cfg.reshard_enabled:
            raise ReshardError("resharding is disabled "
                               "(reshard_enabled: false)")
        new_n = int(new_n_shards)
        if new_n < 1:
            raise ReshardError(f"bad target shard count {new_n}")
        if new_n > 1:
            # early capacity guard (checked again on the pipeline
            # thread): the per-shard layout needs every capacity
            # divisible by the shard count
            from veneur_tpu_torch.server.sharded_aggregator import (
                per_shard_spec)
            try:
                per_shard_spec(srv.aggregator.spec, new_n)
            except ValueError as e:
                raise ReshardError(str(e))
        timeout = (float(timeout_s) if timeout_s is not None
                   else max(_FIRST_WAIT_FLOOR_S,
                            float(cfg.reshard_transfer_timeout_s)))
        with self._lock:
            if self.active:
                raise ReshardError("a reshard is already in progress")
            self._epoch += 1
            t = _Transfer(new_n, self._epoch)
            self._transfer = t
        begin = _BeginRequest(self, t)
        srv.packet_queue.put(begin)
        if not begin.wait(timeout):
            t.fail(f"drain visit timed out after {timeout:.1f}s")
            self._finalize(t)
            raise ReshardError(t.detail)
        if not begin.ok:
            self._finalize(t)
            raise ReshardError(begin.detail or "reshard begin failed")
        mover = threading.Thread(target=self._run_transfer, args=(t,),
                                 daemon=True, name="reshard-mover")
        mover.start()
        if not wait:
            return t
        if not t.done.wait(timeout):
            t.fail(f"transfer timed out after {timeout:.1f}s")
            raise ReshardError(t.detail)
        if t.failed:
            raise ReshardError(t.detail)
        return t.summary()

    def complete_pending_folds(self, aggregator, timeout_s: float) -> bool:
        """Pipeline-thread hook, called by the flush handler before the
        swap: a flush that lands mid-transfer folds the remaining units
        first, so its output covers the whole drained interval and the
        transition ends at one flush boundary. Returns False only when
        the transfer had to be abandoned (its units were not ready
        within the timeout)."""
        t = self._transfer
        if t is None or t.done.is_set():
            return True
        if not t.units_ready.wait(timeout_s):
            t.fail(f"migration units not ready within {timeout_s:.1f}s "
                   "at a flush boundary; remainder dropped")
            self._finalize(t)
            return False
        self._fold_some(t, aggregator, limit=None)
        if t.remaining() == 0 or t.failed:
            self._finalize(t)
        return not t.failed

    # -- DRAIN (pipeline thread) --------------------------------------------
    def _begin_on_pipeline(self, t: _Transfer) -> None:
        srv = self._server
        old_agg = srv.aggregator
        old_n = int(getattr(old_agg, "n_shards", 1))
        if t.new_n == old_n:
            raise ReshardError(f"mesh already has {old_n} shards")
        t.plan = ReshardPlan(old_n, t.new_n)
        t.t0_ns = time.perf_counter_ns()
        log.info("reshard %s: announce (epoch=%d)", t.plan.signature,
                 t.epoch)
        # ANNOUNCE: ready-but-announcing, /readyz stays 200
        srv._resharding = True
        ov = srv._overload
        if ov is not None:
            ov.enter_resharding()
        try:
            # the new mesh's device state first: a card that cannot hold
            # it raises here, with nothing staged or swapped
            new_agg, native = srv._make_aggregator(
                t.new_n, engine=getattr(old_agg, "eng", None),
                spec=old_agg.spec)
            # flush boundary and shard-map re-learn in one quiesce
            state, table = quiesce.shard_map_swap(old_agg, t.new_n)
        except Exception:
            # nothing installed: the old aggregator keeps serving
            srv._resharding = False
            if ov is not None:
                ov.exit_resharding()
            raise
        t.state, t.table, t.old_agg = state, table, old_agg
        # lifetime counters belong to the Server, not to one aggregator
        for attr in ("processed", "dropped_capacity", "h2d_bytes",
                     "steps_total", "step_ns", "dispatch_ns",
                     "steps_synced", "last_set_shift",
                     "degraded_timer_skipped", "degraded_set_skipped"):
            setattr(new_agg, attr, getattr(old_agg, attr))
        if getattr(old_agg, "_pressure", None) is not None:
            new_agg.set_pressure(old_agg._pressure)
        srv.aggregator = new_agg
        srv._native = native
        log.info("reshard %s: new mesh serving; transfer starting",
                 t.plan.signature)

    # -- TRANSFER (mover thread, folds on the pipeline thread) --------------
    def _run_transfer(self, t: _Transfer) -> None:
        srv = self._server
        t0 = time.perf_counter_ns()
        try:
            from veneur_tpu_torch.persistence import build_snapshot
            flush_arrays, table, raw = t.old_agg.compute_flush(
                t.state, t.table, srv.cfg.percentiles, want_raw=True)
            snap = build_snapshot(
                t.old_agg.spec, table, flush_arrays, raw,
                agg_kind="sharded" if t.plan.old_n > 1 else "single",
                n_shards=t.plan.old_n, interval_ts=time.time(),
                hostname=srv.hostname)
            t.units = partition_units(snap, t.plan)
        except Exception as e:
            log.exception("reshard %s: unit build failed",
                          t.plan.signature)
            t.fail(f"unit build failed: {e}")
            t.units_ready.set()
            self._finalize(t)
            return
        t.build_ns = time.perf_counter_ns() - t0
        t.units_ready.set()
        batch = max(1, int(srv.cfg.reshard_max_parallel_shards))
        wave_s = float(srv.cfg.reshard_transfer_timeout_s)
        # the budget bounds a lack of progress, not the total wall time:
        # a wave that folds at least one unit re-arms it, while a wedged
        # pipeline still trips it within one budget
        deadline = time.monotonic() + max(wave_s, _FIRST_WAIT_FLOOR_S)
        while not t.done.is_set() and t.remaining() and not t.failed:
            if time.monotonic() > deadline:
                t.fail("transfer timed out; remainder dropped")
                break
            with t.lock:
                before = t.next_i
            call = PipelineCall(
                lambda agg, _t=t, _b=batch: self._fold_some(_t, agg, _b))
            srv.packet_queue.put(call)
            call.wait(max(0.1, deadline - time.monotonic()))
            with t.lock:
                progressed = t.next_i > before
            if progressed:
                deadline = time.monotonic() + wave_s
        self._finalize(t)

    def _fold_some(self, t: _Transfer, aggregator, limit) -> int:
        """Fold up to `limit` units (None: all) into the serving
        aggregator. Pipeline thread only. A fold fault replays the whole
        epoch under the original seqs: the dedup window turns folded
        units into DUPLICATE skips, so a replay never folds twice."""
        from veneur_tpu_torch.persistence import fold_snapshot
        t0 = time.perf_counter_ns()
        folded = 0
        while limit is None or folded < limit:
            with t.lock:
                if t.failed or t.next_i >= len(t.units):
                    break
                i = t.next_i
                t.next_i = i + 1
            u = t.units[i]
            env = Envelope(self._source_id, t.epoch, u["dest_shard"])
            if self.dedup.observe(env) != FRESH:
                with t.lock:
                    t.dup_suppressed += 1
                folded += 1
                continue
            try:
                n = fold_snapshot(aggregator, u)
                # chaos hook: a fault here is the receiver dying after
                # the fold but before its progress is recorded, the
                # replay hazard exactly-once exists for
                FAULTS.inject(RESHARD_FOLD, name=f"unit{u['dest_shard']}")
            except Exception as e:
                with t.lock:
                    t.replays += 1
                    replays = t.replays
                    t.next_i = 0   # replay the epoch from seq 0
                if replays > _MAX_REPLAYS:
                    t.fail(f"fold failed after {replays} replays: {e}")
                else:
                    log.warning("reshard %s: fold fault (%s); replaying "
                                "epoch %d (attempt %d)", t.plan.signature,
                                e, t.epoch, replays)
                break
            with t.lock:
                t.rows_folded += n
                t.rows_moved += int(u.get("rows_moved", 0))
            folded += 1
        t.fold_ns.append(time.perf_counter_ns() - t0)
        return folded

    # -- CUTOVER -------------------------------------------------------------
    def _finalize(self, t: _Transfer) -> None:
        with t.lock:
            if t.done.is_set():
                return
            t.duration_ns = (time.perf_counter_ns() - t.t0_ns
                             if t.t0_ns else 0)
            # release the drained interval's device state
            t.state = t.table = t.old_agg = None
            t.done.set()
        srv = self._server
        srv._resharding = False
        if srv._overload is not None:
            srv._overload.exit_resharding()
        sig = t.plan.signature if t.plan else f"->{t.new_n}"
        if t.failed:
            self.failed_total += 1
            srv._c_reshard_failed.inc()
            log.warning("reshard %s FAILED: %s", sig, t.detail)
        else:
            self.moves_total += 1
            srv._c_reshard_moves.inc()
            log.info("reshard %s complete: %d units, %d rows folded "
                     "(%d moved owner), %.1f ms", sig, len(t.units),
                     t.rows_folded, t.rows_moved, t.duration_ns / 1e6)
        if t.rows_moved:
            srv._c_reshard_rows_moved.inc(t.rows_moved)
        if t.duration_ns:
            srv._t_reshard.observe(t.duration_ns)
