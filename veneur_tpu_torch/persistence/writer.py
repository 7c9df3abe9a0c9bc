"""Async checkpoint writer: double-buffered, latest-wins, off the flush
path.

The flush worker hands build_snapshot's host-side dict to submit() and
moves on — serialization, fsync, atomic rename, and retention GC all run
on one background thread. The double-buffer is a single pending slot: at
most one write is in flight, at most one snapshot waits, and a newer
snapshot REPLACES a waiting older one (checkpoints are full state, so
the newest supersedes; writing a stale one would only add latency to the
recovery point).

Write protocol (crash-safe at every instant):
  1. serialize into  <root>/.tmp-ckpt-<seq>/   (chunks, then manifest —
     codec.encode_to_dir fsyncs both)
  2. os.replace -> <root>/ckpt-<seq>           (atomic publish)
  3. fsync <root>, bump last_write_ts, GC to the newest `retain`

A failed write is counted and logged, never raised into the flush path;
the fault point `checkpoint.write` (reliability/faults.py) exercises
exactly that containment.
"""

from __future__ import annotations

import logging
import os
import shutil
import threading
import time

from veneur_tpu_torch.persistence import codec
from veneur_tpu_torch.reliability.faults import CHECKPOINT_WRITE, FAULTS
from veneur_tpu_torch.utils.atomicio import fsync_dir

log = logging.getLogger("veneur_tpu_torch.persistence.writer")


class CheckpointWriter:
    def __init__(self, root: str, retain: int = 3, fsync: bool = True,
                 write_timer=None, bytes_counter=None,
                 writes_counter=None):
        """`write_timer`/`bytes_counter`/`writes_counter` are registry
        instruments (Timer.observe(ns) / Counter.inc(n)) owned by the
        server; None leaves the writer silent (tests, CLI)."""
        self.root = root
        self.retain = max(1, int(retain))
        self.fsync = fsync
        self._write_timer = write_timer
        self._bytes_counter = bytes_counter
        self._writes_counter = writes_counter
        os.makedirs(root, exist_ok=True)
        existing = codec.list_checkpoints(root)
        self._next_seq = (existing[-1][0] + 1) if existing else 0
        self.failures = 0
        self.writes = 0
        self.last_write_ts: float = 0.0
        self.last_path: str = ""
        self._cond = threading.Condition()
        self._pending = None      # the double-buffer's waiting slot
        self._writing = False
        self._closed = False
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="checkpoint-writer")
        self._thread.start()

    # -- submission ---------------------------------------------------------
    def submit(self, snap: dict) -> None:
        """Queue a snapshot for background write; replaces any snapshot
        still waiting (latest wins)."""
        with self._cond:
            if self._closed:
                return
            if self._pending is not None:
                log.debug("checkpoint writer busy; superseding pending "
                          "snapshot")
            self._pending = snap
            self._cond.notify_all()

    def write_sync(self, snap: dict) -> bool:
        """Write on the CALLER's thread (shutdown's final checkpoint, the
        CLI, tests). Serializes against the background thread via the
        same in-flight gate. Returns success."""
        with self._cond:
            while self._writing:
                self._cond.wait()
            self._writing = True
        try:
            return self._write(snap)
        finally:
            with self._cond:
                self._writing = False
                self._cond.notify_all()

    def wait_idle(self, timeout: float = 30.0) -> bool:
        """Block until no snapshot is pending or in flight (tests)."""
        deadline = time.monotonic() + timeout
        with self._cond:
            while self._pending is not None or self._writing:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._cond.wait(timeout=left)
        return True

    def close(self) -> None:
        """Finish the in-flight/pending write and stop the thread."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._thread.join(timeout=60.0)
        if self._thread.is_alive():
            log.error("checkpoint writer thread did not exit")

    # -- background thread --------------------------------------------------
    def _run(self):
        while True:
            with self._cond:
                while self._pending is None and not self._closed:
                    self._cond.wait()
                snap = self._pending
                self._pending = None
                if snap is None and self._closed:
                    return
                self._writing = True
            try:
                self._write(snap)
            finally:
                with self._cond:
                    self._writing = False
                    self._cond.notify_all()

    def _write(self, snap: dict) -> bool:
        seq = self._next_seq
        tmp = os.path.join(self.root, f".tmp-{codec.checkpoint_dirname(seq)}")
        t0 = time.perf_counter_ns()
        try:
            FAULTS.inject(CHECKPOINT_WRITE)
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            nbytes = codec.encode_to_dir(tmp, snap, fsync=self.fsync)
            final = os.path.join(self.root, codec.checkpoint_dirname(seq))
            os.replace(tmp, final)
            if self.fsync:
                fsync_dir(self.root)
        except Exception as e:
            # containment: a full disk / injected fault degrades the
            # recovery point, never the flush path
            self.failures += 1
            log.warning("checkpoint write failed (seq %d): %s", seq, e)
            shutil.rmtree(tmp, ignore_errors=True)
            return False
        dur_ns = time.perf_counter_ns() - t0
        self._next_seq = seq + 1
        self.writes += 1
        self.last_write_ts = time.time()
        self.last_path = final
        if self._write_timer is not None:
            self._write_timer.observe(dur_ns)
        if self._bytes_counter is not None:
            self._bytes_counter.inc(nbytes)
        if self._writes_counter is not None:
            self._writes_counter.inc()
        self._gc()
        return True

    def _gc(self):
        ckpts = codec.list_checkpoints(self.root)
        for _seq, path in ckpts[:-self.retain]:
            shutil.rmtree(path, ignore_errors=True)
            log.debug("checkpoint retention: removed %s", path)
