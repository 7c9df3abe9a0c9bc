"""The native ingest path against the JAX package, on the CPU.

The port's `NativeAggregator(device="cpu")` runs its own build of the C++
engine (veneur_tpu_torch/native); the JAX `NativeAggregator` runs the JAX
package's. Both get the same datagrams at the JAX suite's small spec
(tests/test_native.py `_small_native_agg`). The JAX side waits for each
of its steps (`_SyncedJNative`): its packed buffers are handed to a jit
call that may read them late on the CPU backend (ROADMAP C-watch 4).

- (a) the packed buffer equals the JAX one word for word at every emit;
- (b) after swap, every state leaf is byte-equal but the digest cells
  (`h_w`, `h_wm`), whose torch prologue may round differently (C-watch 3);
- (c) the same InterMetrics, `processed`, `dropped_capacity` and parse
  errors on the slice test's traffic (bad lines and capacity drops
  included): quantiles within rtol/atol 2e-5, the rest exact;
- (d) the port's native path against its own Python `Aggregator`;
- (e) `ingest_core` with live histo-stat lanes against JAX `ingest_core`
  (its Pallas kernel in interpret mode): byte-exact;
- (f) `packed_rings_core` with three rings and the compaction flag against
  JAX's, and `rings_start(3)` + `rings_inject` + `pump` against the JAX
  package's flush;
- (g) a loopback UDP run through `readers_start` + `pump`: lossless,
  counted, and the flush `feed` gives;
- (h) without a card, `NativeAggregator(spec)` raises.
"""

import socket
import time

import jax
import numpy as np
import pytest
import torch

from veneur_tpu.aggregation import state as jstate_mod
from veneur_tpu.aggregation import step as jstep
from veneur_tpu.aggregation.host import BatchSpec as JBatchSpec
from veneur_tpu.ops import pallas_ingest as jpi
from veneur_tpu.server.flusher import generate_intermetrics as jgen
from veneur_tpu.server.native_aggregator import (
    NativeAggregator as JNativeAggregator)
from veneur_tpu_torch import convert
from veneur_tpu_torch.aggregation import state as tstate_mod
from veneur_tpu_torch.aggregation import step as tstep
from veneur_tpu_torch.aggregation.host import BatchSpec as TBatchSpec
from veneur_tpu_torch.native import INJECT_OK
from veneur_tpu_torch.samplers.parser import ParseError
from veneur_tpu_torch.samplers.parser import parse_metric as tparse
from veneur_tpu_torch.server.aggregator import Aggregator as TAggregator
from veneur_tpu_torch.server.flusher import generate_intermetrics as tgen
from veneur_tpu_torch.server.native_aggregator import (
    NativeAggregator as TNativeAggregator)
from tests.test_torch_ingest import EXACT_LEAVES, _rand_batch, _row_quantiles
from tests.test_torch_slice import _lines

SPEC_KW = dict(counter_capacity=64, gauge_capacity=64, status_capacity=16,
               set_capacity=16, histo_capacity=64)
BATCH_KW = dict(counter=128, gauge=64, status=16, set=64, histo=128)
PERC = [0.5, 0.9, 0.99]
AGGS = ["min", "max", "median", "avg", "count", "sum", "hmean"]
DIGEST_CELLS = ("h_w", "h_wm")


class _SyncedJNative(JNativeAggregator):
    """The JAX NativeAggregator, waiting for each step before the engine
    writes the next buffer (C-watch 4)."""

    def _emit_native(self):
        super()._emit_native()
        jax.block_until_ready(self.state)

    def _emit_rings(self):
        stepped = super()._emit_rings()
        jax.block_until_ready(self.state)
        return stepped


def _pair(compact_every=2):
    jagg = _SyncedJNative(jstate_mod.TableSpec(**SPEC_KW),
                          JBatchSpec(**BATCH_KW), compact_every=compact_every)
    tagg = TNativeAggregator(tstate_mod.TableSpec(**SPEC_KW),
                             TBatchSpec(**BATCH_KW), device="cpu",
                             compact_every=compact_every)
    return jagg, tagg


def _datagrams(lines, size=1400):
    """Lines joined by newlines into datagrams of at most `size` bytes."""
    out, cur = [], []
    for line in lines:
        if cur and sum(map(len, cur)) + len(cur) + len(line) > size:
            out.append(b"\n".join(cur))
            cur = []
        cur.append(line)
    if cur:
        out.append(b"\n".join(cur))
    return out


def _parity_waves():
    """Mixed traffic in shrinking waves (tests/test_native.py
    `_parity_waves`): emits between waves alternate the two buffers and
    leave stale tails that the next emit must re-sentinel."""
    waves = []
    for scale in (40, 25, 7, 1):
        lines = []
        for i in range(scale):
            lines.append(b"pz.c%d:%d|c" % (i, i + 1))
            lines.append(b"pz.c%d:2|c|@0.5" % (i % 11))
            if i < 30:
                lines.append(b"pz.g%d:%d.25|g" % (i % 30, i))
                lines.append(b"pz.h%d:%d|ms" % (i % 20, i * 3))
            if i < 10:
                lines.append(b"pz.s%d:u%d|s" % (i % 4, i))
        waves.append(b"\n".join(lines))
    return waves


def _last_buffer(agg):
    """The packed buffer the last step read (the engine flips to the other
    one after each step), as a copy."""
    buf = agg._pk_bufs[1 - agg._pk_idx]
    return np.array(getattr(buf, "array", buf))


def _flush(agg, gen):
    state, table = agg.swap()
    res, table = agg.compute_flush(state, table, PERC)
    return gen(res, table, percentiles=PERC, aggregates=AGGS,
               is_local=False, timestamp=1700000000, hostname="h")


def _assert_same_intermetrics(got, want, by_key=False, set_rtol=0.0):
    """Names, tags, types and values: quantiles within rtol/atol 2e-5, set
    estimates (names "s.*") within `set_rtol`, the rest exact. Across the
    two packages set_rtol is 1e-6, as in tests/test_torch_slice.py: the
    HLL registers are byte-equal (test (b)), but the estimator's f32 sums
    round differently. by_key compares the two sorted by (name, tags),
    for runs whose slot order depends on thread timing."""
    if by_key:
        got = sorted(got, key=lambda m: (m.name, tuple(m.tags)))
        want = sorted(want, key=lambda m: (m.name, tuple(m.tags)))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert (g.name, g.tags, g.type, g.message, g.hostname, g.sinks,
                g.timestamp) == (w.name, w.tags, w.type, w.message,
                                 w.hostname, w.sinks, w.timestamp)
        tail = g.name.rsplit(".", 1)[-1]
        if tail.endswith("percentile") or tail == "median":
            np.testing.assert_allclose(g.value, w.value, rtol=2e-5,
                                       atol=2e-5, err_msg=g.name)
        elif g.name.startswith("s."):
            np.testing.assert_allclose(g.value, w.value, rtol=set_rtol,
                                       atol=0, err_msg=g.name)
        else:
            assert g.value == w.value, (g.name, g.value, w.value)


def _assert_counts(tagg, jagg):
    for attr in ("processed", "dropped_capacity", "steps_total",
                 "h2d_bytes"):
        assert getattr(tagg, attr) == getattr(jagg, attr), attr
    assert tagg.extra_parse_errors() == jagg.extra_parse_errors()


def test_batch_spec_and_packed_sizes_match_jax():
    assert TBatchSpec() == TBatchSpec(**JBatchSpec().__dict__)
    jagg, tagg = _pair()
    assert tagg._pk_sizes == jagg._pk_sizes
    assert np.array_equal(tagg._pk_offs, jagg._pk_offs)
    for jb, tb in zip(jagg._pk_bufs, tagg._pk_bufs):
        assert tb.array.tobytes() == jb.tobytes()


def test_packed_buffer_equals_jax_word_for_word_at_every_emit():
    """(a) the engine copy, the lane offsets, the sentinel restore and the
    control word, over shrinking waves (compaction every 2nd step)."""
    jagg, tagg = _pair()
    emits = 0
    for wave in _parity_waves() * 2:
        for data in (wave, wave[:len(wave) // 3]):
            jagg.feed(data)
            tagg.feed(data)
            before = tagg.steps_total
            jagg._emit_native()
            tagg._emit_native()
            assert tagg.steps_total == jagg.steps_total
            if tagg.steps_total > before:
                emits += 1
                got, want = _last_buffer(tagg), _last_buffer(jagg)
                assert got.dtype == want.dtype == np.int32
                assert np.array_equal(got, want), f"emit {emits}"
    assert emits >= 12
    assert tagg.steps_total % 2 == 0      # the last emit compacted
    _assert_counts(tagg, jagg)


def test_state_leaves_after_swap_match_jax():
    """(b) byte-equal but the digest cells (C-watch 3)."""
    jagg, tagg = _pair()
    for wave in _parity_waves():
        jagg.feed(wave)
        tagg.feed(wave)
        jagg._emit_native()
        tagg._emit_native()
    jst, _ = jagg.swap()
    tst, ttable = tagg.swap()
    want = {k: np.asarray(v) for k, v in jst._asdict().items()}
    got = convert.state_to_numpy(tst)
    assert list(got) == list(want)
    for name in want:
        if name in DIGEST_CELLS:
            np.testing.assert_allclose(got[name].sum(-1),
                                       want[name].sum(-1), rtol=1e-6)
            continue
        assert got[name].dtype == want[name].dtype, name
        assert np.array_equal(got[name], want[name], equal_nan=True), name
    assert len(ttable.get_meta("counter")) == 40


@pytest.mark.parametrize("seed", [11, 12])
def test_flush_matches_jax_native(seed):
    """(c) the slice test's traffic (bad lines, capacity drops) as
    datagrams through feed on both packages."""
    jagg, tagg = _pair()
    for data in _datagrams(_lines(seed)):
        assert jagg.feed(data) == tagg.feed(data) == []
    want = _flush(jagg, jgen)
    got = _flush(tagg, tgen)
    _assert_counts(tagg, jagg)
    assert tagg.dropped_capacity > 0 and tagg.extra_parse_errors() > 0
    assert tagg.steps_total >= 8
    _assert_same_intermetrics(got, want, set_rtol=1e-6)


def test_native_path_matches_the_ports_python_path():
    """(d) the same lines through the engine and through parse_metric +
    the Python Aggregator of the port: the same InterMetrics and counts."""
    lines = _lines(13)
    _, nat = _pair()
    py = TAggregator(tstate_mod.TableSpec(**SPEC_KW), TBatchSpec(**BATCH_KW),
                     device="cpu", compact_every=2)
    errors = 0
    for line in lines:
        try:
            py.process_metric(tparse(line))
        except (ParseError, ValueError):
            errors += 1
    for data in _datagrams(lines):
        nat.feed(data)
    want = _flush(py, tgen)
    got = _flush(nat, tgen)
    assert (nat.processed, nat.dropped_capacity, nat.extra_parse_errors()) \
        == (py.processed, py.dropped_capacity, errors)
    assert nat.steps_total == py.steps_total
    _assert_same_intermetrics(got, want)


def _stat_lanes(rng, spec, b=48, negative=False):
    """Histo-stat lanes: duplicate slots (the reciprocal adds then depend
    on row order), sentinel rows (slot == capacity), overflow rows and,
    when asked, negative slots."""
    kh = spec.histo_capacity
    slot = rng.integers(0, 6, b).astype(np.int32)
    slot[rng.integers(0, b, 6)] = kh
    slot[rng.integers(0, b, 3)] = kh + 5
    if negative:
        slot[rng.integers(0, b, 4)] = -1
    mn = rng.lognormal(0.0, 1.0, b).astype(np.float32)
    return dict(histo_stat_slot=slot, histo_stat_min=mn,
                histo_stat_max=(mn + rng.uniform(0, 9, b)).astype(np.float32),
                histo_stat_recip=rng.uniform(0.01, 3.0, b).astype(np.float32))


def _tbatch(batch):
    return tstep.Batch(*[None if a is None else torch.from_numpy(np.array(a))
                         for a in batch])


def test_ingest_core_histo_stat_lanes_match_jax_byte_exact(monkeypatch):
    """(e) against JAX `ingest_core` with its Pallas kernel in interpret
    mode: every leaf the lanes touch (and the rest of the exact ones)
    byte-exact over three batches, duplicate slots and sentinel rows
    included."""
    monkeypatch.setattr(jpi, "_OVERRIDE", True)
    kw = dict(counter_capacity=64, gauge_capacity=32, status_capacity=8,
              set_capacity=16, histo_capacity=32, hll_precision=8,
              temp_cells=16)
    jspec, tspec = jstate_mod.TableSpec(**kw), tstate_mod.TableSpec(**kw)
    rng = np.random.default_rng(5)
    jst = jstate_mod.empty_state(jspec)
    tst = tstate_mod.empty_state(tspec, "cpu")
    for _ in range(3):
        batch = _rand_batch(rng, jspec, b=64)._replace(
            **_stat_lanes(rng, jspec))
        jst = jstep.ingest_core(jst, batch, spec=jspec)
        tstep.ingest_core(tst, _tbatch(batch), spec=tspec)
        got = convert.state_to_numpy(tst)
        want = {k: np.asarray(v) for k, v in jst._asdict().items()}
        for name in EXACT_LEAVES + ("h_temp_n",):
            assert np.array_equal(got[name], want[name], equal_nan=True), \
                name
    assert np.isfinite(got["h_min"][:6]).all()


def test_ingest_core_drops_negative_histo_stat_slots():
    """(e) a negative slot is dropped (the fused path's rule; ROADMAP
    C-watch 1 keeps the JAX chain's wrap out of the port's tests): the
    state is what the same batch gives with those rows as sentinels."""
    spec = tstate_mod.TableSpec(**SPEC_KW)
    rng = np.random.default_rng(6)
    batch = _rand_batch(rng, spec, b=32, negative=False)._replace(
        **_stat_lanes(rng, spec, negative=True))
    neg = batch.histo_stat_slot < 0
    assert neg.any()
    clean = batch._replace(histo_stat_slot=np.where(
        neg, spec.histo_capacity, batch.histo_stat_slot).astype(np.int32))
    a = tstep.ingest_core(tstate_mod.empty_state(spec, "cpu"), _tbatch(batch),
                          spec=spec)
    b = tstep.ingest_core(tstate_mod.empty_state(spec, "cpu"), _tbatch(clean),
                          spec=spec)
    for x, y in zip(convert.state_to_numpy(a).values(),
                    convert.state_to_numpy(b).values()):
        assert x.tobytes() == y.tobytes()
    assert convert.state_to_numpy(a)["h_max"][-1] == -np.inf


def test_packed_rings_core_matches_jax():
    """(f) three rows a step, the compaction flag on every second step:
    the JAX program's order (row 0, its compaction, then rows 1-2) on the
    exact leaves, and the digests through their quantiles."""
    jspec = jstate_mod.TableSpec(**SPEC_KW)
    tspec = tstate_mod.TableSpec(**SPEC_KW)
    rng = np.random.default_rng(7)
    jst = jstate_mod.empty_state(jspec)
    tst = tstate_mod.empty_state(tspec, "cpu")
    qs = np.asarray([0.01, 0.5, 0.9, 0.99], np.float32)
    for step in range(4):
        do_compact = step % 2 == 1
        rows = [_rand_batch(rng, jspec, b=96, negative=False)._replace(
            **_stat_lanes(rng, jspec, b=24)) for _ in range(3)]
        sizes = jstep.batch_sizes(rows[0])
        arena = np.stack([jstep.pack_batch(r, do_compact and i == 0)
                          for i, r in enumerate(rows)])
        jst = jstep.ingest_step_packed_rings(jst, arena, spec=jspec,
                                             sizes=sizes)
        tstep.packed_rings_core(tst, torch.from_numpy(arena.copy()),
                                spec=tspec, sizes=sizes,
                                do_compact=do_compact)
        got = convert.state_to_numpy(tst)
        want = {k: np.asarray(v) for k, v in jst._asdict().items()}
        for name in EXACT_LEAVES + ("h_temp_n",):
            assert np.array_equal(got[name], want[name], equal_nan=True), \
                (step, name)
        gq, wq = _row_quantiles(got, qs), _row_quantiles(want, qs)
        assert np.array_equal(np.isnan(gq), np.isnan(wq))
        live = ~np.isnan(wq)
        np.testing.assert_allclose(gq[live], wq[live], rtol=2e-5, atol=2e-5)


def _wait(cond, what, timeout=30.0):
    t0 = time.time()
    while not cond():
        if time.time() - t0 > timeout:
            raise TimeoutError(what)
        time.sleep(0.005)


def _lines_seen(agg) -> int:
    """Lines the engine has parsed: processed, refused, or dropped at
    capacity."""
    st = agg.eng.stats()
    return st["processed"] + st["parse_errors"] + st["dropped"]


def _ring_waves(agg, waves, n_rings):
    """Each wave's datagrams onto the rings (a key's lines always on one
    ring, so each key's order is fixed), wait until the ring workers have
    parsed all of them, then pump: one step a wave, whatever the
    threads' timing."""
    sent = 0
    for wave in waves:
        for ring, data in wave:
            assert agg.eng.rings_inject(ring % n_rings, data) == INJECT_OK
            sent += data.count(b"\n") + 1
        _wait(lambda: _lines_seen(agg) >= sent,
              "ring workers did not parse every line")
        before = agg.steps_total
        agg.pump(0)
        assert agg.steps_total == before + 1


def _keyed_waves(seed, n_waves=4):
    """Per wave, each ring's lines as one datagram: counters, gauges,
    timers, histograms with sample rates, sets and bad lines over keys
    that fit the tables (with rings, which key a full table turns away
    depends on which ring keys first), each key's lines on one ring (by
    its name), and few enough that no ring's staging fills in a wave."""
    rng = np.random.default_rng(seed)
    waves = []
    for _ in range(n_waves):
        by_ring = {0: [], 1: [], 2: []}
        for _ in range(150):
            k = rng.integers(0, 6)
            if k == 0:
                line = b"rc.%d:%d|c|@0.5|#env:prod" % (
                    rng.integers(0, 40), rng.integers(1, 9))
            elif k == 1:
                line = b"rg.%d:%.3f|g" % (rng.integers(0, 20), rng.normal())
            elif k == 2:
                line = b"rt.%d:%.4f|ms" % (min(rng.zipf(1.5), 15),
                                          rng.lognormal(3.0, 1.0))
            elif k == 3:
                line = b"s.%d:user-%d|s" % (rng.integers(0, 10),
                                            rng.integers(0, 500))
            elif k == 4:
                line = b"rh.%d:%.2f|h|@0.25" % (rng.integers(0, 6),
                                                rng.uniform(0, 500))
            else:
                line = rng.choice([b"bad line", b"x:1|q", b"y:nan|g"])
            name = line.split(b":", 1)[0]
            by_ring[sum(name) % 3].append(line)
        waves.append([(r, b"\n".join(ls)) for r, ls in by_ring.items()
                      if ls])
    return waves


def test_rings_inject_and_pump_flush_matches_jax():
    """(f) rings_start(3) + rings_inject + pump on both packages: the same
    InterMetrics by key, and the same counts."""
    jagg, tagg = _pair()
    waves = _keyed_waves(8)
    out = []
    for agg, gen in ((jagg, jgen), (tagg, tgen)):
        agg.rings_start(3)
        try:
            _ring_waves(agg, waves, 3)
            out.append(_flush(agg, gen))
            stats = agg.ring_stats_per_ring()
        finally:
            agg.readers_stop()
    _assert_counts(tagg, jagg)
    assert tagg.steps_total == len(waves) and tagg.dropped_capacity == 0
    assert [s["datagrams"] for s in stats] == [len(waves)] * 3
    assert all(s["emit_packed_calls"] > 0 for s in stats)
    _assert_same_intermetrics(out[1], out[0], by_key=True, set_rtol=1e-6)


def test_udp_readers_lossless_and_flush_what_feed_flushes():
    """(g) loopback datagrams through readers_start + pump: every one
    received and counted, nothing dropped in the ring, and the flush
    equals feed's on the same datagrams (one reader keeps their order)."""
    datagrams = _datagrams(_lines(14))
    lines = sum(d.count(b"\n") + 1 for d in datagrams)
    _, udp = _pair()
    rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rx.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 1 << 20)
    rx.bind(("127.0.0.1", 0))
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        udp.readers_start([rx.fileno()])
        for i in range(0, len(datagrams), 16):
            # paced: 16 datagrams, then wait until the reader has them
            for d in datagrams[i:i + 16]:
                tx.sendto(d, rx.getsockname())
            sent = min(i + 16, len(datagrams))
            _wait(lambda: udp.reader_counters()["datagrams"] >= sent,
                  "reader did not receive every datagram")
            udp.pump(0)

        def parsed():
            udp.pump(1)
            return _lines_seen(udp) >= lines
        _wait(parsed, "pump did not parse every line")
        counters = udp.reader_counters()
        got = _flush(udp, tgen)
    finally:
        udp.readers_stop()
        rx.close()
        tx.close()
    assert counters["datagrams"] == len(datagrams)
    assert counters["ring_dropped"] == 0 and counters["toolong"] == 0
    _, fed = _pair()
    for d in datagrams:
        fed.feed(d)
    want = _flush(fed, tgen)
    assert (udp.processed, udp.dropped_capacity, udp.extra_parse_errors(),
            udp.steps_total) == (fed.processed, fed.dropped_capacity,
                                 fed.extra_parse_errors(), fed.steps_total)
    _assert_same_intermetrics(got, want)


def test_no_card_raises():
    """(h) an entry point with no device means the card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TNativeAggregator(tstate_mod.TableSpec(**SPEC_KW))
