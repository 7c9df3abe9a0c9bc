"""The port's history tier against the JAX package, on the CPU.

The same numpy inputs, made from a seed, go through both packages:

1. kernel K3's plain version (ops/cuda_history.py) byte-exact against
   the XLA chain `_merge_windows_xla` and the Pallas kernel in interpret
   mode: p in {10, 14}, ragged N and W, an all-zero row, a step that
   selects nothing, NaN and negative mask entries, registers over 0..63;
   and its row-index form against `_take` then the same two, repeated
   and clamped indices included, on a ring of 12,300 columns at p = 4;
2. `HistorySpec` geometry and the empty ring, byte for byte;
3. archived frames replayed through `record_frame` into a JAX and a port
   writer over enough intervals to roll every tier, with evictions and
   row wipes: every ring field byte-exact except the centroid means
   (held through the range quantiles), `read_values` and `plan_range`
   equal;
4. the range program and `query_combined`: counters, gauges, status,
   histogram min/max/count/sum byte-exact, set estimates within rtol
   1e-6, histogram quantiles within rtol/atol 2e-5 (the K2 tolerance);
5. inside the port, the ring the fused flush fills is bit-identical to
   a replay of the archived frames into a fresh writer;
6. the whole slice, DogStatsD lines -> Aggregator.compute_flush(
   history=...) -> range batch, against the JAX package;
7. writer snapshots restore across the packages in both directions;
8. a writer without a device needs the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_slice import BATCH_KW, SPEC_KW, _lines
from veneur_tpu.aggregation import state as jstate_mod
from veneur_tpu.aggregation import step as jstep
from veneur_tpu.aggregation.host import BatchSpec as JBatchSpec
from veneur_tpu.history import device as jhdev
from veneur_tpu.history import merge as jmerge
from veneur_tpu.history.spec import HistorySpec as JHistorySpec
from veneur_tpu.history.writer import HistoryWriter as JWriter
from veneur_tpu.ops import pallas_history
from veneur_tpu.samplers.parser import parse_metric as jparse
from veneur_tpu.server.aggregator import Aggregator as JAggregator
from veneur_tpu_torch import convert
from veneur_tpu_torch.aggregation import state as tstate_mod
from veneur_tpu_torch.aggregation import step as tstep
from veneur_tpu_torch.aggregation.host import BatchSpec as TBatchSpec
from veneur_tpu_torch.history import device as thdev
from veneur_tpu_torch.history import merge as tmerge
from veneur_tpu_torch.history.spec import HistorySpec as THistorySpec
from veneur_tpu_torch.history.writer import HistoryWriter as TWriter
from veneur_tpu_torch.ops import cuda_digest, cuda_history, hll
from veneur_tpu_torch.samplers.parser import parse_metric as tparse
from veneur_tpu_torch.server.aggregator import Aggregator as TAggregator

PERC = [0.5, 0.9, 0.99]
RING_KW = dict(windows=4, tiers=2, counter_rows=64, gauge_rows=64,
               status_rows=64, set_rows=4, histo_rows=64, hll_precision=10)
TOLERANT = {"r_histo_quantiles": 2e-5, "r_set_estimate": 1e-6}


class _Meta:
    def __init__(self, kind, name, tags=""):
        self.kind, self.name, self.joined_tags = kind, name, tags


class _Table:
    """Stand-in for KeyTable: get_meta(kind) in flush order."""

    def __init__(self, by_kind):
        self._by_kind = by_kind

    def get_meta(self, kind):
        return list(enumerate(self._by_kind.get(kind, [])))


# -- 1. kernel K3 ------------------------------------------------------------

@pytest.mark.parametrize("p,n,w,s", [(10, 5, 7, 3), (10, 9, 13, 6),
                                     (14, 3, 11, 5), (14, 7, 17, 4)])
def test_k3_plain_matches_xla_and_pallas_byte_exact(p, n, w, s):
    rng = np.random.default_rng(100 * p + n)
    regs = rng.integers(0, 64, (n, w, 1 << p)).astype(np.uint8)
    regs[0] = 0                                   # all-zero row
    regs[-1, :, ::7] = 63                         # every field's top value
    rows = hll.pack_registers_np(regs, p)
    sel = rng.integers(0, 2, (s, w)).astype(np.float32)
    sel[1] = 0.0                                  # selects nothing
    sel[0, 0], sel[-1, -1] = np.nan, -1.0         # never selected
    sel[2, :] = 1.0                               # every column
    want = np.asarray(jmerge._merge_windows_xla(
        jnp.asarray(rows), jnp.asarray(sel), precision=p))
    pal = np.asarray(pallas_history.merge_windows_packed(
        jnp.asarray(rows), jnp.asarray(sel), precision=p, interpret=True))
    got = cuda_history.merge_windows_packed(
        torch.from_numpy(rows), torch.from_numpy(sel), precision=p).numpy()
    assert got.dtype == np.int32 and got.shape == (n, s, rows.shape[-1])
    assert got.tobytes() == want.tobytes() == pal.tobytes()
    assert not got[:, 1].any() and not got[0].any()
    dense = hll.unpack_registers_np(got, p)
    np.testing.assert_array_equal(dense[:, 2], regs.max(axis=1))


@pytest.mark.parametrize("p,r,w,s", [
    (10, 6, 9, 4), (14, 5, 13, 5),
    (4, 3, 12_300, 3)])     # many of the kernel's 512-column chunks
def test_k3_plain_with_row_index_matches_take_then_merge(p, r, w, s):
    """K3's row-index form: the plain version with idx (repeated rows,
    and indices below 0 and past the ring, which clamp) against the
    range program's gather (`_take`, mode="clip") followed by the XLA
    chain and the Pallas kernel in interpret mode, byte-exact."""
    rng = np.random.default_rng(10 * p + r)
    regs = rng.integers(0, 64, (r, w, 1 << p)).astype(np.uint8)
    regs[1] = 0                                   # all-zero row
    rows = hll.pack_registers_np(regs, p)
    idx = np.asarray([2, 0, 2, -5, r + 3, r - 1, 1, 0], np.int32)
    sel = (rng.uniform(size=(s, w)) < 0.2).astype(np.float32)
    sel[0] = 0.0                                  # selects nothing
    sel[1, :2] = np.nan, -1.0                     # never selected
    sel[-1] = 1.0                                 # every column
    taken = jstep._take(jnp.asarray(rows), jnp.asarray(idx))
    want = np.asarray(jmerge._merge_windows_xla(
        taken, jnp.asarray(sel), precision=p))
    got = cuda_history.merge_windows_packed(
        torch.from_numpy(rows), torch.from_numpy(sel), precision=p,
        idx=torch.from_numpy(idx)).numpy()
    assert got.shape == (idx.size, s, rows.shape[-1])
    pal = np.asarray(pallas_history.merge_windows_packed(
        taken, jnp.asarray(sel), precision=p, interpret=True))
    assert got.tobytes() == want.tobytes() == pal.tobytes()
    assert not got[:, 0].any()
    clamped = np.clip(idx, 0, r - 1)
    np.testing.assert_array_equal(hll.unpack_registers_np(got[:, -1], p),
                                  regs[clamped].max(axis=1))


# -- 2. geometry ---------------------------------------------------------------

@pytest.mark.parametrize("kw", [SPEC_KW, {}], ids=["small", "default"])
def test_history_spec_geometry_matches_jax(kw):
    tspec = THistorySpec.for_table(tstate_mod.TableSpec(**kw), windows=6,
                                   tiers=2, max_keys=1 << 20)
    jspec = JHistorySpec.for_table(jstate_mod.TableSpec(**kw), windows=6,
                                   tiers=2, max_keys=1 << 20)
    assert tspec.to_dict() == jspec.to_dict()
    assert THistorySpec.from_dict(jspec.to_dict()) == tspec
    for attr in ("total_cols", "centroids", "hll_words", "span_intervals"):
        assert getattr(tspec, attr) == getattr(jspec, attr), attr
    assert [tspec.rows_for(k) for k in range(5)] == \
        [jspec.rows_for(k) for k in range(5)]
    assert tspec.hbm_bytes() == jspec.hbm_bytes()
    small = THistorySpec(**RING_KW)
    ring = thdev.empty_history(small, "cpu")
    assert sum(t.numel() * t.element_size() for t in ring) == \
        small.hbm_bytes()
    assert list(ring._fields) == list(jhdev.HISTORY_FIELDS)
    want = jhdev.empty_history(JHistorySpec(**RING_KW))
    for name, t in convert.history_to_numpy(ring).items():
        assert t.tobytes() == np.asarray(getattr(want, name)).tobytes(), name


# -- 3/4. replayed frames and the range program --------------------------------

def _frame(rng, spec, seq, cells=40):
    """(table, result, raw) of one archived interval over every kind.
    Key sets drift with seq so rows are admitted, evicted and wiped; the
    digest weights are integers (1/rate), as ingest gives them."""
    def names(prefix, universe, n):
        pick = rng.choice(universe, size=n, replace=False)
        return [f"{prefix}.{i}" for i in sorted(pick)]

    by = {"counter": [_Meta("counter", n, "a:1" if n.endswith("3") else "")
                      for n in names("c", 50, 30)],
          "gauge": [_Meta("gauge", n) for n in names("g", 30, 12)],
          "status": [_Meta("status", n) for n in names("st", 8, 3)],
          "set": [_Meta("set", n) for n in names("s", 6, 3 + seq % 2)],
          "histogram": [_Meta("histogram", n) for n in names("h", 20, 9)]}
    nc, ng, nst = len(by["counter"]), len(by["gauge"]), len(by["status"])
    ns, nh = len(by["set"]), len(by["histogram"])
    regs = rng.integers(0, 30, (ns, 1 << spec.hll_precision)).astype(
        np.uint8)
    regs[:, rng.uniform(size=regs.shape[1]) < 0.7] = 0
    mean = rng.lognormal(3.0, 1.0, (nh, cells)).astype(np.float32)
    weight = rng.integers(1, 4, (nh, cells)).astype(np.float32)
    weight[rng.uniform(size=(nh, cells)) < 0.3] = 0.0
    live = weight > 0
    gauge = rng.normal(size=ng).astype(np.float32)
    gauge[::5] = np.nan                           # a key with no write
    result = {
        "counter": rng.integers(-50, 5000, nc).astype(np.float64) * 0.25,
        "status": rng.integers(0, 3, nst).astype(np.float32),
        "histo_count": weight.sum(-1).astype(np.float64),
        "histo_sum": (weight.astype(np.float64) * mean).sum(-1),
    }
    raw = {
        "gauge": gauge,
        "hll": hll.pack_registers_np(regs, spec.hll_precision),
        "h_mean": mean, "h_weight": weight,
        "h_min": np.where(live, mean, np.inf).min(-1).astype(np.float32),
        "h_max": np.where(live, mean, -np.inf).max(-1).astype(np.float32),
    }
    return _Table(by), result, raw


def _writers(n_frames=17, seed=21):
    """A JAX and a port writer fed the same frames (17 intervals: tier 1
    rolls 8 times and wraps, tier 2 fills its 4 windows, tier 0 wraps
    four times)."""
    jspec, tspec = JHistorySpec(**RING_KW), THistorySpec(**RING_KW)
    jw = JWriter(jspec, interval_s=10.0)
    tw = TWriter(tspec, interval_s=10.0, device="cpu")
    rng = np.random.default_rng(seed)
    for seq in range(n_frames):
        table, result, raw = _frame(rng, tspec, seq)
        ts = 1000.0 + 10.0 * seq
        jw.record_frame(table, result, raw, ts=ts)
        tw.record_frame(table, result, raw, ts=ts)
    return jw, tw


def _batch(wr, ranges):
    """A range batch the way the query engine builds one: each (range,
    window, step) spec planned once, the step masks concatenated, every
    ring key gathered."""
    need = [[] for _ in range(5)]
    for k, _key, row in sorted(wr.iter_keys(), key=lambda e: (e[0], e[2])):
        need[k].append(row)
    sels, rank = [], None
    for r, win, st in ranges:
        plan = wr.plan_range(r, win, st, jmerge.MAX_STEPS)
        sels.append(plan.sel)
        rank = plan.rank
    return need, np.concatenate(sels), rank


def _range(mod, step_mod, wr, packed_inputs, to_dev):
    flat, n_q, n_steps, buckets, _qcol = packed_inputs
    hist = wr.acquire_read()
    try:
        packed = mod.range_in_packed(hist, to_dev(flat), hspec=wr.spec,
                                     n_q=n_q, n_steps=n_steps,
                                     buckets=buckets)
    finally:
        wr.release_read()
    packed = (packed.numpy() if isinstance(packed, torch.Tensor)
              else np.asarray(packed))
    return step_mod.unpack_flush(packed, mod.range_shapes(
        wr.spec, buckets, n_steps, n_q))


def _run_both(jw, tw, ranges, qs=(0.5, 0.9, 0.99)):
    need, sel, rank = _batch(tw, ranges)
    assert need == _batch(jw, ranges)[0]
    ins = tmerge.pack_range_inputs(tw.spec, need, sel, rank, set(qs))
    jins = jmerge.pack_range_inputs(jw.spec, need, sel, rank, set(qs))
    assert ins[0].tobytes() == jins[0].tobytes() and ins[1:] == jins[1:]
    got = _range(tmerge, tstep, tw, ins,
                 lambda a: torch.from_numpy(a.copy()))
    want = _range(jmerge, jstep, jw, jins, jnp.asarray)
    return got, want


def _assert_range_equal(got, want):
    assert list(got) == list(want)
    for key in got:
        a, b = np.asarray(got[key]), np.asarray(want[key])
        assert a.shape == b.shape, key
        if key in TOLERANT:
            assert np.array_equal(np.isnan(a), np.isnan(b)), key
            live = ~np.isnan(b)
            tol = TOLERANT[key]
            np.testing.assert_allclose(a[live], b[live], rtol=tol,
                                       atol=tol if "histo" in key else 0,
                                       err_msg=key)
        else:
            assert a.tobytes() == b.tobytes(), f"{key} differs"
    assert np.isfinite(got["r_histo_quantiles"]).any()
    assert (np.asarray(got["r_set_estimate"]) > 0).any()
    assert np.isfinite(got["r_gauge"]).any()


RANGES = [(40.0, None, 10.0), (160.0, 40.0, 20.0), (160.0, None, None),
          (30.0, 20.0, None)]


@pytest.fixture(scope="module")
def fed():
    return _writers()


def test_replayed_rings_match_jax(fed):
    jw, tw = fed
    js, ts = jw.snapshot(), tw.snapshot()
    assert ts["meta"] == js["meta"]
    for name, a in ts["arrays"].items():
        b = js["arrays"][name]
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if name == "h_mean":
            continue                              # held via quantiles
        assert a.tobytes() == b.tobytes(), f"ring field {name} differs"
    assert ts["arrays"]["hll"].any() and np.isfinite(
        ts["arrays"]["gauge"]).any()
    # every tier was written, and a set row was wiped and reused
    assert all(m is not None for m in ts["meta"]["cols"])
    assert len(ts["meta"]["keys"][3]) == RING_KW["set_rows"]
    rows = [(k, row) for k, _key, row in tw.iter_keys() if k <= 2]
    for seq in (tw.seq - 1, tw.seq - 3, 0):
        got, want = tw.read_values(seq, rows), jw.read_values(seq, rows)
        assert got.tobytes() == want.tobytes()
    for r, win, st in RANGES + [(1e6, None, 10.0)]:
        a = tw.plan_range(r, win, st, jmerge.MAX_STEPS)
        b = jw.plan_range(r, win, st, jmerge.MAX_STEPS)
        assert a.sel.tobytes() == b.sel.tobytes()
        assert a.rank.tobytes() == b.rank.tobytes()
        assert a.steps == b.steps


def test_range_program_matches_jax(fed):
    jw, tw = fed
    got, want = _run_both(jw, tw, RANGES)
    _assert_range_equal(got, want)


def test_range_quantiles_in_one_call_equal_the_per_step_calls(fed,
                                                               monkeypatch):
    """The range program hands every step's compressed digests to K2 in
    one call; each step's rows of it are the bytes a call per step gives."""
    _jw, tw = fed
    calls = []
    one_call = cuda_digest.quantiles_rows

    def record(*args):
        calls.append((args, one_call(*args)))
        return calls[-1][1]
    monkeypatch.setattr(cuda_digest, "quantiles_rows", record)
    need, sel, rank = _batch(tw, RANGES)
    ins = tmerge.pack_range_inputs(tw.spec, need, sel, rank, {0.5, 0.99})
    got = _range(tmerge, tstep, tw, ins, lambda a: torch.from_numpy(a.copy()))
    assert len(calls) == 1
    (mean, weight, mn, mx, qs), out = calls[0]
    n_steps, bh = ins[2], ins[3][4]            # steps, histogram rows
    assert len(need[4]) > 0 and mean.shape[0] == bh * n_steps

    def steps(a):                              # [bh * S, ...] -> [bh, S, ...]
        return a.reshape(bh, n_steps, *a.shape[1:])
    for i in range(n_steps):
        per_step = one_call(*(steps(a)[:, i].contiguous() for a in
                              (mean, weight, mn, mx)), qs)
        assert per_step.numpy().tobytes() == \
            steps(out)[:, i].contiguous().numpy().tobytes(), i
    assert got["r_histo_quantiles"].tobytes() == steps(out).numpy().tobytes()


def _live_flat(spec, table, step_mod, perc):
    slots = [step_mod.live_slots(table, k) for k in
             ("counter", "gauge", "status", "set", "histogram")]
    caps = (spec.counter_capacity, spec.gauge_capacity,
            spec.status_capacity, spec.set_capacity, spec.histo_capacity)
    buckets = tuple(step_mod.pad_bucket(len(s), c)
                    for s, c in zip(slots, caps))
    return (step_mod.pack_flush_inputs(
        perc, step_mod.pack_bucket_chunks(slots, buckets, 0)), buckets)


# -- 5/6/7. the fused flush, the slice, snapshots --------------------------------

class _SyncedJAggregator(JAggregator):
    """The JAX Aggregator, waiting for each step (see test_torch_slice)."""

    def _on_batch(self, batch):
        super()._on_batch(batch)
        jax.block_until_ready(self.state)


def _intervals(n, seed=30, per=400):
    return [_lines(seed + i, per) for i in range(n)]


def _drive(agg, parse, writer, intervals, frames=None):
    for i, lines in enumerate(intervals):
        for line in lines:
            try:
                m = parse(line)
            except ValueError:
                continue
            agg.process_metric(m)
        state, table = agg.swap()
        res, table, raw = agg.compute_flush(state, table, PERC,
                                            want_raw=True, history=writer)
        if frames is not None:
            frames.append((table, {k: np.copy(v) for k, v in res.items()},
                           {k: np.copy(v) for k, v in raw.items()}))
    return agg


def _ring_spec(mod, tspec_mod):
    return mod.for_table(tspec_mod.TableSpec(**SPEC_KW), windows=4,
                         tiers=2)


def test_fused_flush_ring_equals_replay():
    hspec = _ring_spec(THistorySpec, tstate_mod)
    wr = TWriter(hspec, interval_s=10.0, device="cpu")
    agg = TAggregator(tstate_mod.TableSpec(**SPEC_KW),
                      TBatchSpec(**BATCH_KW), device="cpu", compact_every=2)
    frames = []
    _drive(agg, tparse, wr, _intervals(9), frames)
    replay = TWriter(hspec, interval_s=10.0, device="cpu")
    for table, res, raw in frames:
        replay.record_frame(table, res, raw)
    a, b = wr.snapshot(), replay.snapshot()
    assert a["meta"]["keys"] == b["meta"]["keys"]
    assert a["meta"]["seq"] == b["meta"]["seq"] == 9
    for name in thdev.HISTORY_FIELDS:
        x, y = a["arrays"][name], b["arrays"][name]
        assert x.view(np.int32).tobytes() == y.view(np.int32).tobytes(), \
            f"fused ring field {name} differs from the replay"
    assert a["arrays"]["h_weight"].any() and a["arrays"]["hll"].any()


def test_slice_range_answers_match_jax():
    intervals = _intervals(8, seed=50)
    jhspec = _ring_spec(JHistorySpec, jstate_mod)
    thspec = _ring_spec(THistorySpec, tstate_mod)
    jw = JWriter(jhspec, interval_s=10.0)
    tw = TWriter(thspec, interval_s=10.0, device="cpu")
    jagg = _drive(_SyncedJAggregator(jstate_mod.TableSpec(**SPEC_KW),
                                     JBatchSpec(**BATCH_KW), compact_every=2),
                  jparse, jw, intervals)
    tagg = _drive(TAggregator(tstate_mod.TableSpec(**SPEC_KW),
                              TBatchSpec(**BATCH_KW), device="cpu",
                              compact_every=2),
                  tparse, tw, intervals)
    assert tw.iter_keys() == jw.iter_keys()
    got, want = _run_both(jw, tw, [(80.0, None, 10.0), (80.0, 40.0, 20.0),
                                   (1e6, None, None)])
    _assert_range_equal(got, want)

    # one more interval's live state, asked together with the range batch
    for line in _lines(99, 300):
        for agg, parse in ((jagg, jparse), (tagg, tparse)):
            try:
                agg.process_metric(parse(line))
            except ValueError:
                pass
    jstate, jtable = jagg.swap()
    tstate, ttable = tagg.swap()
    jspec, tspec = jagg.spec, tagg.spec
    flat, buckets = _live_flat(tspec, ttable, tstep, PERC)
    need, sel, rank = _batch(tw, [(40.0, None, 10.0)])
    hin = tmerge.pack_range_inputs(thspec, need, sel, rank, set(PERC))
    hflat, hn_q, hsteps, hbuckets, _ = hin
    t_inst, t_rng = tmerge.query_combined(
        tstate, torch.from_numpy(flat.copy()), tw.acquire_read(),
        torch.from_numpy(hflat.copy()), spec=tspec, n_q=len(PERC),
        buckets=buckets, hspec=thspec, hn_q=hn_q, hsteps=hsteps,
        hbuckets=hbuckets)
    tw.release_read()
    j_inst, j_rng = jmerge.query_combined(
        jstate, jnp.asarray(flat), jw.acquire_read(), jnp.asarray(hflat),
        spec=jspec, n_q=len(PERC), buckets=buckets, hspec=jhspec, hn_q=hn_q,
        hsteps=hsteps, hbuckets=hbuckets)
    jw.release_read()
    shapes = tmerge.range_shapes(thspec, hbuckets, hsteps, hn_q)
    _assert_range_equal(tstep.unpack_flush(t_rng.numpy(), shapes),
                        jstep.unpack_flush(np.asarray(j_rng), shapes))
    fshapes = tstep.flush_live_shapes(tspec, *buckets, len(PERC))
    a = tstep.unpack_flush(t_inst.numpy(), fshapes)
    b = jstep.unpack_flush(np.asarray(j_inst), fshapes)
    for key in a:
        if key in ("histo_quantiles", "histo_median"):
            np.testing.assert_allclose(a[key], b[key], rtol=2e-5,
                                       atol=2e-5, err_msg=key)
        elif key == "set_estimate":
            np.testing.assert_allclose(a[key], b[key], rtol=1e-6)
        else:
            assert a[key].tobytes() == b[key].tobytes(), key


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_snapshot_restores_across_packages(fed, direction):
    jw, tw = fed
    src = jw if direction == "jax_to_port" else tw
    snap = src.snapshot()
    if direction == "jax_to_port":
        dst = TWriter(THistorySpec(**RING_KW), interval_s=10.0,
                      device="cpu")
    else:
        dst = JWriter(JHistorySpec(**RING_KW), interval_s=10.0)
    dst.restore(snap)
    back = dst.snapshot()
    assert back["meta"] == snap["meta"]
    for name, a in snap["arrays"].items():
        assert np.asarray(back["arrays"][name]).tobytes() == \
            np.asarray(a).tobytes(), name
    # the same range batch over the original and the restored ring
    pair = (src, dst) if direction == "jax_to_port" else (dst, src)
    got, want = _run_both(pair[0], pair[1], RANGES)
    _assert_range_equal(got, want)
    # restoring into a differently shaped ring keeps the fresh ring
    other = TWriter(THistorySpec(**dict(RING_KW, windows=8)),
                    interval_s=10.0, device="cpu")
    other.restore(snap)
    assert other.seq == 0 and not other.armed


def test_history_writer_without_device_needs_cuda():
    hspec = THistorySpec(**RING_KW)
    if torch.cuda.is_available():
        assert TWriter(hspec).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TWriter(hspec)
    wr = TWriter(hspec, device="cpu")
    agg = TAggregator(tstate_mod.TableSpec(**SPEC_KW), device="cpu")
    state, table = agg.swap()
    agg.device = torch.device("meta")
    with pytest.raises(ValueError, match="history ring on cpu"):
        agg.compute_flush(state, table, PERC, history=wr)
    assert wr.seq == 0
