"""The port's CUDA kernels against their plain versions, on the card.

Marked `gpu`: without a card every test here skips with a reason (the
decision is taken inside the `cuda` fixture, never at import). Run them
on a machine with an H100:

    python -m pytest -m gpu --noconftest tests/test_torch_cuda.py

(`--noconftest`: tests/conftest.py pins JAX to the CPU, and the card
machine has no JAX.)

- fused ingest (K1): byte-exact on all 14 state leaves against the plain
  version run on a CPU copy of the same streams, on Zipf batches, on
  batches where one slot takes a whole lane, and on hand-made streams
  with runs of 4,096+ entries, at the default widths (rows staged in
  shared memory) and at compression 2,400 with hll_precision 16 (rows
  walked in place); at the widest rows it stages; and it refuses,
  before any launch, streams that are not 16-byte aligned and tables
  past 32-bit offsets;
- digest quantiles (K2): within rtol/atol 2e-5 of the plain version, on
  rows staged in shared memory and on rows past 2,048 cells (global
  scratch);
- masked window merge (K3): byte-exact against the plain version, with
  and without a row index, on the 16-byte and the scalar paths and on a
  ring of more than 12,288 columns;
- the whole slice on the card against the same slice on the CPU;
- the native ingest path (NativeAggregator) on the card against the same
  run on the CPU, single-ring through `feed` and with four rings;
- the history tier on the card: the fused ring equals a replay of the
  archived frames, and a range batch matches the same batch over a CPU
  copy of the ring;
- the Server on the card against the Server on the CPU: the same
  datagrams over loopback (the C++ engine's UDP readers), the same
  flushed InterMetrics.
"""

import time

import numpy as np
import pytest
import torch

from veneur_tpu_torch import convert
from veneur_tpu_torch.aggregation import state as tstate
from veneur_tpu_torch.aggregation import step as tstep
from veneur_tpu_torch.aggregation.host import BatchSpec
from veneur_tpu_torch.history import HistorySpec, HistoryWriter
from veneur_tpu_torch.history import merge as hmerge
from veneur_tpu_torch.ops import (_build, cuda_digest, cuda_history,
                                  cuda_ingest, hll)
from veneur_tpu_torch.samplers.parser import ParseError, parse_metric
from veneur_tpu_torch.server.aggregator import Aggregator
from veneur_tpu_torch.server.flusher import generate_intermetrics
from veneur_tpu_torch.server.native_aggregator import NativeAggregator

pytestmark = pytest.mark.gpu

SPEC = tstate.TableSpec(counter_capacity=1 << 12, gauge_capacity=256,
                        status_capacity=64, set_capacity=64,
                        histo_capacity=256)
# 3,928 digest cells and 12,288 HLL words a row: K1 walks them in place
WIDE_SPEC = tstate.TableSpec(counter_capacity=1 << 12, gauge_capacity=256,
                             status_capacity=64, set_capacity=64,
                             histo_capacity=256, compression=2400.0,
                             hll_precision=16)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CPU runs the plain versions")
    return torch.device("cuda")


def _batch(rng, spec, b=2048):
    def slots(cap):
        s = rng.zipf(1.3, b).astype(np.int64) % (cap + 8) - 2
        return s.astype(np.int32)       # hot keys, negatives, overflow
    return tstep.Batch(
        counter_slot=slots(spec.counter_capacity),
        counter_inc=rng.uniform(-3, 5, b).astype(np.float32),
        gauge_slot=slots(spec.gauge_capacity),
        gauge_val=rng.normal(size=b).astype(np.float32),
        status_slot=slots(spec.status_capacity),
        status_val=rng.integers(0, 4, b).astype(np.float32),
        set_slot=slots(spec.set_capacity),
        set_reg=rng.integers(-2, spec.registers + 2, b).astype(np.int32),
        set_rho=rng.integers(0, 52, b).astype(np.uint8),
        histo_slot=slots(spec.histo_capacity),
        histo_val=rng.lognormal(2.0, 1.0, b).astype(np.float32),
        histo_wt=rng.integers(0, 3, b).astype(np.float32))


def _hot_batch(rng, spec, b=8192):
    """One histogram slot takes the whole histogram lane and one set slot
    the whole set lane."""
    return _batch(rng, spec, b)._replace(
        histo_slot=np.full(b, 7, np.int32), set_slot=np.full(b, 9, np.int32))


def _hand_streams(rng, spec):
    """Streams made by hand, as build_streams would sort them: a 5,000-entry
    counter run, a 4,096-entry gauge run, a 4,500-entry histogram run whose
    cells run backwards and interleave from both ends (with zero-weight
    entries), a 300-entry run on one 16-register group whose fields
    straddle words, and BIG tails."""
    big = np.int32(1 << 30)

    def lane(runs, tail):
        return np.concatenate([np.full(n, s, np.int32) for s, n in runs]
                              + [np.full(tail, big, np.int32)])
    c_slot = lane([(0, 3), (1, 5000), (2, 7), (40, 1)], 9)
    g_slot = lane([(3, 4096), (4, 2)], 5)
    st_slot = lane([(1, 33), (2, 1)], 3)
    s_slot = lane([(2, 300), (3, 4100), (8, 2)], 6)
    s_reg = rng.integers(0, spec.registers, s_slot.size).astype(np.int32)
    s_reg[:300] = rng.choice([0, 5, 10, 15], 300)        # group 0 of slot 2
    s_reg[300:400] = 16 * 17 + 5                          # one register
    s_rho = rng.integers(0, 62, s_slot.size).astype(np.int32)
    h_slot = lane([(1, 4500), (5, 40), (6, 1)], 11)
    n = h_slot.size
    cells = spec.total_cells
    h_cell = np.empty(n, np.int32)
    k = np.arange(4500)
    h_cell[:4500] = np.where(k % 2 == 0, (4499 - k) % (cells - 40) + 20,
                             cells - 1 - k % 16)          # down, and temp
    h_cell[4500:] = rng.integers(0, cells, n - 4500)
    h_v = rng.lognormal(2.0, 1.0, n).astype(np.float32)
    h_w = rng.integers(0, 3, n).astype(np.float32)
    h_w[::13] = 0.0
    h_rcp = np.where(h_w > 0, h_w / h_v, 0.0).astype(np.float32)
    h_tadd = (h_cell >= spec.centroids).astype(np.int32)
    arrays = (c_slot, rng.uniform(-3, 5, c_slot.size), g_slot,
              rng.normal(size=g_slot.size), st_slot,
              rng.integers(0, 4, st_slot.size), s_slot, s_reg, s_rho,
              h_slot, h_cell, h_v, h_w, h_w * h_v, h_rcp, h_tadd)
    return cuda_ingest.IngestStreams(*(
        torch.from_numpy(np.ascontiguousarray(
            a, np.int32 if name in cuda_ingest._STREAM_I32 else np.float32))
        for name, a in zip(cuda_ingest.IngestStreams._fields, arrays)))


def _ingest_byte_exact(cuda, spec, case):
    """Four batches of `case` through K1 and through the plain version on
    a CPU copy of the same state and streams: every leaf byte-equal, one
    launch of the kernel the spec's widths pick."""
    wide = cuda_ingest.rows_in_place(spec)
    rng = np.random.default_rng(0)
    gpu = tstate.empty_state(spec, cuda)
    for _ in range(4):
        if case == "hand":
            streams = cuda_ingest.IngestStreams(
                *(t.to(cuda) for t in _hand_streams(rng, spec)))
        else:
            make = _batch if case == "zipf" else _hot_batch
            batch = tstep.Batch(*(None if a is None else
                                  torch.from_numpy(a).to(cuda)
                                  for a in make(rng, spec)))
            streams = tstep.build_streams(gpu, batch, spec)
        cpu = convert.state_from_numpy(convert.state_to_numpy(gpu), "cpu")
        before = (cuda_ingest.launches, cuda_ingest.wide_launches)
        cuda_ingest.fused_ingest(gpu, streams, spec)
        torch.cuda.synchronize()
        assert (cuda_ingest.launches, cuda_ingest.wide_launches) == (
            before[0] + (not wide), before[1] + wide)
        cuda_ingest.fused_ingest(
            cpu, cuda_ingest.IngestStreams(*(t.cpu() for t in streams)),
            spec)
        got, want = convert.state_to_numpy(gpu), convert.state_to_numpy(cpu)
        for name in cuda_ingest.STATE_LEAVES:
            assert got[name].tobytes() == want[name].tobytes(), name


@pytest.mark.parametrize("case", ["zipf", "hot", "hand"])
def test_fused_ingest_kernel_byte_exact(cuda, case):
    _ingest_byte_exact(cuda, SPEC, case)


@pytest.mark.parametrize("case", ["zipf", "hot", "hand"])
def test_fused_ingest_wide_kernel_byte_exact(cuda, case):
    """Compression 2,400 and hll_precision 16: the in-place kernel."""
    assert cuda_ingest.rows_in_place(WIDE_SPEC)
    _ingest_byte_exact(cuda, WIDE_SPEC, case)


def test_fused_ingest_kernel_widest_spec_byte_exact(cuda):
    """The widest rows the kernel stages in shared memory (hll_precision
    15, 3,624 digest cells: 232,128 bytes a block) on the hot batch; the
    wrapper's mirror of the kernel's shared-memory need agrees with the
    kernel's own, rows staged and in place."""
    spec = tstate.TableSpec(counter_capacity=1 << 12, gauge_capacity=256,
                            status_capacity=64, set_capacity=64,
                            histo_capacity=256, hll_precision=15,
                            compression=2200.0)
    lib = _build.load()
    for words, cells in ((3072, 472), (spec.hll_words, spec.total_cells),
                         (12288, 472), (3072, 3631), (192, 40),
                         (12288, 3928)):
        for in_place in (False, True):
            assert lib.vt_fused_ingest_smem(words, cells, in_place) == \
                cuda_ingest.shared_bytes(words, cells, in_place), (
                    words, cells, in_place)
    assert cuda_ingest.shared_bytes(spec.hll_words, spec.total_cells) == \
        232_128
    rng = np.random.default_rng(5)
    gpu = tstate.empty_state(spec, cuda)
    for _ in range(2):
        batch = tstep.Batch(*(None if a is None else
                              torch.from_numpy(a).to(cuda)
                              for a in _hot_batch(rng, spec)))
        streams = tstep.build_streams(gpu, batch, spec)
        cpu = convert.state_from_numpy(convert.state_to_numpy(gpu), "cpu")
        before = cuda_ingest.launches
        cuda_ingest.fused_ingest(gpu, streams, spec)
        torch.cuda.synchronize()
        assert cuda_ingest.launches == before + 1
        cuda_ingest.fused_ingest(
            cpu, cuda_ingest.IngestStreams(*(t.cpu() for t in streams)),
            spec)
        got, want = convert.state_to_numpy(gpu), convert.state_to_numpy(cpu)
        for name in cuda_ingest.STATE_LEAVES:
            assert got[name].tobytes() == want[name].tobytes(), name


@pytest.mark.parametrize("case", ["misaligned_stream", "offsets"])
def test_fused_ingest_refuses_what_the_kernel_cannot_index(cuda, case):
    """A stream that is not 16-byte aligned (a view at offset 1), and a
    set table whose rows x words reach 2^31 (2^20 rows of 3,072 words),
    raise ValueError before any launch."""
    rng = np.random.default_rng(6)
    streams = cuda_ingest.IngestStreams(
        *(t.to(cuda) for t in _hand_streams(rng, SPEC)))
    spec = SPEC
    if case == "misaligned_stream":
        buf = torch.empty(streams.c_inc.numel() + 1, device=cuda)
        view = buf[1:]
        view.copy_(streams.c_inc)
        streams = streams._replace(c_inc=view)
        match = "16-byte aligned"
    else:
        spec = tstate.TableSpec(counter_capacity=SPEC.counter_capacity,
                                gauge_capacity=SPEC.gauge_capacity,
                                status_capacity=SPEC.status_capacity,
                                set_capacity=1 << 20,
                                histo_capacity=SPEC.histo_capacity)
        match = "32-bit offsets"
    gpu = tstate.empty_state(spec, cuda)
    before = cuda_ingest.launches
    with pytest.raises(ValueError, match=match):
        cuda_ingest.fused_ingest(gpu, streams, spec)
    assert cuda_ingest.launches == before


def test_digest_quantiles_kernel_matches_plain(cuda):
    rng = np.random.default_rng(1)
    r, c = 3000, SPEC.total_cells
    mean = rng.lognormal(2.0, 1.0, (r, c)).astype(np.float32)
    weight = rng.integers(0, 4, (r, c)).astype(np.float32)
    weight[0] = 0.0                                   # empty row
    mean[1] = rng.choice(np.asarray([1.0, 2.0, 2.0], np.float32), c)
    live = weight > 0
    mn = np.where(live, mean, np.inf).min(-1).astype(np.float32)
    mx = np.where(live, mean, -np.inf).max(-1).astype(np.float32)
    qs = np.asarray([0.0, 0.5, 0.9, 0.99, 1.0], np.float32)
    args = [torch.from_numpy(a) for a in (mean, weight, mn, mx, qs)]
    want = cuda_digest.quantiles_rows(*args).numpy()
    before = cuda_digest.launches
    got = cuda_digest.quantiles_rows(*(a.to(cuda) for a in args)).cpu()
    assert cuda_digest.launches == before + 1
    got = got.numpy()
    assert np.isnan(got[0]).all()
    assert np.array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=2e-5, atol=2e-5)


def _k2_rows(rng, c):
    """Digest rows of c cells that reach every path of K2: each live count
    of LIVE (and c) that fits, with dead cells interleaved; duplicate
    means; a live -inf; live +inf means behind dead cells, with a finite
    and an infinite max."""
    rows = []                                     # (mean, weight, max?)

    def row(n, means=None):
        mean = rng.lognormal(3.0, 1.0, c).astype(np.float32)
        weight = np.zeros(c, np.float32)
        at = rng.choice(c, n, replace=False)
        weight[at] = rng.integers(1, 4, n) + rng.choice([0.0, 0.5], n)
        if means is not None:
            mean[at] = rng.choice(np.asarray(means, np.float32), n)
        return mean, weight

    for n in sorted({*K2_LIVE, c}):
        if n <= c:
            rows += [row(n) + (None,) for _ in range(3)]
    for n in {min(c, 5), min(c, 40), c}:
        rows.append(row(n, [1.0, 2.0, 2.0, 5.0]) + (None,))
        rows.append(row(n, [0.0, -0.0, 3.0]) + (None,))
    mean, weight = row(min(c, 7))
    mean[np.flatnonzero(weight)[0]] = -np.inf
    rows.append((mean, weight, None))
    if c >= 3:
        for top in (50.0, np.inf):
            for n in {3, min(c, 300), c}:
                mean, weight = row(n)
                live = np.flatnonzero(weight)
                mean[live[-1]] = np.inf           # after every dead cell
                mean[live[len(live) // 2]] = np.inf
                rows.append((mean, weight, top))
    mean = np.stack([r[0] for r in rows])
    weight = np.stack([r[1] for r in rows])
    live = weight > 0
    mn = np.where(live, mean, np.inf).min(-1).astype(np.float32)
    mx = np.where(live, mean, -np.inf).max(-1).astype(np.float32)
    for i, r in enumerate(rows):
        if r[2] is not None:
            mx[i] = r[2]
    return mean, weight, mn, mx


K2_LIVE = (0, 1, 2, 31, 32, 33, 64, 100, 200, 280, 472)


@pytest.mark.parametrize("q", [1, 4, 40])
@pytest.mark.parametrize("c", [1, 32, 33, 472, 2048])
def test_digest_quantiles_kernel_every_path(cuda, c, q):
    """K2 at each live count (one key a lane, 2-16 keys a lane in
    registers, the shared-memory sort past 512), on the 16-byte and the
    scalar load path, with ties, -0/+0, -inf and live +inf means: within
    rtol/atol 2e-5 of the plain version, the same NaN pattern, one
    launch."""
    rng = np.random.default_rng(c * 100 + q)
    qs = np.concatenate([[0.0, 1.0, 0.5], rng.uniform(0, 1, q)])[:q]
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in
            (*_k2_rows(rng, c), qs.astype(np.float32))]
    want = cuda_digest.quantiles_rows(*args).numpy()
    before = cuda_digest.launches
    got = cuda_digest.quantiles_rows(*(a.to(cuda) for a in args)).cpu()
    assert cuda_digest.launches == before + 1
    got = got.numpy()
    empty = ~(args[1].numpy() > 0).any(-1)
    assert np.isnan(got[empty]).all()
    assert np.array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=2e-5, atol=2e-5)


def test_digest_quantiles_kernel_unaligned_rows(cuda):
    """Rows whose base is not 16-byte aligned take the scalar loads."""
    rng = np.random.default_rng(5)
    mean, weight, mn, mx = _k2_rows(rng, 472)
    qs = torch.tensor([0.5, 0.9, 0.99, 0.5])
    want = cuda_digest.quantiles_rows(*(torch.from_numpy(a) for a in
                                        (mean, weight, mn, mx)), qs).numpy()

    def shifted(a):
        buf = torch.zeros(a.size + 1, dtype=torch.float32, device=cuda)
        buf[1:] = torch.from_numpy(a.reshape(-1)).to(cuda)
        return buf[1:].view(a.shape)
    m, w = shifted(mean), shifted(weight)
    assert m.data_ptr() % 16 and m.is_contiguous()
    got = cuda_digest.quantiles_rows(m, w, torch.from_numpy(mn).to(cuda),
                                     torch.from_numpy(mx).to(cuda),
                                     qs.to(cuda)).cpu().numpy()
    assert np.array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("c", [2049, 2056, 3928, 9000])
def test_digest_quantiles_wide_rows_match_plain(cuda, c):
    """Rows past SMEM_CELLS (2,049 on the scalar loads; 2,056 and 3,928,
    compression 1,279 and 2,400; 9,000) go to the wide-row kernel, once a
    call: every live count of K2_LIVE and c, ties, -0/+0, -inf, and live
    +inf means behind dead cells, within rtol/atol 2e-5 of the plain
    version with the same NaN pattern."""
    assert c > cuda_digest.SMEM_CELLS
    rng = np.random.default_rng(c)
    qs = np.asarray([0.0, 0.5, 0.9, 0.99, 1.0], np.float32)
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in
            (*_k2_rows(rng, c), qs)]
    want = cuda_digest.quantiles_rows(*args).numpy()
    before = (cuda_digest.launches, cuda_digest.wide_launches)
    got = cuda_digest.quantiles_rows(*(a.to(cuda) for a in args)).cpu()
    assert (cuda_digest.launches, cuda_digest.wide_launches) == (
        before[0], before[1] + 1)
    got = got.numpy()
    assert np.array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=2e-5, atol=2e-5)


def test_slice_on_the_card_matches_the_cpu(cuda):
    rng = np.random.default_rng(2)
    lines = []
    for _ in range(20000):
        k = rng.integers(0, 4)
        if k == 0:
            lines.append(b"c.%d:%d|c|@0.5" % (rng.integers(0, 500),
                                             rng.integers(1, 9)))
        elif k == 1:
            lines.append(b"g.%d:%.3f|g" % (rng.integers(0, 100),
                                          rng.normal()))
        elif k == 2:
            lines.append(b"t.%d:%.3f|ms|#a:b" % (min(rng.zipf(1.4), 200),
                                                 rng.lognormal(3.0, 1.0)))
        else:
            lines.append(b"s.%d:u%d|s" % (rng.integers(0, 40),
                                          rng.integers(0, 5000)))
    bspec = BatchSpec(counter=1024, gauge=256, status=64, set=1024,
                      histo=1024)
    out = []
    for device in ("cpu", cuda):
        agg = Aggregator(SPEC, bspec, device=device, compact_every=2)
        for line in lines:
            try:
                agg.process_metric(parse_metric(line))
            except ParseError:
                pass
        res, table = agg.flush([0.5, 0.99])
        out.append(generate_intermetrics(
            res, table, percentiles=[0.5, 0.99], aggregates=["count"],
            is_local=False, timestamp=1))
    assert cuda_ingest.launches >= agg.steps_total > 8
    assert cuda_digest.launches >= 1
    cpu_ims, gpu_ims = out
    assert [(m.name, m.type) for m in gpu_ims] == \
        [(m.name, m.type) for m in cpu_ims]
    for g, c in zip(gpu_ims, cpu_ims):
        if g.name.endswith("percentile"):
            # the torch prologue's sums round differently on the card, so
            # a sample may land one digest cell over
            assert abs(g.value - c.value) <= 1e-2 * abs(c.value) + 1e-6, \
                g.name
        elif g.name.startswith("s."):
            assert abs(g.value - c.value) <= 1e-5 * c.value, g.name
        else:
            assert g.value == c.value, g.name


def _native_waves(rng, rings=4, waves=6, per_wave=400):
    """Waves of counter, gauge, timer and set lines; a line's ring is fixed
    by its name (so a key's order is too), and per wave and ring the
    lines form datagrams of at most ~1,400 bytes."""
    out = []
    for _ in range(waves):
        by_ring = [[] for _ in range(rings)]
        for _ in range(per_wave):
            k = rng.integers(0, 4)
            if k == 0:
                line = b"c.%d:%d|c|@0.5" % (rng.integers(0, 500),
                                           rng.integers(1, 9))
            elif k == 1:
                line = b"g.%d:%.3f|g" % (rng.integers(0, 100), rng.normal())
            elif k == 2:
                line = b"t.%d:%.3f|ms|#a:b" % (min(rng.zipf(1.4), 200),
                                               rng.lognormal(3.0, 1.0))
            else:
                line = b"s.%d:u%d|s" % (rng.integers(0, 40),
                                        rng.integers(0, 5000))
            by_ring[sum(line.split(b":", 1)[0]) % rings].append(line)
        wave = []
        for r, lines in enumerate(by_ring):
            for i in range(0, len(lines), 40):
                wave.append((r, b"\n".join(lines[i:i + 40])))
        out.append(wave)
    return out


def _native_run(device, waves, rings):
    """The waves through NativeAggregator on `device`: fed in order, or
    injected into `rings` rings, each wave parsed in full before one pump
    (one step a wave, whatever the threads' timing). Returns the swapped
    state as numpy, the InterMetrics and the steps."""
    agg = NativeAggregator(SPEC, BatchSpec(counter=1024, gauge=256,
                                           status=64, set=1024, histo=1024),
                           device=device, compact_every=2)
    if rings:
        agg.rings_start(rings)
    try:
        sent = 0
        for wave in waves:
            for r, data in wave:
                if rings:
                    assert agg.eng.rings_inject(r, data) == 1
                else:
                    agg.feed(data)
                sent += data.count(b"\n") + 1
            if rings:
                while (agg.processed + agg.extra_parse_errors()
                       + agg.dropped_capacity) < sent:
                    time.sleep(0.002)
                agg.pump(0)
        state, table = agg.swap()
        steps = agg.steps_total
        res, table = agg.compute_flush(state, table, [0.5, 0.99])
    finally:
        agg.readers_stop()
    return (_rows_by_key(convert.state_to_numpy(state), table),
            generate_intermetrics(res, table, percentiles=[0.5, 0.99],
                                  aggregates=["count"], is_local=False,
                                  timestamp=1), steps)


def _rows_by_key(state: dict, table) -> dict:
    """Each leaf's live rows in (name, tags) order: with rings, which slot
    a key gets depends on which ring keys it first."""
    kinds = {"counter": "counter", "gauge": "gauge", "status": "status",
             "hll": "set", "h_": "histogram"}
    out = {}
    for leaf, rows in state.items():
        kind = next(k for p, k in kinds.items() if leaf.startswith(p))
        metas = sorted(table.get_meta(kind),
                       key=lambda sm: (sm[1].name, sm[1].joined_tags or ""))
        out[leaf] = rows[[slot for slot, _m in metas]]
    return out


@pytest.mark.parametrize("rings", [0, 4], ids=["feed", "rings"])
def test_native_path_on_the_card_matches_the_cpu(cuda, rings):
    """The same datagrams through NativeAggregator on the card and on the
    CPU: every key's state rows byte-equal but the digest cells, which
    the torch prologue's sums may place one cell over on the card (as in
    the slice test); the same flush. K1 launches once a step, or once a
    ring a step with rings."""
    waves = _native_waves(np.random.default_rng(4))
    cpu = _native_run("cpu", waves, rings)
    cuda_ingest.launches = cuda_digest.launches = 0
    gpu = _native_run(cuda, waves, rings)
    assert gpu[2] == cpu[2] >= 3
    assert cuda_ingest.launches == gpu[2] * max(rings, 1)
    assert cuda_digest.launches >= 1
    for name, want in cpu[0].items():
        if name not in ("h_w", "h_wm"):
            assert np.array_equal(gpu[0][name], want, equal_nan=True), name
    key = (lambda m: (m.name, tuple(m.tags))) if rings else None
    gims, cims = (sorted(x[1], key=key) if key else x[1] for x in (gpu, cpu))
    assert [(m.name, m.type) for m in gims] == \
        [(m.name, m.type) for m in cims]
    for g, c in zip(gims, cims):
        if g.name.endswith("percentile"):
            assert abs(g.value - c.value) <= 1e-2 * abs(c.value) + 1e-6, \
                g.name
        elif g.name.startswith("s."):
            assert abs(g.value - c.value) <= 1e-5 * c.value, g.name
        else:
            assert g.value == c.value, g.name


@pytest.mark.parametrize("p,n,w,s,form", [
    (10, 5, 7, 3, "rows"), (10, 4, 200, 4, "rows"), (14, 9, 37, 6, "rows"),
    (14, 3, 361, 5, "rows"), (14, 6, 361, 40, "idx"), (4, 5, 9, 3, "idx"),
    (5, 4, 700, 6, "idx"), (10, 4, 700, 6, "idx"), (14, 3, 600, 5, "rows"),
    (10, 5, 33, 4, "unaligned"), (4, 3, 12_300, 3, "idx")])
def test_merge_windows_kernel_byte_exact(cuda, p, n, w, s, form):
    """K3 against its plain version: rows given whole or through a row
    index (repeated, and clamped from below 0 and past the ring); the
    16-byte path (p >= 6) and the scalar one (p = 4, 5, and a base off
    16-byte alignment); more than 32 steps (two step groups); rings of
    more than 512 columns (several column chunks) on both paths, and of
    12,300."""
    rng = np.random.default_rng(1000 * p + w)
    regs = rng.integers(0, 64, (n, w, 1 << p)).astype(np.uint8)
    regs[0] = 0                                   # all-zero row
    rows = torch.from_numpy(hll.pack_registers_np(regs, p))
    sel = (rng.uniform(size=(s, w)) < 0.3).astype(np.float32)
    sel[1] = 0.0                                  # selects nothing
    sel[0, 0], sel[0, -1] = np.nan, -1.0          # never selected
    sel[-1] = 1.0                                 # every column
    sel = torch.from_numpy(sel)
    idx = None
    if form == "idx":
        idx = torch.tensor([n - 1, 0, 2, -3, n + 4, 2, 1], dtype=torch.int32)
    want = cuda_history.merge_windows_packed(rows, sel, precision=p,
                                             idx=idx)
    rows_c = rows.to(cuda)
    if form == "unaligned":
        buf = torch.zeros(rows.numel() + 1, dtype=torch.int32, device=cuda)
        buf[1:] = rows_c.reshape(-1)
        rows_c = buf[1:].view(rows.shape)
        assert rows_c.data_ptr() % 16 and rows_c.is_contiguous()
    before = cuda_history.launches
    got = cuda_history.merge_windows_packed(
        rows_c, sel.to(cuda), precision=p,
        idx=None if idx is None else idx.to(cuda))
    torch.cuda.synchronize()
    assert cuda_history.launches == before + 1
    assert torch.equal(got.cpu(), want)
    # every output row but those of the all-zero ring row 0 is non-zero
    # on the every-column step
    live = (torch.arange(n) if idx is None else idx.clamp(0, n - 1)) != 0
    assert not want[:, 1].any() and want[live, -1].any(-1).all()


def _range_answers(wr, need, sel, rank):
    flat, n_q, n_steps, buckets, _ = hmerge.pack_range_inputs(
        wr.spec, need, sel, rank, {0.5, 0.99})
    hist = wr.acquire_read()
    try:
        packed = hmerge.range_in_packed(
            hist, torch.from_numpy(flat).to(wr.device), hspec=wr.spec,
            n_q=n_q, n_steps=n_steps, buckets=buckets)
    finally:
        wr.release_read()
    return tstep.unpack_flush(packed.cpu().numpy(), hmerge.range_shapes(
        wr.spec, buckets, n_steps, n_q))


def test_history_on_the_card_matches_the_cpu(cuda):
    rng = np.random.default_rng(3)
    hspec = HistorySpec.for_table(SPEC, windows=4, tiers=2)
    bspec = BatchSpec(counter=1024, gauge=256, status=64, set=1024,
                      histo=1024)
    agg = Aggregator(SPEC, bspec, device=cuda, compact_every=2)
    wr = HistoryWriter(hspec, interval_s=10.0, device=cuda)
    frames = []
    for _ in range(9):           # tier 1 rolls four times, tier 2 twice
        for _ in range(3000):
            k = rng.integers(0, 4)
            if k == 0:
                line = b"c.%d:%d|c" % (rng.integers(0, 300),
                                       rng.integers(1, 9))
            elif k == 1:
                line = b"g.%d:%.3f|g" % (rng.integers(0, 60), rng.normal())
            elif k == 2:
                line = b"t.%d:%.3f|ms" % (min(rng.zipf(1.4), 150),
                                          rng.lognormal(3.0, 1.0))
            else:
                line = b"s.%d:u%d|s" % (rng.integers(0, 90),
                                        rng.integers(0, 5000))
            agg.process_metric(parse_metric(line))
        state, table = agg.swap()
        res, table, raw = agg.compute_flush(state, table, [0.5, 0.99],
                                            want_raw=True, history=wr)
        frames.append((table, res, raw))
    replay = HistoryWriter(hspec, interval_s=10.0, device=cuda)
    for table, res, raw in frames:
        replay.record_frame(table, res, raw)
    a, b = wr.acquire_read(), replay.acquire_read()
    for name, x, y in zip(a._fields, a, b):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32)), name
    wr.release_read()
    replay.release_read()

    cpu = HistoryWriter(hspec, interval_s=10.0, device="cpu")
    cpu.restore(wr.snapshot())
    need = [[] for _ in range(5)]
    for k, _key, row in sorted(wr.iter_keys(), key=lambda e: (e[0], e[2])):
        need[k].append(row)
    plans = [wr.plan_range(r, win, st, hmerge.MAX_STEPS)
             for r, win, st in ((90.0, None, 10.0), (90.0, 40.0, 20.0),
                                (90.0, None, None))]
    sel = np.concatenate([p.sel for p in plans])
    k3, k2 = cuda_history.launches, cuda_digest.launches
    got = _range_answers(wr, need, sel, plans[0].rank)
    assert cuda_history.launches == k3 + 1 and cuda_digest.launches == k2 + 1
    want = _range_answers(cpu, need, sel, plans[0].rank)
    for key in want:
        if key == "r_histo_quantiles":
            np.testing.assert_allclose(got[key], want[key], rtol=2e-5,
                                       atol=2e-5, err_msg=key)
        elif key == "r_set_estimate":
            np.testing.assert_allclose(got[key], want[key], rtol=1e-6,
                                       err_msg=key)
        else:
            assert got[key].tobytes() == want[key].tobytes(), key
    assert (got["r_set_estimate"] > 0).any()


def _server_run(device, grams):
    """One Server on `device` takes `grams` over loopback and flushes once;
    returns its app InterMetrics sorted by key and its counters."""
    import socket
    from veneur_tpu_torch.config import Config
    from veneur_tpu_torch.server.server import Server
    from veneur_tpu_torch.sinks.debug import DebugMetricSink
    sink = DebugMetricSink()
    srv = Server(Config(
        interval="3600s", hostname="h", metric_max_length=4096,
        read_buffer_size_bytes=1 << 22, percentiles=[0.5, 0.99],
        aggregates=["min", "max", "count"],
        statsd_listen_addresses=["udp://127.0.0.1:0"],
        tpu_counter_capacity=1 << 12, tpu_gauge_capacity=256,
        tpu_status_capacity=64, tpu_set_capacity=64,
        tpu_histo_capacity=256), metric_sinks=[sink], device=device)
    srv.start()
    try:
        tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        for i, g in enumerate(grams):
            tx.sendto(g, srv.local_addr())
            if i % 32 == 31:        # paced: the socket buffer holds them
                time.sleep(0.002)
        tx.close()
        n = sum(g.count(b"\n") + 1 for g in grams)
        t0 = time.time()
        agg = srv.aggregator
        while (agg.processed + agg.dropped_capacity + srv.parse_errors
               + agg.extra_parse_errors()) < n:
            assert time.time() - t0 < 60, "lines not all seen"
            time.sleep(0.01)
        # read before the flush: its self-metrics re-enter the pipeline
        counts = (agg.processed, agg.dropped_capacity, srv.packets_received,
                  srv.packets_dropped)
        assert srv.trigger_flush(timeout=120)
    finally:
        srv.shutdown()
    ims = sorted((m for m in sink.flushed
                  if not m.name.startswith("veneur.")
                  and m.name != "ssf.names_unique"),
                 key=lambda m: (m.name, tuple(m.tags)))
    return ims, counts


def test_server_on_the_card_matches_the_cpu(cuda):
    """The Server's main path (native UDP readers → K1 steps → flush with
    K2) on the card against the same Server on the CPU."""
    rng = np.random.default_rng(8)
    lines = []
    for i in range(6000):
        k = i % 4
        if k == 0:
            lines.append(b"c.%d:%d|c|#env:e%d" % (i % 500, 1 + i % 5, i % 3))
        elif k == 1:
            lines.append(b"t.%d:%.4f|ms" % (int(rng.zipf(1.3)) % 200,
                                            rng.lognormal(3.0, 0.5)))
        elif k == 2:
            lines.append(b"g.%d:%.3f|g" % (i % 100, rng.normal()))
        else:
            lines.append(b"s.%d:u%d|s" % (i % 40, rng.integers(0, 5000)))
    grams = [b"\n".join(lines[i:i + 40]) for i in range(0, len(lines), 40)]
    cims, ccounts = _server_run("cpu", grams)
    cuda_ingest.launches = cuda_digest.launches = 0
    gims, gcounts = _server_run(cuda, grams)
    assert gcounts == ccounts == (len(lines), 0, len(grams), 0)
    assert cuda_ingest.launches >= 1 and cuda_digest.launches >= 1
    assert [(m.name, m.tags, m.type) for m in gims] == \
        [(m.name, m.tags, m.type) for m in cims]
    for g, c in zip(gims, cims):
        if g.name.endswith("percentile"):
            assert abs(g.value - c.value) <= 1e-2 * abs(c.value) + 1e-6, \
                g.name
        elif g.name.startswith("s."):
            assert abs(g.value - c.value) <= 1e-5 * c.value, g.name
        else:
            assert g.value == c.value, g.name
