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
  walked in place); at the widest rows it stages; at tables whose rows
  x width pass 2^31 (2^20 set rows at p = 14, 4,600,000 digest rows);
  and it refuses, before any launch, streams that are not 16-byte
  aligned and capacities past the stream sentinel;
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
  flushed InterMetrics; and with the history, query and watch tiers on,
  the same POST /query answers (instant, then range over three
  intervals) and the same watch transitions;
- K1 past 32-bit offsets (C-8): at set_capacity 2^20 (p = 14) and at
  histo_capacity 4,600,000 (x 472 cells), with the batch's set and
  histogram slots at the tables' top rows, byte-exact against the plain
  version run on a copy of the state on the card;
- a Server on the card whose counter table grows at a flush (table
  growth): the intervals before, across and after the grow flush the
  InterMetrics a CPU Server flushes, with the same drops and capacities;
- the global tier on the card against the same Server on the CPU: the
  same MetricLists over gRPC (the engine's vi_import, K1 steps) and a
  JSONMetric POST /import flush the same InterMetrics, and the shutdown
  checkpoint restores (K1's two steps) into a card Server and a CPU
  Server that flush the same tail;
- the forward tier on the card against the same tier on the CPU: two
  local Servers forward exactly once through a ProxyServer to two global
  Servers, which flush the same InterMetrics and set words;
- the sharded step (every [R, S] tile in one K1 launch) and the merged
  flush on the card against the same on the CPU, and the collective
  tier at (R, S) = (2, 4) absorbing the same locals on both;
- count-min's update and estimate on the card, bit-equal to the same
  calls on the CPU, and a Server resized live 4 -> 8 -> 2 on the card
  flushing what the same run flushes on the CPU.
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
    spec whose counter capacity passes the stream sentinel 2^30, raise
    ValueError before any launch (the spec is refused before the state's
    shapes are read)."""
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
        spec = tstate.TableSpec(counter_capacity=(1 << 30) + 1,
                                gauge_capacity=SPEC.gauge_capacity,
                                status_capacity=SPEC.status_capacity,
                                set_capacity=SPEC.set_capacity,
                                histo_capacity=SPEC.histo_capacity)
        match = "sentinel"
    gpu = tstate.empty_state(SPEC, cuda)
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


def _tiers_run(device, waves):
    """One Server on `device` with the history, query and watch tiers on
    takes each wave of datagrams as an interval: an instant batch before
    each flush, one range batch after the last; returns the answers and
    the watch events."""
    import json
    import socket
    import urllib.request
    from veneur_tpu_torch.config import Config
    from veneur_tpu_torch.server.server import Server
    from veneur_tpu_torch.sinks.debug import DebugMetricSink
    srv = Server(Config(
        interval="3600s", hostname="h", metric_max_length=4096,
        read_buffer_size_bytes=1 << 22, percentiles=[0.5, 0.99],
        aggregates=["min", "max", "count"],
        statsd_listen_addresses=["udp://127.0.0.1:0"],
        http_address="127.0.0.1:0", query_enabled=True,
        history_enabled=True, watch_enabled=True, history_windows=8,
        history_decimation_tiers=2, history_max_keys=1 << 12,
        tpu_counter_capacity=1 << 12, tpu_gauge_capacity=256,
        tpu_status_capacity=64, tpu_set_capacity=64,
        tpu_histo_capacity=256), metric_sinks=[DebugMetricSink()],
        device=device)
    srv.start()

    def post(path, body):
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.http_port}{path}",
            data=json.dumps(body).encode())
        with urllib.request.urlopen(req, timeout=120) as r:
            return json.loads(r.read())
    answers = []
    try:
        post("/watch", {"prefix": "c.1", "threshold": 40})
        post("/watch", {"name": "t.1", "kind": "quantile", "quantile": 0.5,
                        "threshold": 20})
        sub = srv.watch_engine.hub.subscribe()
        agg, sent = srv.aggregator, 0
        tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        for wave in waves:
            for i, g in enumerate(wave):
                tx.sendto(g, srv.local_addr())
                if i % 32 == 31:
                    time.sleep(0.002)
            sent += sum(g.count(b"\n") + 1 for g in wave)
            t0 = time.time()
            while agg.eng.stats()["processed"] < sent:
                assert time.time() - t0 < 60, "lines not all seen"
                time.sleep(0.01)
            answers.append(post("/query", {"queries": [
                {"prefix": "c."}, {"prefix": "g."}, {"prefix": "s."},
                {"prefix": "t.", "quantiles": [0.5, 0.99]}]}))
            n = srv.watch_engine.intervals_evaluated
            assert srv.trigger_flush(timeout=120)
            t0 = time.time()
            while srv.watch_engine.intervals_evaluated <= n:
                assert time.time() - t0 < 60, "watch not evaluated"
                time.sleep(0.01)
        tx.close()
        answers.append(post("/query", {"queries": [
            {"prefix": p, "range": 3 * 3600.0, "step": 3600.0,
             "quantiles": [0.5, 0.99]} for p in ("c.", "g.", "s.", "t.")]}))
        events = []
        while (ev := sub.get(timeout=0.0)) is not None:
            events.append({k: v for k, v in ev.items() if k != "ts"})
    finally:
        srv.shutdown()
    return answers, events


def _close_answers(got, want, where="", tol=0.0):
    """Card against CPU: quantiles and medians within 1e-2 (the card's
    and the CPU's digest compaction round apart), set estimates within
    1e-5, the rest exact; wall-clock stamps skipped."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), where
        for k in want:
            if k in ("ts", "ts_start"):
                continue
            t = {"quantiles": 1e-2, "median": 1e-2, "estimate": 1e-5}.get(
                k, tol)
            _close_answers(got[k], want[k], f"{where}.{k}", t)
    elif isinstance(want, list):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _close_answers(g, w, f"{where}[{i}]", tol)
    elif tol and isinstance(want, float):
        assert abs(got - want) <= tol * abs(want) + 1e-6, (where, got, want)
    else:
        assert got == want, (where, got, want)


def test_server_tiers_on_the_card_match_the_cpu(cuda):
    """POST /query (instant and range, K2 and K3 on the Server's path)
    and the watch tier on the card against the same Server on the CPU."""
    rng = np.random.default_rng(9)
    waves = []
    for w in range(3):
        lines = []
        for i in range(3000):
            k = i % 4
            if k == 0:
                lines.append(b"c.%d:%d|c" % (i % 300, 1 + (i + w) % 5))
            elif k == 1:
                lines.append(b"t.%d:%.4f|ms" % (int(rng.zipf(1.3)) % 100,
                                                rng.lognormal(3.0, 0.5)))
            elif k == 2:
                lines.append(b"g.%d:%.3f|g" % (i % 100, rng.normal()))
            else:
                lines.append(b"s.%d:u%d|s" % (i % 40, rng.integers(0, 5000)))
        waves.append([b"\n".join(lines[i:i + 40])
                      for i in range(0, len(lines), 40)])
    want, want_ev = _tiers_run("cpu", waves)
    cuda_digest.launches = cuda_history.launches = 0
    got, got_ev = _tiers_run(cuda, waves)
    assert cuda_history.launches == 1 and cuda_digest.launches >= 10
    _close_answers(got, want)
    assert [(e["id"], e["from"], e["to"]) for e in got_ev] == \
        [(e["id"], e["from"], e["to"]) for e in want_ev]
    assert got_ev


def _global_run(device, lists, body, tail, root):
    """A global Server on `device`: `lists` over gRPC and `body` through
    POST /import, a flush, then `tail` over gRPC and a shutdown that
    checkpoints it under `root`; a second Server restores it and flushes.
    Returns both flushes' app InterMetrics."""
    import json
    import urllib.request
    from veneur_tpu_torch.config import Config
    from veneur_tpu_torch.forward.rpc import ForwardClient
    from veneur_tpu_torch.proto import forwardrpc_pb2 as fpb
    from veneur_tpu_torch.server.server import Server
    from veneur_tpu_torch.sinks.debug import DebugMetricSink
    kw = dict(interval="3600s", hostname="g", percentiles=[0.5, 0.99],
              aggregates=["min", "max", "count"],
              statsd_listen_addresses=[], http_address="127.0.0.1:0",
              grpc_address="127.0.0.1:0", checkpoint_dir=str(root),
              tpu_counter_capacity=1 << 12, tpu_gauge_capacity=256,
              tpu_status_capacity=64, tpu_set_capacity=64,
              tpu_histo_capacity=256)

    def app(sink):
        # not the self-metrics, nor the span-name uniqueness sets the
        # extraction sink samples at 1% from the server's own spans
        return sorted((m for m in sink.flushed
                       if not m.name.startswith("veneur.")
                       and m.name != "ssf.names_unique"),
                      key=lambda m: (m.name, tuple(m.tags)))

    def count(data):
        return len(fpb.MetricList.FromString(data).metrics)

    def wait(srv, n):
        t0 = time.time()
        while srv.imported_total + srv.import_errors < n:
            assert time.time() - t0 < 60, "imports not all folded"
            time.sleep(0.01)

    out = []
    sink = DebugMetricSink()
    srv = Server(Config(**kw), metric_sinks=[sink], device=device)
    srv.start()
    try:
        client = ForwardClient(f"127.0.0.1:{srv.grpc_port}")
        for data in lists:
            client.send_serialized(data)
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.http_port}/import", data=body,
            method="POST", headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as r:
            assert r.status == 202
        n = sum(map(count, lists)) + len(json.loads(body))
        wait(srv, n)
        assert srv.trigger_flush(timeout=120)
        out.append(app(sink))
        client.send_serialized(tail)
        wait(srv, n + count(tail))
        client.close()
    finally:
        srv.shutdown()
    assert srv.import_errors == 0
    sink = DebugMetricSink()
    srv = Server(Config(**dict(kw, restore_on_start=True,
                               checkpoint_on_shutdown=False)),
                 metric_sinks=[sink], device=device)
    srv.start()
    try:
        assert srv._c_ckpt_restores.value() == 1
        assert srv.trigger_flush(timeout=120)
        out.append(app(sink))
    finally:
        srv.shutdown()
    return out


def test_global_tier_on_the_card_matches_the_cpu(cuda, tmp_path):
    import json
    from veneur_tpu_torch.forward.convert import export_metrics
    from veneur_tpu_torch.forward.jsonmetric import to_json_metrics
    from veneur_tpu_torch.proto import forwardrpc_pb2 as fpb
    lists = []
    for seed in range(5):
        rng = np.random.default_rng(seed)
        lines = [b"gc.%d:%d|c|#veneurglobalonly" % (i, 1 + i % 7)
                 for i in range(400)]
        lines += [b"gg.%d:%.3f|g|#veneurglobalonly" % (i, rng.normal())
                  for i in range(50)]
        lines += [b"gt.%d:%.4f|ms" % (int(rng.zipf(1.3)) % 100,
                                      rng.lognormal(3.0, 0.5))
                  for _ in range(4000)]
        lines += [b"gs.%d:u%d|s" % (i % 40, rng.integers(0, 5000))
                  for i in range(2000)]
        loc = NativeAggregator(SPEC, device="cpu")
        loc.feed(b"\n".join(lines))
        _res, table, raw = loc.flush([0.5], want_raw=True)
        lists.append(fpb.MetricList(metrics=export_metrics(
            raw, table, SPEC.compression, SPEC.hll_precision))
            .SerializeToString())
    body = json.dumps(to_json_metrics(list(
        fpb.MetricList.FromString(lists[0]).metrics))).encode()
    want = _global_run("cpu", lists[1:], body, lists[0], tmp_path / "c")
    cuda_ingest.launches = cuda_digest.launches = 0
    got = _global_run(cuda, lists[1:], body, lists[0], tmp_path / "g")
    assert cuda_ingest.launches >= 4 and cuda_digest.launches >= 2
    for g_ims, c_ims in zip(got, want):
        assert [(m.name, m.tags, m.type) for m in g_ims] == \
            [(m.name, m.tags, m.type) for m in c_ims]
        assert len(g_ims) > 500
        for g, c in zip(g_ims, c_ims):
            if g.name.endswith("percentile"):
                np.testing.assert_allclose(g.value, c.value, rtol=2e-5,
                                           atol=2e-5, err_msg=g.name)
            elif g.name.startswith("gs."):
                np.testing.assert_allclose(g.value, c.value, rtol=1e-5,
                                           err_msg=g.name)
            else:
                assert g.value == c.value, g.name


class _DropSpans:
    """A trace backend that drops every span: a Server's own telemetry
    stays out of its pipeline, so no ingest step boundary moves with
    thread timing."""

    def send(self, span) -> None:
        pass

    def close(self) -> None:
        pass


def _forward_run(device, datas):
    """Locals (one per buffer in `datas`) → a proxy → two globals, every
    Server on `device`, exactly once: each local takes its buffer, flushes
    and forwards; then both globals flush. Returns the globals' app
    InterMetrics, sorted by key, and their set words by key."""
    from veneur_tpu_torch.config import Config
    from veneur_tpu_torch.forward.discovery import StaticDiscoverer
    from veneur_tpu_torch.forward.proxysrv import ProxyServer
    from veneur_tpu_torch.server.server import Server
    from veneur_tpu_torch.sinks.debug import DebugMetricSink
    kw = dict(interval="3600s", hostname="f", percentiles=[0.5, 0.99],
              aggregates=["min", "max", "count", "sum"],
              statsd_listen_addresses=[], forward_dedup_window=64,
              tpu_counter_capacity=1 << 12, tpu_gauge_capacity=256,
              tpu_status_capacity=64, tpu_set_capacity=64,
              tpu_histo_capacity=256)

    def wait(cond, what):
        t0 = time.time()
        while not cond():
            assert time.time() - t0 < 60, what
            time.sleep(0.005)

    sinks = [DebugMetricSink(), DebugMetricSink()]
    globs = [Server(Config(**dict(kw, grpc_address="127.0.0.1:0")),
                    metric_sinks=[s], device=device) for s in sinks]
    words = {}
    for g in globs:
        g.trace_client.backend = _DropSpans()
        orig = g.aggregator.compute_flush

        def flush_with_words(state, table, percentiles, want_raw=False,
                             _orig=orig, **k):
            res, table, raw = _orig(state, table, percentiles,
                                    want_raw=True, **k)
            for i, (_s, m) in enumerate(table.get_meta("set")):
                words[(m.name, tuple(m.tags))] = np.asarray(raw["hll"][i])
            return (res, table, raw) if want_raw else (res, table)
        g.aggregator.compute_flush = flush_with_words
        g.start()
    proxy = ProxyServer(StaticDiscoverer(
        [f"127.0.0.1:{g.grpc_port}" for g in globs]), dedup_window=64)
    proxy.start("127.0.0.1:0")
    locs = [Server(Config(**dict(
        kw, forward_address=f"127.0.0.1:{proxy.port}")), device=device)
        for _ in datas]
    try:
        for loc, data in zip(locs, datas):
            loc.trace_client.backend = _DropSpans()
            loc.start()
            loc.packet_queue.put(data)
            n = data.count(b"\n") + 1
            wait(lambda: loc.aggregator.processed >= n, "lines processed")
            fwd0, imp0 = proxy.forwarded, sum(g.imported_total
                                              for g in globs)
            assert loc.trigger_flush(timeout=120)
            wait(lambda: loc.forward_sends_total == 1
                 and len(loc.forward_spill) == 0, "unit acked")
            assert loc.forward_errors == 0
            wait(lambda: sum(g.imported_total for g in globs) - imp0
                 == proxy.forwarded - fwd0 > 0, "unit folded")
        for g in globs:
            assert g.trigger_flush(timeout=120)
    finally:
        for srv in locs + globs:
            srv.shutdown()
        proxy.stop()
    ims = sorted((m for s in sinks for m in s.flushed
                  if not m.name.startswith("veneur.")
                  and m.name != "ssf.names_unique"),
                 key=lambda m: (m.name, tuple(m.tags), m.type))
    return ims, words


def test_forward_tier_on_the_card_matches_the_cpu(cuda):
    """Locals → proxy → globals: the locals' ingest (K1) and flushes (K2),
    the globals' imports (K1) and flushes (K2), on the card against the
    same tier on the CPU."""
    datas = []
    for seed in range(2):
        rng = np.random.default_rng(20 + seed)
        lines = [b"fc.%d:%d|c|#veneurglobalonly" % (i % 300, 1 + i % 9)
                 for i in range(900)]
        lines += [b"fg.%d:%.3f|g|#veneurglobalonly" % (i, rng.normal())
                  for i in range(60)]
        lines += [b"ft.%d:%.4f|ms" % (int(rng.zipf(1.3)) % 120,
                                      rng.lognormal(3.0, 0.5))
                  for _ in range(3000)]
        lines += [b"fs.%d:u%d|s" % (i % 30, rng.integers(0, 5000))
                  for i in range(1500)]
        datas.append(b"\n".join(lines))
    cims, cwords = _forward_run("cpu", datas)
    cuda_ingest.launches = cuda_digest.launches = 0
    gims, gwords = _forward_run(cuda, datas)
    assert cuda_ingest.launches >= 4 and cuda_digest.launches >= 4
    assert [(m.name, m.tags, m.type) for m in gims] == \
        [(m.name, m.tags, m.type) for m in cims]
    assert len(gims) > 500
    assert sorted(gwords) == sorted(cwords) and len(gwords) == 30
    for key, w in cwords.items():
        assert np.array_equal(gwords[key], w), key
    for g, c in zip(gims, cims):
        if g.name.endswith("percentile"):
            np.testing.assert_allclose(g.value, c.value, rtol=2e-5,
                                       atol=2e-5, err_msg=g.name)
        elif g.name.startswith("fs."):
            np.testing.assert_allclose(g.value, c.value, rtol=1e-5,
                                       err_msg=g.name)
        else:
            assert g.value == c.value, g.name


@pytest.mark.parametrize("kind", ["sets", "digests"])
def test_fused_ingest_past_32bit_offsets_byte_exact(cuda, kind):
    """C-8: the short-run groups index the state with 64-bit offsets, so a
    table whose rows x width pass 2^31 is served, byte for byte."""
    import dataclasses
    base = tstate.TableSpec()
    spec = dataclasses.replace(
        base, **({"set_capacity": 1 << 20} if kind == "sets"
                 else {"histo_capacity": 4_600_000}))
    rng = np.random.default_rng(11)
    b = _batch(rng, spec, 8192)
    top = {"set_slot": spec.set_capacity, "histo_slot": spec.histo_capacity}
    b = b._replace(**{k: (cap - 1 - np.abs(getattr(b, k))).astype(np.int32)
                      for k, cap in top.items()})
    gpu = tstate.empty_state(spec, cuda)
    streams = tstep.build_streams(gpu, tstep.Batch(*(
        None if a is None else torch.from_numpy(a).to(cuda) for a in b)),
        spec)
    plain = tstate.DeviceState(*(t.clone() for t in gpu))
    before = cuda_ingest.launches
    cuda_ingest.fused_ingest(gpu, streams, spec)
    cuda_ingest.fused_ingest_plain(plain, streams, spec)
    assert cuda_ingest.launches == before + 1
    for name in cuda_ingest.STATE_LEAVES:
        assert torch.equal(getattr(gpu, name), getattr(plain, name)), name
    del gpu, plain, streams
    torch.cuda.empty_cache()


def _grow_run(device):
    """A Server with table growth: 100 counters into 64 slots (36 exact
    drops), the flush that grows the table, then 120 counters at 128 and
    the flush that grows it to 256; returns each flush's app
    InterMetrics and (capacity, drops) after it."""
    from veneur_tpu_torch.config import Config
    from veneur_tpu_torch.server.server import Server
    from veneur_tpu_torch.sinks.debug import DebugMetricSink
    sink = DebugMetricSink()
    srv = Server(Config(
        interval="3600s", hostname="h", percentiles=[0.5, 0.99],
        aggregates=["min", "max", "count"], statsd_listen_addresses=[],
        http_address="", table_grow_enabled=True, tpu_counter_capacity=64,
        tpu_gauge_capacity=64, tpu_status_capacity=16, tpu_set_capacity=16,
        tpu_histo_capacity=64, tpu_batch_counter=128),
        metric_sinks=[sink], device=device)
    srv.start()
    out = []
    try:
        for scale, n in ((1, 100), (2, 100), (3, 120)):
            lines = [b"gw.c%d:%d|c" % (i, scale * (i % 7 + 1))
                     for i in range(n)]
            lines += [b"gw.t%d:%d|ms" % (i % 3, scale * i + 1)
                      for i in range(30)]
            lines += [b"gw.s:u%d|s" % (i % 40) for i in range(60)]
            base = srv.aggregator.eng.stats()
            for k in range(0, len(lines), 50):
                srv.packet_queue.put(b"\n".join(lines[k:k + 50]))
            t0 = time.time()
            while True:
                st = srv.aggregator.eng.stats()
                seen = sum(st[k] - base[k] for k in st)
                if seen >= len(lines):
                    break
                assert time.time() - t0 < 60, "lines not all seen"
                time.sleep(0.01)
            sink.flushed.clear()
            assert srv.trigger_flush(timeout=120)
            out.append((sorted((m for m in sink.flushed
                                if m.name.startswith("gw.")),
                               key=lambda m: (m.name, m.tags)),
                        srv.aggregator.spec.counter_capacity,
                        srv.aggregator.dropped_capacity))
    finally:
        srv.shutdown()
    return out


def test_grow_on_the_card_matches_the_cpu(cuda):
    want = _grow_run("cpu")
    cuda_ingest.launches = cuda_digest.launches = 0
    got = _grow_run(cuda)
    assert cuda_ingest.launches >= 3 and cuda_digest.launches >= 3
    assert [g[1:] for g in got] == [w[1:] for w in want] == [
        (128, 36), (128, 36), (256, 36)]
    for (gims, _, _), (cims, _, _) in zip(got, want):
        assert [(m.name, m.tags, m.type) for m in gims] == \
            [(m.name, m.tags, m.type) for m in cims]
        for g, c in zip(gims, cims):
            if g.name.endswith("percentile"):
                assert abs(g.value - c.value) <= 1e-2 * abs(c.value) + 1e-6
            elif g.name.startswith("gw.s"):
                assert abs(g.value - c.value) <= 1e-5 * c.value
            else:
                assert g.value == c.value, g.name


@pytest.mark.parametrize("r,s", [(1, 4), (2, 4)])
def test_sharded_step_on_the_card_matches_the_cpu(cuda, r, s):
    """Four steps of random tile batches (hot keys, negative and
    overflowing slots) through the sharded step, one K1 launch each,
    then the merged flush, on the card and on the CPU: every state leaf
    byte-equal but the digest cells (the prologue's sums may place one a
    cell over on the card, as in the slice test), counters and gauges
    flushed equal, quantiles within 1e-2."""
    from veneur_tpu_torch.parallel import sharded
    rng = np.random.default_rng(3)
    steps = []
    for i in range(4):
        grid = [[_batch(rng, SPEC, b=512) for _ in range(s)]
                for _ in range(r)]
        steps.append((sharded.pack_tiles(sharded.stack_batches(grid, r, s),
                                         i == 2),
                      tstep.batch_sizes(grid[0][0]), i == 2))
    out = {}
    for dev in ("cpu", cuda):
        st = sharded.sharded_empty_state(SPEC, r, s, dev)
        cuda_ingest.launches = cuda_digest.launches = 0
        for flat, sizes, compact in steps:
            sharded.sharded_ingest_packed(st, torch.from_numpy(flat).to(dev),
                                          spec=SPEC, sizes=sizes,
                                          do_compact=compact)
        res = tstep.combine_flush_scalars(sharded.merged_flush(
            st, [0.5, 0.99], spec=SPEC, layout=sharded.Layout(r, s)))
        out[str(dev)] = (convert.state_to_numpy(st), res,
                         cuda_ingest.launches, cuda_digest.launches)
    (cs, cres, _l, _d), (gs, gres, k1, k2) = out["cpu"], out[str(cuda)]
    assert (k1, k2) == (4, 1)
    for name, want in cs.items():
        if name not in ("h_w", "h_wm"):
            assert np.array_equal(gs[name], want, equal_nan=True), name
    for key in ("counter", "gauge", "status", "histo_count"):
        np.testing.assert_array_equal(gres[key], cres[key], err_msg=key)
    np.testing.assert_allclose(gres["set_estimate"], cres["set_estimate"],
                               rtol=1e-6)
    np.testing.assert_allclose(gres["histo_quantiles"],
                               cres["histo_quantiles"], rtol=1e-2,
                               atol=1e-6, equal_nan=True)


def test_collective_tier_on_the_card_matches_the_cpu(cuda):
    """Four locals' flush outputs absorbed into a CollectiveGlobalTier at
    (R, S) = (2, 4) on the card and on the CPU (routed steps, one K1
    launch each): the same merged flush."""
    from veneur_tpu_torch.collective.tier import CollectiveGlobalTier
    from veneur_tpu_torch.server.aggregator import Aggregator as TAgg
    spec = tstate.TableSpec(counter_capacity=1 << 10, gauge_capacity=256,
                            status_capacity=64, set_capacity=64,
                            histo_capacity=256)
    bs = BatchSpec(counter=512, gauge=128, status=64, set=256, histo=1024,
                   histo_stat=64)
    locs = []
    for p in range(4):
        agg = TAgg(spec, bs, device="cpu")
        lines = [b"c.%d:%d|c|#veneurglobalonly" % (i, i + p)
                 for i in range(300)]
        lines += [b"t.%d:%d|ms" % (i % 40, i * 7 % 500) for i in range(800)]
        lines += [b"s.%d:m%d|s" % (i % 16, i + 1000 * p) for i in range(400)]
        lines += [b"g.%d:%d|g|#veneurglobalonly" % (i, p) for i in range(50)]
        for ln in lines:
            agg.process_metric(parse_metric(ln))
        st, tb = agg.swap()
        _res, tb, raw = agg.compute_flush(st, tb, [0.5], want_raw=True)
        locs.append((raw, tb))
    out = {}
    for dev in ("cpu", cuda):
        tier = CollectiveGlobalTier(spec, bs, n_shards=4, n_replicas=2,
                                    device=dev)
        cuda_ingest.launches = 0
        for raw, tb in locs:
            tier.absorb_raw(raw, tb)
        st, tb = tier.swap()
        res, tb = tier.compute_flush(st, tb, [0.5, 0.99])
        out[str(dev)] = ({(k, m.name): np.asarray(res[key][i])
                          for k, key in (("counter", "counter"),
                                         ("gauge", "gauge"),
                                         ("set", "set_estimate"),
                                         ("histogram", "histo_quantiles"))
                          for i, (_s, m) in enumerate(tb.get_meta(k))},
                         cuda_ingest.launches, tier.steps_total)
    cpu, (gpu, k1, steps) = out["cpu"][0], out[str(cuda)]
    assert k1 == steps > 0
    assert sorted(gpu) == sorted(cpu)
    for k, want in cpu.items():
        if k[0] == "histogram":
            np.testing.assert_allclose(gpu[k], want, rtol=1e-2, atol=1e-6)
        elif k[0] == "set":
            np.testing.assert_allclose(gpu[k], want, rtol=1e-6)
        else:
            assert np.array_equal(gpu[k], want), k


def test_countmin_on_the_card_bit_equal_to_the_cpu(cuda):
    """Count-min's update and estimate (ops/countmin.py) on the card:
    the [depth, width] table after Zipf batches with padded items, and
    each batch's estimates, bit-equal to the same calls on the CPU (the
    counts are integers below 2^24, so the card's atomic add order
    cannot change them)."""
    from veneur_tpu_torch.ops import countmin
    rng = np.random.default_rng(15)
    tables = {d: countmin.empty_counters(4, 1 << 12, device=d)
              for d in ("cpu", cuda)}
    for _ in range(6):
        members = [b"tag%d" % v for v in rng.zipf(1.2, 5000) % 30000]
        cols = countmin.columns_for_batch(members, 4, 1 << 12)
        cols[rng.random(len(members)) < 0.05] = -1          # padding
        w = rng.integers(1, 4, len(members)).astype(np.float32)
        est = {}
        for d, t in tables.items():
            tables[d], e = countmin.insert_and_estimate(
                t, torch.from_numpy(cols).to(d), torch.from_numpy(w).to(d))
            est[d] = e.cpu().numpy()
        assert est["cpu"].tobytes() == est[cuda].tobytes()
        assert tables["cpu"].numpy().tobytes() == \
            tables[cuda].cpu().numpy().tobytes()
    hh = countmin.HeavyHitters(k=5, width=1 << 12, device=cuda)
    hh.update([b"hot"] * 300 + [b"t%d" % i for i in range(2000)])
    assert hh.counters.device.type == "cuda"
    assert hh.top(1) == [(b"hot", 300.0)]


def _reshard_run(device):
    from veneur_tpu_torch.config import Config
    from veneur_tpu_torch.server.server import Server
    from veneur_tpu_torch.sinks.debug import DebugMetricSink
    sink = DebugMetricSink()
    srv = Server(Config(
        interval="3600s", statsd_listen_addresses=[], http_address="",
        percentiles=[0.5, 0.99], tpu_n_shards=4, reshard_enabled=True,
        tpu_counter_capacity=1 << 10, tpu_gauge_capacity=64,
        tpu_status_capacity=16, tpu_set_capacity=64,
        tpu_histo_capacity=256), metric_sinks=[sink], device=device)
    srv.start()
    rng = np.random.default_rng(3)
    try:
        summaries = []
        for n in (8, 2, None):
            lines = [b"rs.c%d:%d|c" % (i % 300, i) for i in range(900)]
            lines += [b"rs.t%d:%d|ms" % (i % 20, v) for i, v in
                      enumerate(rng.integers(1, 1000, 600))]
            lines += [b"rs.s%d:m%d|s" % (i % 10, i) for i in range(500)]
            want = srv.aggregator.processed + len(lines)
            srv.packet_queue.put(b"\n".join(lines))
            t0 = time.time()
            while srv.aggregator.processed < want:
                assert time.time() - t0 < 60, "lines not processed"
                time.sleep(0.005)
            if n is not None:
                summaries.append(srv.trigger_reshard(n, timeout=120))
        assert srv.trigger_flush(timeout=120)
        return summaries, sorted(
            ((m.name, m.tags, m.value) for m in sink.flushed
             if m.name.startswith("rs.")), key=lambda t: t[:2])
    finally:
        srv.shutdown()


def test_live_reshard_on_the_card_matches_the_cpu(cuda):
    """A Server resized 4 -> 8 -> 2 between three intervals' worth of
    lines on the card flushes what the same run on the CPU flushes: the
    same migration summaries, counters and set estimates exact,
    percentiles within 1e-2 (the fold re-adds digest cells)."""
    want_sum, want = _reshard_run("cpu")
    cuda_ingest.launches = cuda_digest.launches = 0
    got_sum, got = _reshard_run(cuda)
    assert cuda_ingest.launches > 0 and cuda_digest.launches >= 3
    keys = ("plan", "units", "rows_folded", "rows_moved")
    assert [{k: s[k] for k in keys} for s in got_sum] == \
        [{k: s[k] for k in keys} for s in want_sum]
    assert [g[:2] for g in got] == [w[:2] for w in want]
    for (name, _tags, g), (_n, _t, w) in zip(got, want):
        if name.endswith("percentile"):
            assert abs(g - w) <= 1e-2 * abs(w) + 1e-6, name
        else:
            assert g == w, name
