"""The port's CUDA kernels against their plain versions, on the card.

Marked `gpu`: without a card every test here skips with a reason (the
decision is taken inside the `cuda` fixture, never at import). Run them
on a machine with an H100:

    python -m pytest -m gpu --noconftest tests/test_torch_cuda.py

(`--noconftest`: tests/conftest.py pins JAX to the CPU, and the card
machine has no JAX.)

- fused ingest (K1): byte-exact on all 14 state leaves against the plain
  version run on a CPU copy of the same streams;
- digest quantiles (K2): within rtol/atol 2e-5 of the plain version;
- masked window merge (K3): byte-exact against the plain version;
- the whole slice on the card against the same slice on the CPU;
- the history tier on the card: the fused ring equals a replay of the
  archived frames, and a range batch matches the same batch over a CPU
  copy of the ring.
"""

import numpy as np
import pytest
import torch

from veneur_tpu_torch import convert
from veneur_tpu_torch.aggregation import state as tstate
from veneur_tpu_torch.aggregation import step as tstep
from veneur_tpu_torch.aggregation.host import BatchSpec
from veneur_tpu_torch.history import HistorySpec, HistoryWriter
from veneur_tpu_torch.history import merge as hmerge
from veneur_tpu_torch.ops import cuda_digest, cuda_history, cuda_ingest, hll
from veneur_tpu_torch.samplers.parser import ParseError, parse_metric
from veneur_tpu_torch.server.aggregator import Aggregator
from veneur_tpu_torch.server.flusher import generate_intermetrics

pytestmark = pytest.mark.gpu

SPEC = tstate.TableSpec(counter_capacity=1 << 12, gauge_capacity=256,
                        status_capacity=64, set_capacity=64,
                        histo_capacity=256)


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


def test_fused_ingest_kernel_byte_exact(cuda):
    rng = np.random.default_rng(0)
    gpu = tstate.empty_state(SPEC, cuda)
    for _ in range(4):
        batch = tstep.Batch(*(None if a is None else
                              torch.from_numpy(a).to(cuda)
                              for a in _batch(rng, SPEC)))
        streams = tstep.build_streams(gpu, batch, SPEC)
        cpu = convert.state_from_numpy(convert.state_to_numpy(gpu), "cpu")
        before = cuda_ingest.launches
        cuda_ingest.fused_ingest(gpu, streams, SPEC)
        torch.cuda.synchronize()
        assert cuda_ingest.launches == before + 1
        cuda_ingest.fused_ingest(
            cpu, cuda_ingest.IngestStreams(*(t.cpu() for t in streams)),
            SPEC)
        got, want = convert.state_to_numpy(gpu), convert.state_to_numpy(cpu)
        for name in cuda_ingest.STATE_LEAVES:
            assert got[name].tobytes() == want[name].tobytes(), name


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


@pytest.mark.parametrize("p,n,w,s", [(10, 5, 7, 3), (10, 4, 200, 4),
                                     (14, 9, 37, 6), (14, 3, 361, 5)])
def test_merge_windows_kernel_byte_exact(cuda, p, n, w, s):
    rng = np.random.default_rng(1000 * p + w)
    regs = rng.integers(0, 64, (n, w, 1 << p)).astype(np.uint8)
    regs[0] = 0                                   # all-zero row
    rows = torch.from_numpy(hll.pack_registers_np(regs, p))
    sel = (rng.uniform(size=(s, w)) < 0.3).astype(np.float32)
    sel[1] = 0.0                                  # selects nothing
    sel[0, 0], sel[0, -1] = np.nan, -1.0          # never selected
    sel[-1] = 1.0                                 # every column
    sel = torch.from_numpy(sel)
    want = cuda_history.merge_windows_packed(rows, sel, precision=p)
    before = cuda_history.launches
    got = cuda_history.merge_windows_packed(rows.to(cuda), sel.to(cuda),
                                            precision=p)
    torch.cuda.synchronize()
    assert cuda_history.launches == before + 1
    assert torch.equal(got.cpu(), want)
    assert not want[:, 1].any() and want[1:, -1].any()


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
    assert cuda_history.launches == k3 + 1 and cuda_digest.launches > k2
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
