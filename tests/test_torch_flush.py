"""The port's flush half against the JAX package, on the CPU.

- The digest quantile kernel's plain version (ops/cuda_digest.py) against
  the Pallas kernel `quantiles_rows` in interpret mode and against the XLA
  path `_quantiles_one`, within rtol/atol 2e-5: random occupancy, empty
  rows (NaN), single-cell rows, duplicate means, dead cells (keyed +inf)
  among live ones, endpoint quantiles, the production 472-cell width,
  and rows of 2,056 and 3,928 cells.
- `flush_live_in_packed`: the packed output buffer byte-equal to the JAX
  one except the quantile and median columns (2e-5) and the HLL
  estimates (rtol 1e-6), with and without the raw sketch rows.
- The host halves (`pack_flush_inputs`, `unpack_flush`, `pad_bucket`,
  `pack_bucket_chunks`, `combine_flush_scalars`) against the JAX ones.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from veneur_tpu.aggregation import state as jstate_mod
from veneur_tpu.aggregation import step as jstep
from veneur_tpu.ops import pallas_digest as jpd
from veneur_tpu.ops import tdigest as jtd
from veneur_tpu_torch import convert
from veneur_tpu_torch.aggregation import state as tstate_mod
from veneur_tpu_torch.aggregation import step as tstep
from veneur_tpu_torch.ops import cuda_digest


def _min_max(mean, weight):
    live = weight > 0
    any_live = live.any(-1)
    mn = np.where(any_live, np.where(live, mean, np.inf).min(-1), np.inf)
    mx = np.where(any_live, np.where(live, mean, -np.inf).max(-1), -np.inf)
    return mn.astype(np.float32), mx.astype(np.float32)


def _digest_rows(seed, r, c):
    rng = np.random.default_rng(seed)
    mean = rng.lognormal(2.0, 1.0, (r, c)).astype(np.float32)
    if c > 256:
        # at the production width two f32 prefix sums of non-integer
        # weights drift apart by more than 2e-5 even between the two JAX
        # paths (its own test holds them to 1e-3 there); ingest's weights
        # are sums of 1/rate, integers for the usual rates
        weight = rng.integers(0, 5, (r, c)).astype(np.float32)
    else:
        weight = rng.uniform(0.0, 4.0, (r, c)).astype(np.float32)
    weight[rng.uniform(size=(r, c)) < 0.5] = 0.0
    weight[0] = 0.0                       # empty row -> NaN
    weight[1] = 0.0
    weight[1, 17] = 3.0                   # single live cell
    mean[2] = rng.choice(np.asarray([1.0, 2.0, 2.0, 3.0], np.float32), c)
    weight[3, ::2] = 0.0                  # dead cells (+inf keys) interleaved
    weight[3, 1::2] = 1.0
    mn, mx = _min_max(mean, weight)
    return mean, weight, mn, mx


def _plain(mean, weight, mn, mx, qs):
    return cuda_digest.quantiles_rows(
        *map(torch.from_numpy, (mean, weight, mn, mx, qs))).numpy()


def _xla(mean, weight, mn, mx, qs):
    return np.asarray(jax.vmap(jtd._quantiles_one,
                               in_axes=(0, 0, 0, 0, None))(
        *map(jnp.asarray, (mean, weight, mn, mx, qs))))


@pytest.mark.parametrize("c", [64, 232, 472, 2056, 3928])
def test_plain_quantiles_match_pallas_interpret_and_xla(c):
    """Up to the production width on 40 rows, and at the rows the card
    serves past shared memory (2,056 and 3,928 cells: compression 1,279
    and 2,400) on 8."""
    mean, weight, mn, mx, = _digest_rows(c, 40 if c <= 472 else 8, c)
    qs = np.asarray([0.0, 0.01, 0.5, 0.99, 1.0], np.float32)
    got = _plain(mean, weight, mn, mx, qs)
    pallas = np.asarray(jpd.quantiles_rows(
        *map(jnp.asarray, (mean, weight, mn, mx, qs)), interpret=True))
    xla = _xla(mean, weight, mn, mx, qs)
    assert np.isnan(got[0]).all() and np.isnan(pallas[0]).all()
    for want in (pallas, xla):
        assert np.array_equal(np.isnan(got), np.isnan(want))
        live = ~np.isnan(want)
        np.testing.assert_allclose(got[live], want[live], rtol=2e-5,
                                   atol=2e-5)
    np.testing.assert_allclose(got[1], np.full(5, mean[1, 17]), rtol=1e-6)
    assert cuda_digest.launches == 0   # CPU tensors never launch


def test_plain_quantiles_duplicate_keys_and_empty_cells():
    """Many equal means with different weights: the sort is stable, so
    the result is the XLA path's exactly up to the prefix-sum rounding."""
    c = 128
    rng = np.random.default_rng(6)
    mean = rng.choice(np.asarray([1.0, 2.0, 2.0, 3.0], np.float32),
                      size=(9, c))
    weight = rng.uniform(0.5, 2.0, (9, c)).astype(np.float32)
    weight[:, 100:] = 0.0
    mn, mx = _min_max(mean, weight)
    qs = np.linspace(0.0, 1.0, 11).astype(np.float32)
    got = _plain(mean, weight, mn, mx, qs)
    np.testing.assert_allclose(got, _xla(mean, weight, mn, mx, qs),
                               rtol=2e-5, atol=2e-5)


def _flush_fixture(want_raw):
    """A JAX state after a few XLA-chain steps and a compaction, plus its
    port copy, a live-slot selection per kind and the packed inputs."""
    from tests.test_torch_ingest import SMALL, _rand_batch
    jspec = jstate_mod.TableSpec(**SMALL)
    tspec = tstate_mod.TableSpec(**SMALL)
    rng = np.random.default_rng(7)
    jst = jstate_mod.empty_state(jspec)
    for _ in range(4):
        jst = jstep.ingest_core(jst, _rand_batch(rng, jspec, negative=False),
                                spec=jspec, allow_pallas=False)
    jst = jstep.compact_core(jst, spec=jspec)
    jst = jstep.ingest_core(jst, _rand_batch(rng, jspec, negative=False),
                            spec=jspec, allow_pallas=False)
    tst = convert.state_from_numpy(
        {k: np.asarray(v) for k, v in jst._asdict().items()}, "cpu")
    caps = (jspec.counter_capacity, jspec.gauge_capacity,
            jspec.status_capacity, jspec.set_capacity, jspec.histo_capacity)
    slots = [rng.permutation(cap)[:max(cap // 2, 1)].astype(np.int32)
             for cap in caps]
    buckets = tuple(jstep.pad_bucket(len(s), cap)
                    for s, cap in zip(slots, caps))
    perc = [0.5, 0.9, 0.99]
    chunks = jstep.pack_bucket_chunks(slots, buckets, 0)
    flat = jstep.pack_flush_inputs(perc, chunks)
    assert flat.tobytes() == tstep.pack_flush_inputs(
        perc, tstep.pack_bucket_chunks(slots, buckets, 0)).tobytes()
    want = np.asarray(jstep.flush_live_in_packed(
        jst, flat, spec=jspec, n_q=len(perc), buckets=buckets,
        want_raw=want_raw))
    got = tstep.flush_live_in_packed(
        tst, torch.from_numpy(flat.copy()), spec=tspec, n_q=len(perc),
        buckets=buckets, want_raw=want_raw).numpy()
    shapes = jstep.flush_live_shapes(jspec, *buckets, len(perc),
                                     want_raw=want_raw)
    assert shapes == tstep.flush_live_shapes(tspec, *buckets, len(perc),
                                             want_raw=want_raw)
    return got, want, shapes


TOLERANT = {"histo_quantiles": 2e-5, "histo_median": 2e-5,
            "set_estimate": 1e-6}


@pytest.mark.parametrize("want_raw", [False, True])
def test_flush_live_in_packed_buffer_matches_jax(want_raw):
    got, want, shapes = _flush_fixture(want_raw)
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape
    g, w = tstep.unpack_flush(got, shapes), jstep.unpack_flush(want, shapes)
    assert list(g) == list(w)
    for key in g:
        a, b = np.asarray(g[key]), np.asarray(w[key])
        if key in TOLERANT:
            assert np.array_equal(np.isnan(a), np.isnan(b)), key
            live = ~np.isnan(b)
            tol = TOLERANT[key]
            np.testing.assert_allclose(a[live], b[live], rtol=tol,
                                       atol=tol if "histo" in key else 0,
                                       err_msg=key)
        else:
            assert a.tobytes() == b.tobytes(), f"{key} differs"
    assert np.isfinite(g["histo_quantiles"]).any()
    a = tstep.combine_flush_scalars(g)
    b = jstep.combine_flush_scalars(w)
    for key in ("counter", "histo_count", "histo_sum", "histo_avg",
                "histo_hmean"):
        np.testing.assert_array_equal(a[key], b[key])


def test_flush_host_helpers_match_jax():
    for n, cap in ((0, 64), (1, 64), (65, 1 << 10), (5000, 4096)):
        assert tstep.pad_bucket(n, cap) == jstep.pad_bucket(n, cap)
    slots = [np.arange(300, dtype=np.int32), np.arange(5, dtype=np.int32)]
    for i in range(3):
        for a, b in zip(tstep.pack_bucket_chunks(slots, (128, 64), i, 7),
                        jstep.pack_bucket_chunks(slots, (128, 64), i, 7)):
            np.testing.assert_array_equal(a, b)
    assert tstep.FLUSH_KEY_KIND == jstep.FLUSH_KEY_KIND
    assert tstep.FLUSH_BLOCK_ROWS == jstep.FLUSH_BLOCK_ROWS
