"""The PyTorch port's sketch math, numerics, hashing and parser against the
JAX package, on the CPU: HLL packing/insert byte-exact, the HLL estimate
within rtol 1e-6 (the 2^p-lane exp2 sum is reduced in another order),
t-digest compression held through the quantiles of its result, and the
port's import graph free of JAX and of the JAX package."""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from veneur_tpu.ops import hll as jhll
from veneur_tpu.ops import tdigest as jtd
from veneur_tpu.samplers import parser as jparser
from veneur_tpu.utils import hashing as jhashing
from veneur_tpu.utils import numerics as jnum
from veneur_tpu_torch.ops import hll as thll
from veneur_tpu_torch.ops import tdigest as ttd
from veneur_tpu_torch.samplers import parser as tparser
from veneur_tpu_torch.utils import hashing as thashing
from veneur_tpu_torch.utils import numerics as tnum


@pytest.mark.parametrize("p", [6, 8, 14])
def test_pack_unpack_registers_byte_exact(p):
    rng = np.random.default_rng(p)
    regs = rng.integers(0, 62, size=(5, 1 << p)).astype(np.uint8)
    want = np.asarray(jhll.pack_registers(jnp.asarray(regs), precision=p))
    got = thll.pack_registers(torch.from_numpy(regs), precision=p).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(thll.pack_registers_np(regs, p), want)
    back = thll.unpack_registers(torch.from_numpy(want.copy()), precision=p)
    np.testing.assert_array_equal(back.numpy(), regs)
    np.testing.assert_array_equal(thll.unpack_registers_np(want, p), regs)


def test_insert_batch_dense_and_packed_byte_exact():
    p, k, b = 8, 16, 400
    rng = np.random.default_rng(1)
    regs = rng.integers(0, 20, size=(k, 1 << p)).astype(np.uint8)
    slot = rng.integers(0, k + 3, b).astype(np.int32)   # overflow rows drop
    reg = rng.integers(0, 1 << p, b).astype(np.int32)
    reg[:16] = 17                                       # duplicates
    rho = rng.integers(0, 54, b).astype(np.uint8)
    want = np.asarray(jhll.insert_batch(
        jnp.asarray(regs), jnp.asarray(slot), jnp.asarray(reg),
        jnp.asarray(rho), precision=p))
    got = thll.insert_batch(torch.from_numpy(regs), torch.from_numpy(slot),
                            torch.from_numpy(reg), torch.from_numpy(rho),
                            precision=p)
    np.testing.assert_array_equal(got.numpy(), want)
    words = thll.pack_registers_np(regs, p)
    want_p = np.asarray(jhll.insert_batch_packed(
        jnp.asarray(words), jnp.asarray(slot), jnp.asarray(reg),
        jnp.asarray(rho), precision=p))
    got_p = thll.insert_batch_packed(
        torch.from_numpy(words), torch.from_numpy(slot),
        torch.from_numpy(reg), torch.from_numpy(rho), precision=p)
    np.testing.assert_array_equal(got_p.numpy(), want_p)


def test_estimate_packed_rows_matches_jax():
    p = 14
    rng = np.random.default_rng(2)
    dense = rng.integers(0, 30, size=(4, 1 << p)).astype(np.uint8)
    dense[0] = 0                      # empty: linear counting gives 0
    dense[1, 1 << 12:] = 0            # linear-counting branch
    dense[2] = rng.integers(0, 3, 1 << p)
    words = thll.pack_registers_np(dense, p)
    want = np.asarray(jhll.estimate_packed_rows(jnp.asarray(words),
                                                precision=p))
    got = thll.estimate_packed_rows(torch.from_numpy(words),
                                    precision=p).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    empty = thll.estimate_packed_rows(
        torch.zeros((0, thll.packed_words(p)), dtype=torch.int32),
        precision=p)
    assert tuple(empty.shape) == (0,)


def test_split_hash_and_member_hash_match_jax():
    rng = np.random.default_rng(3)
    h = rng.integers(0, 2 ** 63, 1000, dtype=np.int64).astype(np.uint64) * 2
    h[:3] = [0, 1, 2 ** 63]
    for a, b in zip(thll.split_hash(h), jhll.split_hash(h)):
        np.testing.assert_array_equal(a, b)
    for member in (b"", b"a", b"uid-12345", bytes(range(70))):
        assert thashing.metro_hash_64(member) == jhashing.metro_hash_64(
            member)
        assert thashing.fnv1a_32(member) == jhashing.fnv1a_32(member)
        assert thashing.fnv1a_64(member) == jhashing.fnv1a_64(member)
        assert thashing.hll_reg_rho(member, 14) == jhashing.hll_reg_rho(
            member, 14)
    assert thashing.splitmix64(12345) == jhashing.splitmix64(12345)


def test_twofloat_numerics_byte_exact():
    rng = np.random.default_rng(4)
    hi = rng.normal(0, 1e6, 256).astype(np.float32)
    lo = (rng.normal(0, 1, 256) * 1e-3).astype(np.float32)
    x = rng.normal(0, 1e3, 256).astype(np.float32)
    for want, got in zip(
            jnum.twofloat_add(jnp.asarray(hi), jnp.asarray(lo),
                              jnp.asarray(x)),
            tnum.twofloat_add(torch.from_numpy(hi), torch.from_numpy(lo),
                              torch.from_numpy(x))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for want, got in zip(
            jnum.twofloat_merge(*map(jnp.asarray, (hi, lo, x, lo))),
            tnum.twofloat_merge(*map(torch.from_numpy, (hi, lo, x, lo)))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _rand_digest_rows(rng, r, c):
    mean = rng.lognormal(2.0, 1.0, (r, c)).astype(np.float32)
    weight = rng.uniform(0.0, 3.0, (r, c)).astype(np.float32)
    weight[rng.uniform(size=(r, c)) < 0.4] = 0.0
    weight[0] = 0.0
    mean[1, ::3] = mean[1, 0]          # duplicate means
    return mean, weight


def _jax_quantiles(mean, weight, qs):
    mn = np.where(weight > 0, mean, np.inf).min(-1).astype(np.float32)
    mx = np.where(weight > 0, mean, -np.inf).max(-1).astype(np.float32)
    import jax
    return np.asarray(jax.vmap(jtd._quantiles_one,
                               in_axes=(0, 0, 0, 0, None))(
        jnp.asarray(mean), jnp.asarray(weight), jnp.asarray(mn),
        jnp.asarray(mx), jnp.asarray(qs)))


@pytest.mark.parametrize("exact_extremes", [0, 8, 64])
def test_compress_rows_quantiles_match_jax(exact_extremes):
    """Production row width (472 cells) with the integer weights ingest
    gives (1/rate for rates 1, 1/2, 1/3): the cumulative weights are then
    exact on both sides, so every centroid lands in the same cell and the
    weights agree byte for byte. Only the w·m prefix sums round
    differently (torch's CPU cumsum accumulates f32 in f64, XLA's in
    f32), which the quantiles of the result absorb within 2e-5."""
    rng = np.random.default_rng(5 + exact_extremes)
    r, c = 24, 472
    mean = rng.lognormal(2.0, 1.0, (r, c)).astype(np.float32)
    weight = rng.integers(1, 4, (r, c)).astype(np.float32)
    weight[rng.uniform(size=(r, c)) < 0.4] = 0.0
    weight[0] = 0.0
    mean[1, ::3] = mean[1, 0]          # duplicate means
    kw = dict(compression=100.0, cells_per_k=3,
              out_c=160 + 2 * exact_extremes, exact_extremes=exact_extremes)
    jm, jw = jtd.compress_rows(jnp.asarray(mean), jnp.asarray(weight), **kw)
    tm, tw = ttd.compress_rows(torch.from_numpy(mean),
                               torch.from_numpy(weight), **kw)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    qs = np.asarray([0.0, 0.01, 0.25, 0.5, 0.9, 0.99, 1.0], np.float32)
    want = _jax_quantiles(np.asarray(jm), np.asarray(jw), qs)
    got = _jax_quantiles(tm.numpy(), tw.numpy(), qs)
    assert np.isnan(want[0]).all() and np.isnan(got[0]).all()
    np.testing.assert_allclose(got[1:], want[1:], rtol=2e-5, atol=2e-5)


def test_quantiles_one_matches_jax_interp():
    """The port's jnp.interp twin, endpoints included."""
    rng = np.random.default_rng(6)
    mean, weight = _rand_digest_rows(rng, 16, 64)
    qs = np.asarray([0.0, 1e-4, 0.3, 0.5, 0.999, 1.0], np.float32)
    mn = np.where(weight > 0, mean, np.inf).min(-1).astype(np.float32)
    mx = np.where(weight > 0, mean, -np.inf).max(-1).astype(np.float32)
    want = _jax_quantiles(mean, weight, qs)
    got = ttd._quantiles_one(*map(torch.from_numpy,
                                  (mean, weight, mn, mx, qs))).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("line", [
    b"a.b.c:1|c", b"x:2.5|c|@0.5|#b:2,a:1", b"g:-3e2|g|#veneurlocalonly",
    b"t:12|ms|#z,veneurglobalonly:1,a", b"h:0.5|h|@1", b"d:7|d|#",
    b"s:user-1|s|#k:v", b"bad", b"n:1", b"n:x|c", b"n:1|q", b"n:1|c|@2",
    b"n:1|c|@0.5|@0.5", b"n:1|c||#a", b"n: 1|c", b"n:1_0|c", b":1|c",
    b"n:nan|g", b"n:1|c|#a|#b", b"n:1|c|x"])
def test_parse_metric_matches_jax(line):
    try:
        want = jparser.parse_metric(line)
    except jparser.ParseError:
        with pytest.raises(tparser.ParseError):
            tparser.parse_metric(line)
        return
    got = tparser.parse_metric(line)
    for f in ("name", "type", "value", "digest", "sample_rate", "tags",
              "joined_tags", "scope"):
        assert getattr(got, f) == getattr(want, f), f


def test_port_imports_no_jax_and_no_reference_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import veneur_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'veneur_tpu' or m.startswith('veneur_tpu.')]\n"
        "assert not bad, bad\n"
        "n = sum(m.startswith('veneur_tpu_torch.') for m in sys.modules)\n"
        "assert n >= 30, n\n"
        "import veneur_tpu_torch.native as nat\n"
        "import veneur_tpu_torch.server.native_aggregator\n"
        "assert nat.load.cache_info().currsize == 0   # built at first use\n"
        "print('ok', n)\n")
    import pathlib
    root = pathlib.Path(__file__).resolve().parent.parent
    res = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.startswith("ok")
