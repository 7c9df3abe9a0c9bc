"""The port's ingest half against the JAX package, on the CPU.

- The fused ingest kernel's plain version (ops/cuda_ingest.py), fed the
  JAX prologue's own sorted streams and cell plan, against the Pallas
  kernel `fused_ingest_core` in interpret mode: byte-exact on all 14 state
  leaves, duplicate slots, overflow and negative slots, word-straddling
  HLL fields, multi-block widths and a hot run (one slot owning the
  whole histogram and set lanes) included.
- The port's own prologue (`build_streams`) against the JAX one.
- `packed_layout` / `pack_batch` / `unpack_batch`: identical bytes.
- `packed_step_core` with in-band compaction against the JAX
  `ingest_step_packed` over several steps: byte-exact on counters,
  gauges, status, stamps, HLL and the histogram scalars; the digest
  cells through their quantiles within 2e-5 (a compaction's prefix sums
  may round differently, and a later cell plan may then differ at a
  boundary; at this size they agree byte for byte).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from veneur_tpu.aggregation import state as jstate_mod
from veneur_tpu.aggregation import step as jstep
from veneur_tpu.ops import hll as jhll
from veneur_tpu.ops import pallas_ingest as jpi
from veneur_tpu_torch import convert
from veneur_tpu_torch.aggregation import state as tstate_mod
from veneur_tpu_torch.aggregation import step as tstep
from veneur_tpu_torch.ops import cuda_ingest

SMALL = dict(counter_capacity=64, gauge_capacity=32, status_capacity=8,
             set_capacity=16, histo_capacity=32, hll_precision=8,
             temp_cells=16)
WIDE = dict(SMALL, counter_capacity=1 << 16, set_capacity=1 << 13)
# the widths the card serves by walking rows in place (3,928 digest
# cells; 12,288 HLL words a row)
WIDE_DIGEST = dict(SMALL, compression=2400.0)
P16 = dict(SMALL, hll_precision=16)


def _specs(kw):
    return jstate_mod.TableSpec(**kw), tstate_mod.TableSpec(**kw)


def _rand_batch(rng, spec, b=64, negative=True):
    """Hostile to the kernel: duplicate slots, overflow rows
    (slot > cap), negative slots, padding tails (slot == cap),
    zero-weight histogram rows and registers whose 6-bit field straddles
    two words."""
    def slots(cap, n):
        s = rng.integers(0, max(cap // 2, 1), size=n).astype(np.int32)
        s[rng.integers(0, n, size=max(n // 8, 1))] = cap + 3
        if negative:
            s[rng.integers(0, n, size=2)] = -1
        return np.concatenate([s, np.full(b - n, cap, np.int32)])
    n = (3 * b) // 4
    wt = rng.integers(1, 3, b).astype(np.float32)
    wt[rng.integers(0, b, size=b // 4)] = 0.0
    return jstep.Batch(
        counter_slot=slots(spec.counter_capacity, n),
        counter_inc=rng.uniform(-3, 5, b).astype(np.float32),
        gauge_slot=slots(spec.gauge_capacity, n),
        gauge_val=rng.uniform(-10, 10, b).astype(np.float32),
        status_slot=slots(spec.status_capacity, n),
        status_val=rng.integers(0, 4, b).astype(np.float32),
        set_slot=slots(spec.set_capacity, n),
        set_reg=rng.integers(0, jhll.num_registers(spec.hll_precision),
                             b).astype(np.int32),
        set_rho=rng.integers(0, 54, b).astype(np.uint8),
        histo_slot=slots(spec.histo_capacity, n),
        histo_val=rng.lognormal(1.0, 1.0, b).astype(np.float32),
        histo_wt=wt,
    )


def _jax_streams(jst, batch, spec) -> cuda_ingest.IngestStreams:
    """The Pallas path's prologue (pallas_ingest._stream + step._histo_plan)
    as the port's stream tuple."""
    j = {k: jnp.asarray(v) for k, v in batch._asdict().items()
         if v is not None}
    c_sk, (c_inc,) = jpi._stream(j["counter_slot"], spec.counter_capacity,
                                 j["counter_inc"])
    g_sk, (g_val,) = jpi._stream(j["gauge_slot"], spec.gauge_capacity,
                                 j["gauge_val"])
    st_sk, (st_val,) = jpi._stream(j["status_slot"], spec.status_capacity,
                                   j["status_val"])
    reg_ok = (j["set_reg"] >= 0) & (j["set_reg"] < spec.registers)
    s_sk, (s_reg, s_rho) = jpi._stream(
        j["set_slot"], spec.set_capacity, j["set_reg"],
        j["set_rho"].astype(jnp.int32), extra_valid=reg_ok)
    hs, h_cell, h_v, h_w, h_tadd = jstep._histo_plan(
        jst, j["histo_slot"], j["histo_val"], j["histo_wt"], spec)
    h_sk = jnp.where(hs < spec.histo_capacity, hs, jpi._BIG)
    arrays = dict(
        c_slot=c_sk, c_inc=c_inc, g_slot=g_sk, g_val=g_val, st_slot=st_sk,
        st_val=st_val, s_slot=s_sk, s_reg=s_reg, s_rho=s_rho, h_slot=h_sk,
        h_cell=h_cell, h_v=h_v, h_w=h_w, h_wv=h_w * h_v,
        h_rcp=jnp.where(h_w > 0, h_w / h_v, 0.0), h_tadd=h_tadd)
    return cuda_ingest.IngestStreams(**{
        k: torch.from_numpy(np.array(v)) for k, v in arrays.items()})


def _np_state(st):
    return {k: np.asarray(v) for k, v in st._asdict().items()}


def _assert_leaves_equal(got: dict, want: dict, names):
    for name in names:
        a, b = got[name], want[name]
        assert a.dtype == b.dtype, name
        assert np.array_equal(a, b, equal_nan=True), f"leaf {name} differs"


def _warm_state(jspec, rng, steps=2):
    """A JAX state with live digests, HLL rows and counters, so the next
    batch's adds start from resident values."""
    st = jstate_mod.empty_state(jspec)
    for _ in range(steps):
        st = jstep.ingest_core(st, _rand_batch(rng, jspec, negative=False),
                               spec=jspec, allow_pallas=False)
    return st


def _hot_batch(rng, spec, b=128):
    """One histogram slot takes the whole lane (on a warm state its temp
    and k-cells interleave) and one set slot the whole set lane, over
    every register, the straddling fields (register % 16 in {5, 10})
    included."""
    batch = _rand_batch(rng, spec, b=b)
    reg = rng.integers(0, spec.registers, b).astype(np.int32)
    reg[::4] = 16 * rng.integers(0, spec.registers // 16, b // 4) + 5
    reg[1::4] = 16 * rng.integers(0, spec.registers // 16, b // 4) + 10
    return batch._replace(histo_slot=np.full(b, 3, np.int32),
                          set_slot=np.full(b, 5, np.int32), set_reg=reg)


@pytest.mark.parametrize("kw,hot", [(SMALL, False), (WIDE, False),
                                    (SMALL, True), (WIDE_DIGEST, True),
                                    (P16, True)],
                         ids=["small", "multi_block", "hot", "wide_digest",
                              "p16"])
def test_plain_kernel_matches_pallas_interpret_byte_exact(kw, hot):
    jspec, tspec = _specs(kw)
    rng = np.random.default_rng(0)
    jst = _warm_state(jspec, rng)
    tst = convert.state_from_numpy(_np_state(jst), "cpu")
    for _ in range(3):
        batch = (_hot_batch if hot else _rand_batch)(rng, jspec, b=128)
        streams = _jax_streams(jst, batch, jspec)
        jst = jpi.fused_ingest_core(jst, batch, spec=jspec, interpret=True)
        cuda_ingest.fused_ingest(tst, streams, tspec)
        _assert_leaves_equal(convert.state_to_numpy(tst), _np_state(jst),
                             cuda_ingest.STATE_LEAVES)
    assert cuda_ingest.launches == 0   # CPU tensors never launch


def test_plain_kernel_duplicate_slot_ordering():
    """Every row on one slot: gauges keep the last write, counters add in
    batch order from the resident value, sets keep the register max."""
    jspec, tspec = _specs(SMALL)
    b = 32
    batch = jstep.Batch(
        counter_slot=np.zeros(b, np.int32),
        counter_inc=(np.arange(b, dtype=np.float32) * 1e-3 + 1e4),
        gauge_slot=np.zeros(b, np.int32),
        gauge_val=np.arange(b, dtype=np.float32),
        status_slot=np.zeros(b, np.int32),
        status_val=np.arange(b, dtype=np.float32) % 4,
        set_slot=np.zeros(b, np.int32),
        set_reg=np.full(b, 5, np.int32),       # bits 30-35: straddles
        set_rho=(np.arange(b) % 7 + 1).astype(np.uint8),
        histo_slot=np.zeros(b, np.int32),
        histo_val=np.linspace(0.1, 3.0, b).astype(np.float32),
        histo_wt=np.ones(b, np.float32),
    )
    jst = jstate_mod.empty_state(jspec)
    tst = convert.state_from_numpy(_np_state(jst), "cpu")
    streams = _jax_streams(jst, batch, jspec)
    jst = jpi.fused_ingest_core(jst, batch, spec=jspec, interpret=True)
    cuda_ingest.fused_ingest(tst, streams, tspec)
    got = convert.state_to_numpy(tst)
    _assert_leaves_equal(got, _np_state(jst), cuda_ingest.STATE_LEAVES)
    assert got["gauge"][0] == b - 1
    assert jhll.unpack_registers_np(got["hll"][:1], 8)[0, 5] == 7


@pytest.mark.parametrize("kw,route", [
    ({}, "staged"),
    (dict(hll_precision=15, compression=2200.0), "staged"),
    (dict(hll_precision=16), "in_place"),
    (dict(compression=2400.0), "in_place"),
    (dict(set_capacity=1 << 20, histo_capacity=4_600_000), "staged"),
    (dict(counter_capacity=(1 << 30) + 1), "sentinel"),
], ids=["default", "widest", "p16", "wide_digest", "offsets", "sentinel"])
def test_kernel_stages_or_walks_rows_in_place_and_refuses_offsets(kw,
                                                                  route):
    """The CUDA branch picks its kernel from the spec before it launches:
    rows that fit a block's shared memory (the default widths, and the
    widest: hll_precision 15 with 3,624 digest cells) are staged; a set
    row at hll_precision 16 or a digest row of 3,928 cells (compression
    2,400) is walked in place, with the stages alone in shared memory.
    Its offsets are 64-bit: tables whose rows x width pass 2^31 (2^20
    set rows of 3,072 words, 4,600,000 digest rows of 472 cells) are
    served; only a capacity past the stream sentinel 2^30 raises."""
    spec = tstate_mod.TableSpec(**kw)
    need = cuda_ingest.shared_bytes(spec.hll_words, spec.total_cells)
    if route == "sentinel":
        with pytest.raises(ValueError, match="sentinel"):
            cuda_ingest._check_spec(spec)
        return
    cuda_ingest._check_spec(spec)
    assert cuda_ingest.rows_in_place(spec) == (route == "in_place")
    assert (need <= cuda_ingest.SMEM_PER_BLOCK) == (route == "staged")
    if not kw or "set_capacity" in kw:
        assert need == 83_200              # 2 blocks an SM at the defaults
    # in place, a block holds the walks' stages alone, at any width
    assert cuda_ingest.shared_bytes(spec.hll_words, spec.total_cells,
                                    in_place=True) == 58_240


def test_port_prologue_matches_jax_prologue():
    """build_streams (torch) against the Pallas prologue (JAX) on the
    same state: every lane byte-identical, cells included (the batch is
    the state's first, so no f32 mass-below sums are involved)."""
    jspec, tspec = _specs(SMALL)
    rng = np.random.default_rng(1)
    batch = _rand_batch(rng, jspec, b=128)
    jst = jstate_mod.empty_state(jspec)
    want = _jax_streams(jst, batch, jspec)
    tbatch = tstep.Batch(**{k: torch.from_numpy(np.array(v))
                            for k, v in batch._asdict().items()
                            if v is not None})
    got = tstep.build_streams(tstate_mod.empty_state(tspec, "cpu"), tbatch,
                              tspec)
    for name in cuda_ingest.IngestStreams._fields:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        assert torch.equal(a, b), f"stream {name} differs"


def test_packed_layout_and_pack_bytes_identical():
    jspec, _ = _specs(SMALL)
    rng = np.random.default_rng(2)
    batch = _rand_batch(rng, jspec, b=37)            # u8 lane pads a word
    stats = batch._replace(
        histo_stat_slot=np.arange(5, dtype=np.int32),
        histo_stat_min=np.ones(5, np.float32),
        histo_stat_max=np.full(5, 2.0, np.float32),
        histo_stat_recip=np.full(5, 0.5, np.float32))
    for b in (batch, stats):
        sizes = jstep.batch_sizes(b)
        tb = tstep.Batch(*b)
        assert tstep.batch_sizes(tb) == sizes
        assert tstep.packed_layout(sizes) == jstep.packed_layout(sizes)
        for do_compact in (False, True):
            want = jstep.pack_batch(b, do_compact)
            got = tstep.pack_batch(tb, do_compact)
            assert got.dtype == want.dtype
            assert got.tobytes() == want.tobytes()
        flat = torch.from_numpy(got)
        back = tstep.unpack_batch(flat[1:], sizes)
        for name, a, orig in zip(tstep.Batch._fields, back, b):
            if orig is None:
                assert a is None
                continue
            assert a.numpy().tobytes() == np.asarray(orig).tobytes(), name


EXACT_LEAVES = ("counter_acc", "counter_hi", "counter_lo", "gauge",
                "gauge_stamp", "status", "status_stamp", "hll", "h_min",
                "h_max", "h_count_acc", "h_count_hi", "h_count_lo",
                "h_sum_acc", "h_sum_hi", "h_sum_lo", "h_recip_acc",
                "h_recip_hi", "h_recip_lo")


def _row_quantiles(d: dict, qs):
    import jax
    from veneur_tpu.ops import tdigest as jtd
    mean = d["h_wm"] / np.maximum(d["h_w"], 1e-30)
    return np.asarray(jax.vmap(jtd._quantiles_one,
                               in_axes=(0, 0, 0, 0, None))(
        jnp.asarray(mean), jnp.asarray(d["h_w"]), jnp.asarray(d["h_min"]),
        jnp.asarray(d["h_max"]), jnp.asarray(qs)))


def test_packed_step_core_with_compaction_matches_jax():
    """Six packed steps, compaction in band every second step. The JAX
    side is the production jit (`ingest_step_packed`, the XLA chain on
    the CPU), whose scatters wrap negative slots, so the batches carry
    none (the port drops them, as the fused kernel does)."""
    jspec, tspec = _specs(SMALL)
    rng = np.random.default_rng(3)
    jst = jstate_mod.empty_state(jspec)
    tst = tstate_mod.empty_state(tspec, "cpu")
    qs = np.asarray([0.01, 0.5, 0.9, 0.99], np.float32)
    for step in range(6):
        batch = _rand_batch(rng, jspec, b=128, negative=False)
        do_compact = step % 2 == 1
        flat = jstep.pack_batch(batch, do_compact)
        sizes = jstep.batch_sizes(batch)
        jst = jstep.ingest_step_packed(jst, flat, spec=jspec, sizes=sizes)
        tstep.packed_step_core(tst, torch.from_numpy(flat.copy()),
                               spec=tspec, sizes=sizes,
                               do_compact=do_compact)
        got, want = convert.state_to_numpy(tst), _np_state(jst)
        _assert_leaves_equal(got, want, EXACT_LEAVES)
        np.testing.assert_array_equal(got["h_temp_n"], want["h_temp_n"])
        # the digests agree through their quantiles
        gq, wq = _row_quantiles(got, qs), _row_quantiles(want, qs)
        assert np.array_equal(np.isnan(gq), np.isnan(wq))
        live = ~np.isnan(wq)
        np.testing.assert_allclose(gq[live], wq[live], rtol=2e-5,
                                   atol=2e-5)
        np.testing.assert_allclose(got["h_w"].sum(-1), want["h_w"].sum(-1),
                                   rtol=1e-6)
