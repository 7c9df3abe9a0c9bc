"""Batched HyperLogLog over torch tensors.

One sketch per set key, precision p (2^p registers; p=14 by default, the
reference's). The device holds the registers in the 6-bit packed layout
of the JAX package: register r at bit offset 6·r little-endian within a
row of int32 words, so 16 registers fill exactly 3 words and a row of
2^p registers takes ``packed_words(p)`` words. A field that straddles a
word boundary (in-word bit 28 or 30) always has its second word in the
same row, because 2^p is a multiple of 16.

Shifts that would cross bit 31 are done in int64 and masked before the
words are narrowed back to int32; right shifts on int32 are arithmetic,
so every extracted lane is masked after its shift.
"""

from __future__ import annotations

import numpy as np
import torch

DEFAULT_PRECISION = 14
REGISTER_BITS = 6        # max rho = 64-4+1 = 61 < 64 fits any p >= 4


def num_registers(precision: int = DEFAULT_PRECISION) -> int:
    return 1 << precision


def packed_words(precision: int = DEFAULT_PRECISION) -> int:
    """int32 words per key for the 6-bit packed layout."""
    return (num_registers(precision) * REGISTER_BITS + 31) // 32


def _alpha(m: int) -> float:
    if m == 16:
        return 0.673
    if m == 32:
        return 0.697
    if m == 64:
        return 0.709
    return 0.7213 / (1.0 + 1.079 / m)


def split_hash(hashes64, precision: int = DEFAULT_PRECISION):
    """Host numpy: uint64 member hashes -> (register index i32, rho u8);
    rho = 1 + leading zeros of the remaining 64-p bits, capped at 64-p+1
    (the same split as utils.hashing.hll_reg_rho, vectorized)."""
    h = np.asarray(hashes64, dtype=np.uint64)
    p = precision
    reg = (h >> np.uint64(64 - p)).astype(np.int32)
    rest = h << np.uint64(p)
    cur = rest
    lz = np.zeros(h.shape, np.int32)
    for shift in (32, 16, 8, 4, 2, 1):
        mask = cur < (np.uint64(1) << np.uint64(64 - shift))
        lz = np.where(mask, lz + shift, lz)
        cur = np.where(mask, cur << np.uint64(shift), cur)
    lz = np.where(rest == 0, 64, lz)
    rho = np.minimum(lz, 64 - p) + 1
    return reg, rho.astype(np.uint8)


def _group16(x, last):
    """Split the trailing axis into (groups, last); the group count is
    explicit so a zero-row input still reshapes."""
    return x.reshape(tuple(x.shape[:-1]) + (x.shape[-1] // last, last))


def _words_from_groups(v):
    """v: int64 [..., G, 16] register values -> int64 [..., G, 3] words
    (unmasked; callers mask to 32 bits)."""
    g = [v[..., i] for i in range(16)]
    w0 = (g[0] | (g[1] << 6) | (g[2] << 12) | (g[3] << 18) | (g[4] << 24)
          | ((g[5] & 0x3) << 30))
    w1 = ((g[5] >> 2) | (g[6] << 4) | (g[7] << 10) | (g[8] << 16)
          | (g[9] << 22) | ((g[10] & 0xF) << 28))
    w2 = ((g[10] >> 4) | (g[11] << 2) | (g[12] << 8) | (g[13] << 14)
          | (g[14] << 20) | (g[15] << 26))
    return w0, w1, w2


def _lanes(w0, w1, w2):
    """The 16 register lanes of a 3-word group (any signed int dtype)."""
    return [
        w0 & 0x3F, (w0 >> 6) & 0x3F, (w0 >> 12) & 0x3F, (w0 >> 18) & 0x3F,
        (w0 >> 24) & 0x3F,
        ((w0 >> 30) & 0x3) | ((w1 & 0xF) << 2),
        (w1 >> 4) & 0x3F, (w1 >> 10) & 0x3F, (w1 >> 16) & 0x3F,
        (w1 >> 22) & 0x3F,
        ((w1 >> 28) & 0xF) | ((w2 & 0x3) << 4),
        (w2 >> 2) & 0x3F, (w2 >> 8) & 0x3F, (w2 >> 14) & 0x3F,
        (w2 >> 20) & 0x3F, (w2 >> 26) & 0x3F,
    ]


def pack_registers(regs: torch.Tensor, *,
                   precision: int = DEFAULT_PRECISION) -> torch.Tensor:
    """u8[..., R] dense registers -> i32[..., W] 6-bit packed words."""
    r = num_registers(precision)
    if r % 16 or regs.shape[-1] != r:
        raise ValueError(f"expected {r} registers, got {regs.shape[-1]}")
    v = _group16(regs, 16).to(torch.int64) & 0x3F
    words = torch.stack(_words_from_groups(v), dim=-1) & 0xFFFFFFFF
    words = torch.where(words >= (1 << 31), words - (1 << 32), words)
    return words.to(torch.int32).reshape(
        tuple(regs.shape[:-1]) + (packed_words(precision),))


def unpack_registers(words: torch.Tensor, *,
                     precision: int = DEFAULT_PRECISION) -> torch.Tensor:
    """i32[..., W] packed words -> u8[..., R] dense registers."""
    if words.shape[-1] != packed_words(precision):
        raise ValueError("packed row width does not match precision")
    g = _group16(words, 3)
    out = torch.stack(_lanes(g[..., 0], g[..., 1], g[..., 2]), dim=-1)
    return out.reshape(tuple(words.shape[:-1])
                       + (num_registers(precision),)).to(torch.uint8)


def pack_registers_np(regs, precision: int = DEFAULT_PRECISION):
    """Host numpy twin of pack_registers."""
    regs = np.asarray(regs, np.uint8)
    r = num_registers(precision)
    if r % 16 or regs.shape[-1] != r:
        raise ValueError(f"expected {r} registers, got {regs.shape[-1]}")
    v = _group16(regs, 16).astype(np.int64) & 0x3F
    words = np.stack(_words_from_groups(v), axis=-1) & 0xFFFFFFFF
    return (words.reshape(regs.shape[:-1] + (packed_words(precision),))
            .astype(np.uint32).view(np.int32))


def unpack_registers_np(words, precision: int = DEFAULT_PRECISION):
    """Host numpy twin of unpack_registers."""
    words = np.asarray(words)
    if words.shape[-1] != packed_words(precision):
        raise ValueError("packed row width does not match precision")
    g = _group16(words.astype(np.int64) & 0xFFFFFFFF, 3)
    out = np.stack(_lanes(g[..., 0], g[..., 1], g[..., 2]), axis=-1)
    return out.reshape(words.shape[:-1]
                       + (num_registers(precision),)).astype(np.uint8)


def insert_batch(registers: torch.Tensor, slot, reg, rho, *,
                 precision: int = DEFAULT_PRECISION) -> torch.Tensor:
    """Register max of a batch of (slot, register, rho) into dense
    u8[K, R] registers; returns a new table. Rows whose slot or register
    is out of range are dropped."""
    k, r = registers.shape
    ok = (slot >= 0) & (slot < k) & (reg >= 0) & (reg < r)
    flat = slot[ok].to(torch.int64) * r + reg[ok].to(torch.int64)
    out = registers.to(torch.int32).reshape(-1)
    out = out.scatter_reduce(0, flat, rho[ok].to(torch.int32), "amax")
    return out.reshape(k, r).to(torch.uint8)


def insert_rows_packed_(words: torch.Tensor, slot, reg, rho, *,
                        precision: int = DEFAULT_PRECISION) -> None:
    """In place: register max of a batch into the packed table, touching
    only the addressed rows (gather -> unpack -> max -> pack -> store)."""
    k = words.shape[0]
    r = num_registers(precision)
    ok = (slot >= 0) & (slot < k) & (reg >= 0) & (reg < r)
    if not bool(ok.any()):
        return
    s = slot[ok].to(torch.int64)
    rows, inv = torch.unique(s, return_inverse=True)
    dense = unpack_registers(words[rows], precision=precision)
    dense = insert_batch(dense, inv, reg[ok], rho[ok], precision=precision)
    words[rows] = pack_registers(dense, precision=precision)


def insert_batch_packed(words: torch.Tensor, slot, reg, rho, *,
                        precision: int = DEFAULT_PRECISION) -> torch.Tensor:
    """`insert_batch` over the packed table; returns a new table. Register
    max commutes with packing, so this equals unpack -> insert -> pack."""
    out = words.clone()
    insert_rows_packed_(out, slot, reg, rho, precision=precision)
    return out


def merge_rows_packed_(words: torch.Tensor, slot, rows, *,
                       precision: int = DEFAULT_PRECISION) -> None:
    """In place: union dense u8[B, R] import rows into the packed table,
    touching only the addressed rows (gather -> unpack -> max -> pack ->
    store). Duplicate slots are combined by a segment max before the
    store, so the store's indices are unique. Out-of-range slots,
    negative ones included, are dropped."""
    k = words.shape[0]
    slot = torch.as_tensor(slot, device=words.device).to(torch.int64)
    rows = torch.as_tensor(rows, device=words.device)
    ok = (slot >= 0) & (slot < k)
    s, r = slot[ok], rows[ok].to(torch.int32)
    if s.numel() == 0:
        return
    tgt, inv = torch.unique(s, return_inverse=True)
    comb = torch.zeros((tgt.numel(), r.shape[-1]), dtype=torch.int32,
                       device=words.device)
    comb.scatter_reduce_(0, inv[:, None].expand_as(r), r, "amax")
    cur = unpack_registers(words[tgt], precision=precision).to(torch.int32)
    words[tgt] = pack_registers(torch.maximum(cur, comb).to(torch.uint8),
                                precision=precision)


def merge_rows_packed(words: torch.Tensor, slot, rows, *,
                      precision: int = DEFAULT_PRECISION) -> torch.Tensor:
    """`merge_rows_packed_` on a copy; returns the new table."""
    out = words.clone()
    merge_rows_packed_(out, slot, rows, precision=precision)
    return out


MAGIC = b"VHLL"          # legacy round-1 wire format (still decodable)
_SPARSE_PP = 25          # axiomhq sparse precision (hyperloglog.go pp)


def serialize(registers, precision: int = DEFAULT_PRECISION) -> bytes:
    """Wire bytes for one key's registers in the reference sketch's
    MarshalBinary layout (axiomhq/hyperloglog hyperloglog.go:274): dense
    form `[version=1][p][b][sparse=0][len(m/2) BE32][m/2 nibble-packed
    bytes]`, register value = b + stored nibble, register 2i in the high
    nibble of byte i. A reference global can UnmarshalBinary these bytes
    directly, so forwarded set metrics merge across a mixed fleet.

    Base selection mirrors the reference's rebase invariant (b only ever
    grows to the register minimum): exact whenever the register spread fits
    in a nibble, saturating at b+15 otherwise — the same tailcut loss the
    reference's own insert applies (hyperloglog.go:169-180).
    """
    regs = np.asarray(registers)
    if regs.dtype != np.uint8:           # 6-bit packed i32 row
        regs = unpack_registers_np(regs, precision)
    m = regs.shape[0]
    mn, mx = int(regs.min()), int(regs.max())
    b = 0
    if mn > 0 and mx > 15:
        b = min(mn, mx - 15)
    stored = np.clip(regs.astype(np.int32) - b, 0, 15).astype(np.uint8)
    packed = ((stored[0::2] << 4) | stored[1::2]).astype(np.uint8)
    return (bytes([1, precision, b, 0]) + (m // 2).to_bytes(4, "big")
            + packed.tobytes())


def _decode_sparse_hash(k: int, p: int):
    """axiomhq sparse.go decodeHash: sparse key -> (register, rho)."""
    pp = _SPARSE_PP
    if k & 1:
        r = ((k >> 1) & 0x3F) + pp - p
        idx = (k >> (32 - p)) & ((1 << p) - 1)
    else:
        shifted = (k << (32 - pp + p - 1)) & 0xFFFFFFFF
        # clz32(shifted) + 1; shifted==0 cannot occur for a valid key
        r = (33 - shifted.bit_length()) if shifted else 32
        idx = (k >> (pp - p + 1)) & ((1 << p) - 1)
    return idx, r


def _bitlen32(x):
    """Vectorized int.bit_length for non-negative int64 arrays < 2^32.
    Binary-search halving — no float log2 (exact at every power of two)."""
    x = x.astype(np.int64)
    n = np.zeros_like(x)
    for s in (16, 8, 4, 2, 1):
        big = x >= (np.int64(1) << s)
        n = np.where(big, n + s, n)
        x = np.where(big, x >> s, x)
    return n + (x > 0)


def _decode_sparse_hashes_np(keys, p: int):
    """Vectorized `_decode_sparse_hash` over an int64 key array — returns
    (idx, r) int64 arrays. Same field math as the scalar version (the
    sparse-form oracle test in tests/test_hll.py pins both)."""
    pp = _SPARSE_PP
    k = keys.astype(np.int64) & 0xFFFFFFFF
    m = 1 << p
    odd = (k & 1) == 1
    r_odd = ((k >> 1) & 0x3F) + pp - p
    idx_odd = (k >> (32 - p)) & (m - 1)
    shifted = (k << (32 - pp + p - 1)) & 0xFFFFFFFF
    r_even = np.where(shifted == 0, 32, 33 - _bitlen32(shifted))
    idx_even = (k >> (pp - p + 1)) & (m - 1)
    return (np.where(odd, idx_odd, idx_even),
            np.where(odd, r_odd, r_even))


def _decode_varint_deltas(buf: bytes):
    """Vectorized LEB128 varint decode of axiomhq's compressedList delta
    stream -> int64 delta array. Replaces the per-byte Python while loop
   .

    Grouping trick: a varint ends at each byte with the continuation bit
    clear; `np.add.reduceat` over per-byte `7*pos`-shifted payloads at the
    group starts reassembles every value in one pass."""
    if not buf:
        return np.zeros(0, np.int64)
    b = np.frombuffer(buf, np.uint8).astype(np.int64)
    is_end = (b & 0x80) == 0
    if not is_end[-1]:
        raise ValueError("truncated HLL sparse varint")
    ends = np.nonzero(is_end)[0]
    starts = np.concatenate([[0], ends[:-1] + 1])
    gid = np.cumsum(np.concatenate([[False], is_end[:-1]]).astype(np.int64))
    pos = np.arange(b.shape[0]) - starts[gid]
    if pos.max() * 7 >= 63:
        raise ValueError("HLL sparse varint too long")
    vals = (b & 0x7F) << (7 * pos)
    return np.add.reduceat(vals, starts)


def _deserialize_axiomhq(data: bytes):
    p = data[1]
    b = data[2]
    m = 1 << p
    if data[3] == 1:
        # sparse form: tmpSet (BE32 count + BE32 keys) then compressedList
        # (count, last, varint-delta list) — decode into dense registers,
        # exactly the sketch's own toNormal() conversion
        regs = np.zeros(m, np.uint8)
        (tssz,) = _be32(data, 4)
        if 8 + 4 * tssz + 12 > len(data):
            raise ValueError("truncated HLL sparse payload (tmpSet)")
        off = 8
        ts_keys = np.frombuffer(data[off:off + 4 * tssz], ">u4") \
            .astype(np.int64)
        off += 4 * tssz
        off += 8  # compressedList count + last (we re-derive from deltas)
        (sz,) = _be32(data, off)
        off += 4
        if off + sz > len(data):
            raise ValueError("truncated HLL sparse payload (list)")
        deltas = _decode_varint_deltas(data[off:off + sz])
        keys = np.concatenate([ts_keys, np.cumsum(deltas)])
        if keys.shape[0]:
            idx, r = _decode_sparse_hashes_np(keys, p)
            acc = np.zeros(m, np.int64)
            np.maximum.at(acc, idx, r)
            regs = acc.astype(np.uint8)
        return p, regs
    (sz,) = _be32(data, 4)
    packed = np.frombuffer(data[8:8 + sz], np.uint8)
    if packed.shape[0] != m // 2:
        raise ValueError("HLL dense payload length mismatch")
    regs = np.empty(m, np.uint8)
    regs[0::2] = packed >> 4
    regs[1::2] = packed & 0x0F
    if b:
        regs = (regs.astype(np.int32) + b).astype(np.uint8)
    return p, regs


def _be32(data: bytes, off: int):
    return (int.from_bytes(data[off:off + 4], "big"),)


def deserialize(data: bytes):
    """Parse sketch wire bytes -> (precision, uint8 registers[2^p]).

    Accepts the reference's axiomhq MarshalBinary bytes (dense AND sparse
    forms) and this framework's legacy VHLL dump."""
    if data[:4] == MAGIC:
        precision = data[4]
        regs = np.frombuffer(data[5:], np.uint8)
        if regs.shape[0] != (1 << precision):
            raise ValueError("HLL payload length mismatch")
        return precision, regs
    if len(data) >= 8 and data[0] == 1 and 4 <= data[1] <= 18:
        return _deserialize_axiomhq(data)
    raise ValueError("unrecognized HLL payload")


def estimate_packed_rows(words: torch.Tensor, *,
                         precision: int = DEFAULT_PRECISION) -> torch.Tensor:
    """Cardinality estimate f32[...] straight from packed rows [..., W]:
    classic HLL alpha·m²/Σ2^-M_j with linear counting m·ln(m/V) when the
    raw estimate is at most 5/2·m and zero registers exist."""
    m = num_registers(precision)
    if words.shape[-1] != packed_words(precision):
        raise ValueError("packed row width does not match precision")
    g = _group16(words, 3)
    regs_i = torch.stack(_lanes(g[..., 0], g[..., 1], g[..., 2]), dim=-1)
    regs_i = regs_i.reshape(tuple(words.shape[:-1]) + (m,))
    regs = regs_i.to(torch.float32)
    inv = torch.sum(torch.exp2(-regs), dim=-1)
    raw = (_alpha(m) * m * m) / inv
    zeros = torch.sum((regs_i == 0).to(torch.float32), dim=-1)
    lin = m * torch.log(m / torch.clamp(zeros, min=1.0))
    use_lin = (raw <= 2.5 * m) & (zeros > 0)
    return torch.where(use_lin, lin, raw)
