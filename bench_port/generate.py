"""What every kind of traffic shares: a mix's parameter file
(`traffic/<mix>.json`), name popularity, value draws and the
vectorised assembly of text lines into datagrams.

A mix's `kind` names the module under `kinds/` that turns the mix and a
seed into a corpus, holds the plain reference's answer for it, and
hands each item to the Server; those modules build on the pieces here.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import List

import numpy as np

ROOT = Path(__file__).resolve().parent


def load_mix(name: str) -> dict:
    with open(ROOT / "traffic" / f"{name}.json") as f:
        return json.load(f)


def zipf_shares(n: int, s: float) -> np.ndarray:
    """p_k ∝ k^-s over k = 1..n (s = 0: uniform)."""
    p = np.arange(1, n + 1, dtype=np.float64) ** -float(s)
    return p / p.sum()


def apportion(total: int, shares: np.ndarray) -> np.ndarray:
    """Whole counts summing to `total`, by largest remainder."""
    raw = shares * total
    out = np.floor(raw).astype(np.int64)
    short = total - int(out.sum())
    if short:
        out[np.argsort(out - raw, kind="stable")[:short]] += 1
    return out


def draw_values(rng, spec: dict, n: int) -> np.ndarray:
    dist = spec["dist"]
    if dist == "lognormal":
        return rng.lognormal(spec["mean"], spec["sigma"], n)
    if dist == "normal":
        return rng.normal(spec.get("loc", 0.0), spec.get("scale", 1.0), n)
    if dist == "integers":
        return rng.integers(spec["low"], spec["high"], n).astype(np.float64)
    raise ValueError(f"unknown value distribution {dist!r}")


def padded(strings: List[bytes]):
    """A list of byte strings as (uint8[n, width] zero-padded, lengths)."""
    lens = np.fromiter((len(s) for s in strings), np.int64, len(strings))
    width = int(lens.max(initial=0))
    buf = np.frombuffer(b"".join(s.ljust(width, b"\0") for s in strings),
                        np.uint8).reshape(len(strings), width)
    return buf, lens


def assemble(pieces, n: int):
    """Lines made of table pieces: `pieces` is [(table, lengths, index)],
    each line the concatenation of table[index[i]] over the pieces (no
    piece holds a zero byte: tables are zero-padded). Returns (blob:
    every line followed by a newline, line lengths)."""
    cols = [table[idx] for table, _lens, idx in pieces]
    cols.append(np.full((n, 1), ord("\n"), np.uint8))
    flat = np.concatenate(cols, axis=1).reshape(-1)
    total = sum(lens[idx] for _t, lens, idx in pieces)
    return flat[flat != 0].tobytes(), total


def pack_datagrams(blob: bytes, line_lens: np.ndarray, size: int):
    """Lines joined by newlines into datagrams of at most `size` bytes,
    greedily, as a DogStatsD client fills its buffer. Returns (datagrams,
    lines per datagram)."""
    ends = np.cumsum(line_lens + 1)          # offset after each newline
    out, counts = [], []
    start_line, start_off = 0, 0
    n = len(line_lens)
    while start_line < n:
        # the last line whose end (without its newline) fits
        stop = int(np.searchsorted(ends, start_off + size + 1, "right"))
        stop = max(stop, start_line + 1)
        end_off = int(ends[stop - 1])
        out.append(blob[start_off:end_off - 1])
        counts.append(stop - start_line)
        start_line, start_off = stop, end_off
    return out, np.asarray(counts, np.int64)


def decimal_texts(vint: np.ndarray, decimals: int):
    """The fixed-point texts of integer-scaled values: (unique texts,
    index of each value's text)."""
    uniq, inv = np.unique(vint, return_inverse=True)
    scale = 10 ** decimals
    texts = []
    for v in uniq.tolist():
        sign = b"-" if v < 0 else b""
        a = abs(v)
        if decimals:
            texts.append(b"%s%d.%0*d" % (sign, a // scale, decimals,
                                         a % scale))
        else:
            texts.append(b"%s%d" % (sign, a))
    return texts, inv.reshape(-1)
