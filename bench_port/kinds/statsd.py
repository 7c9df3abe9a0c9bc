"""DogStatsD traffic: lines packed into datagrams as clients pack them,
handed to the Server's packet queue one datagram an item, as its UDP
listener enqueues them; and the answers a flushed interval must hold.

A mix of this kind (`traffic/<mix>.json`, `"kind": "statsd"`) gives the
corpus's `lines`, the `datagram_bytes` a datagram holds at most, the
`warmup_lines` set-up feeds, and its families of metrics (`metrics`):
each a type (`c`, `g`, `ms` or `h`), a share of the lines, a name space
drawn with a Zipf exponent (0 for uniform), a value distribution printed
with a fixed number of decimals, and optionally a tag that every
`every`-th name carries. Every seed gets the same number of lines per
name (the Zipf shares are apportioned, not drawn); the seed draws the
order and the values.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from bench_port import generate as g
from bench_port import reference as r

TYPE_NAMES = {"c": "counter", "g": "gauge", "ms": "timer", "h": "histogram"}
SKIP = ("veneur.", "ssf.")          # the Server's own rows


def put(srv, item: bytes) -> None:
    """One datagram, as the UDP listener enqueues it."""
    srv.packet_queue.put(item)


@dataclasses.dataclass
class Corpus:
    """Datagrams and, per line in corpus order, its key and value."""
    items: List[bytes]
    item_samples: np.ndarray    # lines in each datagram
    line_key: np.ndarray        # int32 key id per line
    line_value: np.ndarray      # float64: the value the engine parses
    key_name: List[str]
    key_tags: List[tuple]
    key_type: List[str]         # counter / gauge / timer / histogram
    warmup_items: int


def corpus(mix: dict, seed: int) -> Corpus:
    rng = np.random.default_rng(seed)
    n_lines = int(mix["lines"])
    fams = mix["metrics"]
    shares = np.asarray([f["share"] for f in fams], np.float64)
    counts = g.apportion(n_lines, shares / shares.sum())
    key_name, key_tags, key_type = [], [], []
    prefixes, suffixes = [], []
    line_key_parts, value_parts, decimals = [], [], []
    for fam, n_fam in zip(fams, counts):
        n_names = int(fam["names"])
        per_name = g.apportion(int(n_fam), g.zipf_shares(
            n_names, fam.get("zipf", 0.0)))
        names = np.flatnonzero(per_name)
        base = len(key_name)
        tag = fam.get("tag")
        mtype = fam["type"]
        for n in names.tolist():
            name = f"{fam['prefix']}{n}"
            tags = ()
            if tag is not None and n % tag["every"] == 0:
                tags = (f"{tag['key']}:{tag['value_prefix']}"
                        f"{n % tag['values']}",)
            key_name.append(name)
            key_tags.append(tags)
            key_type.append(TYPE_NAMES[mtype])
            prefixes.append(name.encode() + b":")
            suffixes.append(b"|" + mtype.encode()
                            + (b"|#" + tags[0].encode() if tags else b""))
        ids = np.repeat(np.arange(base, base + len(names)),
                        per_name[names])
        line_key_parts.append(ids)
        value_parts.append((fam["value"], len(ids)))
        decimals.append(int(fam["value"].get("decimals", 0)))
    line_key = np.concatenate(line_key_parts).astype(np.int32)
    order = rng.permutation(n_lines)
    line_key = line_key[order]
    # values are drawn per family in its own line order, then laid out
    fam_of_line = np.repeat(np.arange(len(fams)), counts)[order]
    line_value = np.empty(n_lines, np.float64)
    vidx = np.empty(n_lines, np.int64)
    texts = []
    for i, ((vspec, n), d) in enumerate(zip(value_parts, decimals)):
        at = np.flatnonzero(fam_of_line == i)
        v = np.rint(g.draw_values(rng, vspec, n) * 10 ** d).astype(np.int64)
        # what strtod gives for the printed decimal: the exactly rounded
        # quotient of two exact doubles
        line_value[at] = v.astype(np.float64) / float(10 ** d)
        fam_texts, inv = g.decimal_texts(v, d)
        vidx[at] = inv + len(texts)
        texts += fam_texts
    vtab, vlens = g.padded(texts)
    ptab, plens = g.padded(prefixes)
    stab, slens = g.padded(suffixes)
    blob, lens = g.assemble([(ptab, plens, line_key), (vtab, vlens, vidx),
                             (stab, slens, line_key)], n_lines)
    items, item_lines = g.pack_datagrams(blob, lens,
                                         int(mix["datagram_bytes"]))
    warm = int(np.searchsorted(np.cumsum(item_lines),
                               int(mix["warmup_lines"]))) + 1
    return Corpus(items=items, item_samples=item_lines, line_key=line_key,
                  line_value=line_value, key_name=key_name,
                  key_tags=key_tags, key_type=key_type,
                  warmup_items=min(warm, len(items)))


class Reference:
    """The answers of a DogStatsD corpus: each timer's count, min, max and
    percentiles, each counter's sum and each gauge's last write.

    Numbers compared (larger is worse; each with its limit from the
    configuration's `limits`):

    - `count_gap`: the largest |flushed − reference| timer count over the
      union of keys (a key missing on either side counts in full);
    - `minmax_gap`: the largest relative gap of a timer's min or max;
    - `counter_gap` / `gauge_gap`: the largest |flushed − reference|
      counter sum and gauge (the interval's last write);
    - `exact_q_err` and `rank_err`: see reference.quantile_errs.
    """

    def __init__(self, corpus: Corpus):
        self.c = corpus
        self.n_keys = len(corpus.key_name)
        kinds = np.asarray(corpus.key_type)
        self.is_counter = kinds == "counter"
        self.is_gauge = kinds == "gauge"
        key = corpus.line_key.astype(np.int64)
        # values as the program keeps them (f32)
        v32 = corpus.line_value.astype(np.float32).astype(np.float64)
        self.v32 = v32
        timer = np.isin(kinds, ("timer", "histogram"))[key]
        # timer lines sorted by key, then value
        lines = np.flatnonzero(timer)
        self.order = lines[np.lexsort((v32[lines], key[lines]))]
        self.vals = v32[self.order]
        self.key = key[self.order]
        self.scalar = np.flatnonzero(~timer)     # counter and gauge lines
        self.cum_lines = np.concatenate([[0], np.cumsum(corpus.item_samples)])
        self.index = {(n, t): i for i, (n, t) in
                      enumerate(zip(corpus.key_name, corpus.key_tags))}
        # a name carries one tag set in these mixes: rows are keyed by
        # name, and the sampled labels are held to the full key
        self.by_name = {n: i for i, n in enumerate(corpus.key_name)}
        if len(self.by_name) != len(self.index):
            raise ValueError("a name with two tag sets")

    def line_pos(self, item: int) -> int:
        n_items = len(self.c.items)
        return (item // n_items) * int(self.cum_lines[-1]) + int(
            self.cum_lines[item % n_items])

    def interval(self, item_start: int, item_stop: int, low=False) -> dict:
        """The answers for items [item_start, item_stop) of the replay;
        with `low`, one precision step down (the control)."""
        a, b = self.line_pos(item_start), self.line_pos(item_stop)
        n = len(self.c.line_key)
        m_all = r.multiplicity(n, a, b)
        m = m_all[self.order]
        vals = r.bf16(self.vals) if low else self.vals
        live = m > 0
        mn = np.full(self.n_keys, np.inf)
        mx = np.full(self.n_keys, -np.inf)
        np.minimum.at(mn, self.key[live], vals[live])
        np.maximum.at(mx, self.key[live], vals[live])
        count, q = r.digest_quantiles(vals, np.ones(len(vals)), m, self.key,
                                      self.n_keys, mn, mx, r.QUANTILES)
        # counters: the sum of their lines; gauges: the interval's last
        # line of the key (each line's last replay position before b)
        sk = self.c.line_key[self.scalar].astype(np.int64)
        sm = m_all[self.scalar]
        sv = self.v32[self.scalar]
        hits = np.bincount(sk, weights=sm, minlength=self.n_keys)
        counter = np.bincount(sk, weights=sv * sm, minlength=self.n_keys)
        last = b - 1 - (b - 1 - self.scalar) % n
        seen = sm > 0
        o = np.lexsort((last[seen], sk[seen]))
        ks, vs = sk[seen][o], sv[seen][o]
        gauge = np.full(self.n_keys, np.nan)
        gauge[ks] = vs                     # the last write of a key wins
        present = hits > 0
        counter = np.where(self.is_counter & present, counter, np.nan)
        gauge = np.where(self.is_gauge & present, gauge, np.nan)
        if low:
            count, q = r.bf16(count), r.bf16(q)
            counter = counter.astype(np.float32).astype(np.float64)
            gauge = r.bf16(gauge)
        # where each reported percentile falls among the exact samples
        ranks = r.Ranks(self.vals, m, self.key, self.n_keys)
        return dict(count=count, min=mn, max=mx, q=q, counter=counter,
                    gauge=gauge, ranks=ranks)

    def control_rows(self, item_start: int, item_stop: int) -> dict:
        """The answers computed one precision step down (f32 counter
        sums; bfloat16 values, counts and quantiles), in the shape `rows`
        gives the program's."""
        want = self.interval(item_start, item_stop, low=True)
        absent = want["count"] == 0
        got = {f: want[f] for f in ("count", "counter", "gauge")}
        for f in ("min", "max"):
            got[f] = np.where(absent, np.nan, want[f])
        for j, name in enumerate(r.PERCENTILES):
            got[name] = np.where(absent, np.nan, want["q"][:, j])
        got["unknown"] = 0
        return got

    def rows(self, segments) -> dict:
        """The flushed rows (the capture sink's segments: names, values,
        suffix, sampled labels) as arrays by key id, NaN where a key has
        no row; rows of unknown keys or labels are counted."""
        got = {f: np.full(self.n_keys, np.nan)
               for f in ("count", "min", "max", "counter", "gauge")
               + r.PERCENTILES}
        unknown = 0
        for names, values, sfx, labels in segments:
            field = r.SUFFIX.get(sfx)
            cut = len(sfx)
            for name, v in zip(names, np.asarray(values).tolist()):
                base = name[:len(name) - cut] if cut else name
                if base.startswith(SKIP):
                    continue
                k = self.by_name.get(base)
                if k is not None and not cut:
                    field = ("counter" if self.is_counter[k] else
                             "gauge" if self.is_gauge[k] else None)
                if k is None or field is None:
                    unknown += 1
                    continue
                got[field][k] = v
            for name, tags in labels:
                if not name.startswith(SKIP) and \
                        self.index.get((name, tags)) is None:
                    unknown += 1
        got["unknown"] = unknown
        return got

    @staticmethod
    def compare(got: dict, want: dict, comparison: dict) -> dict:
        """The numbers of one interval (larger is worse)."""
        gc = np.nan_to_num(got["count"], nan=0.0)
        count_gap = float(np.max(np.abs(gc - want["count"]), initial=0.0))
        if got["unknown"]:
            count_gap = float("inf")
        live = want["count"] > 0
        gap = 0.0
        for f in ("min", "max"):
            gv, wv = got[f][live], want[f][live]
            with np.errstate(invalid="ignore", divide="ignore"):
                rel = np.abs(gv - wv) / np.maximum(np.abs(wv), 1e-30)
            rel[np.isnan(gv)] = np.inf
            gap = max(gap, float(np.max(rel, initial=0.0)))
        out = dict(count_gap=count_gap, minmax_gap=gap)
        for f in ("counter", "gauge"):
            out[f"{f}_gap"] = r.scalar_gap(got[f], want[f])
        out.update(r.quantile_errs(got, want, live,
                                   int(comparison["exact_max_count"]),
                                   want["ranks"]))
        return out


def reference(corpus: Corpus) -> Reference:
    return Reference(corpus)
