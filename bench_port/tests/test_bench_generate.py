"""The traffic generator: a corpus is a function of its seed, keeps the
same sizes for every seed, and encodes what the reference reads."""

import numpy as np
import pytest

from bench_port import generate, harness

statsd = harness.kind("statsd")

STATSD = {"kind": "statsd", "lines": 5000, "datagram_bytes": 300,
          "warmup_lines": 500, "backlog": [8, 4],
          "metrics": [{"type": "ms", "share": 1.0, "prefix": "t.", "names": 50,
                       "zipf": 1.2,
                       "value": {"dist": "lognormal", "mean": 3.0,
                                 "sigma": 0.5, "decimals": 2},
                       "tag": {"key": "route", "value_prefix": "r",
                               "values": 5, "every": 2}}]}
# counters, gauges and timers in one mix, as later cells may send
MIXED = dict(STATSD, metrics=STATSD["metrics"] + [
    {"type": "c", "share": 0.5, "prefix": "c.", "names": 40, "zipf": 1.1,
     "value": {"dist": "integers", "low": 1, "high": 9}},
    {"type": "g", "share": 0.3, "prefix": "g.", "names": 20, "zipf": 0.0,
     "value": {"dist": "normal", "decimals": 4}}])

def test_statsd_corpus_is_a_function_of_its_seed():
    a = statsd.corpus(STATSD, 2**31 + 5)
    b = statsd.corpus(STATSD, 2**31 + 5)
    c = statsd.corpus(STATSD, 7)
    assert a.items == b.items
    assert np.array_equal(a.line_value, b.line_value)
    assert a.items != c.items
    # the same lines per key for every seed, in another order
    assert a.key_name == c.key_name
    assert np.array_equal(np.bincount(a.line_key), np.bincount(c.line_key))


@pytest.mark.parametrize("mix", [STATSD, MIXED], ids=["timers", "mixed"])
def test_statsd_datagrams_hold_the_lines(mix):
    c = statsd.corpus(mix, 11)
    assert max(len(d) for d in c.items) <= mix["datagram_bytes"]
    lines = b"\n".join(c.items).split(b"\n")
    assert len(lines) == len(c.line_key) == c.item_samples.sum()
    for line, k, v in zip(lines[:200], c.line_key[:200], c.line_value[:200]):
        head, rest = line.split(b":", 1)
        value, kind, *fields = rest.split(b"|")
        assert head.decode() == c.key_name[k]
        assert statsd.TYPE_NAMES[kind.decode()] == c.key_type[k]
        assert float(value) == v
        tags = tuple(f[1:].decode() for f in fields if f.startswith(b"#"))
        assert tags == c.key_tags[k]


@pytest.mark.parametrize("mix", ["timers_zipf"])
def test_every_mix_has_its_kind(mix):
    m = generate.load_mix(mix)
    k = harness.kind(m["kind"])
    assert callable(k.corpus) and callable(k.reference) and callable(k.put)
    high, low = m["backlog"]
    assert 0 <= low < high
