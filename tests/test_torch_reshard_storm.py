"""Config 12's storm resized on fixed steps: the port's Server against
the JAX Server on the CPU, on the very lines and steps chip_smoke.py
phase 15a gates on the card.

chip_smoke.py's `storm_fixed_run` drives both Servers (config 12's
capacities at tpu_n_shards 4, native ingest, each segment parsed whole
before the resize 4 -> 8 -> 2). The elastic flush's counters, gauges
and set words equal the static flush's in both packages and across
them. Its timer percentiles move from the static pass's, because a moved
digest folds back through fold_snapshot, which re-adds its cells as
weighted samples (ROADMAP C-5): the JAX package's gap is the one
chip_smoke.py records as P15_JAX_TIMER_GAP, and the port's is the JAX
package's within the digest tolerance (2e-5), which is the gate the card
is held to.
"""

import numpy as np

import chip_smoke
from tests.test_torch_import import _DropSpans
from tests.test_torch_reshard_servers import _JReshardServer
from tests.test_torch_server import _CapturingJSink, _CapturingTSink
from veneur_tpu import config as jconfig
from veneur_tpu_torch import config as tconfig
from veneur_tpu_torch.server import server as tserver_mod


def _storm(pkg, elastic):
    kw = chip_smoke.storm_config()
    if pkg == "jax":
        sink = _CapturingJSink()
        srv = _JReshardServer(jconfig.Config(**kw), metric_sinks=[sink])
    else:
        sink = _CapturingTSink()
        srv = tserver_mod.Server(tconfig.Config(**kw), metric_sinks=[sink],
                                 device="cpu")
    srv.trace_client.backend = _DropSpans()
    srv.start()
    try:
        sums = chip_smoke.storm_fixed_run(srv, chip_smoke.storm_segments(),
                                          elastic)
        assert srv.trigger_flush(timeout=300)
    finally:
        srv.shutdown()
    rows = {(m.name, tuple(m.tags)): m.value for m in sink.flushed
            if m.name.startswith("el.")}
    timer = {q: rows[(f"el.t.{int(q * 100)}percentile", ())]
             for q in (0.5, 0.9, 0.99)}
    rest = {k: v for k, v in rows.items() if not k[0].startswith("el.t.")
            or k[0].endswith((".min", ".max", ".count"))}
    return timer, rest, sums


def test_storm_timer_gap_is_the_jax_packages():
    t_static, t_rest0, _ = _storm("torch", False)
    t_el, t_rest, t_sums = _storm("torch", True)
    j_static, j_rest0, _ = _storm("jax", False)
    j_el, j_rest, j_sums = _storm("jax", True)
    # counters, gauges, set estimates, timer count/min/max: exact across
    # the resize, set estimates within rtol 1e-6 across the packages
    assert t_rest == t_rest0 and j_rest == j_rest0
    assert sorted(t_rest) == sorted(j_rest) and len(t_rest) == 2048 + 1 + 64 + 3
    for k, v in t_rest.items():
        if k[0].startswith("el.s"):
            np.testing.assert_allclose(v, j_rest[k], rtol=1e-6)
        else:
            assert v == j_rest[k], k
    assert [s["plan"] for s in t_sums] == [s["plan"] for s in j_sums] == [
        "4->8", "8->2"]
    for got, want in ((t_static, j_static), (t_el, j_el)):
        for q in got:
            np.testing.assert_allclose(got[q], want[q], rtol=2e-5, atol=2e-5)
    t_gap = chip_smoke.timer_gap(t_el, t_static)
    j_gap = chip_smoke.timer_gap(j_el, j_static)
    assert abs(j_gap - chip_smoke.P15_JAX_TIMER_GAP) <= 1e-8, j_gap
    assert abs(t_gap - j_gap) <= chip_smoke.DIGEST_TOL
    assert t_gap <= chip_smoke.P15_JAX_TIMER_GAP + chip_smoke.DIGEST_TOL
    assert j_gap > 1e-6        # config 12's 1e-6 is out of reach (C-5)
