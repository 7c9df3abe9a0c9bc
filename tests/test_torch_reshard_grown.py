"""A reshard after a key-table grow (ROADMAP C-watch 9), the port's
Server against the JAX Server on the CPU.

Both Servers start at tpu_n_shards 4 with a 64-slot counter table, grow
it to 256 at a flush, take 150 counter keys (more than the config's 64)
and then reshard 4 -> 8. The port's drain builds the new mesh at the
serving aggregator's (grown) spec and keeps every row. The JAX drain
rebuilds at the config's spec, so the drained rows do not fit: on the
Python route it keeps 64 of them and counts the other 86 in
`dropped_capacity`; on the native route its folds fail and the transfer
is abandoned. The test pins both packages' values: the difference is a
fault of the reference, and the port keeps the grown spec.
"""

import pytest

from tests.test_torch_import import _DropSpans
from tests.test_torch_reshard_servers import _JReshardServer
from tests.test_torch_server import (SMALL, _app, _CapturingJSink,
                                     _CapturingTSink, _wait)
from veneur_tpu import config as jconfig
from veneur_tpu_torch import config as tconfig
from veneur_tpu_torch.server import server as tserver_mod

N_KEYS = 150
WANT_SUM = float(sum(i + 1 for i in range(N_KEYS)))


def _start(pkg, native):
    kw = dict(SMALL, interval="3600s", statsd_listen_addresses=[],
              ssf_listen_addresses=[], http_address="", tpu_n_shards=4,
              reshard_enabled=True, native_ingest=native,
              table_grow_enabled=True, tpu_counter_capacity=64,
              tpu_batch_counter=256)
    if pkg == "jax":
        sink = _CapturingJSink()
        srv = _JReshardServer(jconfig.Config(**kw), metric_sinks=[sink])
    else:
        sink = _CapturingTSink()
        srv = tserver_mod.Server(tconfig.Config(**kw), metric_sinks=[sink],
                                 device="cpu")
    srv.trace_client.backend = _DropSpans()
    srv.start()
    return srv, sink


def _feed(srv, n):
    lines = [b"g.c%d:%d|c" % (i, i + 1) for i in range(n)]
    want = srv.aggregator.processed + len(lines)
    for k in range(0, len(lines), 50):
        srv.packet_queue.put(b"\n".join(lines[k:k + 50]))
    _wait(lambda: srv.aggregator.processed >= want, "lines")


def _grow_then_reshard(pkg, native):
    """-> (the reshard's error or None, the flush's g.c rows, the
    aggregator's dropped_capacity, and the counter capacity and shard
    count the drain built)."""
    srv, sink = _start(pkg, native)
    try:
        _feed(srv, 40)
        sink.flushed.clear()
        srv.trigger_table_grow({"counter": 256}, timeout=120)
        assert srv.aggregator.spec.counter_capacity == 256
        assert len(_app(sink.flushed)) == 40
        _feed(srv, N_KEYS)
        assert srv.aggregator.dropped_capacity == 0
        err = None
        try:
            srv.trigger_reshard(8, timeout=120)
        except Exception as e:            # the JAX native drain's fault
            err = e
        built = (srv.aggregator.spec.counter_capacity,
                 srv.aggregator.n_shards)
        sink.flushed.clear()
        assert srv.trigger_flush(timeout=120)
        rows = {m.name: m.value for m in _app(sink.flushed)
                if m.name.startswith("g.c")}
        return err, rows, srv.aggregator.dropped_capacity, built
    finally:
        srv.shutdown()


@pytest.mark.parametrize("native", [False, True], ids=["python", "native"])
def test_a_reshard_after_a_grow_keeps_the_grown_tables(native):
    t_err, t_rows, t_dropped, t_built = _grow_then_reshard("torch", native)
    # the port: the grown spec carried across, every row kept exactly
    assert t_err is None
    assert t_built == (256, 8)
    assert t_rows == {f"g.c{i}": float(i + 1) for i in range(N_KEYS)}
    assert sum(t_rows.values()) == WANT_SUM and t_dropped == 0

    j_err, j_rows, j_dropped, j_built = _grow_then_reshard("jax", native)
    # the reference: rebuilt at the config's 64 counter slots
    assert j_built == (64, 8)
    if native:
        # its folds index past the config-sized tables and fail: the
        # transfer is abandoned and the drained rows are lost
        assert j_err is not None and "fold failed" in str(j_err)
        assert len(j_rows) < N_KEYS
    else:
        # 64 rows fit the eight 8-slot shards; the other 86 are dropped
        assert j_err is None
        assert len(j_rows) == 64 and j_dropped == N_KEYS - 64
    # what the JAX Server does keep, it keeps at the port's values
    for name, value in j_rows.items():
        assert name in t_rows
        if not native:
            assert value == t_rows[name]
