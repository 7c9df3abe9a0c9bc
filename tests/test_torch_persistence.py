"""The port's durability layer against the JAX package, on the CPU.

- (a) `schema_hash()` is the same in both packages and equals the pin,
  and the copied protobuf modules differ from the JAX package's only in
  their import line (a subprocess also checks that no module of this
  slice loads jax or veneur_tpu);
- (b) golden round trip: feed A → checkpoint → restore → feed B equals
  feed A+B, with counters past 2^24 (the two-float restore split);
- (c) a snapshot written by either package folds into the other's
  aggregator and gives that package's own fold; a checkpoint written by
  the JAX Server restores into the port's Server, and the reverse, with
  equal flushes, watches and history rings (percentiles within rtol/atol
  2e-5 across the packages, set estimates within rtol 1e-6, the rest
  exact; within one package the persistence tests' own 1e-6);
- (d) corrupt, truncated and schema-mismatched checkpoints are rejected
  and quarantined; the writer keeps `retain`, resumes its sequence and
  contains an injected write fault;
- (e) the port's Server checkpoints on its cadence, writes the unflushed
  tail at shutdown and restores only it, cold-starts past a corrupt
  checkpoint, and `cli/checkpoint.py` inspects and verifies.

The JAX aggregators and Servers are the test-side synced subclasses of
tests/test_torch_server.py (ROADMAP C-watch 4).
"""

import json
import os
import pathlib
import shutil
import socket
import subprocess
import sys

import numpy as np
import pytest

from tests.test_torch_server import _SyncedJAggregator, _SyncedJServer, _wait
from veneur_tpu import config as jconfig
from veneur_tpu.aggregation.host import BatchSpec as JBatchSpec
from veneur_tpu.aggregation.state import TableSpec as JTableSpec
from veneur_tpu.persistence import build_snapshot as jbuild_snapshot
from veneur_tpu.persistence import codec as jcodec
from veneur_tpu.persistence import fold_snapshot as jfold_snapshot
from veneur_tpu.samplers.parser import UDPMetric as JUDPMetric
from veneur_tpu.sinks.debug import DebugMetricSink as JDebugMetricSink
from veneur_tpu_torch import config as tconfig
from veneur_tpu_torch.aggregation.host import BatchSpec
from veneur_tpu_torch.aggregation.state import TableSpec
from veneur_tpu_torch.persistence import (CheckpointWriter, CorruptSnapshot,
                                          build_snapshot, fold_snapshot,
                                          list_checkpoints, load_dir,
                                          restore_latest, schema_hash,
                                          verify_dir)
from veneur_tpu_torch.persistence import codec as tcodec
from veneur_tpu_torch.persistence.codec import (CHUNKS_NAME, MANIFEST_NAME,
                                                encode_to_dir)
from veneur_tpu_torch.reliability.faults import CHECKPOINT_WRITE, FAULTS
from veneur_tpu_torch.samplers.parser import UDPMetric
from veneur_tpu_torch.server import server as tserver_mod
from veneur_tpu_torch.server.aggregator import Aggregator
from veneur_tpu_torch.sinks.debug import DebugMetricSink

REPO = pathlib.Path(__file__).resolve().parent.parent
PERC = [0.5, 0.99]
BSPEC_KW = dict(counter=512, gauge=128, status=16, set=64, histo=512)
SPEC_KW = {
    "small": dict(counter_capacity=64, gauge_capacity=32,
                  status_capacity=8, set_capacity=8, histo_capacity=32),
    "medium": dict(counter_capacity=256, gauge_capacity=64,
                   status_capacity=16, set_capacity=16, histo_capacity=64),
    "large": dict(counter_capacity=512, gauge_capacity=128,
                  status_capacity=32, set_capacity=32, histo_capacity=128),
}


# -- (a) the format is the JAX package's --------------------------------------

def test_schema_hash_is_the_jax_hash_and_the_pin():
    assert schema_hash() == jcodec.schema_hash()
    assert schema_hash() == tcodec._SCHEMA_PINS[tcodec.SNAPSHOT_FORMAT_VERSION]
    assert tcodec._SCHEMA_PINS == jcodec._SCHEMA_PINS
    assert tcodec.SNAPSHOT_FORMAT_VERSION == jcodec.SNAPSHOT_FORMAT_VERSION


@pytest.mark.parametrize("name", ["tdigestpb_pb2", "metricpb_pb2",
                                  "forwardrpc_pb2"])
def test_proto_modules_differ_only_in_their_import_line(name):
    port = (REPO / "veneur_tpu_torch" / "proto" / f"{name}.py").read_text()
    ref = (REPO / "veneur_tpu" / "proto" / f"{name}.py").read_text()
    diff = [(a, b) for a, b in zip(port.splitlines(), ref.splitlines())
            if a != b]
    assert len(port.splitlines()) == len(ref.splitlines())
    assert all(a.replace("veneur_tpu_torch.", "veneur_tpu.") == b
               and a.startswith("from veneur_tpu_torch.proto import ")
               for a, b in diff), diff
    assert len(diff) == (0 if name == "tdigestpb_pb2" else 1)


def test_slice_modules_import_no_jax_and_no_reference_package():
    code = (
        "import importlib, sys\n"
        "for m in ('proto.tdigestpb_pb2', 'proto.metricpb_pb2',\n"
        "          'proto.forwardrpc_pb2', 'forward.envelope',\n"
        "          'forward.gob', 'forward.jsonmetric', 'forward.convert',\n"
        "          'forward.rpc', 'forward.tracedhttp', 'trace.opentracing',\n"
        "          'persistence', 'persistence.assembly', 'cli.checkpoint'):\n"
        "    importlib.import_module('veneur_tpu_torch.' + m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'veneur_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.startswith("ok"), \
        res.stdout + res.stderr


# -- (b), (c) aggregator-level round trips --------------------------------------

def _feed(agg, udp, part: int, n_counter=12, n_gauge=6, n_timer=200):
    """tests/test_persistence.py's traffic: counters at 2^24 magnitudes,
    gauges, a status check, a set and a timer."""
    rng = np.random.RandomState(1000 + part)
    for i in range(n_counter):
        agg.process_metric(udp(
            name=f"c{i}", type="counter", digest=i * 7 + 3,
            value=float((1 << 24) + i * 3 + part), tags=("t:1",),
            joined_tags="t:1"))
    for i in range(n_gauge):
        agg.process_metric(udp(name=f"g{i}", type="gauge", digest=i * 5 + 1,
                               value=float(i * 10 + part)))
    agg.process_metric(udp(name="st", type="status", value=1.0,
                           message=f"msg{part}"))
    for i in range(150):
        agg.process_metric(udp(name="s0", type="set", digest=9,
                               value=f"member-{part}-{i}"))
    for v in rng.gamma(2.0, 10.0, size=n_timer):
        agg.process_metric(udp(name="t0", type="timer", digest=11,
                               value=float(v)))


def _port_agg(size):
    return Aggregator(TableSpec(**SPEC_KW[size]), BatchSpec(**BSPEC_KW),
                      device="cpu")


def _jax_agg(size):
    return _SyncedJAggregator(JTableSpec(**SPEC_KW[size]),
                              JBatchSpec(**BSPEC_KW))


def _snapshot_of(agg, build):
    state, table = agg.swap()
    res, table, raw = agg.compute_flush(state, table, PERC, want_raw=True)
    return build(agg.spec, table, res, raw, agg_kind="single", n_shards=1,
                 interval_ts=123, hostname="testbox")


def _result_map(res, table):
    out = {}
    for kind in ("counter", "gauge", "status", "set", "histogram"):
        for i, (_slot, meta) in enumerate(table.get_meta(kind)):
            key = (kind, meta.name)
            if kind == "counter":
                out[key] = float(res["counter"][i])
            elif kind == "gauge":
                out[key] = float(res["gauge"][i])
            elif kind == "status":
                out[key] = float(res["status"][i])
            elif kind == "set":
                out[key] = float(res["set_estimate"][i])
            else:
                out[key] = (np.asarray(res["histo_quantiles"][i]),
                            float(res["histo_count"][i]),
                            float(res["histo_min"][i]),
                            float(res["histo_max"][i]))
    return out


def _assert_equivalent(want_map, got_map, q_tol=1e-6, set_rtol=0.0):
    assert set(got_map) == set(want_map)
    for key, want in sorted(want_map.items()):
        got = got_map[key]
        if key[0] == "set":
            np.testing.assert_allclose(got, want, rtol=set_rtol, atol=0,
                                       err_msg=str(key))
        elif key[0] != "histogram":
            assert got == want, (key, want, got)
        else:
            qs_w, n_w, mn_w, mx_w = want
            qs_g, n_g, mn_g, mx_g = got
            np.testing.assert_allclose(qs_g, qs_w, rtol=q_tol, atol=q_tol,
                                       err_msg=str(key))
            assert (n_g, mn_g, mx_g) == (n_w, mn_w, mx_w), key


def _write_ckpt(root: pathlib.Path, seq: int, snap) -> pathlib.Path:
    d = root / f"ckpt-{seq:08d}"
    d.mkdir(parents=True)
    encode_to_dir(str(d), snap)
    return d


@pytest.mark.parametrize("size", ["small", "medium", "large"])
def test_golden_roundtrip(size, tmp_path):
    ref = _port_agg(size)
    _feed(ref, UDPMetric, 0)
    _feed(ref, UDPMetric, 1)
    ref_map = _result_map(*ref.flush(PERC))

    a1 = _port_agg(size)
    _feed(a1, UDPMetric, 0)
    loaded = load_dir(str(_write_ckpt(tmp_path, 0,
                                      _snapshot_of(a1, build_snapshot))))
    a2 = _port_agg(size)
    folded = fold_snapshot(a2, loaded)
    assert folded == sum(len(v) for v in loaded["tables"].values())
    _feed(a2, UDPMetric, 1)
    _assert_equivalent(ref_map, _result_map(*a2.flush(PERC)))


def test_counter_restore_splits_into_two_steps(tmp_path):
    """A count an f32 cannot hold folds back exactly: its hi part in one
    ingest step and its lo residual in a second."""
    src = _port_agg("small")
    for v in (float(1 << 24), 1.0, float(1 << 30), 3.0):
        src.process_metric(UDPMetric(name="big", type="counter", digest=1,
                                     value=v))
        src.batcher.emit()      # one step each: the two-float fold is exact
    snap = _snapshot_of(src, build_snapshot)
    want = float((1 << 24) + 1 + (1 << 30) + 3)
    assert snap["arrays"]["counter"][0] == want
    assert float(np.float32(want)) != want
    dst = _port_agg("small")
    fold_snapshot(dst, snap)
    assert dst.steps_total == 2
    res, _table = dst.flush(PERC)
    assert res["counter"][0] == want


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_snapshot_folds_across_packages(writer, tmp_path):
    """A checkpoint written by one package folds into the other's
    aggregator; the flush (fold, then feed B) equals the writing
    package's own fold, and the fold equals the feed A+B reference."""
    if writer == "jax":
        src = _jax_agg("medium")
        _feed(src, JUDPMetric, 0)
        snap = _snapshot_of(src, jbuild_snapshot)
        jcodec_dir = tmp_path / "ckpt-00000000"
        jcodec_dir.mkdir()
        jcodec.encode_to_dir(str(jcodec_dir), snap)
    else:
        src = _port_agg("medium")
        _feed(src, UDPMetric, 0)
        _write_ckpt(tmp_path, 0, _snapshot_of(src, build_snapshot))
    tsnap, _path = restore_latest(str(tmp_path))
    jsnap = jcodec.load_dir(str(tmp_path / "ckpt-00000000"))

    t = _port_agg("medium")
    fold_snapshot(t, tsnap)
    _feed(t, UDPMetric, 1)
    j = _jax_agg("medium")
    jfold_snapshot(j, jsnap)
    _feed(j, JUDPMetric, 1)
    got, want = _result_map(*t.flush(PERC)), _result_map(*j.flush(PERC))
    _assert_equivalent(want, got, q_tol=2e-5, set_rtol=1e-6)
    ref = _port_agg("medium")
    _feed(ref, UDPMetric, 0)
    _feed(ref, UDPMetric, 1)
    _assert_equivalent(_result_map(*ref.flush(PERC)), got, q_tol=2e-5)


# -- (d) rejection, quarantine and the writer -------------------------------------

@pytest.fixture(scope="module")
def small_snap():
    agg = _port_agg("small")
    _feed(agg, UDPMetric, 0, n_timer=40)
    return _snapshot_of(agg, build_snapshot)


def test_corrupt_chunk_rejected_and_quarantined(tmp_path, small_snap):
    d = _write_ckpt(tmp_path, 0, small_snap)
    blob = bytearray((d / CHUNKS_NAME).read_bytes())
    blob[len(blob) // 2] ^= 0xFF
    (d / CHUNKS_NAME).write_bytes(bytes(blob))
    with pytest.raises(CorruptSnapshot, match="CRC"):
        load_dir(str(d))
    hits = []
    assert restore_latest(str(tmp_path),
                          on_corrupt=lambda: hits.append(1)) is None
    assert hits == [1]
    assert not d.exists()
    assert (tmp_path / "quarantine" / d.name / CHUNKS_NAME).exists()


def test_truncated_manifest_rejected_falls_back(tmp_path, small_snap):
    good = _write_ckpt(tmp_path, 0, small_snap)
    bad = _write_ckpt(tmp_path, 1, small_snap)
    (bad / MANIFEST_NAME).write_bytes((bad / MANIFEST_NAME).read_bytes()[:40])
    _snap, path = restore_latest(str(tmp_path))
    assert path == str(good)
    assert not bad.exists()


@pytest.mark.parametrize("how", ["schema", "chunks"])
def test_schema_mismatch_and_truncated_chunks_rejected(how, tmp_path,
                                                        small_snap):
    d = _write_ckpt(tmp_path, 0, small_snap)
    if how == "schema":
        manifest = json.loads((d / MANIFEST_NAME).read_bytes())
        manifest["schema_hash"] = "0" * 64
        (d / MANIFEST_NAME).write_bytes(json.dumps(manifest).encode())
        with pytest.raises(CorruptSnapshot, match="schema hash"):
            verify_dir(str(d))
    else:
        blob = (d / CHUNKS_NAME).read_bytes()
        (d / CHUNKS_NAME).write_bytes(blob[:len(blob) // 2])
        with pytest.raises(CorruptSnapshot):
            verify_dir(str(d))
    # the JAX reader refuses it too
    with pytest.raises(jcodec.CorruptSnapshot):
        jcodec.verify_dir(str(d))


def test_in_flight_write_is_not_a_checkpoint(tmp_path, small_snap):
    (tmp_path / ".tmp-ckpt-00000007").mkdir()
    (tmp_path / "ckpt-00000003").mkdir()   # manifest never landed
    _write_ckpt(tmp_path, 1, small_snap)
    assert [seq for seq, _ in list_checkpoints(str(tmp_path))] == [1]


def test_writer_async_write_and_retention_gc(tmp_path, small_snap):
    w = CheckpointWriter(str(tmp_path), retain=2, fsync=False)
    try:
        for _ in range(4):
            w.submit(small_snap)
            assert w.wait_idle(30.0)
        assert w.writes == 4 and w.failures == 0
        assert [s for s, _ in list_checkpoints(str(tmp_path))] == [2, 3]
        assert w.last_path.endswith("ckpt-00000003")
        assert verify_dir(w.last_path)["rows"] == \
            {k: len(v) for k, v in small_snap["tables"].items()}
        # the JAX reader verifies the port's checkpoint
        assert jcodec.verify_dir(w.last_path)["rows"] == \
            verify_dir(w.last_path)["rows"]
    finally:
        w.close()


def test_writer_resumes_sequence_after_restart(tmp_path, small_snap):
    for _ in range(2):
        w = CheckpointWriter(str(tmp_path), retain=5, fsync=False)
        try:
            assert w.write_sync(small_snap)
        finally:
            w.close()
    assert [s for s, _ in list_checkpoints(str(tmp_path))] == [0, 1]


def test_writer_fault_contained_not_raised(tmp_path, small_snap):
    FAULTS.reset()
    w = CheckpointWriter(str(tmp_path), retain=3, fsync=False)
    try:
        FAULTS.arm(CHECKPOINT_WRITE, error=True, times=1)
        assert w.write_sync(small_snap) is False
        assert w.failures == 1 and w.writes == 0
        assert list_checkpoints(str(tmp_path)) == []
        assert w.write_sync(small_snap) is True
        assert [s for s, _ in list_checkpoints(str(tmp_path))] == [0]
    finally:
        FAULTS.reset()
        w.close()


def test_cli_inspect_and_verify(tmp_path, small_snap, capsys):
    from veneur_tpu_torch.cli.checkpoint import main as ckpt_main
    _write_ckpt(tmp_path, 0, small_snap)
    _write_ckpt(tmp_path, 1, small_snap)
    assert ckpt_main(["inspect", str(tmp_path), "--json"]) == 0
    desc = json.loads(capsys.readouterr().out)
    assert len(desc) == 2
    assert desc[0]["live_keys"] == sum(
        len(v) for v in small_snap["tables"].values())
    res = subprocess.run(
        [sys.executable, "-m", "veneur_tpu_torch.cli.checkpoint", "verify",
         str(tmp_path)], cwd=REPO, capture_output=True, text=True,
        timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    bad = tmp_path / "ckpt-00000001" / CHUNKS_NAME
    blob = bytearray(bad.read_bytes())
    blob[-1] ^= 0xFF
    bad.write_bytes(bytes(blob))
    assert ckpt_main(["verify", str(tmp_path)]) == 1
    out = capsys.readouterr().out
    assert "ckpt-00000000: OK" in out and "CORRUPT" in out


# -- (c), (e) Servers -------------------------------------------------------------

SERVER_KW = dict(
    interval="3600s", hostname="ckptbox", percentiles=PERC,
    aggregates=["min", "max", "count"],
    statsd_listen_addresses=["udp://127.0.0.1:0"], ssf_listen_addresses=[],
    http_address="", tpu_counter_capacity=256, tpu_gauge_capacity=64,
    tpu_status_capacity=16, tpu_set_capacity=16, tpu_histo_capacity=64,
    tpu_batch_counter=512, tpu_batch_gauge=128, tpu_batch_status=16,
    tpu_batch_set=64, tpu_batch_histo=512, native_ingest=False)
TIERS = dict(watch_enabled=True, history_enabled=True, history_windows=4,
             history_decimation_tiers=2, history_max_keys=32)


def _tserver(**kw):
    sink = DebugMetricSink()
    srv = tserver_mod.Server(tconfig.Config(**dict(SERVER_KW, **kw)),
                             metric_sinks=[sink], device="cpu")
    srv.start()
    return srv, sink


def _jserver(**kw):
    sink = JDebugMetricSink()
    srv = _SyncedJServer(jconfig.Config(**dict(SERVER_KW, **kw)),
                         metric_sinks=[sink])
    srv.start()
    return srv, sink


def _lines(part):
    rng = np.random.default_rng(part)
    out = [b"pc.c%d:%d|c" % (i, 1000 * i + part + 1) for i in range(6)]
    out += [b"pc.g%d:%d.5|g" % (i, i + part) for i in range(3)]
    out += [b"pc.t:%.4f|ms" % v for v in rng.gamma(2.0, 10.0, 120)]
    out += [b"pc.s:m%d-%d|s" % (part, i) for i in range(40)]
    return out


def _send(srv, lines):
    base = srv.aggregator.processed
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    for i in range(0, len(lines), 40):
        tx.sendto(b"\n".join(lines[i:i + 40]), srv.local_addr(0))
    tx.close()
    _wait(lambda: srv.aggregator.processed >= base + len(lines),
          "lines not all processed")


def _app(sink):
    return sorted(((m.name, tuple(m.tags), m.type, m.value)
                   for m in sink.flushed if not m.name.startswith("veneur.")
                   and m.name != "ssf.names_unique"))


def _assert_same_app(got, want):
    assert [g[:3] for g in got] == [w[:3] for w in want] and want
    for g, w in zip(got, want):
        if "percentile" in g[0]:
            np.testing.assert_allclose(g[3], w[3], rtol=2e-5, atol=2e-5,
                                       err_msg=g[0])
        elif g[0] == "pc.s":
            np.testing.assert_allclose(g[3], w[3], rtol=1e-6, err_msg=g[0])
        else:
            assert g[3] == w[3], (g, w)


def _history_arrays(srv):
    snap = srv.history.snapshot()
    return snap["meta"], {k: np.array(v) for k, v in snap["arrays"].items()}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_server_checkpoint_restores_across_packages(writer, tmp_path):
    """A Server of one package flushes one interval (writing its ring),
    holds a watch, takes a second interval and shuts down: the tail
    checkpoint restores into both packages' Servers, which flush the
    same tail, hold the same watch state and the same ring."""
    root = tmp_path / "ckpt"
    make = _jserver if writer == "jax" else _tserver
    srv, _sink = make(checkpoint_dir=str(root), checkpoint_interval_flushes=1,
                      **TIERS)
    try:
        srv.watch_engine.register({"name": "pc.c0", "threshold": 0.5})
        _send(srv, _lines(0))
        assert srv.trigger_flush(timeout=120)
        _wait(lambda: srv.watch_engine.snapshot()["watches"][0]["state"]
              ["status"] == "ALERT", "watch not in ALERT")
        _send(srv, _lines(1))
    finally:
        srv.shutdown()
    assert len(list_checkpoints(str(root))) == 2
    got = {}
    for pkg, mk in (("jax", _jserver), ("port", _tserver)):
        d = tmp_path / f"restore-{pkg}"
        shutil.copytree(root, d)
        rsrv, rsink = mk(checkpoint_dir=str(d), restore_on_start=True,
                         checkpoint_on_shutdown=False, **TIERS)
        try:
            assert rsrv._c_ckpt_restores.value() == 1
            watches = rsrv.watch_engine.snapshot()
            ring = _history_arrays(rsrv)
            assert rsrv.trigger_flush(timeout=120)
            got[pkg] = (_app(rsink), watches, ring)
        finally:
            rsrv.shutdown()
    (tapp, tw, (tmeta, tarr)), (japp, jw, (jmeta, jarr)) = (got["port"],
                                                           got["jax"])
    _assert_same_app(tapp, japp)
    by = {(n, t): v for n, t, _ty, v in tapp}
    assert by[("pc.c0", ())] == 2.0               # the tail only
    assert tw == jw and tw["watches"][0]["state"]["status"] == "ALERT"
    assert json.dumps(tmeta, sort_keys=True) == json.dumps(jmeta,
                                                           sort_keys=True)
    assert sorted(tarr) == sorted(jarr)
    for k in tarr:
        np.testing.assert_array_equal(tarr[k], jarr[k], err_msg=k)


def test_server_periodic_checkpoint_cadence_and_metrics(tmp_path):
    srv, _ = _tserver(checkpoint_dir=str(tmp_path / "ckpt"),
                      checkpoint_interval_flushes=2,
                      checkpoint_on_shutdown=False)
    try:
        _send(srv, [b"p.count:5|c", b"p.timer:12|ms"])
        assert srv.trigger_flush(timeout=120)
        assert srv._ckpt_writer.wait_idle(30.0)
        assert list_checkpoints(str(tmp_path / "ckpt")) == []
        _send(srv, [b"p.count:5|c", b"p.timer:12|ms"])
        assert srv.trigger_flush(timeout=120)
        assert srv._ckpt_writer.wait_idle(30.0)
        (_seq, path), = list_checkpoints(str(tmp_path / "ckpt"))
        manifest = verify_dir(path)
        assert manifest["rows"]["counter"] >= 1
        assert manifest["rows"]["histo"] >= 1
        assert srv._c_ckpt_writes.value() == 1
        assert srv._c_ckpt_bytes.value() > 0
        assert "veneur.checkpoint.age_s" in srv.metrics.flat_values()
    finally:
        srv.shutdown()


def test_server_graceful_shutdown_checkpoints_tail_only(tmp_path):
    root = str(tmp_path / "ckpt")
    srv, sink1 = _tserver(checkpoint_dir=root, checkpoint_interval_flushes=1)
    _send(srv, [b"flushed.count:7|c"])
    assert srv.trigger_flush(timeout=120)
    assert srv._ckpt_writer.wait_idle(30.0)
    _send(srv, [b"tail.count:3|c"])
    srv.shutdown()
    assert {m.name: m.value for m in sink1.flushed}["flushed.count"] == 7.0
    srv2, sink2 = _tserver(checkpoint_dir=root, restore_on_start=True)
    try:
        assert srv2._c_ckpt_restores.value() == 1
        assert srv2.trigger_flush(timeout=120)
        m = {x.name: x.value for x in sink2.flushed}
        assert m["tail.count"] == 3.0
        assert "flushed.count" not in m
    finally:
        srv2.shutdown()


def test_server_restore_quarantines_corrupt_and_cold_starts(tmp_path):
    root = tmp_path / "ckpt"
    srv, _ = _tserver(checkpoint_dir=str(root), checkpoint_interval_flushes=1,
                      checkpoint_on_shutdown=False)
    _send(srv, [b"x.count:1|c"])
    assert srv.trigger_flush(timeout=120)
    assert srv._ckpt_writer.wait_idle(30.0)
    srv.shutdown()
    (_seq, path), = list_checkpoints(str(root))
    blob = bytearray(pathlib.Path(path, CHUNKS_NAME).read_bytes())
    blob[0] ^= 0xFF
    pathlib.Path(path, CHUNKS_NAME).write_bytes(bytes(blob))
    srv2, _ = _tserver(checkpoint_dir=str(root), restore_on_start=True)
    try:
        assert srv2._c_ckpt_corrupt.value() == 1
        assert srv2._c_ckpt_restores.value() == 0
        assert srv2.aggregator.processed == 0      # cold start
        assert (root / "quarantine").is_dir()
        _send(srv2, [b"fresh.count:2|c"])
        assert srv2.trigger_flush(timeout=120)
    finally:
        srv2.shutdown()


def test_checkpoint_off_by_default():
    srv, _ = _tserver()
    try:
        assert srv._ckpt_writer is None and srv._restore_complete
    finally:
        srv.shutdown()
    assert not os.path.exists("ckpt")
