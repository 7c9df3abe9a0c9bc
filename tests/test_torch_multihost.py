"""The port's replica merge across PROCESSES (parallel/multihost.py): two
processes join one torch.distributed group on the gloo backend, each
holds one replica row of an (R = 2, S = 2) grid, ingests its own sample
stream, and the merged flush gathers the other row over the group. Both
ranks must see the same merged totals, equal to the one-process merge of
both rows and to the JAX package's merged flush of the same batches on
its (2, 2) CPU mesh (counters exact, quantiles within rtol/atol 2e-5).
Slot alignment across processes is the caller's contract (the same
slots in both processes here), as in tests/test_multihost.py.

Each child gets at most 120 s, so a hang fails one test and does not
cut the run.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from veneur_tpu_torch.aggregation.host import Batcher, BatchSpec
from veneur_tpu_torch.aggregation.state import TableSpec
from veneur_tpu_torch.aggregation.step import combine_flush_scalars
from veneur_tpu_torch.parallel import multihost, sharded

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R, S = 2, 2
SPEC_KW = dict(counter_capacity=16, gauge_capacity=8, status_capacity=4,
               set_capacity=4, histo_capacity=8, hll_precision=12)
BSPEC_KW = dict(counter=32, gauge=8, status=4, set=8, histo=64)


def replica_rows(rank: int, spec=None, batcher=Batcher,
                 bspec_cls=BatchSpec):
    """Replica row `rank`'s batches, one a shard: counters +(rank + 1)
    into slot 3 of shard 0 and 100·(rank + 1) into slot 1 of shard 1,
    timer samples 1..10 + 10·rank into slot 2 of shard 1, a gauge and a
    set member of the rank's own."""
    spec = spec or TableSpec(**SPEC_KW)
    rows = []
    for s in range(S):
        b = batcher(spec, bspec_cls(**BSPEC_KW))
        if s == 0:
            for _ in range(10):
                b.add_counter(3, float(rank + 1), 1.0)
            b.add_gauge(1, float(10 + rank))
            b.add_set(2, f"member-{rank}".encode())
        else:
            b.add_counter(1, 100.0 * (rank + 1), 1.0)
            for v in range(1, 11):
                b.add_histo(2, float(v + 10 * rank), 1.0)
        rows.append(b.force_emit())
    return rows


def merged_result(state, layout, spec=None):
    out = combine_flush_scalars(sharded.merged_flush(
        state, [0.5, 0.99], spec=spec or TableSpec(**SPEC_KW),
        layout=layout))
    return {k: np.asarray(out[k]).tolist() for k in (
        "counter", "gauge", "set_estimate", "histo_quantiles",
        "histo_count", "histo_min", "histo_max")}


_CHILD = r"""
import json, os, sys
sys.path.insert(0, os.environ["VENEUR_REPO"])
rank, port = int(sys.argv[1]), sys.argv[2]
import torch.distributed as dist
from veneur_tpu_torch.aggregation.state import TableSpec
from veneur_tpu_torch.parallel import multihost, sharded
from tests.test_torch_multihost import (R, S, SPEC_KW, merged_result,
                                        replica_rows)

group = multihost.init_multihost(f"127.0.0.1:{port}", num_processes=2,
                                 process_id=rank, device="cpu")
layout = sharded.Layout(R, S, group)
assert layout.r_local == 1
assert list(multihost.owned_replicas(layout)) == [rank]
spec = TableSpec(**SPEC_KW)
state = sharded.sharded_empty_state(spec, layout.r_local, S, "cpu")
batch = sharded.stack_batches([replica_rows(rank)], 1, S)
sharded.sharded_ingest(state, batch, spec=spec)
res = merged_result(state, layout)
assert res["counter"][0][3] == 30.0, res["counter"][0]
assert res["counter"][1][1] == 300.0, res["counter"][1]
# rank 1 is the higher participant: its gauge write wins
assert res["gauge"][0][1] == 11.0, res["gauge"][0]
print("RESULT " + json.dumps(res), flush=True)
dist.destroy_process_group()
"""


def _same(a: dict, b: dict) -> None:
    """Equal results, NaN rows (keys with no samples) included."""
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_merge_matches_one_process_and_jax():
    import jax

    from veneur_tpu.aggregation import host as jhost
    from veneur_tpu.aggregation import step as jstep
    from veneur_tpu.aggregation.state import TableSpec as JTableSpec
    from veneur_tpu.parallel import sharded as jsharded

    port = str(_free_port())
    env = {**os.environ, "VENEUR_REPO": REPO, "PYTHONPATH": REPO}
    env.pop("VENEUR_TPU_COORDINATOR", None)
    procs = [subprocess.Popen([sys.executable, "-c", _CHILD, str(r), port],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env, cwd=REPO)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err[-4000:]
            outs.append(json.loads(out.split("RESULT ", 1)[1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    _same(outs[0], outs[1])

    # the same rows merged in one process
    spec = TableSpec(**SPEC_KW)
    state = sharded.sharded_empty_state(spec, R, S, "cpu")
    sharded.sharded_ingest(state, sharded.stack_batches(
        [replica_rows(r) for r in range(R)], R, S), spec=spec)
    one = merged_result(state, sharded.Layout(R, S))
    _same(one, outs[0])

    # and the JAX merged flush on its (2, 2) mesh
    jspec = JTableSpec(**SPEC_KW)
    mesh = jsharded.make_mesh(R, S)
    jrows = [replica_rows(r, jspec, jhost.Batcher, jhost.BatchSpec)
             for r in range(R)]
    jstate = jsharded.make_sharded_ingest(mesh, jspec)(
        jsharded.sharded_empty_state(jspec, R, S, mesh),
        jsharded.stack_batches(jrows, R, S))
    want = jstep.combine_flush_scalars(jax.tree.map(
        np.asarray, jsharded.make_merged_flush(mesh, jspec)(
            jstate, np.asarray([0.5, 0.99], np.float32))))
    for key in ("counter", "gauge", "histo_count", "histo_min",
                "histo_max"):
        np.testing.assert_array_equal(np.asarray(one[key]), want[key],
                                      err_msg=key)
    np.testing.assert_allclose(np.asarray(one["set_estimate"]),
                               want["set_estimate"], rtol=1e-6)
    np.testing.assert_allclose(np.asarray(one["histo_quantiles"]),
                               want["histo_quantiles"], rtol=2e-5,
                               atol=2e-5, equal_nan=True)
    med = one["histo_quantiles"][1][2][0]
    assert abs(med - 10.5) < 1.5, med


def test_init_multihost_is_a_no_op_without_a_coordinator(monkeypatch):
    monkeypatch.delenv("VENEUR_TPU_COORDINATOR", raising=False)
    assert multihost.init_multihost() is None


def test_init_multihost_needs_the_process_count_and_id(monkeypatch):
    monkeypatch.setenv("VENEUR_TPU_COORDINATOR", "127.0.0.1:1")
    monkeypatch.delenv("VENEUR_TPU_NUM_PROCESSES", raising=False)
    monkeypatch.delenv("VENEUR_TPU_PROCESS_ID", raising=False)
    with pytest.raises(ValueError, match="VENEUR_TPU_NUM_PROCESSES"):
        multihost.init_multihost()


def test_init_multihost_defaults_to_the_card(monkeypatch):
    """No device named: the card (NCCL), which raises without one rather
    than joining over gloo on the CPU."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        multihost.init_multihost("127.0.0.1:1", num_processes=1,
                                 process_id=0)


def test_one_process_layout_owns_every_row_and_checks_batches():
    layout = sharded.Layout(R, S)
    assert (layout.world, layout.rank, layout.r_local) == (1, 0, R)
    assert list(multihost.owned_replicas(layout)) == [0, 1]
    spec = TableSpec(**SPEC_KW)
    st = sharded.sharded_empty_state(spec, layout.r_local, S, "cpu")
    assert tuple(st.counter_hi.shape) == (R, S, 16)
    rows = sharded.stack_batches([replica_rows(0)], 1, S)
    with pytest.raises(ValueError, match="state holds"):
        sharded.sharded_ingest(st, rows, spec=spec)


def test_slice_modules_import_no_jax_and_no_reference_package():
    code = (
        "import importlib, sys\n"
        "for m in ('parallel', 'parallel.sharded', 'parallel.multihost',\n"
        "          'collective', 'collective.ops', 'collective.keytable',\n"
        "          'collective.router', 'collective.tier',\n"
        "          'server.sharded_aggregator', 'server.native_aggregator',\n"
        "          'server.server'):\n"
        "    importlib.import_module('veneur_tpu_torch.' + m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'veneur_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.startswith("ok"), \
        res.stdout + res.stderr
