"""vtlint for the port (veneur_tpu_torch/analysis) against the JAX one.

1. Per-pass positive/negative fixtures: every registered pass flags a
   minimal fixture and stays quiet on a clean one. The torch passes get
   torch fixtures (`.item()` on `self.state`, an unsynced delta around
   `fused_ingest`, `torch.cat` in a hot function).
2. The five generic passes and metric-names report on the JAX test's
   fixture trees exactly what the JAX passes report.
3. Framework self-coverage as in tests/test_vtlint.py: suppressions,
   alias resolution, one parse a file, the --json schema, the registry.
4. The snapshot pin equals the JAX pin, and `--all` exits 0 on the repo.
"""

import ast
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

import veneur_tpu.analysis as janalysis
from veneur_tpu_torch.analysis import (PASSES, accounting_flow,
                                       ambiguous_paths, bare_except,
                                       drop_accounting, hot_path_alloc,
                                       lock_discipline, metric_names,
                                       reshard_quiesce, run_passes,
                                       snapshot_schema, table_grow_quiesce,
                                       timer_sync, torch_hot_path)
from veneur_tpu_torch.analysis.core import (Project, filter_suppressed,
                                            reasonless_suppressions)

REPO = pathlib.Path(__file__).resolve().parent.parent


def _project(root: pathlib.Path, files: dict) -> Project:
    for rel, src in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))
    return Project(root)


def _inventory(*rows):
    """A README holding both packages' inventory blocks with `rows`."""
    body = "\n".join(f"| `{r}` | c | x |" for r in rows)
    return (f"<!-- metric-inventory:begin -->\n{body}\n"
            "<!-- metric-inventory:end -->\n"
            f"<!-- torch-metric-inventory:begin -->\n{body}\n"
            "<!-- torch-metric-inventory:end -->\n")


# -- 1. per-pass positive/negative fixtures ---------------------------------

# (pass name, runner(project), files that MUST flag, files that must not)
CASES = [
    (
        "hot-path-alloc",
        lambda p: hot_path_alloc.run(p, hot_funcs={"pkg/mod.py": ["pump"]}),
        {"pkg/mod.py": """
            import numpy as np
            def pump(buf):
                out = np.empty(4)
                return out
        """},
        {"pkg/mod.py": """
            import numpy as np
            def pump(buf):
                out = np.zeros(4)
                return out
        """},
    ),
    (
        # the torch allocations: torch.cat / .clone() per batch flag; the
        # pinned double-buffered copy to the card is reuse
        "hot-path-alloc",
        lambda p: hot_path_alloc.run(p, hot_funcs={"pkg/mod.py": ["pump"]}),
        {"pkg/mod.py": """
            import torch as t
            def pump(self, parts):
                flat = t.cat(parts)
                return flat.clone()
        """},
        {"pkg/mod.py": """
            import torch
            def pump(self, buf):
                buf.ready()
                return buf.to(self.device)
        """},
    ),
    (
        "bare-except",
        lambda p: bare_except.run(p, egress=["pkg"]),
        {"pkg/sink.py": """
            def flush(batch):
                try:
                    batch.send()
                except Exception:
                    pass
        """},
        {"pkg/sink.py": """
            import logging
            def flush(batch):
                try:
                    batch.send()
                except Exception:
                    logging.exception("flush failed")
        """},
    ),
    (
        "drop-accounting",
        lambda p: drop_accounting.run(p, targets=["pkg"],
                                      required_counters=[]),
        {"pkg/ingest.py": """
            import queue
            def enqueue(q, item):
                try:
                    q.put_nowait(item)
                except queue.Full:
                    pass
        """},
        {"pkg/ingest.py": """
            import queue
            def enqueue(q, item, stats):
                try:
                    q.put_nowait(item)
                except queue.Full:
                    stats.dropped += 1
        """},
    ),
    (
        "ambiguous-paths",
        lambda p: ambiguous_paths.run(p, targets={"pkg/mod.py": {"send"}}),
        {"pkg/mod.py": """
            def send(win, batch):
                try:
                    win.post(batch)
                except OSError:
                    win.clear()
                    raise
        """},
        {"pkg/mod.py": """
            def send(win, batch):
                try:
                    win.post(batch)
                except OSError:
                    win.failed.inc()
                    raise
        """},
    ),
    (
        "metric-names",
        lambda p: metric_names.run(p, pkg="pkg", readme="README.md"),
        {"pkg/a.py": """
            def setup(reg):
                reg.counter("veneur.dup.total")
         """,
         "pkg/b.py": """
            def setup_again(reg):
                reg.counter("veneur.dup.total")
         """,
         "README.md": _inventory("veneur.dup.total")},
        {"pkg/a.py": """
            def setup(reg):
                reg.counter("veneur.dup.total")
         """,
         "README.md": _inventory("veneur.dup.total")},
    ),
    (
        # a registration table (server.py's ring family) registers each
        # row's literal: a row missing from the inventory flags, and so
        # does an inventory row no table registers
        "metric-names",
        lambda p: metric_names.run(p, pkg="pkg", readme="README.md"),
        {"pkg/srv.py": """
            def setup(M, stats):
                for name, key, kind in (
                        ("veneur.ring.depth", "ring_depth", "gauge"),
                        ("veneur.ring.stalls_total", "stalls", "counter")):
                    M.callback(name, lambda k=key: stats[k], kind=kind)
         """,
         "README.md": _inventory("veneur.ring.depth", "veneur.ring.gone")},
        {"pkg/srv.py": """
            def setup(M, stats):
                for name, key, kind in (
                        ("veneur.ring.depth", "ring_depth", "gauge"),
                        ("veneur.ring.stalls_total", "stalls", "counter")):
                    M.callback(name, lambda k=key: stats[k], kind=kind)
         """,
         "README.md": _inventory("veneur.ring.depth",
                                 "veneur.ring.stalls_total")},
    ),
    (
        # host syncs on device values in a hot function: .item() on
        # self.state, .cpu() of a kernel wrapper's result, an `if` on a
        # torch result, and a full-device drain
        "torch-hot-path",
        lambda p: torch_hot_path.run(p, hot_funcs={"pkg/mod.py": ["hot"]},
                                     inplace_mutators={}, sync_scan=[]),
        {"pkg/mod.py": """
            import torch
            from veneur_tpu_torch.ops.cuda_digest import quantiles_rows
            class Agg:
                def hot(self, rows, qs):
                    n = self.state.counter_acc.sum().item()
                    q = quantiles_rows(rows, qs).cpu()
                    if torch.any(rows > 0):
                        torch.cuda.synchronize()
                    return n, q
        """},
        # negative: metadata reads, host numpy, a from_numpy host tensor,
        # and enqueued work never read back
        {"pkg/mod.py": """
            import numpy as np
            import torch
            class Agg:
                def hot(self, rows, qs):
                    n = int(self.state.counter_acc.shape[0])
                    if self.state.hll.numel() > 0:
                        host = torch.from_numpy(np.zeros(4)).numpy()
                    self.state.counter_acc.add_(1.0)
                    return n
        """},
    ),
    (
        # the in-place mutators (K1's wrapper, the ring writers): a rebind
        # of the state or a leaf, a clone, a _replace must flag
        "torch-hot-path",
        lambda p: torch_hot_path.run(
            p, hot_funcs={}, inplace_mutators={"pkg/ring.py": [
                "write_window_core", "roll_tiers", "fused_ingest"]},
            sync_scan=[]),
        {"pkg/ring.py": """
            def write_window_core(hist, vals, col):
                hist.gauge = vals["gauge"]
                return hist

            def roll_tiers(hist, src0, src1, dst):
                h = hist
                old = h.gauge.clone()
                hist = hist._replace(gauge=old)
                return hist

            def fused_ingest(state, st, spec):
                state = state._replace(counter_acc=st.c_inc)
        """},
        {"pkg/ring.py": """
            def write_window_core(hist, vals, col):
                hist.gauge[:, col] = vals["gauge"]
                return hist

            def roll_tiers(hist, src0, src1, dst):
                h = hist
                h.gauge[:, dst] = h.gauge[:, src1]
                return hist

            def fused_ingest(state, st, spec):
                state.counter_acc.index_add_(0, st.c_slot, st.c_inc)
        """},
    ),
    (
        # every host wait on the card outside the hot functions needs a
        # reason: torch.cuda.synchronize called or handed to a thread, an
        # event's .synchronize()
        "torch-hot-path",
        lambda p: torch_hot_path.run(p, hot_funcs={}, inplace_mutators={},
                                     sync_scan=["pkg"]),
        {"pkg/srv.py": """
            import threading
            import torch
            def shutdown(dev):
                threading.Thread(target=torch.cuda.synchronize,
                                 args=(dev,)).start()
            def wait(ev):
                ev.synchronize()
        """},
        {"pkg/srv.py": """
            import threading
            import torch
            def shutdown(dev):
                # vtlint: disable=torch-hot-path -- shutdown quiesce
                threading.Thread(target=torch.cuda.synchronize,
                                 args=(dev,)).start()
            def wait(ev):
                ev.record()
        """},
    ),
    (
        "lock-discipline",
        lambda p: lock_discipline.run(p, modules=["pkg/mod.py"]),
        {"pkg/mod.py": """
            import threading
            class C:
                def __init__(self):
                    self._lock = threading.Lock()
                    self.n = 0
                def locked_bump(self):
                    with self._lock:
                        self.n += 1
                def racy_bump(self):
                    self.n += 1
        """},
        {"pkg/mod.py": """
            import threading
            class C:
                def __init__(self):
                    self._lock = threading.Lock()
                    self.n = 0
                def locked_bump(self):
                    with self._lock:
                        self.n += 1
                def other_bump(self):
                    with self._lock:
                        self.n += 2
        """},
    ),
    (
        # timing K1's launch without a sync measures the enqueue — must
        # flag; the dispatch_* name, an in-range event wait, sync_and_time
        # and a host copy of the result must not
        "timer-sync",
        lambda p: timer_sync.run(p, files=["pkg/mod.py"]),
        {"pkg/mod.py": """
            import time
            from veneur_tpu_torch.ops.cuda_ingest import fused_ingest

            class C:
                def step(self, st):
                    t0 = time.perf_counter_ns()
                    fused_ingest(self.state, st, self.spec)
                    self.step_ns += time.perf_counter_ns() - t0

                def routed(self, flat):
                    t0 = time.perf_counter_ns()
                    routed_ingest(self.state, flat, spec=self.spec)
                    self.timer.observe(time.perf_counter_ns() - t0)
        """},
        {"pkg/mod.py": """
            import time
            import torch
            from veneur_tpu_torch.observability.runtime import sync_and_time
            from veneur_tpu_torch.ops.cuda_digest import quantiles_rows
            from veneur_tpu_torch.ops.cuda_ingest import fused_ingest

            class C:
                def enqueue_only(self, st):
                    t0 = time.perf_counter_ns()
                    fused_ingest(self.state, st, self.spec)
                    dispatch_dt = time.perf_counter_ns() - t0
                    self.dispatch_ns += dispatch_dt

                def synced(self, st):
                    t0 = time.perf_counter_ns()
                    fused_ingest(self.state, st, self.spec)
                    torch.cuda.synchronize()
                    self.step_ns += time.perf_counter_ns() - t0

                def sampled(self, st):
                    t0 = time.perf_counter_ns()
                    fused_ingest(self.state, st, self.spec)
                    self.step_ns += sync_and_time(self.state) + (
                        time.perf_counter_ns() - t0)

                def copied_back(self, rows, qs):
                    t0 = time.perf_counter_ns()
                    out = quantiles_rows(rows, qs).cpu()
                    self.flush_ns += time.perf_counter_ns() - t0
                    return out

                def host_only(self, rows):
                    t0 = time.perf_counter_ns()
                    n = sum(len(r) for r in rows)
                    self.host_ns += time.perf_counter_ns() - t0
                    return n
        """},
    ),
    (
        "accounting-flow",
        lambda p: accounting_flow.run(p, targets=["pkg"], send_targets={}),
        {"pkg/ingest.py": """
            import queue
            def enqueue(q, item, stats=None):
                try:
                    q.put_nowait(item)
                except queue.Full:
                    if stats is not None:
                        stats.dropped += 1
        """},
        {"pkg/ingest.py": """
            import queue
            def enqueue(q, item, stats):
                try:
                    q.put_nowait(item)
                except queue.Full:
                    stats.dropped += 1
        """},
    ),
    (
        # surface 3 with the binding's closure idiom: a per-ring drain in
        # a closure of a `_one` accessor rides the accessor's contract,
        # but the accessor's callers must still fold across every ring
        "accounting-flow",
        lambda p: accounting_flow.run(p, targets=[], send_targets={},
                                      ring_targets=["pkg"]),
        {"pkg/binding.py": """
            class Eng:
                def ring_tenant_drain_one(self, ring):
                    def call(cap):
                        return self._lib.vrm_tenant_counters(
                            self._rings, ring, cap)
                    return self._grow_call(call, 64)

                def tenant_totals(self):
                    return self.ring_tenant_drain_one(0)

                def tenant_table(self):
                    def call(cap):
                        return self._lib.vrm_tenant_counters(
                            self._rings, 0, cap)
                    return self._grow_call(call, 64)
        """},
        {"pkg/binding.py": """
            class Eng:
                def ring_tenant_drain_one(self, ring):
                    def call(cap):
                        return self._lib.vrm_tenant_counters(
                            self._rings, ring, cap)
                    return self._grow_call(call, 64)

                def tenant_totals(self, n_rings):
                    out = []
                    for r in range(n_rings):
                        out.append(self.ring_tenant_drain_one(r))
                    return out
        """},
    ),
    (
        "reshard-quiesce",
        lambda p: reshard_quiesce.run(p, roots=["veneur_tpu_torch"]),
        {"veneur_tpu_torch/srv.py": """
            class Agg:
                def resize(self, eng, n):
                    eng.shard_map_set(n)
                    self.n_shards = n

            class Proxy:
                def poll(self, ring):
                    self._ring = ring
        """},
        {"veneur_tpu_torch/reshard/quiesce.py": """
            def shard_map_swap(aggregator, new_n_shards):
                eng = getattr(aggregator, "eng", None)
                if eng is not None:
                    eng.shard_map_set(int(new_n_shards))
                return aggregator.swap()
        """,
         "veneur_tpu_torch/forward/proxysrv.py": """
            class ProxyServer:
                def __init__(self):
                    self._ring = None

                def refresh(self, dests):
                    self._ring = tuple(dests)
        """,
         "veneur_tpu_torch/srv.py": """
            class Agg:
                def __init__(self, n_shards):
                    self.n_shards = n_shards
        """},
    ),
    (
        # growth calls the engine; an aggregator-level delegate to the
        # engine's capacity_set is a second grow site and must flag
        "table-grow-quiesce",
        lambda p: table_grow_quiesce.run(p, roots=["veneur_tpu_torch"]),
        {"veneur_tpu_torch/server/native_aggregator.py": """
            class NativeAggregator:
                def capacity_set(self, counter, gauge, set_, histo):
                    self.eng.capacity_set(counter, gauge, set_, histo)

                def grow(self, caps):
                    self.spec = caps
        """},
        {"veneur_tpu_torch/tables/growth.py": """
            def grow_swap(server, new_spec):
                eng = getattr(server.aggregator, "eng", None)
                if eng is not None:
                    eng.capacity_set(1, 2, 3, 4)
                return server.aggregator.swap()
        """,
         "veneur_tpu_torch/native/__init__.py": """
            class NativeIngest:
                def capacity_set(self, counter, gauge, set_, histo):
                    self._lib.vt_capacity_set(self._h, counter)
        """,
         "veneur_tpu_torch/server/native_aggregator.py": """
            class NativeAggregator:
                def __init__(self, spec):
                    self.spec = spec
        """},
    ),
]

_IDS = [c[0] for c in CASES]


@pytest.mark.parametrize("pass_name,runner,pos,neg", CASES, ids=_IDS)
def test_pass_flags_positive_fixture(tmp_path, pass_name, runner, pos, neg):
    proj = _project(tmp_path, pos)
    found = filter_suppressed(proj, runner(proj))
    assert found, f"{pass_name} missed its positive fixture"
    assert all(f.pass_name == pass_name for f in found)


@pytest.mark.parametrize("pass_name,runner,pos,neg", CASES, ids=_IDS)
def test_pass_quiet_on_negative_fixture(tmp_path, pass_name, runner,
                                        pos, neg):
    proj = _project(tmp_path, neg)
    assert filter_suppressed(proj, runner(proj)) == []
    assert reasonless_suppressions(proj) == []


def test_torch_fixtures_flag_each_site(tmp_path):
    """Each sync of the torch-hot-path fixture, each unsynced delta of
    the timer-sync fixture and each hazard of the mutator fixture is its
    own finding."""
    by_name = {}
    for i, (name, runner, pos, _) in enumerate(CASES):
        found = runner(_project(tmp_path / str(i), pos))
        by_name.setdefault(name, []).append(found)
    sync, mutators, waits = by_name["torch-hot-path"]
    assert sorted(f.message.split(" ")[0] for f in sync) == [
        "Python", "`.cpu()`", "`.item()`", "`torch.cuda.synchronize()`"]
    # a leaf rebind; a clone; two rebinds of the state, each by _replace
    assert len(mutators) == 6
    assert len(waits) == 2
    assert len(by_name["timer-sync"][0]) == 2
    assert len(by_name["hot-path-alloc"][1]) == 2


# -- 2. the generic passes against the JAX passes ---------------------------

# (module, kwargs, fixture tree): the JAX test's fixtures for the five
# generic passes and metric-names, positive and negative
SHARED = [
    ("bare_except", dict(egress=["pkg"]), CASES[2][2]),
    ("bare_except", dict(egress=["pkg"]), CASES[2][3]),
    ("drop_accounting", dict(targets=["pkg"], required_counters=[]),
     CASES[3][2]),
    ("drop_accounting", dict(targets=["pkg"], required_counters=[]),
     CASES[3][3]),
    ("ambiguous_paths", dict(targets={"pkg/mod.py": {"send"}}), CASES[4][2]),
    ("ambiguous_paths", dict(targets={"pkg/mod.py": {"send"}}), CASES[4][3]),
    ("lock_discipline", dict(modules=["pkg/mod.py"]), CASES[10][2]),
    ("lock_discipline", dict(modules=["pkg/mod.py"]), CASES[10][3]),
    ("accounting_flow", dict(targets=["pkg"], send_targets={}),
     CASES[12][2]),
    ("accounting_flow", dict(targets=["pkg"], send_targets={}),
     CASES[12][3]),
    ("accounting_flow", dict(targets=["pkg"], send_targets={}),
     {"pkg/watchq.py": """
        import queue
        def offer(jobs, job):
            try:
                jobs.put_nowait(job)
            except queue.Full:
                try:
                    jobs.get_nowait()
                except queue.Empty:
                    pass
                jobs.put_nowait(job)
     """}),
    ("accounting_flow", dict(targets=[], send_targets={},
                             ring_targets=["pkg"]),
     {"pkg/drain.py": """
        def reader_totals(eng):
            out = eng.ring_counters_one(0)
            adm = eng.ring_admission_drain_one(0)
            return out, adm

        def ring_counters_one(eng, r):
            return eng.vrm_counters(r)
     """}),
    ("accounting_flow", dict(targets=["pkg"], send_targets={},
                             ring_targets=["pkg"]),
     {"pkg/tenantq.py": """
        import queue
        def tenant_shed_totals(eng):
            return eng.ring_tenant_drain_one(0)

        def shed_datagram(q, item):
            try:
                q.put_nowait(item)
            except queue.Full:
                return None
     """}),
    ("accounting_flow", dict(targets=["pkg"], send_targets={
        "pkg/send.py": {"send"}}),
     {"pkg/send.py": """
        def send(win, batch, stats):
            try:
                win.post(batch)
            except OSError as e:
                if e.errno == 4:
                    return False
                stats.failed += 1
                raise
     """}),
    ("metric_names", dict(pkg="pkg", readme="README.md"), CASES[5][2]),
    ("metric_names", dict(pkg="pkg", readme="README.md"), CASES[5][3]),
    ("metric_names", dict(pkg="pkg", readme="README.md"),
     {"pkg/a.py": """
        def setup(reg, ssf_samples):
            reg.gauge("veneur.only.code")
            ssf_samples.count("veneur.emitted.total", 1)
            return {"veneur.a": 1, "veneur.b": 2, "veneur.c": 3}
      """,
      "README.md": _inventory("veneur.a", "veneur.b", "veneur.only.doc")}),
]


def _as_tuples(found):
    return sorted((f.pass_name, f.file, f.line, f.message) for f in found)


@pytest.mark.parametrize("idx", range(len(SHARED)),
                         ids=[f"{m}-{i}" for i, (m, _, _) in
                              enumerate(SHARED)])
def test_generic_pass_findings_equal_jax(tmp_path, idx):
    mod, kw, files = SHARED[idx]
    proj = _project(tmp_path, files)
    import importlib
    jmod = importlib.import_module(f"veneur_tpu.analysis.{mod}")
    tmod = importlib.import_module(f"veneur_tpu_torch.analysis.{mod}")
    from veneur_tpu.analysis.core import Project as JProject
    want = jmod.run(JProject(tmp_path), **kw)
    got = tmod.run(proj, **kw)
    assert _as_tuples(got) == _as_tuples(want)


def test_snapshot_schema_clean_and_drift(monkeypatch):
    """The live-code pass: clean against this repo, and a bogus pin for
    the current format version is reported as drift."""
    assert snapshot_schema.run(Project(REPO)) == []
    from veneur_tpu_torch.persistence import codec
    monkeypatch.setitem(codec._SCHEMA_PINS,
                        codec.SNAPSHOT_FORMAT_VERSION, "bogus")
    drifted = snapshot_schema.run(Project(REPO))
    assert len(drifted) == 1 and "DRIFT" in drifted[0].message


def test_snapshot_pin_equals_the_jax_pin():
    """Checkpoints restore across the two packages: the same format
    version, the same pins and migrations, the same live hash."""
    from veneur_tpu.persistence import codec as jcodec
    from veneur_tpu_torch.persistence import codec as tcodec
    assert tcodec.SNAPSHOT_FORMAT_VERSION == jcodec.SNAPSHOT_FORMAT_VERSION
    assert tcodec._SCHEMA_PINS == jcodec._SCHEMA_PINS
    assert set(tcodec._SCHEMA_MIGRATIONS) == set(jcodec._SCHEMA_MIGRATIONS)
    assert tcodec.schema_hash() == jcodec.schema_hash() == \
        tcodec._SCHEMA_PINS[tcodec.SNAPSHOT_FORMAT_VERSION]


# -- 3. framework self-coverage ---------------------------------------------

def test_alias_resolution(tmp_path):
    proj = _project(tmp_path, {"m.py": """
        import numpy as np
        import torch as t
        from os import path as p
        from x import y as z
    """})
    ctx = proj.file("m.py")
    assert ctx.aliases["np"] == "numpy"
    assert ctx.aliases["t"] == "torch"
    assert ctx.aliases["p"] == "os.path"
    assert ctx.aliases["z"] == "x.y"
    expr = lambda s: ast.parse(s).body[0].value
    assert ctx.resolve(expr("np.empty")) == "numpy.empty"
    assert ctx.resolve(expr("t.cuda.synchronize")) == \
        "torch.cuda.synchronize"
    assert ctx.resolve(expr("z")) == "x.y"
    assert ctx.resolve(expr("unaliased.f")) == "unaliased.f"


def test_suppression_same_line_and_line_above(tmp_path):
    proj = _project(tmp_path, {"pkg/sink.py": """
        def flush(batch):
            try:
                batch.send()
            except Exception:  # vtlint: disable=bare-except -- fixture: testing suppression
                pass
        def flush2(batch):
            try:
                batch.send()
            # vtlint: disable=bare-except -- covers the next line
            except Exception:
                pass
    """})
    found = filter_suppressed(proj, bare_except.run(proj, egress=["pkg"]))
    assert found == []
    assert reasonless_suppressions(proj) == []


def test_suppression_without_reason_is_itself_reported(tmp_path):
    proj = _project(tmp_path, {"pkg/sink.py": """
        def flush(batch):
            try:
                batch.send()
            except Exception:  # vtlint: disable=bare-except
                pass
    """})
    assert filter_suppressed(
        proj, bare_except.run(proj, egress=["pkg"])) == []
    missing = reasonless_suppressions(proj)
    assert len(missing) == 1 and missing[0].pass_name == "vtlint"


def test_suppression_is_per_pass(tmp_path):
    """Disabling one pass does not silence another on the same line."""
    proj = _project(tmp_path, {"pkg/sink.py": """
        def flush(batch):
            try:
                batch.send()
            except Exception:  # vtlint: disable=torch-hot-path -- wrong pass name
                pass
    """})
    found = filter_suppressed(proj, bare_except.run(proj, egress=["pkg"]))
    assert len(found) == 1


def test_registered_hot_function_missing_is_an_error(tmp_path):
    """A renamed hot function or mutator must fail the lint, not shrink
    its surface silently; same for a moved file."""
    proj = _project(tmp_path, {"pkg/mod.py": "def other():\n    pass\n"})
    found = hot_path_alloc.run(proj, hot_funcs={"pkg/mod.py": ["pump"]})
    assert any("not found" in f.message for f in found)
    found = hot_path_alloc.run(proj, hot_funcs={"pkg/gone.py": []})
    assert any("file missing" in f.message for f in found)
    found = torch_hot_path.run(
        proj, hot_funcs={}, sync_scan=[],
        inplace_mutators={"pkg/mod.py": ["fused_ingest"]})
    assert any("not found" in f.message for f in found)


def test_one_parse_per_file(tmp_path):
    """Multiple passes over the same file share one AST parse."""
    proj = _project(tmp_path, {"pkg/ingest.py": """
        import queue
        def enqueue(q, item, stats):
            try:
                q.put_nowait(item)
            except queue.Full:
                stats.dropped += 1
    """})
    drop_accounting.run(proj, targets=["pkg"], required_counters=[])
    accounting_flow.run(proj, targets=["pkg"], send_targets={})
    bare_except.run(proj, egress=["pkg"])
    torch_hot_path.run(proj, hot_funcs={}, inplace_mutators={},
                       sync_scan=["pkg"])
    assert proj.parse_count == 1


def test_run_passes_json_schema_matches_jax(tmp_path):
    """The --json result has the JAX package's keys, version and rows."""
    proj = _project(tmp_path, {"pkg/mod.py": "x = 1\n"})
    result = run_passes(proj, ["bare-except"])
    from veneur_tpu.analysis.core import Project as JProject
    want = janalysis.run_passes(JProject(tmp_path), ["bare-except"])
    assert set(result) == set(want) == {
        "version", "root", "passes", "findings", "files_parsed",
        "parse_count", "runtime_s", "ok"}
    assert result["version"] == want["version"] == 1
    assert result["ok"] is True
    assert [set(row) for row in result["passes"]] == [
        set(row) for row in want["passes"]] == [
        {"name", "doc", "findings", "runtime_s"}]


def test_registry_covers_all_twelve_passes():
    """The JAX eleven in their order, with torch-hot-path in place of
    jax-hot-path."""
    want = [("torch-hot-path" if n == "jax-hot-path" else n)
            for n in janalysis.PASSES]
    assert list(PASSES) == want == [
        "hot-path-alloc", "drop-accounting", "ambiguous-paths",
        "bare-except", "metric-names", "snapshot-schema",
        "torch-hot-path", "lock-discipline", "accounting-flow",
        "timer-sync", "reshard-quiesce", "table-grow-quiesce"]
    for name, mod in PASSES.items():
        assert mod.NAME == name and mod.DOC


def test_the_lints_repairs_stay_repaired():
    """The port's code repairs the lint drove: the routed step's phase
    is its enqueue under a dispatch name, growth is the one capacity
    caller, the binding's closure drain rides its `_one` accessor, and
    every host wait on the card carries its reason."""
    proj = Project(REPO)
    tier = timer_sync.run(proj, files=[
        "veneur_tpu_torch/collective/tier.py"])
    assert [f.message.split("()")[0].rsplit(" ", 1)[-1]
            for f in tier] == ["compute_flush"]
    assert filter_suppressed(proj, tier) == []
    from veneur_tpu_torch.server import native_aggregator as na
    assert not hasattr(na.NativeAggregator, "capacity_set")
    assert not hasattr(na.NativeShardedAggregator, "capacity_set")
    assert accounting_flow.run(
        proj, targets=[], send_targets={},
        ring_targets=["veneur_tpu_torch/native/__init__.py"]) == []
    waits = torch_hot_path.run(proj, hot_funcs={}, inplace_mutators={})
    assert sorted(f.file for f in waits) == [
        "veneur_tpu_torch/observability/runtime.py",
        "veneur_tpu_torch/server/aggregator.py",
        "veneur_tpu_torch/server/server.py"]
    assert filter_suppressed(proj, waits) == []


def test_port_analysis_imports_no_jax():
    code = ("import sys, veneur_tpu_torch.analysis as a\n"
            "import veneur_tpu_torch.analysis.__main__\n"
            "r = a.run_passes(a.Project(a.REPO), ['snapshot-schema'])\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'veneur_tpu')]\n"
            "assert not bad and r['ok'], (bad, r)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


# -- 4. the gate -------------------------------------------------------------

def test_vtlint_all_gate_on_the_port():
    """`--all` runs every pass against the port in one process and exits
    0; every suppression in the port carries a reason."""
    proc = subprocess.run(
        [sys.executable, "-m", "veneur_tpu_torch.analysis", "--all",
         "--json"],
        capture_output=True, text=True, cwd=REPO, timeout=300,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    data = json.loads(proc.stdout.strip().splitlines()[-1])
    assert data["ok"] is True and data["findings"] == []
    assert [p["name"] for p in data["passes"]] == list(PASSES)
    assert data["files_parsed"] == data["parse_count"] > 100
    listed = subprocess.run(
        [sys.executable, "-m", "veneur_tpu_torch.analysis", "--list"],
        capture_output=True, text=True, cwd=REPO, timeout=120)
    assert listed.returncode == 0
    assert [ln.split()[0] for ln in listed.stdout.splitlines()] == \
        list(PASSES)
