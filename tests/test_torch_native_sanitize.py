"""The port's engine under AddressSanitizer and UndefinedBehaviorSanitizer.

VENEUR_NATIVE_SANITIZE=1 (the JAX package's switch) makes
veneur_tpu_torch.native build dogstatsd.cpp with -fsanitize=address,
undefined as libdogstatsd_san_<key>.so. CPython is not instrumented, so
the runtimes are LD_PRELOADed into a child interpreter, which runs

- (a) tests/test_torch_native.py's packed-emit tests: the port's packed
  buffers word for word against the JAX engine, which the same variable
  also sanitizes. The JAX side waits for each of its steps there
  (`_SyncedJNative`): an unsynced JAX aggregator step is what fails the
  reference's own sanitized child (ROADMAP C-watch 4);
- (b) the intake corpora (tests/test_native.py, tests/test_intake_fuzz.py)
  through the port's NativeIngest and NativeAggregator;
- (c) the loopback UDP readers (readers_start + pump).

Any heap overflow, use after free or undefined behaviour in the parser,
the packed emit or the readers aborts the child. Skips, with the reason,
only where g++ or the sanitizer runtimes are absent.
"""

import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

from veneur_tpu_torch import native

REPO = pathlib.Path(__file__).resolve().parent.parent


def _sanitizer_env():
    if shutil.which("g++") is None:
        pytest.skip("g++ not on PATH — cannot build the native engine")
    preload = []
    for name in ("libasan.so", "libubsan.so"):
        out = subprocess.run(
            ["g++", f"-print-file-name={name}"],
            capture_output=True, text=True).stdout.strip()
        if os.path.sep not in out or not pathlib.Path(out).is_file():
            pytest.skip(f"{name} not shipped with this g++ — "
                        "sanitizer runtime unavailable")
        preload.append(out)
    env = dict(os.environ)
    env.update({
        "VENEUR_NATIVE_SANITIZE": "1",
        # the child interpreter is not instrumented; the runtime must be
        # resolvable before libpython allocates anything
        "LD_PRELOAD": ":".join(preload),
        # leak checking would report the whole CPython/torch heap; the
        # target is memory errors and UB in dogstatsd.cpp
        "ASAN_OPTIONS": "detect_leaks=0",
        "UBSAN_OPTIONS": "halt_on_error=1:print_stacktrace=1",
        "JAX_PLATFORMS": "cpu",
        "PYTHONPATH": str(REPO),
    })
    return env


def _run(env, *argv):
    return subprocess.run(
        [sys.executable, *argv], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=540)


def _clean(proc):
    """No sanitizer report anywhere in the child's output."""
    text = proc.stdout + proc.stderr
    assert "AddressSanitizer" not in text, text[-4000:]
    assert "runtime error:" not in text, text[-4000:]


# tests/test_torch_native.py's cases that run in the sanitized child:
# (a) the packed-emit tests, (c) the loopback readers
_PACKED = ("test_batch_spec_and_packed_sizes_match_jax",
           "test_packed_buffer_equals_jax_word_for_word_at_every_emit",
           "test_packed_rings_core_matches_jax")
_READERS = ("test_udp_readers_lossless_and_flush_what_feed_flushes",)


@pytest.fixture(scope="module")
def native_child():
    """One sanitized child interpreter runs (a) and (c) together: each
    child pays the runtimes' slow start of torch and JAX once."""
    env = _sanitizer_env()
    return _run(env, "-m", "pytest", "tests/test_torch_native.py", "-q",
                "-rA", "-p", "no:cacheprovider", "-p", "no:randomly",
                "-k", "packed or udp_readers")


def _passed(proc, names):
    text = proc.stdout + proc.stderr
    _clean(proc)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    for name in names:
        assert f"PASSED tests/test_torch_native.py::{name}" in text, \
            proc.stdout[-3000:]
    assert f"{len(_PACKED) + len(_READERS)} passed" in proc.stdout


def test_sanitized_packed_emit_parity(native_child):
    """(a) The port's packed-emit tests pass under ASan+UBSan, against
    the sanitized JAX engine."""
    _passed(native_child, _PACKED)


def test_sanitized_loopback_readers(native_child):
    """(c) Loopback datagrams through the sanitized readers and pump:
    lossless, counted, and the flush `feed` gives."""
    _passed(native_child, _READERS)


_CORPUS_RUN = """
import json, sys
sys.path.insert(0, "tests")
from veneur_tpu_torch import native
from veneur_tpu_torch.aggregation.host import BatchSpec
from veneur_tpu_torch.aggregation.state import TableSpec
from veneur_tpu_torch.server.flusher import generate_intermetrics
from veneur_tpu_torch.server.native_aggregator import NativeAggregator
import test_native as tn
import test_intake_fuzz as fz

corpus = (tn.GOOD_PACKETS + tn.BAD_PACKETS
          + fz.MALFORMED_METRIC_CORPUS + fz.MALFORMED_EVENT_CORPUS
          + fz.MALFORMED_CHECK_CORPUS)
spec = TableSpec(counter_capacity=64, gauge_capacity=64, status_capacity=16,
                 set_capacity=16, histo_capacity=64)
# four-row lanes: the corpus fills them again and again, so emits leave
# stale tails that the next emit must re-sentinel
agg = NativeAggregator(spec, BatchSpec(counter=4, gauge=4, status=4,
                                       set=4, histo=4), device="cpu")
specials = 0
for pkt in corpus:
    data = pkt if isinstance(pkt, bytes) else pkt.encode(
        "utf-8", "surrogateescape")
    specials += len(agg.feed(data + b"\\n"))
state, table = agg.swap()
res, table = agg.compute_flush(state, table, [0.5, 0.99])
ims = generate_intermetrics(res, table, percentiles=[0.5, 0.99],
                            aggregates=["count", "max"], is_local=False,
                            timestamp=0)
print(json.dumps({"library": native.load()._name.rsplit("/", 1)[-1],
                  "lines": len(corpus), "specials": specials,
                  "processed": agg.processed,
                  "parse_errors": agg.extra_parse_errors(),
                  "steps": agg.steps_total,
                  "ims": sorted([m.name, m.tags, m.value] for m in ims)}))
"""


def test_sanitized_intake_corpora():
    """(b) Every intake-corpus packet feeds through the sanitized engine
    (NativeAggregator on the CPU, four-row lanes, to a flush): no
    sanitizer report, and the counts and InterMetrics the plain engine
    gives on the same corpus."""
    env = _sanitizer_env()
    proc = _run(env, "-c", _CORPUS_RUN)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    _clean(proc)
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    plain = subprocess.run(
        [sys.executable, "-c", _CORPUS_RUN], cwd=REPO, capture_output=True,
        text=True, timeout=300,
        env={**os.environ, "VENEUR_NATIVE_SANITIZE": "0"})
    assert plain.returncode == 0, plain.stderr[-4000:]
    want = json.loads(plain.stdout.strip().splitlines()[-1])
    assert got["library"] == native.library(True)[1].name
    assert want["library"] == native.library(False)[1].name
    del got["library"], want["library"]
    assert got == want
    assert got["steps"] >= 4 and got["parse_errors"] > 0
    assert got["processed"] >= 13 and got["specials"] > 0


def test_sanitized_and_plain_libraries_differ_and_import_builds_nothing():
    """The sanitized build adds the reference's four flags under its own
    name; the plain build's name and flags are what they were; importing
    the binding (with the variable set) builds and loads nothing."""
    plain_flags, plain = native.library(False)
    san_flags, san = native.library(True)
    assert plain_flags == native.GXX_FLAGS == (
        "-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")
    assert san_flags == plain_flags + (
        "-g", "-fsanitize=address,undefined", "-fno-sanitize-recover=all",
        "-fno-omit-frame-pointer")
    assert plain.name.startswith("libdogstatsd_")
    assert not plain.name.startswith("libdogstatsd_san_")
    assert san.name.startswith("libdogstatsd_san_")
    assert plain.parent == san.parent == native.BUILD_DIR
    assert plain.name[len("libdogstatsd_"):] != san.name[
        len("libdogstatsd_san_"):]
    code = (
        "import subprocess, sys\n"
        "def no_build(*a, **k):\n"
        "    raise AssertionError(f'import ran {a}')\n"
        "subprocess.run = subprocess.Popen = no_build\n"
        "import veneur_tpu_torch.native as nat\n"
        "import veneur_tpu_torch.server.native_aggregator\n"
        "assert nat.sanitized()\n"
        "assert nat.library()[1].name.startswith('libdogstatsd_san_')\n"
        "assert nat.load.cache_info().currsize == 0\n"
        "assert not any(m.split('.')[0] in ('jax', 'veneur_tpu') "
        "for m in sys.modules)\n"
        "print('ok')\n")
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=120,
        env={**os.environ, "VENEUR_NATIVE_SANITIZE": "1"})
    assert res.returncode == 0 and res.stdout.strip() == "ok", \
        res.stdout + res.stderr


def test_a_failed_sanitized_build_raises_with_the_compilers_message(
        tmp_path, monkeypatch):
    if shutil.which("g++") is None:
        pytest.skip("g++ not on PATH — cannot run the compiler")
    bad = tmp_path / "dogstatsd.cpp"
    bad.write_text("int broken( {\n")
    monkeypatch.setattr(native, "_SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as err:
        native.build(sanitize=True)
    assert "dogstatsd.cpp" in str(err.value)
    assert "error" in str(err.value)
    assert not list((tmp_path / "_build").glob("*.so"))
    assert not list((tmp_path / "_build").glob("*.tmp"))
