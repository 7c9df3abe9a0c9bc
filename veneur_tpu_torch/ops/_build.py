"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process, all
started together, into an object file; the objects are linked into one
shared library with a plain C interface, loaded with ctypes. The build
lands in ``veneur_tpu_torch/_build/`` (git-ignored) under a name keyed by
the sources' and flags' content, so a changed source rebuilds and an
unchanged one is reused. Nothing here runs at import time: the first
kernel launch builds and loads.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([Path(home) / "bin" / "nvcc"] if home else []) + [
            Path("/usr/local/cuda/bin/nvcc")]:
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put the CUDA "
                           "toolkit's bin directory on PATH")
    return found


def _sources():
    srcs = sorted(SRC_DIR.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {SRC_DIR}")
    return srcs


def _key(srcs) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs + sorted(SRC_DIR.glob("*.cuh")):
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


def build() -> tuple[Path, str]:
    """Compile (or reuse) the kernel library. Returns (path, log), the log
    holding ptxas's register / shared-memory / spill report per kernel."""
    srcs = _sources()
    key = _key(srcs)
    lib = BUILD_DIR / f"libveneur_kernels_{key}.so"
    log_path = lib.with_suffix(".log")
    if lib.exists() and log_path.exists():
        return lib, log_path.read_text()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{key}.{os.getpid()}"
    objs, procs = [], []
    for src in srcs:
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        objs.append(obj)
        procs.append((src, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for src, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    log = "".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n{log}")
    tmp = BUILD_DIR / f"libveneur_kernels.{tag}.so"
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp)] + [str(o) for o in objs],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for o in objs:
        o.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    log_tmp = BUILD_DIR / f"{tag}.log"
    log_tmp.write_text(log)
    os.replace(tmp, lib)
    os.replace(log_tmp, log_path)
    return lib, log


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build if needed, load once per process, declare every entry point."""
    path, _log = build()
    lib = ctypes.CDLL(str(path))
    vp, ll = ctypes.c_void_p, ctypes.c_longlong
    lib.vt_fused_ingest.argtypes = [ctypes.POINTER(vp),
                                    ctypes.POINTER(ll), vp]
    lib.vt_fused_ingest.restype = ctypes.c_int
    lib.vt_fused_ingest_smem.argtypes = [ll, ll, ctypes.c_int]
    lib.vt_fused_ingest_smem.restype = ll
    lib.vt_digest_quantiles.argtypes = [vp, vp, vp, vp, vp, vp, ll,
                                        ctypes.c_int, ctypes.c_int, vp, vp]
    lib.vt_digest_quantiles.restype = ctypes.c_int
    lib.vt_digest_quantiles_scratch.argtypes = [ll, ctypes.c_int]
    lib.vt_digest_quantiles_scratch.restype = ll
    lib.vt_merge_windows.argtypes = [vp, vp, vp, vp, ll, ll, ll, ll, ll,
                                     ctypes.c_int, vp]
    lib.vt_merge_windows.restype = ctypes.c_int
    return lib


def check(rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if rc != 0:
        raise RuntimeError(f"{what} failed: cudaError_t {rc}")
