"""Build and load the hand-written CUDA kernels (plain C interface + ctypes).

Each kernel is one ``csrc/<name>.cu`` file beside its ``ops.py``.  At first
use it is compiled by ``nvcc`` for ``sm_90a`` into ``kernels/build/`` (listed
in ``.gitignore``) and loaded with :mod:`ctypes`.  The library's file name
carries a digest of the source and the flags, so an edited source is rebuilt
and a stale library is never loaded.  Nothing here runs at import time.

Flags: ``-O3 -fmad=false`` and no ``--use_fast_math``: denormals are kept
(no flush-to-zero) and no multiply-add is contracted, so the extraction
``(r + A) - A`` and the scale ``q * 2^(m - e)`` round exactly as written.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["NVCC_FLAGS", "BUILD_DIR", "KERNEL_SOURCES", "nvcc_path",
           "source_path", "library_path", "build", "build_all", "load"]

_KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = _KERNELS_DIR / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")
# kernel name -> source, relative to this directory
KERNEL_SOURCES = {
    "segment_rsum": "segment_rsum/csrc/segment_rsum.cu",
    "rsum": "rsum/csrc/rsum.cu",
}

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``nvcc`` from ``PATH``, else from ``$CUDA_HOME/bin``."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "source at first use and need the CUDA toolkit")


def source_path(name: str) -> Path:
    return _KERNELS_DIR / KERNEL_SOURCES[name]


def library_path(name: str) -> Path:
    src = source_path(name).read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def _start(name: str):
    """Start ``nvcc`` for one kernel; returns (popen | None, lib, tmp)."""
    lib = library_path(name)
    if lib.exists():
        return None, lib, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(source_path(name))]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, lib, tmp


def _finish(name: str, proc, lib: Path, tmp: Path | None) -> None:
    if proc is None:
        return
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for kernel {name!r} "
                           f"(exit {proc.returncode}):\n{out}")
    os.replace(tmp, lib)        # atomic: a concurrent process never loads half


def build_all(names=None) -> float:
    """Compile every missing kernel library, one ``nvcc`` per source, all
    started together.  Returns the wall time in seconds."""
    names = list(KERNEL_SOURCES) if names is None else list(names)
    t0 = time.perf_counter()
    started = [(n, *_start(n)) for n in names]
    for n, proc, lib, tmp in started:
        _finish(n, proc, lib, tmp)
    return time.perf_counter() - t0


def build(name: str) -> Path:
    """Compile one kernel library if missing; returns its path."""
    proc, lib, tmp = _start(name)
    _finish(name, proc, lib, tmp)
    return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built at first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = _loaded[name] = ctypes.CDLL(str(build(name)))
        return lib
