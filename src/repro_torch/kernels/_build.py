"""Build and load the hand-written CUDA kernels (plain C interface + ctypes).

Each kernel is one ``csrc/<name>.cu`` file beside its ``ops.py``.  At first
use it is compiled by ``nvcc`` for ``sm_90a`` into ``kernels/build/`` (listed
in ``.gitignore``) and loaded with :mod:`ctypes`.  The library's file name
carries a digest of the source and the flags, so an edited source is rebuilt
and a stale library is never loaded.  Nothing here runs at import time.

Flags: ``-O3 -fmad=false`` and no ``--use_fast_math``: denormals are kept
(no flush-to-zero) and no multiply-add is contracted, so the extraction
``(r + A) - A`` and the scale ``q * 2^(m - e)`` round exactly as written.
``-Xptxas -v`` makes ``nvcc`` report each kernel's registers, spills and
shared memory; the report is kept beside the library (``.log``) and read by
:func:`ptxas_report`.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

__all__ = ["NVCC_FLAGS", "BUILD_DIR", "KERNEL_SOURCES", "nvcc_path",
           "source_path", "library_path", "build", "build_all", "load",
           "ptxas_report", "sm_count", "check_cuda", "current_stream"]

_KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = _KERNELS_DIR / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
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
    lib.with_suffix(".log").write_text(out)
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
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = _loaded[name] = ctypes.CDLL(str(build(name)))
        return lib


def check_cuda(what: str, tensors, dtype: torch.dtype) -> None:
    """Raise ``ValueError`` unless every tensor is a contiguous CUDA tensor
    of ``dtype`` (``what`` names them)."""
    for t in tensors:
        if not t.is_cuda or t.dtype != dtype:
            raise ValueError(f"{what} must be {dtype} CUDA tensors")
        if not t.is_contiguous():
            raise ValueError(f"{what} must be contiguous")


def current_stream(tensor: torch.Tensor) -> int:
    """The raw ``cudaStream_t`` of PyTorch's current stream on the tensor's
    device (the handle Triton's launcher passes too)."""
    return torch._C._cuda_getCurrentRawStream(tensor.get_device())


def ptxas_report(name: str) -> list[dict]:
    """Per kernel function of one built library, from ``nvcc -Xptxas -v``:
    ``function`` (demangled where ``cu++filt`` is at hand), ``registers``,
    ``spill_stores`` and ``spill_loads`` (bytes).  Empty when the library
    was built without its log."""
    log = library_path(name).with_suffix(".log")
    if not log.exists():
        return []
    rows, cur = [], None
    for line in log.read_text().splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = {"function": m.group(1)}
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and cur is not None:
            cur["spill_stores"] = int(m.group(1))
            cur["spill_loads"] = int(m.group(2))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
            rows.append(cur)
            cur = None
    filt = Path(nvcc_path()).with_name("cu++filt")
    if rows and filt.exists():
        names = subprocess.run([str(filt)] + [r["function"] for r in rows],
                               capture_output=True, text=True).stdout.split(
                                   "\n")
        for r, nm in zip(rows, names):
            r["function"] = nm.strip() or r["function"]
    return rows


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index`` (cached: the
    query costs microseconds on every launch otherwise)."""
    return torch.cuda.get_device_properties(index).multi_processor_count
