"""Wrappers for the flat reproducible-sum kernel, and its plain version.

* :func:`rsum_table` — the planner-facing strategy: the fused multi-column
  table layout of :func:`repro_torch.core.aggregates.segment_table`
  specialized to ``num_segments == 1`` (SQL SUM without GROUP BY).  Returns
  a ``(1, ncols, L)`` accumulator table, bit-identical to every other
  strategy;
* :func:`rsum_acc` / :func:`rsum` — sum every element of a vector.

On a CUDA tensor the hand-written kernel (``csrc/rsum.cu``) runs, or the
call raises; on a CPU tensor :func:`rsum_levels_plain` computes the same
function in plain PyTorch.  ``LAUNCHES`` counts kernel launches.  The
launch is the operator ``repro_torch::rsum_levels``, with a fake
implementation for traces on fake tensors.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.core import accumulator as acc_mod
from repro_torch.core import eft
from repro_torch.core import prescan
from repro_torch.core.accumulator import ReproAcc
from repro_torch.core.types import ReproSpec
from repro_torch.device import resolve_device
from repro_torch.kernels import _build

__all__ = ["rsum", "rsum_acc", "rsum_table", "max_block_rows",
           "rsum_levels", "rsum_levels_kernel", "rsum_levels_plain",
           "ladder", "grid_blocks", "LAUNCHES"]

LAUNCHES = 0          # kernel launches in this process
THREADS = 256         # threads per block
VEC = 4               # floats per 16-byte vector load


def grid_blocks(total: int, ncols: int, sms: int, blocks_per_sm: int) -> int:
    """Blocks of one launch over ``total`` floats: at most one resident
    wave (``blocks_per_sm * sms``), and a multiple of ``step`` so that
    ``blocks * THREADS * VEC`` is a multiple of ``ncols`` (each vector slot
    of a thread then keeps one column).  Only when one ``step`` exceeds the
    wave does the grid take more."""
    step = ncols // math.gcd(ncols, THREADS * VEC)
    blocks = min(-(-total // (THREADS * VEC)), blocks_per_sm * sms)
    return max(step, blocks // step * step)


def max_block_rows(spec: ReproSpec, ncols: int = 1,
                   levels: tuple[int, int] | None = None) -> int:
    """Rows whose int32 window offsets could be summed between renorms
    (``rows * 2^(W-1) <= 2^30``) — the planner's ``chunk`` for ``rsum``.

    The CUDA kernel accumulates in int64 registers and needs no renorm
    cadence, so this bound changes how nothing runs; like every chunk it
    changes no bits.
    """
    del ncols, levels
    return 1 << (30 - (spec.W - 1))


def ladder(e1: torch.Tensor, spec: ReproSpec, levels):
    """Per-column extractor sub-ladder over the live window:
    ``A``, ``inv_ulp`` float (nlev, ncols)."""
    lo, hi = levels
    lvl = torch.arange(lo, hi, dtype=torch.int32, device=e1.device)
    es = e1[None, :] - lvl[:, None] * spec.W                  # (nlev, ncols)
    return (eft.extractor(es, spec.dtype).contiguous(),
            eft.pow2(spec.m - es, spec.dtype).contiguous())


def _canonical(total: torch.Tensor, spec: ReproSpec):
    """Split exact int64 level sums T into the canonical int32
    ``k = T mod 2^(m-2)``, ``C = T >> (m-2)``."""
    shift = spec.m - 2
    C = total >> shift
    k = total - (C << shift)
    return k.to(spec.int_dtype), C.to(spec.int_dtype)


def _check_range(n: int, spec: ReproSpec) -> None:
    # C = T >> (m-2) must fit int32: n * 2^(W-1) < 2^31 * 2^(m-2)
    if n * (1 << (spec.W - 1)) >= (1 << 31) * (1 << (spec.m - 2)):
        raise ValueError(f"{n} rows overflow the int32 carry counter of "
                         f"{spec}")


def rsum_levels_plain(x: torch.Tensor, A: torch.Tensor,
                      inv_ulp: torch.Tensor, spec: ReproSpec):
    """Plain PyTorch version of the kernel: ``x`` float (n, ncols) ->
    canonical ``(k, C)`` int (nlev, ncols)."""
    r = x
    sums = []
    for l in range(A.shape[0]):
        q = (r + A[l]) - A[l]
        r = r - q
        sums.append((q * inv_ulp[l]).to(torch.int64).sum(dim=0))
    return _canonical(torch.stack(sums), spec)


def _launcher():
    lib = _build.load("rsum")
    fn = lib.rsum_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 6 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.rsum_blocks_per_sm.restype = ctypes.c_int
        lib.rsum_blocks_per_sm.argtypes = [ctypes.c_int] * 3
        lib.rsum_error_string.restype = ctypes.c_char_p
        lib.rsum_error_string.argtypes = [ctypes.c_int]
    return lib


@functools.lru_cache(maxsize=256)
def _grid(index: int, total: int, nlev: int, ncols: int) -> int:
    """:func:`grid_blocks` with this card's SMs and the kernel's measured
    resident blocks per SM."""
    with torch.cuda.device(index):
        per_sm = _launcher().rsum_blocks_per_sm(nlev, ncols, THREADS)
    if per_sm < 1:
        raise RuntimeError(f"rsum kernel cannot run {nlev} levels x "
                           f"{ncols} columns on device {index}")
    return grid_blocks(total, ncols, _build.sm_count(index), per_sm)


_WORKSPACES: dict[tuple[int, int], torch.Tensor] = {}


def _workspace(x: torch.Tensor, stream: int, n: int) -> torch.Tensor:
    """int64 scratch of ``1 + n`` entries or more, one per (device, stream),
    zero between launches: the kernel's ticket counter, then its (nlev,
    ncols) sums, which the last block zeroes again.  Launches on one stream
    run in order, so they share it; the kernel allocates nothing."""
    key = (x.get_device(), stream)
    ws = _WORKSPACES.get(key)
    if ws is None or ws.numel() < n + 1:
        ws = _WORKSPACES[key] = torch.zeros(n + 1, dtype=torch.int64,
                                            device=x.device)
    return ws


@torch.library.custom_op("repro_torch::rsum_levels", mutates_args=(),
                         device_types="cuda")
def _rsum_launch(x: torch.Tensor, A: torch.Tensor, inv_ulp: torch.Tensor,
                 m: int) -> torch.Tensor:
    """One launch: the int32 (2, nlev, ncols) buffer, ``k`` then ``C``.
    Registered as an operator so that a trace on fake tensors
    (:mod:`repro_torch.launch.dryrun`) sees one op with its fake
    implementation below; everything that needs the card (its SMs, the
    stream, the workspace, the pointers) happens here."""
    global LAUNCHES
    n, ncols = x.shape
    nlev = A.shape[0]
    total = n * ncols
    blocks = _grid(x.get_device(), total, nlev, ncols)
    stream = _build.current_stream(x)
    ws = _workspace(x, stream, nlev * ncols)
    out = x.new_empty((2, nlev, ncols), dtype=torch.int32)
    lib = _launcher()
    k_ptr = out.data_ptr()
    err = lib.rsum_launch(x.data_ptr(), A.data_ptr(), inv_ulp.data_ptr(),
                          ws.data_ptr(), k_ptr, k_ptr + 4 * nlev * ncols,
                          total, ncols, nlev, m, blocks, THREADS, stream)
    if err:
        raise RuntimeError("rsum kernel launch failed: "
                           + lib.rsum_error_string(err).decode())
    LAUNCHES += 1
    return out


@_rsum_launch.register_fake
def _rsum_launch_fake(x, A, inv_ulp, m):
    return x.new_empty((2, A.shape[0], x.shape[1]), dtype=torch.int32)


def rsum_levels_kernel(x: torch.Tensor, A: torch.Tensor,
                       inv_ulp: torch.Tensor, spec: ReproSpec):
    """The CUDA kernel: same contract as :func:`rsum_levels_plain`.  The
    kernel reduces across blocks and splits the sums canonically itself, in
    one launch (the operator ``repro_torch::rsum_levels``); ``k`` and ``C``
    are the two halves of one int32 buffer."""
    if spec.m > 30:
        raise ValueError("the rsum kernel supports float32 accumulators")
    _build.check_cuda("x, A and inv_ulp", (x, A, inv_ulp), torch.float32)
    if x.ndim != 2 or A.ndim != 2 or A.shape != inv_ulp.shape \
            or A.shape[1] != x.shape[1]:
        raise ValueError("rsum kernel expects x (n, ncols) and A, inv_ulp "
                         "(nlev, ncols)")
    nlev, ncols = A.shape
    if not 1 <= nlev <= 8 or ncols < 1:
        raise ValueError(f"unsupported level/column count {nlev}/{ncols}")
    return torch.ops.repro_torch.rsum_levels(x, A, inv_ulp, spec.m).unbind(0)


def rsum_levels(x: torch.Tensor, A: torch.Tensor, inv_ulp: torch.Tensor,
                spec: ReproSpec):
    """Dispatch on the tensor's device: the kernel on CUDA, the plain
    version on the CPU."""
    _check_range(x.shape[0], spec)
    if x.device.type == "cuda":
        return rsum_levels_kernel(x, A, inv_ulp, spec)
    return rsum_levels_plain(x, A, inv_ulp, spec)


def rsum_table(values, segment_ids=None, num_segments: int = 1,
               spec: ReproSpec = ReproSpec(), e1=None,
               block_rows: int | None = None,
               levels: tuple[int, int] | None = None,
               device=None) -> ReproAcc:
    """Fused flat reduction: ``(n, ncols) -> ReproAcc (1, ncols, L)``.

    Valid only for ``num_segments == 1``.  ``segment_ids`` is accepted (and
    ignored) for dispatch-signature compatibility; ``block_rows`` changes no
    bits and nothing in how the kernel runs.  ``levels`` is a prescan-proved
    live window; the returned table is full-L with exact zeros on pruned
    levels.
    """
    del segment_ids, block_rows
    if spec.m > 30:
        raise ValueError("the rsum kernel supports float32 accumulators")
    if num_segments != 1:
        raise ValueError("rsum is the flat-aggregation strategy: "
                         "num_segments must be 1")
    dev = resolve_device(device)
    values = torch.as_tensor(values).to(device=dev, dtype=spec.dtype)
    if values.ndim == 1:
        values = values[:, None]
    values = values.contiguous()
    ncols = values.shape[1]
    lo, hi = prescan.check_levels(levels, spec)
    if e1 is None:
        e1 = acc_mod.required_e1(values, spec, axis=0)        # (ncols,)
    e1 = torch.as_tensor(e1, dtype=torch.int32, device=dev).expand(ncols)
    A, inv_ulp = ladder(e1, spec, (lo, hi))
    k, C = rsum_levels(values, A, inv_ulp, spec)               # (nlev, ncols)
    k = acc_mod.pad_levels(k.T[None], levels, spec).contiguous()
    C = acc_mod.pad_levels(C.T[None], levels, spec).contiguous()
    return ReproAcc(k=k, C=C, e1=e1[None, :].contiguous())


def rsum_acc(x, spec: ReproSpec = ReproSpec(), block_rows: int = 1024,
             device=None) -> ReproAcc:
    """Reproducible sum of all elements of ``x`` -> canonical accumulator."""
    dev = resolve_device(device)
    x = torch.as_tensor(x).to(device=dev, dtype=spec.dtype).reshape(-1)
    acc = rsum_table(x[:, None], num_segments=1, spec=spec,
                     block_rows=block_rows, device=dev)
    return ReproAcc(k=acc.k[0, 0], C=acc.C[0, 0], e1=acc.e1[0, 0])


def rsum(x, spec: ReproSpec = ReproSpec(), block_rows: int = 1024,
         device=None) -> torch.Tensor:
    """Finalized reproducible sum (float scalar)."""
    return acc_mod.finalize(rsum_acc(x, spec, block_rows, device), spec)
