"""Wrappers for the segment RSUM / fused GROUPBY kernel, and its plain version.

``segment_agg_kernel`` is the fused multi-column entry point: a stacked
(n, ncols) value matrix aggregates into an accumulator table (G, ncols, L)
in one streaming pass.  ``segment_rsum_kernel`` is the single-column API.

On a CUDA tensor the hand-written kernel (``csrc/segment_rsum.cu``) runs,
or the call raises; on a CPU tensor :func:`segment_levels_plain` computes
the same function in plain PyTorch.  ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import accumulator as acc_mod
from repro_torch.core import prescan
from repro_torch.core.accumulator import ReproAcc
from repro_torch.core.types import ReproSpec
from repro_torch.device import resolve_device
from repro_torch.kernels import _build
from repro_torch.kernels.rsum.ops import _canonical, ladder

__all__ = ["segment_agg_kernel", "segment_rsum_kernel", "segment_levels",
           "segment_levels_kernel", "segment_levels_plain", "group_tile",
           "launch_shape", "LAUNCHES"]

LAUNCHES = 0                   # kernel launches in this process
THREADS = 512                  # threads per block
SMEM_BYTES = 232_448           # dynamic shared memory one block may use
REPLICA_BYTES = 48 * 1024      # shared memory spent on per-warp table copies
BLOCKS_PER_SM = 4              # target blocks in flight per SM
MIN_SLAB_ROWS = 4 * THREADS    # fewest rows worth a slab of their own
PARTIAL_BYTES = 1 << 28        # cap on the per-slab partial tables


def group_tile(num_segments: int, ncols: int, nlev: int) -> int:
    """Groups per block: as many int32 (k, C) table entries as fit the
    block's shared memory beside the extractor ladder."""
    per_group = 2 * 4 * nlev * ncols
    cap = (SMEM_BYTES - 2 * 4 * nlev * ncols) // per_group
    if cap < 1:
        raise ValueError(f"{ncols} columns x {nlev} levels do not fit one "
                         "block's shared memory")
    return max(1, min(num_segments, cap))


def launch_shape(n: int, num_segments: int, ncols: int, nlev: int,
                 sms: int, tile: int | None = None):
    """(tile, replicas, slabs, rows_per_slab) of one launch.

    Slabs fill the card with blocks, but no more of them than the rows
    justify or than ``PARTIAL_BYTES`` of per-slab partials allow at large G.
    """
    cap = group_tile(num_segments, ncols, nlev)
    tile = cap if tile is None else max(1, min(int(tile), cap))
    n_tiles = -(-num_segments // tile)
    ent_bytes = 2 * 4 * nlev * ncols * tile
    replicas = max(1, min(THREADS // 32, REPLICA_BYTES // ent_bytes))
    slab_bytes = 2 * 4 * nlev * ncols * num_segments
    slabs = -(-BLOCKS_PER_SM * sms // n_tiles)
    slabs = min(slabs, -(-n // MIN_SLAB_ROWS), PARTIAL_BYTES // slab_bytes,
                65_535)
    slabs = max(1, slabs)
    rows_per_slab = max(1, -(-n // slabs))
    return tile, replicas, slabs, rows_per_slab


def segment_levels_plain(x: torch.Tensor, ids: torch.Tensor,
                         num_segments: int, A: torch.Tensor,
                         inv_ulp: torch.Tensor, spec: ReproSpec):
    """Plain PyTorch version of the kernel: ``x`` float (n, ncols), ``ids``
    int32 (n,) in [0, G) or -1 (padding) -> canonical ``(k, C)`` int
    (G, ncols, nlev)."""
    r = x
    ks = []
    for l in range(A.shape[0]):
        q = (r + A[l]) - A[l]
        r = r - q
        ks.append((q * inv_ulp[l]).to(torch.int64))
    k = torch.stack(ks, dim=-1)                        # (n, ncols, nlev)
    dump = torch.where(ids >= 0, ids, num_segments).to(torch.int64)
    tab = torch.zeros((num_segments + 1, *k.shape[1:]), dtype=torch.int64,
                      device=x.device)
    tab.index_add_(0, dump, k)
    return _canonical(tab[:num_segments], spec)


def _launcher():
    lib = _build.load("segment_rsum")
    fn = lib.segment_rsum_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 6 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.segment_rsum_error_string.restype = ctypes.c_char_p
        lib.segment_rsum_error_string.argtypes = [ctypes.c_int]
    return lib


def segment_levels_kernel(x: torch.Tensor, ids: torch.Tensor,
                          num_segments: int, A: torch.Tensor,
                          inv_ulp: torch.Tensor, spec: ReproSpec,
                          tile: int | None = None):
    """The CUDA kernel: same contract as :func:`segment_levels_plain`."""
    global LAUNCHES
    if spec.m > 30:
        raise ValueError("the segment kernel supports float32 accumulators")
    for name, t, dt in (("x", x, torch.float32), ("ids", ids, torch.int32),
                        ("A", A, torch.float32),
                        ("inv_ulp", inv_ulp, torch.float32)):
        if t.device.type != "cuda" or t.dtype != dt:
            raise ValueError(f"{name} must be a {dt} CUDA tensor")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.ndim != 2 or ids.shape != (x.shape[0],) or A.ndim != 2 \
            or A.shape != inv_ulp.shape or A.shape[1] != x.shape[1]:
        raise ValueError("segment kernel expects x (n, ncols), ids (n,) and "
                         "A, inv_ulp (nlev, ncols)")
    n, ncols = x.shape
    nlev = A.shape[0]
    if num_segments < 1 or ncols < 1:
        raise ValueError("segment kernel needs G >= 1 and ncols >= 1")
    renorm_rows = 1 << (30 - (spec.W - 1))
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    tile, replicas, slabs, rows_per_slab = launch_shape(
        n, num_segments, ncols, nlev, sms, tile)
    part_k = torch.empty((slabs, nlev, ncols, num_segments),
                         dtype=torch.int32, device=x.device)
    part_c = torch.empty_like(part_k)
    lib = _launcher()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.segment_rsum_launch(
        ids.data_ptr(), x.data_ptr(), A.data_ptr(), inv_ulp.data_ptr(),
        part_k.data_ptr(), part_c.data_ptr(), n, ncols, nlev, spec.m,
        num_segments, tile, replicas, slabs, rows_per_slab, renorm_rows,
        THREADS, stream)
    if err:
        raise RuntimeError("segment kernel launch failed: "
                           + lib.segment_rsum_error_string(err).decode())
    LAUNCHES += 1
    # exact reduction over slabs; each slab's k is canonical (< 2^(m-2))
    k, C = _canonical(part_k.sum(dim=0, dtype=torch.int64), spec)
    C = C + part_c.sum(dim=0, dtype=torch.int64).to(C.dtype)
    return (k.permute(2, 1, 0).contiguous(),
            C.permute(2, 1, 0).contiguous())       # (G, ncols, nlev)


def segment_levels(x: torch.Tensor, ids: torch.Tensor, num_segments: int,
                   A: torch.Tensor, inv_ulp: torch.Tensor, spec: ReproSpec,
                   tile: int | None = None):
    """Dispatch on the tensor's device: the kernel on CUDA, the plain
    version on the CPU."""
    if x.device.type == "cuda":
        return segment_levels_kernel(x, ids, num_segments, A, inv_ulp, spec,
                                     tile)
    return segment_levels_plain(x, ids, num_segments, A, inv_ulp, spec)


def segment_agg_kernel(values, segment_ids, num_segments: int,
                       spec: ReproSpec = ReproSpec(), e1=None,
                       block_n: int | None = None,
                       group_tile: int | None = None,
                       levels: tuple[int, int] | None = None,
                       device=None) -> ReproAcc:
    """Fused reproducible GROUPBY: (n, ncols) -> table (G, ncols, L).

    Bit-identical to :func:`repro_torch.core.aggregates.segment_table` (any
    method) given the same per-column ``e1`` (defaults to the per-column row
    max).  ``levels = (lo, hi)`` hands the kernel a pruned extractor
    sub-ladder; the dead levels come back as exact zeros.  ``block_n``
    changes no bits and nothing in how the kernel runs; ``group_tile``
    caps the groups per block (it too changes no bits).
    """
    del block_n
    if spec.m > 30:
        raise ValueError("the segment kernel supports float32 accumulators")
    dev = resolve_device(device)
    values = torch.as_tensor(values).to(device=dev, dtype=spec.dtype)
    if values.ndim != 2:
        raise ValueError("segment_agg_kernel expects values (n, ncols)")
    values = values.contiguous()
    ids = torch.as_tensor(segment_ids).to(device=dev, dtype=torch.int32) \
        .reshape(-1).contiguous()
    ncols = values.shape[1]
    lo, hi = prescan.check_levels(levels, spec)
    if e1 is None:
        e1 = acc_mod.required_e1(values, spec, axis=0)        # (ncols,)
    e1 = torch.as_tensor(e1, dtype=torch.int32, device=dev).expand(ncols)
    A, inv_ulp = ladder(e1, spec, (lo, hi))
    k, C = segment_levels(values, ids, num_segments, A, inv_ulp, spec,
                          group_tile)
    k = acc_mod.pad_levels(k, levels, spec)
    C = acc_mod.pad_levels(C, levels, spec)
    e1_b = e1.expand(num_segments, ncols).contiguous()
    return ReproAcc(k=k, C=C, e1=e1_b)


def segment_rsum_kernel(values, segment_ids, num_segments: int,
                        spec: ReproSpec = ReproSpec(),
                        block_n: int | None = None,
                        group_tile: int | None = None,
                        device=None) -> ReproAcc:
    """Reproducible GROUPBY-SUM of one column, on one global lattice
    exponent (the single-column API's contract)."""
    dev = resolve_device(device)
    values = torch.as_tensor(values).to(device=dev, dtype=spec.dtype) \
        .reshape(-1)
    e1 = acc_mod.required_e1(values, spec)
    acc = segment_agg_kernel(values[:, None], segment_ids, num_segments,
                             spec, e1=e1[None], block_n=block_n,
                             group_tile=group_tile, device=dev)
    return ReproAcc(k=acc.k[:, 0, :], C=acc.C[:, 0, :], e1=acc.e1[:, 0])
