"""Wrappers for the segment RSUM / fused GROUPBY kernel, and its plain version.

``segment_agg_kernel`` is the fused multi-column entry point: a stacked
(n, ncols) value matrix aggregates into an accumulator table (G, ncols, L)
in one streaming pass.  ``segment_rsum_kernel`` is the single-column API.

On a CUDA tensor the hand-written kernel (``csrc/segment_rsum.cu``) runs,
or the call raises; on a CPU tensor :func:`segment_levels_plain` computes
the same function in plain PyTorch.  ``LAUNCHES`` counts kernel launches:
two a call on the private path and in one group tile (the path's kernel and
the slab reduction), four over several group tiles (the partition's count,
scan and scatter, then the aggregate; :func:`launch_count`).  The call is
the operator ``repro_torch::segment_levels``, with a fake implementation
for traces on fake tensors.  :func:`partition_plain` is the plain version
of the partition by group tile, held against the kernels' counts and
offsets on the card.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

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
           "launch_shape", "group_limits", "flush_rows", "LaunchShape",
           "launch_count", "takes_rows", "partition_plain", "partition_kernel",
           "aggregate_kernel", "head_tables", "Partition", "Bucketed",
           "LAUNCHES"]

LAUNCHES = 0                   # kernel launches in this process
PRIVATE_THREADS = 256          # threads per block, private path (kernel's)
THREADS = 512                  # threads per block, tiled path
PART_THREADS = 512             # threads per block of the partition
SMEM_BYTES = 232_448           # dynamic shared memory one block may use
PRIVATE_BYTES = 96 * 1024      # private path: slices + int64 block table
PRIVATE_MAX_COLS = 8           # private path's template range (columns)
PRIVATE_MAX_LEVELS = 4         # ... and levels
REPLICA_BYTES = 48 * 1024      # tiled path: shared memory for table copies
BLOCKS_PER_SM = 4              # resident blocks per SM when not measured
MIN_SLAB_ROWS = 2048           # fewest rows worth a slab of their own
PARTIAL_BYTES = 1 << 28        # cap on the per-slab int64 partial tables
PATHS = ("private", "tiled")
PARTITIONED = 2                # kernel code of the aggregate (several tiles)
PARTITION_LAUNCHES = 3         # count, scan, scatter
PARTITION_PASSES = 3           # passes over the rows past one group tile
                               # (count, scatter, aggregate)
PART_MIN_BYTES = 32 * 1024     # fewest bytes of rows of a partition block
PART_BLOCKS_PER_SM = 4         # partition blocks per SM at most
MIN_CHUNK_ROWS = 4096          # fewest rows of a work item (but the last)
STAGE_BYTES = 64 * 1024        # the scatter's staged rows per batch, bytes
PARTITION_MAX_ROWS = 1 << 31   # rows a launch over several tiles takes, less
                               # one (the partition's slots are 32-bit)


class LaunchShape(NamedTuple):
    path: str           # "private" or "tiled"
    tile: int           # groups per block (G unless tiled)
    replicas: int       # copies of the table per block
    slabs: int          # row slabs (blocks per group tile); 1 over several
                        # tiles, where no block reads rows of other tiles
    rows_per_slab: int  # a multiple of 4
    threads: int        # threads per block
    smem: int           # dynamic shared memory per block, bytes
    # over several group tiles (the partition); defaults elsewhere
    tiles: int = 1          # group tiles
    chunk_rows: int = 0     # most rows of one work item
    work_items: int = 0     # most work items: tiles + n // chunk_rows
    blocks: int = 0         # the aggregate's persistent grid
    part_blocks: int = 0    # row blocks of the partition's count and scatter
    part_rows: int = 0      # rows of one such block
    part_smem: int = 0      # their shared histogram, bytes (0: global)
    partials: int = 0       # most int64 partial tables (hot tiles' items)
    scratch_bytes: int = 0  # the partition's scratch, bytes
    stage_rows: int = 0     # rows the scatter stages at a time (0: none)


def group_tile(num_segments: int, ncols: int, nlev: int) -> int:
    """Groups per block on the tiled path: as many int32 (k, C) table
    entries as fit the block's shared memory beside the extractor ladder."""
    per_group = 2 * 4 * nlev * ncols
    cap = (SMEM_BYTES - 2 * 4 * nlev * ncols) // per_group
    if cap < 1:
        raise ValueError(f"{ncols} columns x {nlev} levels do not fit one "
                         "block's shared memory")
    return max(1, min(num_segments, cap))


def flush_rows(spec: ReproSpec) -> int:
    """Rows after which an int32 table entry is flushed (private path) or
    renormalized (tiled path): ``rows * 2^(W-1) <= 2^30``."""
    return 1 << (30 - (spec.W - 1))


def private_bytes(num_segments: int, ncols: int, nlev: int) -> int:
    """Private path's shared memory: an int32 slice per thread plus the
    block's int64 flush table."""
    ent = num_segments * ncols * nlev
    return ent * (4 * PRIVATE_THREADS + 8)


def stage_bytes(ncols: int) -> int:
    """Private path's chunk buffers: two per warp of 128 rows and ids."""
    return 2 * (PRIVATE_THREADS // 32) * (32 * ncols + 32) * 16


def group_limits(ncols: int, nlev: int) -> tuple[int, int]:
    """Largest G the private path takes (0: none), and largest G the tiled
    path takes in one group tile (0: none)."""
    fits_private = ncols <= PRIVATE_MAX_COLS and nlev <= PRIVATE_MAX_LEVELS
    private = PRIVATE_BYTES // private_bytes(1, ncols, nlev) \
        if fits_private else 0
    one_tile = max(0, (SMEM_BYTES - 8 * nlev * ncols) // (8 * ncols * nlev))
    return private, one_tile


def head_words(tiles: int) -> int:
    """int64 words of the partition's head (``Head`` in the ``.cu``): the
    order flag, then counts, offsets, cursors, work offsets, partial
    offsets and finished items per tile."""
    return 3 + 6 * tiles


def scratch_layout(n: int, ncols: int, nlev: int, tile: int, tiles: int,
                   work_items: int, partials: int) -> tuple[int, ...]:
    """Byte offsets of the partition's scratch: the head, each work item's
    tile (int32), the bucketed ids (n int32), the bucketed values (n x
    ncols float32), the int64 partials (``partials`` tables of ``tile *
    ncols * nlev``), and the total; each part 16-byte aligned."""
    def up(b):
        return -(-b // 16) * 16
    items = up(8 * head_words(tiles))
    ids = items + up(4 * work_items)
    vals = ids + up(4 * n)
    part = vals + up(4 * n * ncols)
    return 0, items, ids, vals, part, part + 8 * partials * tile * ncols \
        * nlev


def launch_shape(n: int, num_segments: int, ncols: int, nlev: int,
                 sms: int, tile: int | None = None,
                 blocks_per_sm: int = BLOCKS_PER_SM) -> LaunchShape:
    """The path and sizes of one launch.

    Without a ``tile`` cap, a table that fits ``PRIVATE_BYTES`` as
    per-thread slices takes the private path, and any other the tiled
    path, in as few group tiles as fit a block's shared memory (with one
    copy per warp as far as ``REPLICA_BYTES`` allows); a ``tile`` forces
    the tiled path.  In one group tile, slabs fill ``blocks_per_sm * sms``
    resident blocks once, but no more of them than the rows justify or than
    ``PARTIAL_BYTES`` of int64 partials allow.  Over several tiles the rows
    are partitioned by tile first: one slab, ``blocks_per_sm * sms``
    persistent blocks over work items of at most ``chunk_rows`` rows of one
    tile's bucket (a bucket of more rows is split, and its items' int64
    partials, at most ``2 n // (chunk_rows + 1)`` tables, are added by the
    last of them).
    """
    G = num_segments
    private_max, _ = group_limits(ncols, nlev)
    if tile is None and G <= private_max:
        path, tile, threads = "private", G, PRIVATE_THREADS
        replicas = PRIVATE_THREADS
        smem = -(-private_bytes(G, ncols, nlev) // 16) * 16 \
            + stage_bytes(ncols)
    else:
        cap = group_tile(G, ncols, nlev)
        tile = cap if tile is None else max(1, min(int(tile), cap))
        ent_bytes = 2 * 4 * nlev * ncols * tile
        path, threads = "tiled", THREADS
        replicas = max(1, min(THREADS // 32, REPLICA_BYTES // ent_bytes))
        smem = replicas * ent_bytes + 2 * 4 * nlev * ncols
    n_tiles = -(-G // tile)
    resident = max(1, blocks_per_sm) * sms
    if n_tiles > 1:
        if n >= PARTITION_MAX_ROWS:
            raise ValueError("the segment kernel partitions fewer than 2^31 "
                             "rows over several group tiles")
        chunk = max(MIN_CHUNK_ROWS, -(-n // resident))
        part_rows = max(-(-PART_MIN_BYTES // (4 * (ncols + 1))),
                        -(-n // (PART_BLOCKS_PER_SM * sms)))
        partials = 2 * n // (chunk + 1)
        items = n_tiles + n // chunk
        hist = 4 * n_tiles if 4 * n_tiles <= SMEM_BYTES else 0
        return LaunchShape(
            path, tile, replicas, 1, max(4, -(-n // 4) * 4), threads, smem,
            tiles=n_tiles, chunk_rows=chunk, work_items=items,
            blocks=resident, part_blocks=max(1, -(-n // part_rows)),
            part_rows=part_rows, part_smem=hist, partials=partials,
            scratch_bytes=scratch_layout(n, ncols, nlev, tile, n_tiles,
                                         items, partials)[-1],
            stage_rows=stage_rows(n_tiles, ncols) if hist else 0)
    slabs = min(resident, -(-n // MIN_SLAB_ROWS),
                PARTIAL_BYTES // (8 * G * ncols * nlev), 65_535)
    rows_per_slab = -(-max(1, -(-n // max(1, slabs))) // 4) * 4
    slabs = max(1, -(-n // rows_per_slab))
    return LaunchShape(path, tile, replicas, slabs, rows_per_slab, threads,
                       smem)


def stage_rows(tiles: int, ncols: int) -> int:
    """Rows the partition's scatter stages at a time in shared memory, in
    tile order, before it writes each tile's run of them: a multiple of the
    block's threads within ``STAGE_BYTES``, for rows of fewer than 32
    columns and at least as many rows as tiles (else 0: each row goes
    straight to its slot).  Its shared memory, 12 bytes a tile and the
    staged rows, stays 1 KiB under a block's for the kernel's own."""
    rows = STAGE_BYTES // (4 * (ncols + 1)) // PART_THREADS * PART_THREADS
    if ncols >= 32 or rows < max(PART_THREADS, tiles) \
            or 12 * tiles + 4 * rows * (ncols + 1) > SMEM_BYTES - 1024:
        return 0
    return rows


def takes_rows(n: int, num_segments: int, ncols: int, nlev: int) -> bool:
    """Whether one launch takes ``n`` rows: any number in one group tile
    (or on the private path), fewer than ``PARTITION_MAX_ROWS`` over
    several tiles."""
    return n < PARTITION_MAX_ROWS \
        or launch_shape(1, num_segments, ncols, nlev, 1).tiles == 1


def launch_count(num_segments: int, ncols: int, nlev: int,
                 tile: int | None = None) -> int:
    """Kernel launches of one call: 2 (the path's kernel and the slab
    reduction), or 4 over several group tiles (the partition's count, scan
    and scatter, then the aggregate)."""
    shape = launch_shape(1, num_segments, ncols, nlev, 1, tile)
    return PARTITION_LAUNCHES + 1 if shape.tiles > 1 else 2


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


class Partition(NamedTuple):
    """The partition of rows by group tile: per tile its kept rows, its
    bucket's start, its first work item and its first partial slot (tiles
    of one item take none), and the rows in bucket order (plain version
    only)."""
    counts: torch.Tensor        # (tiles,) int64
    offsets: torch.Tensor       # (tiles + 1,) int64; [-1] = kept rows
    work_offsets: torch.Tensor  # (tiles + 1,) int64; [-1] = work items
    hot_offsets: torch.Tensor   # (tiles,) int64
    order: torch.Tensor | None  # (kept,) int64 row indices, bucket order


def partition_plain(ids: torch.Tensor, num_segments: int, tile: int,
                    chunk_rows: int) -> Partition:
    """Plain PyTorch version of the partition kernels (``partition_count``,
    ``partition_scan`` and the row order of ``partition_scatter``): rows
    with an id in [0, G) go to the bucket of tile ``id // tile``, in input
    order within a bucket (the kernel's order inside a bucket is free);
    each tile has ``max(1, ceil(count / chunk_rows))`` work items."""
    ids = ids.reshape(-1).to(torch.int64)
    tiles = -(-num_segments // tile)
    kept = torch.nonzero((ids >= 0) & (ids < num_segments)).reshape(-1)
    tile_of = ids[kept] // tile
    counts = torch.bincount(tile_of, minlength=tiles)
    zero = counts.new_zeros(1)
    items = torch.where(counts > chunk_rows, -(-counts // chunk_rows), 1)
    hot = torch.where(items > 1, items, 0)
    return Partition(
        counts=counts, offsets=torch.cat([zero, counts.cumsum(0)]),
        work_offsets=torch.cat([zero, items.cumsum(0)]),
        hot_offsets=hot.cumsum(0) - hot,
        order=kept[torch.sort(tile_of, stable=True).indices])


def _launcher():
    lib = _build.load("segment_rsum")
    fn = lib.segment_rsum_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 7 + [
            ctypes.c_longlong] + [ctypes.c_int] * 8 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_longlong, ctypes.c_void_p]
        part = lib.segment_partition_launch
        part.restype = ctypes.c_int
        part.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_longlong] + [
            ctypes.c_int] * 5 + [ctypes.c_longlong] * 2 + [
            ctypes.c_int] * 2 + [ctypes.c_void_p] * 5
        agg = lib.segment_aggregate_launch
        agg.restype = ctypes.c_int
        agg.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        occ = lib.segment_rsum_blocks_per_sm
        occ.restype = ctypes.c_int
        occ.argtypes = [ctypes.c_int] * 4 + [ctypes.c_longlong]
        lib.segment_rsum_error_string.restype = ctypes.c_char_p
        lib.segment_rsum_error_string.argtypes = [ctypes.c_int]
    return lib


@functools.lru_cache(maxsize=256)
def _card_shape(index: int, n: int, num_segments: int, ncols: int,
                nlev: int, tile: int | None) -> LaunchShape:
    """:func:`launch_shape` with this card's SMs and the chosen kernel's
    measured resident blocks per SM."""
    sms = _build.sm_count(index)
    first = launch_shape(n, num_segments, ncols, nlev, sms, tile)
    code = PARTITIONED if first.tiles > 1 else PATHS.index(first.path)
    with torch.cuda.device(index):
        per_sm = _launcher().segment_rsum_blocks_per_sm(
            code, ncols, nlev, first.threads, first.smem)
    if per_sm < 1:
        raise RuntimeError(f"segment kernel ({first.path} path) cannot run "
                           f"G={num_segments} x {ncols} columns x {nlev} "
                           f"levels on device {index}")
    return launch_shape(n, num_segments, ncols, nlev, sms, tile, per_sm)


class Bucketed(NamedTuple):
    """What the partition kernels leave on the card: the launch's shape,
    the scratch (:func:`scratch_layout`) and views of its parts."""
    shape: LaunchShape
    nlev: int                   # levels of the table it is for
    scratch: torch.Tensor       # uint8, kept alive with the views
    head: torch.Tensor          # int64 (head_words(tiles),)
    item_tile: torch.Tensor     # int32 (work_items,)
    ids: torch.Tensor           # int32 (n,): the rows in bucket order,
    x: torch.Tensor             # float32 (n, ncols): unless already in order
    partials: torch.Tensor      # int64 (partials * tile * ncols * nlev,)


def _partition(x, ids, nlev: int, num_segments: int,
               shape: LaunchShape) -> Bucketed:
    """Allocates the scratch and launches the partition's count, scan and
    scatter on the current stream."""
    global LAUNCHES
    n, ncols = x.shape
    _, o_items, o_ids, o_x, o_part, total = scratch_layout(
        n, ncols, nlev, shape.tile, shape.tiles, shape.work_items,
        shape.partials)
    scratch = x.new_empty(total, dtype=torch.uint8)
    b = Bucketed(
        shape, nlev, scratch, scratch[:o_items].view(torch.int64),
        scratch[o_items:o_items + 4 * shape.work_items].view(torch.int32),
        scratch[o_ids:o_ids + 4 * n].view(torch.int32),
        scratch[o_x:o_x + 4 * n * ncols].view(torch.float32).view(n, ncols),
        scratch[o_part:].view(torch.int64))
    lib = _launcher()
    base = scratch.data_ptr()
    err = lib.segment_partition_launch(
        ids.data_ptr(), x.data_ptr(), n, ncols, num_segments, shape.tile,
        shape.tiles, shape.part_blocks, shape.part_rows, shape.chunk_rows,
        int(shape.part_smem > 0), shape.stage_rows, base, base + o_items,
        base + o_ids, base + o_x, _build.current_stream(x))
    if err:
        raise RuntimeError("segment kernel partition failed: "
                           + lib.segment_rsum_error_string(err).decode())
    LAUNCHES += PARTITION_LAUNCHES
    return b


def _aggregate(x, ids, b: Bucketed, A, inv_ulp, m: int, flush: int,
               num_segments: int) -> torch.Tensor:
    """Launches the aggregate over the partition's work list; returns the
    int32 (2, G, ncols, nlev) buffer, ``k`` then ``C``."""
    global LAUNCHES
    ncols, nlev = x.shape[1], A.shape[0]
    shape = b.shape
    ent = num_segments * ncols * nlev
    out = x.new_empty((2, num_segments, ncols, nlev), dtype=torch.int32)
    lib = _launcher()
    base = b.scratch.data_ptr()
    k_ptr = out.data_ptr()
    err = lib.segment_aggregate_launch(
        ids.data_ptr(), x.data_ptr(), A.data_ptr(), inv_ulp.data_ptr(), base,
        b.item_tile.data_ptr(), b.ids.data_ptr(), b.x.data_ptr(),
        b.partials.data_ptr(), k_ptr, k_ptr + 4 * ent, ncols, nlev, m,
        num_segments, shape.tile, shape.tiles, shape.replicas,
        shape.chunk_rows, flush, shape.threads, shape.smem, shape.blocks,
        _build.current_stream(x))
    if err:
        raise RuntimeError("segment kernel aggregate failed: "
                           + lib.segment_rsum_error_string(err).decode())
    LAUNCHES += 1
    return out


@torch.library.custom_op("repro_torch::segment_levels", mutates_args=(),
                         device_types="cuda")
def _segment_launch(x: torch.Tensor, ids: torch.Tensor, num_segments: int,
                    A: torch.Tensor, inv_ulp: torch.Tensor, m: int,
                    flush: int, tile: int | None) -> torch.Tensor:
    """One call (:func:`launch_count` launches): the int32 (2, G, ncols,
    nlev) buffer, ``k`` then ``C``.  Registered as an operator so that a
    trace on fake tensors (:mod:`repro_torch.launch.dryrun`) sees one op
    with its fake implementation below; everything that needs the card
    happens here."""
    global LAUNCHES
    n, ncols = x.shape
    nlev = A.shape[0]
    shape = _card_shape(x.get_device(), n, num_segments, ncols, nlev, tile)
    if shape.tiles > 1:
        b = _partition(x, ids, nlev, num_segments, shape)
        return _aggregate(x, ids, b, A, inv_ulp, m, flush, num_segments)
    ent = num_segments * ncols * nlev
    part = x.new_empty(shape.slabs * ent, dtype=torch.int64)
    out = x.new_empty((2, num_segments, ncols, nlev), dtype=torch.int32)
    lib = _launcher()
    k_ptr = out.data_ptr()
    err = lib.segment_rsum_launch(
        ids.data_ptr(), x.data_ptr(), A.data_ptr(), inv_ulp.data_ptr(),
        part.data_ptr(), k_ptr, k_ptr + 4 * ent, n, ncols, nlev, m,
        num_segments, PATHS.index(shape.path), shape.tile, shape.replicas,
        shape.slabs, shape.rows_per_slab, flush, shape.threads,
        shape.smem, _build.current_stream(x))
    if err:
        raise RuntimeError("segment kernel launch failed: "
                           + lib.segment_rsum_error_string(err).decode())
    LAUNCHES += 2              # the path's kernel and segment_finalize
    return out


@_segment_launch.register_fake
def _segment_launch_fake(x, ids, num_segments, A, inv_ulp, m, flush, tile):
    return x.new_empty((2, num_segments, x.shape[1], A.shape[0]),
                       dtype=torch.int32)


def partition_kernel(x: torch.Tensor, ids: torch.Tensor, num_segments: int,
                     nlev: int, tile: int | None = None) -> Bucketed:
    """The partition kernels of a call over several group tiles, alone (to
    check them against :func:`partition_plain` and to time them on the
    card): the rows of ``x`` (n, ncols) and ``ids`` bucketed by group tile
    for a table of ``nlev`` levels."""
    _build.check_cuda("x", (x,), torch.float32)
    _build.check_cuda("ids", (ids,), torch.int32)
    n, ncols = x.shape
    shape = _card_shape(x.get_device(), n, num_segments, ncols, nlev, tile)
    if shape.tiles < 2:
        raise ValueError("one group tile: the call partitions nothing")
    return _partition(x, ids, nlev, num_segments, shape)


def aggregate_kernel(b: Bucketed, x: torch.Tensor, ids: torch.Tensor,
                     num_segments: int, A: torch.Tensor,
                     inv_ulp: torch.Tensor, spec: ReproSpec):
    """The aggregate of a call over several group tiles, alone, on the
    partition ``b`` of the same ``x`` and ``ids``: ``(k, C)`` as
    :func:`segment_levels_kernel` gives them.  It may run again on the
    same ``b``."""
    _build.check_cuda("x, A and inv_ulp", (x, A, inv_ulp), torch.float32)
    _build.check_cuda("ids", (ids,), torch.int32)
    if x.shape != b.x.shape or ids.shape != b.ids.shape \
            or A.shape != inv_ulp.shape or A.shape != (b.nlev, x.shape[1]):
        raise ValueError("aggregate_kernel expects the x and ids that were "
                         "partitioned and A, inv_ulp (nlev, ncols)")
    return _aggregate(x, ids, b, A, inv_ulp, spec.m, flush_rows(spec),
                      num_segments).unbind(0)


def head_tables(b: Bucketed) -> tuple[Partition, bool]:
    """The kernels' counts, offsets, work offsets and partial offsets
    (``order`` None), and whether the rows already came in tile order (the
    aggregate then read them in place).  Reads the card."""
    t = b.shape.tiles
    h = b.head
    return Partition(h[1:1 + t], h[1 + t:2 + 2 * t], h[2 + 3 * t:3 + 4 * t],
                     h[3 + 4 * t:3 + 5 * t], None), int(h[0]) == 0


def segment_levels_kernel(x: torch.Tensor, ids: torch.Tensor,
                          num_segments: int, A: torch.Tensor,
                          inv_ulp: torch.Tensor, spec: ReproSpec,
                          tile: int | None = None):
    """The CUDA kernel: same contract as :func:`segment_levels_plain`.  The
    kernel reduces across slabs and splits the sums canonically itself
    (the operator ``repro_torch::segment_levels``); ``k`` and ``C`` are the
    two halves of one int32 buffer."""
    if spec.m > 30:
        raise ValueError("the segment kernel supports float32 accumulators")
    _build.check_cuda("x, A and inv_ulp", (x, A, inv_ulp), torch.float32)
    _build.check_cuda("ids", (ids,), torch.int32)
    if x.ndim != 2 or ids.shape != (x.shape[0],) or A.ndim != 2 \
            or A.shape != inv_ulp.shape or A.shape[1] != x.shape[1]:
        raise ValueError("segment kernel expects x (n, ncols), ids (n,) and "
                         "A, inv_ulp (nlev, ncols)")
    nlev, ncols = A.shape
    if num_segments < 1 or ncols < 1 or not 1 <= nlev <= 8:
        raise ValueError("segment kernel needs G >= 1, ncols >= 1 and "
                         "1 <= nlev <= 8")
    return torch.ops.repro_torch.segment_levels(
        x, ids, num_segments, A, inv_ulp, spec.m, flush_rows(spec),
        None if tile is None else int(tile)).unbind(0)


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
    takes the kernel's tiled path with at most that many groups per block
    (it too changes no bits).
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
