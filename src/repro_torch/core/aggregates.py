"""Fused multi-column reproducible segment aggregation.

The paper's GROUPBY-SUM generalizes to the full SQL aggregate family once the
value column is replaced by a *stacked column matrix*: COUNT is a SUM over a
ones column, MEAN is SUM/COUNT, VAR/STD are algebraic functions of
(SUM(x), SUM(x*x), COUNT), and SUM(x*y) is a SUM over an elementwise product
column.  All of these reduce to one fused segment reduction of a matrix
``X (n, ncols)`` into an accumulator *table* ``(G, ncols, L)``.

Strategies: ``scatter`` (paper §IV drop-in: integer ``index_add_``),
``radix`` (§V-B PartitionAndAggregate; ``sort`` is its alias), ``onehot``
(dense float matmul, exact within a block), and the two hand-written
kernels, ``pallas`` (the grouped segment kernel) and ``rsum`` (the flat
G == 1 kernel), which run on CUDA tensors and fall to their plain PyTorch
versions on CPU tensors.  Every path returns the same canonical table, bit
for bit, for any ordering, chunking or bucketing of the rows.

Unlike the JAX package, the strategies do not renormalize once per chunk:
they sum exact integers in int64 over slabs as large as int64 allows and
renormalize once per slab.  The canonical ``(k, C)`` decomposition of an
integer total is unique, so this gives the same bits; ``chunk`` and
``chunk_skip`` are accepted and change no bits.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import accumulator as acc_mod
from repro_torch.core import eft
from repro_torch.core import prescan
from repro_torch.core.accumulator import ReproAcc
from repro_torch.core.types import ReproSpec
from repro_torch.device import resolve_device
from repro_torch.kernels.rsum.ops import ladder, max_block_rows, rsum_table
from repro_torch.kernels.segment_rsum.ops import segment_agg_kernel

__all__ = [
    "pad_and_chunk", "segment_table", "scatter_table", "sort_table",
    "radix_table", "onehot_table", "onehot_block_bound",
    "scatter_chunk_bound", "default_chunk", "table_bytes", "radix_buckets",
    "DEFAULT_CACHE_BYTES",
]

# The paper's summation-buffer budget (§V-A): the cache the per-group tables
# should stay resident in.
DEFAULT_CACHE_BYTES = 1 << 24

_MAX_RADIX_BUCKETS = 64
_SLAB_ROWS = 1 << 22        # rows extracted at once (bounds the int slab)
_ONEHOT_ELEMS = 1 << 24     # one-hot operand elements materialized at once


def onehot_block_bound(spec: ReproSpec) -> int:
    """Largest one-hot matmul block with exact float accumulation:
    block * 2^(W-1) ulp must stay exactly representable, block <= 2^(m-W+2)."""
    return 1 << (spec.m - spec.W + 2)


def scatter_chunk_bound(spec: ReproSpec) -> int:
    """Largest scatter chunk whose per-group int sums cannot overflow the
    table's int dtype: chunk * 2^(W-1) < 2^(bits-1), halved for margin."""
    bits = 31 if spec.m <= 30 else 63
    return 1 << (bits - spec.W)


def default_chunk(method: str, spec: ReproSpec) -> int:
    """Per-method safe default for the summation-buffer size knob."""
    if method == "rsum":
        return max_block_rows(spec)
    if method in ("onehot", "pallas"):
        return onehot_block_bound(spec)
    return min(scatter_chunk_bound(spec), 4096)


def table_bytes(num_segments: int, ncols: int, spec: ReproSpec,
                levels: tuple[int, int] | None = None) -> int:
    """Bytes of the (G+1, ncols, L_eff) x {k, C} accumulator table."""
    nlev = prescan.window_length(levels, spec)
    item = spec.int_dtype.itemsize
    return (num_segments + 1) * max(int(ncols), 1) * nlev * 2 * item


def radix_buckets(num_segments: int, ncols: int, spec: ReproSpec,
                  cache_bytes: int = DEFAULT_CACHE_BYTES,
                  levels: tuple[int, int] | None = None) -> int:
    """Partition fan-out (a power of two) making each radix sub-table
    cache-resident: the smallest B with table_bytes / B <= cache_bytes."""
    tb = table_bytes(num_segments, ncols, spec, levels)
    b = 1
    while tb > b * cache_bytes and b < _MAX_RADIX_BUCKETS:
        b *= 2
    return b


def pad_and_chunk(values: torch.Tensor, chunk: int, segment_ids=None,
                  dump_id=None):
    """Pad rows to a multiple of ``chunk`` and reshape to (nblk, chunk, *F);
    padding rows are zeros and, when ``segment_ids`` is given, carry
    ``dump_id``.  Returns ``values`` chunked, or ``(values, segment_ids)``."""
    if segment_ids is not None and dump_id is None:
        raise ValueError("pad_and_chunk needs a dump_id to pad segment_ids "
                         "with (the caller's dump row / sentinel)")
    n = values.shape[0]
    feat = values.shape[1:]
    pad = (-n) % chunk
    if pad:
        values = torch.cat([values, values.new_zeros((pad, *feat))])
        if segment_ids is not None:
            segment_ids = torch.cat(
                [segment_ids, segment_ids.new_full((pad,), dump_id)])
    values = values.reshape(-1, chunk, *feat)
    if segment_ids is None:
        return values
    return values, segment_ids.reshape(-1, chunk)


def _feat_e1(e1, feat, device) -> torch.Tensor:
    """Broadcast a (possibly scalar) e1 to the feature shape as int32."""
    return torch.as_tensor(e1, dtype=torch.int32, device=device).expand(feat)


def _wide_rows(spec: ReproSpec) -> int:
    """Rows whose int64 level sums cannot overflow: rows * 2^(W-1) < 2^62."""
    return min(_SLAB_ROWS, 1 << (62 - (spec.W - 1)))


def _narrow(k: torch.Tensor, C: torch.Tensor, spec: ReproSpec):
    k, C = acc_mod.renorm(k, C, spec)
    return k.to(spec.int_dtype), C.to(spec.int_dtype)


def scatter_table(values, segment_ids, num_segments, spec: ReproSpec, e1,
                  chunk: int, levels: tuple[int, int] | None = None,
                  chunk_skip: bool = False):
    """Exact integer scatter-add (the drop-in strategy of paper §IV): the
    extracted ints of each slab go into an int64 table with ``index_add_``,
    renormalized once per slab.  Returns the pruned-width table."""
    del chunk, chunk_skip
    lo, hi = prescan.check_levels(levels, spec)
    feat = values.shape[1:]
    e1_f = _feat_e1(e1, feat, values.device)
    ids = segment_ids.to(torch.int64)
    k_tab = torch.zeros((num_segments, *feat, hi - lo), dtype=torch.int64,
                        device=values.device)
    c_tab = torch.zeros_like(k_tab)
    step = _wide_rows(spec)
    for s in range(0, values.shape[0], step):
        k = acc_mod.extract(values[s:s + step], e1_f, spec, levels=(lo, hi))
        k_tab.index_add_(0, ids[s:s + step], k.to(torch.int64))
        k_tab, c_tab = acc_mod.renorm(k_tab, c_tab, spec)
    return _narrow(k_tab, c_tab, spec)


def _bucket_remap(num_segments: int, num_buckets: int) -> np.ndarray:
    """Gather undoing the radix relabeling g -> (g & (B-1)) * Gsub +
    (g >> log2 B): full_table[g] = sub_tables[remap[g]]."""
    bits = num_buckets.bit_length() - 1
    gsub = -(-num_segments // num_buckets)
    g = np.arange(num_segments)
    return ((g & (num_buckets - 1)) * gsub + (g >> bits)).astype(np.int64)


def radix_table(values, segment_ids, num_segments, spec: ReproSpec, e1,
                chunk: int, levels: tuple[int, int] | None = None,
                chunk_skip: bool = False, num_buckets: int | None = None):
    """PartitionAndAggregate (paper §V-B): a stable partition on the low
    group-id bits, then the same integer scatter into contiguous
    sub-tables.  The relabeling is a pure permutation of table rows, so the
    result is bit-identical to :func:`scatter_table` on the original ids."""
    feat = values.shape[1:]
    ncols = int(np.prod(feat)) if feat else 1
    if num_buckets is None:
        num_buckets = radix_buckets(num_segments, ncols, spec, levels=levels)
    nb = max(1, int(num_buckets))
    nb = 1 << (nb - 1).bit_length()                        # ceil to pow2
    if nb <= 1:
        return scatter_table(values, segment_ids, num_segments, spec, e1,
                             chunk, levels=levels, chunk_skip=chunk_skip)
    bits = nb.bit_length() - 1
    gsub = -(-num_segments // nb)
    bucket = segment_ids & (nb - 1)
    tkey = bucket * gsub + (segment_ids >> bits)
    order = torch.argsort(bucket, stable=True)             # the partition
    k, C = scatter_table(values[order], tkey[order], nb * gsub, spec, e1,
                         chunk, levels=levels, chunk_skip=chunk_skip)
    remap = torch.as_tensor(_bucket_remap(num_segments, nb),
                            device=values.device)
    return k[remap], C[remap]


def sort_table(values, segment_ids, num_segments, spec: ReproSpec, e1,
               chunk: int, levels: tuple[int, int] | None = None,
               chunk_skip: bool = False, num_buckets: int | None = None):
    """Partition first, then aggregate (paper §V-B): alias of
    :func:`radix_table`."""
    return radix_table(values, segment_ids, num_segments, spec, e1, chunk,
                       levels=levels, chunk_skip=chunk_skip,
                       num_buckets=num_buckets)


@contextlib.contextmanager
def _full_f32_matmul():
    """Full-precision float32 products for the duration of the block: TF32
    would round the one-hot sums and break exactness."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def onehot_table(values, segment_ids, num_segments, spec: ReproSpec, e1,
                 block: int, levels: tuple[int, int] | None = None,
                 chunk_skip: bool = False):
    """Per-level one-hot matmul accumulation — exact in float within a block
    of at most ``onehot_block_bound`` rows, each block's sums then added as
    exact ints.  ``chunk_skip`` is accepted for signature parity."""
    del chunk_skip
    lo, hi = prescan.check_levels(levels, spec)
    block = min(block, onehot_block_bound(spec))
    feat = values.shape[1:]
    nf = int(np.prod(feat)) if feat else 1
    nseg = num_segments + 1                   # last row collects padding
    vs, ids = pad_and_chunk(values.reshape(values.shape[0], nf), block,
                            segment_ids, dump_id=num_segments)
    e1_f = _feat_e1(e1, feat, values.device).reshape(nf)
    A, inv_ulp = ladder(e1_f, spec, (lo, hi))
    k_tab = torch.zeros((nseg, nf, hi - lo), dtype=torch.int64,
                        device=values.device)
    step = max(1, _ONEHOT_ELEMS // (block * nseg))
    with _full_f32_matmul():
        for b in range(0, vs.shape[0], step):
            onehot = F.one_hot(ids[b:b + step].to(torch.int64), nseg) \
                .to(spec.dtype).transpose(1, 2)    # (bs, nseg, block)
            r = vs[b:b + step]                         # (bs, block, nf)
            for l in range(hi - lo):
                q, r = eft.eft_fixed(A[l], r)
                s = torch.bmm(onehot, q)               # exact: (bs, nseg, nf)
                k_tab[..., l] += (s * inv_ulp[l]).to(torch.int64).sum(dim=0)
    k, C = _narrow(k_tab[:num_segments], torch.zeros_like(
        k_tab[:num_segments]), spec)
    return k.reshape(num_segments, *feat, hi - lo), \
        C.reshape(num_segments, *feat, hi - lo)


_STRATEGIES = {
    "scatter": scatter_table,
    "sort": sort_table,
    "radix": radix_table,
    "onehot": onehot_table,
}


def segment_table(values, segment_ids, num_segments: int, spec: ReproSpec,
                  method: str, e1=None, chunk: int | None = None,
                  levels: tuple[int, int] | None = None,
                  chunk_skip: bool = False,
                  num_buckets: int | None = None,
                  device=None) -> ReproAcc:
    """Fused reproducible segment reduction: ``(n, *F) -> ReproAcc (G, *F, L)``.

    ``method`` must be an executable strategy name ('scatter' | 'sort' |
    'radix' | 'onehot' | 'pallas' | 'rsum').  'pallas' is the hand-written
    segment kernel and 'rsum' the flat kernel (``num_segments == 1``): on a
    CUDA device they launch the CUDA kernels, on the CPU their plain
    versions.  ``e1`` may be scalar or any shape broadcastable to ``F``;
    defaults to the per-feature row maximum.  ``levels`` is a static
    prescan-proved live-level window; the returned table is always full-L.
    """
    dev = resolve_device(device)
    values = torch.as_tensor(values).to(device=dev)
    segment_ids = torch.as_tensor(segment_ids).to(device=dev,
                                                  dtype=torch.int32)
    if segment_ids.ndim != 1 or values.shape[0] != segment_ids.shape[0]:
        raise ValueError("segment_table expects values (n, *F) and ids (n,)")
    values = values.to(spec.dtype)
    feat = values.shape[1:]
    if e1 is None:
        e1 = acc_mod.required_e1(values, spec, axis=0)       # (*F,)
    if method in ("rsum", "pallas"):
        flat = values.reshape(values.shape[0], -1)           # (n, prod(F))
        e1_flat = _feat_e1(e1, feat, dev).reshape(-1)
        if method == "rsum":
            acc = rsum_table(flat, segment_ids, num_segments, spec,
                             e1=e1_flat, block_rows=chunk, levels=levels,
                             device=dev)
        else:
            acc = segment_agg_kernel(flat, segment_ids, num_segments, spec,
                                     e1=e1_flat, block_n=chunk,
                                     levels=levels, device=dev)
        return ReproAcc(k=acc.k.reshape(num_segments, *feat, spec.L),
                        C=acc.C.reshape(num_segments, *feat, spec.L),
                        e1=acc.e1.reshape(num_segments, *feat))
    if method not in _STRATEGIES:
        raise ValueError(f"unknown method {method!r}")
    if chunk is None:
        chunk = default_chunk(method, spec)
    kwargs = {"levels": levels, "chunk_skip": chunk_skip}
    if method in ("sort", "radix"):
        kwargs["num_buckets"] = num_buckets
    k, C = _STRATEGIES[method](values, segment_ids, num_segments, spec, e1,
                               chunk, **kwargs)
    k = acc_mod.pad_levels(k, levels, spec)
    C = acc_mod.pad_levels(C, levels, spec)
    e1_b = _feat_e1(e1, feat, dev).expand(num_segments, *feat).contiguous()
    return ReproAcc(k=k, C=C, e1=e1_b)
