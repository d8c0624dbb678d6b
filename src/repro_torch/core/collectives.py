"""Reproducible cross-process reductions over ``torch.distributed``.

The paper merges per-thread private hash tables into a shared table with
``operator+=(repro<ScalarT,L>)`` — exact, hence schedule-independent.  The
distributed analogue is an all-reduce of accumulators.  Because the
canonical representation is integer, an all-reduce SUM over ``(k, C)`` is
exact and associative: *any* reduction topology (ring, tree, a hierarchy of
process groups) produces identical bits.

Overflow discipline: window offsets k live in [0, 2^(m-2)); an int32 sum of
them is exact for group sizes up to 2^(33-m) (f32: 1024).  Larger
deployments reduce hierarchically, one process group after another with a
renormalization between stages, so each stage stays within bound.

``repro_psum_packed`` is the wire optimization: an all-reduce is a
reduce-scatter (needs integer headroom) followed by an all-gather (pure
data movement).  After the reduce-scatter the shard is renormalized to
canonical form and k (m-2 bits) and C are packed into one int32 word per
level before the gather, halving the gather's bytes at no cost in accuracy.

Every function takes ``groups``: a process group, ``None`` for the default
(world) group, or a sequence of them reduced in turn.  The backend is the
caller's: NCCL for tensors on the card, gloo for tensors on the CPU.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core import accumulator as acc_mod
from repro_torch.core.accumulator import ReproAcc
from repro_torch.core.types import ReproSpec

__all__ = [
    "max_axis_size", "all_reduce", "repro_psum", "repro_psum_scatter",
    "repro_psum_packed", "pack_acc", "unpack_acc",
]


def max_axis_size(spec: ReproSpec) -> int:
    """Largest single-group fan-in with an exact integer sum of window
    offsets."""
    bits = 31 if spec.m <= 30 else 63
    return 1 << (bits - (spec.m - 2))


def _groups(groups) -> tuple:
    if groups is None or isinstance(groups, dist.ProcessGroup):
        return (groups,)
    return tuple(groups)


def _check_group(group, spec: ReproSpec) -> int:
    size = dist.get_world_size(group)
    if size > max_axis_size(spec):
        raise ValueError(
            f"process group of size {size} exceeds the exact-sum bound "
            f"{max_axis_size(spec)}; reduce hierarchically (pass two "
            "smaller groups) or raise the accumulator int width.")
    return size


def all_reduce(t: torch.Tensor, op, group=None) -> torch.Tensor:
    """``t`` reduced over ``group`` with ``op``, as a new tensor."""
    t = t.contiguous().clone()
    dist.all_reduce(t, op=op, group=group)
    return t


def _global_e1(e1: torch.Tensor, groups) -> torch.Tensor:
    for g in groups:
        e1 = all_reduce(e1, dist.ReduceOp.MAX, g)
    return e1


def _reduce_scatter(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Sum over the group; rank i keeps the i-th of ``size`` equal slices
    along ``dim``."""
    size = dist.get_world_size(group)
    t = torch.movedim(t, dim, 0).contiguous()
    if t.shape[0] % size:
        raise ValueError(f"dimension {dim} of length {t.shape[0]} does not "
                         f"split over {size} processes")
    out = t.new_empty((t.shape[0] // size, *t.shape[1:]))
    dist.reduce_scatter_tensor(out, t, op=dist.ReduceOp.SUM, group=group)
    return torch.movedim(out, 0, dim)


def repro_psum(acc: ReproAcc, spec: ReproSpec, groups=None) -> ReproAcc:
    """Exact all-reduce of accumulators over process groups.

    Groups are reduced one at a time with a renormalization between stages,
    so window offsets never overflow.  The result is canonical and
    bit-identical for any group order, process count or reduction topology,
    and equals :func:`repro_torch.core.accumulator.merge_all` of every
    process's accumulator.
    """
    for g in _groups(groups):
        _check_group(g, spec)
        e1 = all_reduce(acc.e1, dist.ReduceOp.MAX, g)
        acc = acc_mod.demote_to(acc, e1, spec)
        k = all_reduce(acc.k, dist.ReduceOp.SUM, g)
        C = all_reduce(acc.C, dist.ReduceOp.SUM, g)
        k, C = acc_mod.renorm(k, C, spec)
        acc = ReproAcc(k=k, C=C, e1=e1)
    return acc


def repro_psum_scatter(acc: ReproAcc, spec: ReproSpec, groups=None,
                       dim: int = 0) -> ReproAcc:
    """Exact reduce-scatter of accumulators along tensor dimension ``dim``
    (the ZeRO-2 building block: each process keeps 1/N of the reduced sums).

    Requires a *scalar* (per-tensor) e1.  Renormalizes between groups so
    hierarchies stay within the integer bound.
    """
    groups = _groups(groups)
    if acc.e1.ndim != 0:
        raise ValueError("repro_psum_scatter expects a per-tensor e1")
    e1 = _global_e1(acc.e1, groups)
    acc = acc_mod.demote_to(acc, e1, spec)
    k, C = acc.k, acc.C
    for g in groups:
        _check_group(g, spec)
        k = _reduce_scatter(k, dim, g)
        C = _reduce_scatter(C, dim, g)
        k, C = acc_mod.renorm(k, C, spec)
    return ReproAcc(k=k, C=C, e1=e1)


def _c_bits(spec: ReproSpec) -> int:
    return 32 - (spec.m - 2) - 1  # leave one sign/slack bit


def pack_acc(acc: ReproAcc, spec: ReproSpec):
    """Bit-pack canonical (k, C) into one int32 word per level.

    Layout per level: k in the low (m-2) bits (canonical, non-negative),
    C biased into the next ``32 - (m-2) - 1`` bits.  Valid only for |C| <
    2^(c_bits-1).  f32/L=2: 8 bytes per scalar instead of 16.
    """
    cb = _c_bits(spec)
    bias = 1 << (cb - 1)
    kk = acc.k.to(torch.int32)
    cc = acc.C.to(torch.int32) + bias
    return kk | (cc << (spec.m - 2)), acc.e1


def unpack_acc(word: torch.Tensor, e1: torch.Tensor,
               spec: ReproSpec) -> ReproAcc:
    cb = _c_bits(spec)
    bias = 1 << (cb - 1)
    mask = (1 << (spec.m - 2)) - 1
    k = (word & mask).to(spec.int_dtype)
    C = ((word >> (spec.m - 2)) & ((1 << cb) - 1)).to(spec.int_dtype) - bias
    return ReproAcc(k=k, C=C, e1=e1)


def repro_psum_packed(acc: ReproAcc, spec: ReproSpec,
                      groups=None) -> ReproAcc:
    """All-reduce = reduce-scatter (int, exact) + packed all-gather (half
    the bytes).

    Needs the leading dimension of the accumulator batch divisible by the
    total process count; falls back to :func:`repro_psum` where the packed
    layout does not apply (f64, no batch dimension, or a leading dimension
    that does not divide), as the JAX package does.
    """
    groups = _groups(groups)
    total = 1
    for g in groups:
        total *= dist.get_world_size(g)
    if spec.m > 30 or acc.k.ndim < 2 or acc.k.shape[0] % total != 0:
        return repro_psum(acc, spec, groups)        # packed layout N/A
    e1 = _global_e1(acc.e1, groups)
    acc = acc_mod.demote_to(acc, e1, spec)
    k, C = acc.k, acc.C
    for g in groups:
        _check_group(g, spec)
        k = _reduce_scatter(k, 0, g)
        C = _reduce_scatter(C, 0, g)
        k, C = acc_mod.renorm(k, C, spec)
    word, _ = pack_acc(ReproAcc(k=k, C=C, e1=e1), spec)
    for g in reversed(groups):
        size = dist.get_world_size(g)
        full = word.new_empty((word.shape[0] * size, *word.shape[1:]))
        dist.all_gather_into_tensor(full, word.contiguous(), group=g)
        word = full
    return unpack_acc(word, e1, spec)     # e1 is replicated already
