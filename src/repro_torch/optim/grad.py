"""Reproducible gradient accumulation, reduction and clipping.

This is the paper's technique doing its production job:

* microbatch gradients (deterministic, fixed-shape quanta) are folded into
  per-parameter ``ReproAcc`` trees — the associative ``repro`` type replaces
  the float += of ordinary gradient accumulation;
* cross-process reduction uses exact integer collectives (``repro_psum``)
  over ``torch.distributed`` process groups;
* the global-norm clip is computed from a reproducible sum of squares, each
  leaf's sum planned as a G == 1 GROUPBY (the rsum kernel on the card), so
  clipping decisions can never flip between process counts.

Everything here is elementwise over parameters.  ``groups`` is what
:mod:`repro_torch.core.collectives` takes; ``()`` means a single process
(no collective at all).
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.distributed as dist

from repro_torch import tree as tree_mod
from repro_torch.core import accumulator as acc_mod
from repro_torch.core import collectives
from repro_torch.core.accumulator import ReproAcc
from repro_torch.core.types import ReproSpec
from repro_torch.kernels.rsum.ops import rsum_table
from repro_torch.obs import repeat
from repro_torch.ops.partial import _sqrt_rn
from repro_torch.ops.plan import plan_groupby

__all__ = ["tree_to_acc", "acc_merge_tree", "acc_finalize_tree",
           "acc_zeros_like", "accumulate_microbatches", "reduce_grads",
           "flat_sum_acc", "repro_global_norm", "div_count", "all_reduce_sum",
           "metric_add"]


def div_count(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x / n``, correctly rounded on every device: CUDA's division by a
    host scalar multiplies by its reciprocal, so divide by a tensor."""
    return x / torch.tensor(n, dtype=x.dtype, device=x.device)


def all_reduce_sum(x: torch.Tensor, groups) -> torch.Tensor:
    """Float sum over each group in turn (the baseline's psum)."""
    for g in collectives._groups(groups):
        x = collectives.all_reduce(x, dist.ReduceOp.SUM, g)
    return x


def tree_to_acc(grads, spec: ReproSpec):
    """Convert a gradient tree into per-parameter accumulators.

    One *scalar* lattice exponent per tensor (from its max |g|): keeps the
    accumulator overhead at exactly (k, C) ints per element and makes the
    ZeRO-2 reduce-scatter path trivial.  A fresh single-value extraction has
    |k| < 2^(W-1), so C == 0; the first merge makes it canonical.
    """
    def conv(g):
        e1 = acc_mod.required_e1(g, spec)                 # scalar ()
        k = acc_mod.extract(g.to(spec.dtype), e1, spec)   # (*shape, L)
        return ReproAcc(k=k, C=torch.zeros_like(k), e1=e1)
    return tree_mod.tree_map(conv, grads)


def acc_merge_tree(a, b, spec: ReproSpec):
    return tree_mod.tree_map(lambda x, y: acc_mod.merge(x, y, spec), a, b)


def acc_finalize_tree(accs, spec: ReproSpec):
    return tree_mod.tree_map(lambda a: acc_mod.finalize(a, spec), accs)


def acc_zeros_like(grads, spec: ReproSpec):
    return tree_mod.tree_map(
        lambda g: acc_mod.zeros(spec, g.shape, device=g.device), grads)


def metric_add(macc: Optional[ReproAcc], x: torch.Tensor,
               spec: ReproSpec) -> ReproAcc:
    """Fold one scalar metric into its accumulator (``None``: the first):
    even the local sum over microbatches is exact, since a float += would
    round differently for different data-parallel widths."""
    a = acc_mod.from_values(x.to(spec.dtype).reshape(1), spec)
    if macc is None:
        macc = acc_mod.zeros(spec, device=x.device)
    return acc_mod.merge(macc, a, spec)


# Accumulator work on a gradient leaf of more elements than this runs in
# slices of it, one after another: every step is elementwise (the lattice
# exponent is the whole leaf's), so the bits are those of one pass, and a
# leaf's temporaries stay this size however large the leaf (a 197 M-element
# embedding shard would need ~10 GB of them in one pass).
ACC_SLICE = 1 << 23


def _acc_rows(acc: ReproAcc, lo: int, hi: int) -> ReproAcc:
    """Elements [lo, hi) of an accumulator, flattened (a scalar lattice
    exponent stays scalar)."""
    L = acc.k.shape[-1]
    e1 = acc.e1.reshape(-1)[lo:hi] if acc.e1.ndim else acc.e1
    return ReproAcc(k=acc.k.reshape(-1, L)[lo:hi],
                    C=acc.C.reshape(-1, L)[lo:hi], e1=e1)


def _fold_leaf(acc: Optional[ReproAcc], g: torch.Tensor,
               spec: ReproSpec) -> ReproAcc:
    """``merge(acc or zeros, tree_to_acc(g))`` for one leaf, in slices of
    :data:`ACC_SLICE` elements where the leaf is larger."""
    if acc is None and g.numel() <= ACC_SLICE:
        acc = acc_mod.zeros(spec, g.shape, device=g.device)
    if g.numel() <= ACC_SLICE:
        return acc_mod.merge(acc, tree_to_acc(g, spec), spec)
    e1 = acc_mod.required_e1(g, spec)                 # the whole leaf's
    x = g.to(spec.dtype).reshape(-1)
    n = x.shape[0]
    k = torch.empty((n, spec.L), dtype=spec.int_dtype, device=g.device)
    C = torch.empty_like(k)
    e1_out = torch.empty((n,), dtype=torch.int32, device=g.device)
    for lo in range(0, n, ACC_SLICE):
        hi = min(lo + ACC_SLICE, n)
        kx = acc_mod.extract(x[lo:hi], e1, spec)
        prev = acc_mod.zeros(spec, (hi - lo,), device=g.device) \
            if acc is None else _acc_rows(acc, lo, hi)
        part = acc_mod.merge(prev, ReproAcc(k=kx, C=torch.zeros_like(kx),
                                            e1=e1), spec)
        k[lo:hi], C[lo:hi], e1_out[lo:hi] = part.k, part.C, part.e1
    return ReproAcc(k=k.reshape(*g.shape, spec.L),
                    C=C.reshape(*g.shape, spec.L), e1=e1_out.reshape(g.shape))


def accumulate_microbatches(grad_fn: Callable, params, microbatches,
                            spec: Optional[ReproSpec]):
    """Loop over microbatches; returns (grad_accs_or_grads, metric sums).

    ``microbatches``: dict of tensors with a leading (n_micro, ...) axis;
    ``grad_fn(params, mb) -> (grads, metrics)``.  With ``spec=None`` this is
    the conventional float += baseline.  Sums are raw: callers normalize by
    the *global* quantum count (a local mean would depend on the width).
    """
    n_micro = next(iter(microbatches.values())).shape[0]
    accs = metrics = None
    for i, _ in repeat.trips(n_micro, "train.quanta"):
        g, m = grad_fn(params, {k: v[i] for k, v in microbatches.items()})
        if spec is None:
            if accs is None:
                accs = tree_mod.tree_map(torch.zeros_like, g)
                metrics = tree_mod.tree_map(torch.zeros_like, m)
            accs = tree_mod.tree_map(torch.add, accs, g)
            metrics = tree_mod.tree_map(torch.add, metrics, m)
            continue
        accs = tree_mod.tree_map(
            lambda x, *a: _fold_leaf(a[0] if a else None, x, spec),
            g, *(() if accs is None else (accs,)))
        metrics = {k: metric_add(None if metrics is None else metrics[k], v,
                                 spec) for k, v in m.items()}
    return accs, metrics


def reduce_grads(accs_or_grads, spec: Optional[ReproSpec], groups,
                 n_quanta_global: int, packed: bool = False):
    """Cross-process gradient reduction.

    Repro mode: exact integer all-reduce of accumulator trees, then
    finalize and normalize by the *global* quantum count (a constant, so
    the division is deterministic).  Baseline: float all-reduce.
    """
    if spec is None:
        return tree_mod.tree_map(
            lambda x: div_count(all_reduce_sum(x, groups), n_quanta_global),
            accs_or_grads)
    fn = collectives.repro_psum_packed if packed else collectives.repro_psum

    def reduce(a):
        return div_count(acc_mod.finalize(fn(a, spec, groups), spec),
                         n_quanta_global)

    def one(a):
        n = math.prod(a.k.shape[:-1])
        if n <= ACC_SLICE:
            return reduce(a)
        out = torch.empty(a.k.shape[:-1], dtype=spec.dtype,
                          device=a.k.device)
        flat = out.reshape(-1)
        for lo in range(0, n, ACC_SLICE):
            hi = min(lo + ACC_SLICE, n)
            flat[lo:hi] = reduce(_acc_rows(a, lo, hi))
        return out
    return tree_mod.tree_map(one, accs_or_grads)


def flat_sum_acc(x: torch.Tensor, spec: ReproSpec) -> ReproAcc:
    """Planner-routed reproducible flat sum (the G == 1 aggregation).

    Gradient-norm sums are exactly the planner's single-group case: consult
    :func:`repro_torch.ops.plan.plan_groupby` for the tensor's device and
    run the rsum kernel (``kernels/rsum``) when it wins the cost race — on
    the card it does; otherwise the eager lattice path.  Both produce
    bit-identical canonical accumulators, so the routing can never change a
    clip decision.
    """
    x = x.to(spec.dtype).reshape(-1)
    plan = plan_groupby(int(x.shape[0]), 1, spec, backend=x.device.type)
    if plan.method == "rsum":
        t = rsum_table(x[:, None], num_segments=1, spec=spec,
                       block_rows=plan.chunk, device=x.device)
        return ReproAcc(k=t.k[0, 0], C=t.C[0, 0], e1=t.e1[0, 0])
    return acc_mod.from_values(x, spec)


def repro_global_norm(grads, spec: Optional[ReproSpec], weights=None,
                      groups=(), tp: Optional[collectives.TP] = None):
    """sqrt of a reproducible sum of squared gradient entries.

    Squares are deterministic per element; their sum uses the associative
    accumulator, one :func:`flat_sum_acc` per leaf in leaf order, so the
    clip decision is independent of process count and ordering.  The square
    root is correctly rounded on every device.

    Over shards (ZeRO slices over ``groups``, model-axis shards over
    ``tp``), ``weights`` gives per leaf ``None`` or a 0/1 float scalar the
    squares are multiplied by, so that a leaf held whole on several ranks
    counts on one of them; the ranks' sums are then added exactly over
    ``groups`` and the model group (the float baseline adds over the model
    axis in rank order).  Each element counts once, so the norm's bits do
    not depend on how the leaves are split.
    """
    gl = tree_mod.leaves(grads)
    ws = weights if weights is not None else [None] * len(gl)

    def weighted(sq, w):
        return sq if w is None else sq * w

    if spec is None:
        total = sum(weighted(torch.sum(torch.square(g.to(torch.float32))), w)
                    for g, w in zip(gl, ws))
        total = all_reduce_sum(total, groups) if groups else total
        return _sqrt_rn(collectives.model_sum(total, tp))
    acc = acc_mod.zeros(spec, device=gl[0].device)
    for g, w in zip(gl, ws):
        sq = weighted(torch.square(g.to(spec.dtype)).reshape(-1), w)
        acc = acc_mod.merge(acc, flat_sum_acc(sq, spec), spec)
    if collectives.model_active(tp):
        groups = tuple(groups) + (tp.group,)
    if groups:
        acc = collectives.repro_psum(acc, spec, groups)
    return _sqrt_rn(acc_mod.finalize(acc, spec))
