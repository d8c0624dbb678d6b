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

from typing import Callable, Optional

import torch
import torch.distributed as dist

from repro_torch import tree as tree_mod
from repro_torch.core import accumulator as acc_mod
from repro_torch.core import collectives
from repro_torch.core.accumulator import ReproAcc
from repro_torch.core.types import ReproSpec
from repro_torch.kernels.rsum.ops import rsum_table
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
    for i in range(n_micro):
        g, m = grad_fn(params, {k: v[i] for k, v in microbatches.items()})
        if spec is None:
            if accs is None:
                accs = tree_mod.tree_map(torch.zeros_like, g)
                metrics = tree_mod.tree_map(torch.zeros_like, m)
            accs = tree_mod.tree_map(torch.add, accs, g)
            metrics = tree_mod.tree_map(torch.add, metrics, m)
            continue
        ga = tree_to_acc(g, spec)
        accs = acc_merge_tree(acc_zeros_like(g, spec) if accs is None
                              else accs, ga, spec)
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
    accs = tree_mod.tree_map(lambda a: fn(a, spec, groups), accs_or_grads)
    return tree_mod.tree_map(lambda x: div_count(x, n_quanta_global),
                             acc_finalize_tree(accs, spec))


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


def repro_global_norm(grads, spec: Optional[ReproSpec]):
    """sqrt of a reproducible sum of squared gradient entries.

    Squares are deterministic per element; their sum uses the associative
    accumulator, one :func:`flat_sum_acc` per leaf in leaf order, so the
    clip decision is independent of process count and ordering.  The square
    root is correctly rounded on every device.
    """
    gl = tree_mod.leaves(grads)
    if spec is None:
        total = sum(torch.sum(torch.square(g.to(torch.float32)))
                    for g in gl)
        return _sqrt_rn(total)
    acc = acc_mod.zeros(spec, device=gl[0].device)
    for g in gl:
        sq = torch.square(g.to(spec.dtype)).reshape(-1)
        acc = acc_mod.merge(acc, flat_sum_acc(sq, spec), spec)
    return _sqrt_rn(acc_mod.finalize(acc, spec))
