"""Reproducible GROUPBY-SUM: the paper's core operation (§IV/§V).

Thin wrapper.  The execution strategies live in
:mod:`repro_torch.core.aggregates`, method selection in the cost-model
planner :mod:`repro_torch.ops.plan`, and the multi-aggregate entry point is
:func:`repro_torch.ops.groupby_agg`.  All strategies return the same
canonical :class:`ReproAcc` bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.core import accumulator as acc_mod
from repro_torch.core import aggregates
from repro_torch.core.accumulator import ReproAcc
from repro_torch.core.aggregates import (  # noqa: F401
    onehot_block_bound, scatter_chunk_bound)
from repro_torch.core.types import ReproSpec
from repro_torch.device import resolve_device

__all__ = ["segment_rsum", "onehot_block_bound", "scatter_chunk_bound"]


def segment_rsum(values, segment_ids, num_segments: int, spec: ReproSpec,
                 method: str = "auto", e1=None, chunk: int | None = None,
                 levels: tuple[int, int] | None = None,
                 device=None) -> ReproAcc:
    """Bit-reproducible GROUPBY-SUM.

    Args:
      values:       float (n, *F) — the value column(s).
      segment_ids:  int32 (n,) in [0, num_segments) — the key column.
      num_segments: group count G.
      spec:         accumulator format (ScalarT, L, W).
      method:       'scatter' | 'sort' | 'radix' | 'onehot' | 'pallas' |
                    'auto' (the cost-model planner).
      e1:           optional shared lattice exponent; derived from the global
                    max by default.
      chunk:        block size knob (changes no bits).
      levels:       optional static live-level window from
                    :mod:`repro_torch.core.prescan`.
      device:       ``None`` (CUDA) or an explicit device such as ``"cpu"``.

    Returns a batched ReproAcc with batch shape (G,).
    """
    dev = resolve_device(device)
    values = torch.as_tensor(values).to(device=dev, dtype=spec.dtype)
    segment_ids = torch.as_tensor(segment_ids).to(device=dev,
                                                  dtype=torch.int32)
    if segment_ids.ndim != 1 or values.shape[0] != segment_ids.shape[0]:
        raise ValueError("segment_rsum expects values (n, *F) and ids (n,)")
    if e1 is None:
        # global (not per-feature) lattice: the single-column contract
        e1 = acc_mod.required_e1(values, spec)
    num_buckets = None
    if method == "auto" or chunk is None:
        from repro_torch.ops.plan import plan_groupby
        n = int(values.shape[0])
        ncols = int(values.numel() // max(n, 1)) if values.ndim > 1 else 1
        plan = plan_groupby(n, num_segments, spec, ncols=ncols, chunk=chunk,
                            method=method, levels=levels,
                            backend=dev.type)
        method, chunk = plan.method, plan.chunk
        if method in ("sort", "radix"):
            num_buckets = plan.buckets
    return aggregates.segment_table(values, segment_ids, num_segments, spec,
                                    method=method, e1=e1, chunk=chunk,
                                    levels=levels, num_buckets=num_buckets,
                                    device=dev)
