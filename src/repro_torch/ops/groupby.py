"""Unified reproducible GROUPBY: one entry point for the aggregate family.

``groupby_agg`` computes any mix of SUM / COUNT / MEAN / VAR / STD /
SUM(x*y) / MIN / MAX in **one** fused pass, bit-identically across
execution methods, row orderings, chunk sizes and devices:

    groupby_agg(rows) == finalize(partial_agg(rows))
"""
from __future__ import annotations

from repro_torch.core.types import ReproSpec
from repro_torch.obs import trace as obs_trace
from repro_torch.ops.partial import (  # noqa: F401
    AGG_KINDS, AggSignature, PartialState, agg_name, finalize, partial_agg)

__all__ = ["groupby_agg", "agg_name", "AGG_KINDS"]


def groupby_agg(values, keys, num_segments: int, aggs=("sum",),
                spec: ReproSpec | None = None, method: str = "auto",
                chunk: int | None = None, return_table: bool = False,
                levels="auto", check_finite: bool = False, device=None):
    """Bit-reproducible multi-aggregate GROUPBY.

    Args:
      values:       float (n,) single column or (n, C) column matrix
                    (numpy array or tensor).
      keys:         int (n,) in [0, num_segments) — the GROUP BY column.
      num_segments: group count G.
      aggs:         aggregate requests: 'sum' | 'count' | 'mean' | 'var' |
                    'std' | 'min' | 'max' (column 0), or tuples
                    ('kind', col) / ('sum_prod', i, j).  'avg' aliases
                    'mean'.
      spec:         accumulator format; default ``ReproSpec()`` (f32, L=2).
      method:       'auto' (cost-model planner) or an explicit strategy:
                    'onehot' | 'scatter' | 'sort' | 'radix' | 'pallas' (the
                    hand-written segment kernel) | 'rsum' (the flat kernel;
                    G == 1 only).
      chunk:        summation-buffer size knob (changes no bits).
      return_table: also return the raw accumulator table ``ReproAcc
                    (G, ncols, L)``.
      levels:       lattice-level window: ``"auto"`` (default) runs the
                    exponent prescan; ``None`` forces the full window; an
                    explicit ``(lo, hi)`` tuple is used as given.
      check_finite: raise ``FloatingPointError`` on ±inf/NaN inputs and on
                    derived columns that overflow to non-finite values.
      device:       ``None`` (CUDA; raises ``RuntimeError`` without a CUDA
                    device) or an explicit device such as ``"cpu"``.

    Returns an ordered dict mapping canonical names (see :func:`agg_name`)
    to finalized (G,) tensors on ``device``; with ``return_table=True``, a
    ``(results, table)`` pair.
    """
    with obs_trace.span("groupby", G=int(num_segments)):
        state = partial_agg(values, keys, num_segments, aggs=aggs,
                            spec=spec, method=method, chunk=chunk,
                            levels=levels, check_finite=check_finite,
                            device=device)
        out = finalize(state)
    if return_table:
        return out, state.table
    return out
