"""Sharded reproducible GROUPBY: per-process partials + exact collective merge.

The paper merges per-thread private hash tables into a shared table with the
exact accumulator ``operator+=`` — schedule-independent because the merge is
integer arithmetic.  This module is the multi-process analogue: it is the
partial/merge/finalize pipeline of :mod:`repro_torch.ops.partial` with the
merge stage run as ``torch.distributed`` collectives.  Each process
aggregates its own rows into a local partial table through the stage of
:func:`repro_torch.ops.partial.partial_agg` (the planner: the segment
kernel on the card), the tables merge with
:func:`repro_torch.core.collectives.repro_psum` (an integer all-reduce, hence
exact and associative over any topology), and the replicated merged state
finalizes through the same :func:`repro_torch.ops.partial.finalize` every
other deployment shape uses.

Bit-identity across process counts rests on two facts:

* the lattice exponents are agreed globally *before* extraction: each
  process takes an all-reduce MAX of its per-column e1, and because the
  lattice snap is monotone, ``max(required_e1(shard)) == required_e1(whole
  input)`` — every process extracts on the very lattice a single device
  would use;
* everything after extraction is integer: the table sums, the row count,
  and MIN/MAX, which reduce the order-preserving integer keys of
  :mod:`repro_torch.ops.partial` (``-0.0 < +0.0``, NaN bits apart) of each
  process's result, so the signed-zero and NaN rules hold for any split of
  the rows.

So :func:`sharded_groupby_agg` on every process equals ``groupby_agg`` over
the concatenation of all processes' rows, byte for byte.  Each process
passes its own rows; no padding is needed.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core import accumulator as acc_mod
from repro_torch.core import collectives
from repro_torch.core.types import ReproSpec
from repro_torch.ops.partial import (PartialState, _from_key, _nan_pick,
                                     _order_key, _partial_agg, finalize)

__all__ = ["sharded_groupby_agg", "sharded_partial_agg"]


def _global_extreme(x: torch.Tensor, largest: bool, group) -> torch.Tensor:
    """Exact MAX (``largest``) or MIN over ``group`` of each process's
    stacked MIN/MAX columns ``x`` (G, c).  The all-reduces run on the
    order-preserving int keys and the NaN bits, never on the floats, so a
    group gets the single-device value for any split of its rows."""
    nan = torch.isnan(x)
    ident = torch.full_like(x, -torch.inf if largest else torch.inf)
    key = collectives.all_reduce(
        _order_key(torch.where(nan, ident, x)),
        dist.ReduceOp.MAX if largest else dist.ReduceOp.MIN, group)
    nanbits = collectives.all_reduce(_nan_pick(x, nan), dist.ReduceOp.MAX,
                                     group)
    lowest = torch.iinfo(nanbits.dtype).min
    return torch.where(nanbits != lowest, nanbits.view(x.dtype),
                       _from_key(key, x.dtype))


def sharded_partial_agg(values, keys, num_segments: int, aggs=("sum",),
                        spec: ReproSpec | None = None, group=None,
                        method: str = "auto", chunk: int | None = None,
                        levels="auto", device=None) -> PartialState:
    """Multi-process partial aggregation: aggregate this process's rows on
    the globally agreed lattice, merge collectively over ``group`` (``None``:
    the default group).  Every process of the group calls it with its own
    rows and gets the same replicated :class:`PartialState` that
    :func:`repro_torch.ops.partial.partial_agg` over all rows would return,
    bit for bit.

    The local stage is :func:`partial_agg`'s, with the lattice all-reduced
    before extraction.  ``levels`` as there: ``"auto"`` proves each
    process's live-level window on its own rows against the global lattice
    (a table holds zeros outside its window, so the windows need not
    agree); a static window must hold for the *whole* input.  ``device``
    as in :func:`repro_torch.ops.groupby_agg`; the group's backend must
    take tensors there (NCCL on the card, gloo on the CPU).
    """
    def lattice(X: torch.Tensor, spec: ReproSpec) -> torch.Tensor:
        # an empty shard admits the bottom of the lattice, like a shard of
        # zeros
        local = X if X.shape[0] else X.new_zeros((1, X.shape[1]))
        return collectives.all_reduce(
            acc_mod.required_e1(local, spec, axis=0), dist.ReduceOp.MAX,
            group)

    st = _partial_agg(values, keys, num_segments, aggs, spec, method, chunk,
                      levels, False, device, lattice=lattice)
    table, minv, maxv = st.table, st.minv, st.maxv
    if st.sig.ncols:
        table = collectives.repro_psum(table, st.spec, group)
    if minv.shape[1]:
        minv = _global_extreme(minv, False, group)
        maxv = _global_extreme(maxv, True, group)
    rows = collectives.all_reduce(st.rows, dist.ReduceOp.SUM, group)
    return PartialState(table=table, minv=minv, maxv=maxv, rows=rows,
                        sig=st.sig)


def sharded_groupby_agg(values, keys, num_segments: int, aggs=("sum",),
                        spec: ReproSpec | None = None, group=None,
                        method: str = "auto", chunk: int | None = None,
                        levels="auto", device=None) -> dict:
    """Multi-process :func:`repro_torch.ops.groupby_agg` over row shards:
    ``finalize(sharded_partial_agg(...))``.  Returns the same dict on every
    process of ``group``, bit-identical to the single-device result over
    the concatenated rows for any process count and any split."""
    return finalize(sharded_partial_agg(
        values, keys, num_segments, aggs=aggs, spec=spec, group=group,
        method=method, chunk=chunk, levels=levels, device=device))
