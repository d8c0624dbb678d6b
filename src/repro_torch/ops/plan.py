"""Cost-model planner for reproducible GROUPBY.

Every execution path — torch onehot / scatter / radix (a.k.a. sort), the
hand-written segment kernel (``pallas``: the name is kept so that ``method=``
strings mean the same in the JAX package and here; on CUDA it launches
``kernels/segment_rsum/csrc/segment_rsum.cu``), and the hand-written flat
kernel (``rsum``, valid only at G == 1) — returns bit-identical accumulator
tables, so method choice is purely a performance decision.
:func:`plan_groupby` returns the strategy, the summation-buffer size
(``chunk``), the radix fan-out (``buckets``) and one line of rationale.

The backend comes from the device the data lives on: ``"cpu"`` or
``"cuda"``.  Two cost sources, in priority order:

* **measured** — when a calibration cache exists (see
  :mod:`repro_torch.ops.calibrate`), per-row costs are interpolated from
  microbenchmarks of each strategy on this machine;
* **modeled** — cold-start per-row costs.  On ``"cpu"`` the model is the
  JAX package's CPU model, constant for constant, so both packages choose
  the same strategy.  On ``"cuda"`` the kernels join the race, and every
  strategy is priced in ns per row from per-row costs measured on an H100.
"""
from __future__ import annotations

import dataclasses
import os

from repro_torch.core.aggregates import (  # noqa: F401  (re-exports)
    DEFAULT_CACHE_BYTES, default_chunk, onehot_block_bound, pad_and_chunk,
    radix_buckets, scatter_chunk_bound, table_bytes)
from repro_torch.core.prescan import window_length
from repro_torch.core.types import ReproSpec
from repro_torch.kernels.rsum.ops import max_block_rows
from repro_torch.kernels.segment_rsum.ops import takes_rows
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.ops import calibrate as cal_mod

__all__ = [
    "GroupbyPlan", "PartialPlan", "plan_groupby", "plan_partial",
    "pick_chunk", "default_chunk", "onehot_block_bound", "scatter_chunk_bound", "pad_and_chunk",
    "table_bytes", "radix_buckets", "METHODS",
]

METHODS = ("onehot", "scatter", "sort", "radix", "pallas", "rsum")

_CPU_LANES = 8        # effective CPU one-hot throughput (the JAX package's
                      # CPU constant)
_EXTRACT_COST = 4.0   # EFT + scale-to-int, per row per level
_SCATTER_COST = 32.0  # random table access, per row per level, in cache
_SPILL_FACTOR = 4.0   # penalty multiplier once the table leaves the cache
_PARTITION_COST = 8.0  # counting-sort partition: 2 streaming passes per row
_MERGE_COST = 6.0      # state merge, per table element (the JAX package's
                       # CPU constant, in the same units as _EXTRACT_COST)
_CACHE_BYTES = DEFAULT_CACHE_BYTES

# H100 cold-start model: each strategy's constants for the features of
# calibrate.cold_features, in ns per row, fitted by calibrate.fit_cold_model
# to the quick grid (2^26 rows) that chip_smoke.py's calibration phase
# measured on 2026-10-18 on an NVIDIA H100 80GB HBM3 at a 700.00 W power
# limit, torch 2.11.0+cu128, with the segment kernel's pass count over the
# rows as its feature (the points are in PERF.md §6).  Scatter's spill
# factor is the JAX package's, not measured on the card.
_CUDA_COLD = {
    "scatter": (0.07874, 0.006296, 0.4897, 0.1138),
    "sort": (0.05317, 0.008727, 0.5507, 0.1028),
    "onehot": (0.003634, 0.03317, 0.02008),
    "pallas": (0.01005, 0.002081),
    "rsum": (0.00943, 0.001695),
}


# One store merge on the card, in ns per table element (G x ncols x L_eff):
# the Q1 state merge (4 x 6 x 2 = 48 elements) that chip_smoke.py's stream
# phase times (0.847 ms, host clock, synchronized, median of 21), divided
# by its elements; NVIDIA H100 80GB HBM3 at a 700.00 W power limit (PERF.md
# §6, PR 15).  A merge is a few dozen eager launches whatever the table's
# size, so this prices small tables right and large ones high.
_CUDA_MERGE_NS = 17640.0


def _clamp_chunk(method: str, chunk: int, spec: ReproSpec) -> int:
    if method == "rsum":
        return min(chunk, max_block_rows(spec))
    if method in ("onehot", "pallas"):
        return min(chunk, onehot_block_bound(spec))
    return min(chunk, scatter_chunk_bound(spec))


def pick_chunk(method: str, num_segments: int, ncols: int, spec: ReproSpec,
               levels=None, cache_bytes: int = _CACHE_BYTES) -> int:
    """Buffer-residency chunk choice (paper §V-C): the largest power-of-two
    block whose extracted integer slab plus the float rows fit in the cache
    budget beside the (sub-)table, clamped to the per-method bound.  Chunk
    sizes change no bits."""
    if method == "rsum":
        return max_block_rows(spec, ncols, levels)
    if method in ("onehot", "pallas"):
        return onehot_block_bound(spec)
    bound = scatter_chunk_bound(spec)
    tb = table_bytes(num_segments, ncols, spec, levels)
    if method in ("sort", "radix"):
        tb //= radix_buckets(num_segments, ncols, spec, cache_bytes, levels)
    nlev = window_length(levels, spec)
    row_bytes = max(int(ncols), 1) * (
        nlev * spec.int_dtype.itemsize + spec.dtype.itemsize)
    free = cache_bytes - tb
    if free < 256 * row_bytes:
        return bound
    return int(min(bound, 1 << (int(free // row_bytes).bit_length() - 1)))


def _emit_plan(plan: "GroupbyPlan", n: int, num_segments: int, ncols: int,
               backend: str, levels) -> "GroupbyPlan":
    """Plan-decision observability: one event + one counter per decision."""
    obs_metrics.counter("repro_plan_total", method=plan.method,
                        source=plan.source).inc()
    obs_trace.event("plan.groupby", method=plan.method, chunk=plan.chunk,
                    buckets=plan.buckets, source=plan.source,
                    cost_per_row=plan.cost, n=int(n), G=int(num_segments),
                    ncols=int(ncols), backend=backend,
                    levels=list(levels) if levels is not None else None,
                    reason=plan.reason)
    return plan


@dataclasses.dataclass(frozen=True)
class GroupbyPlan:
    """An executable dispatch decision: strategy + buffer sizes + rationale."""

    method: str          # 'onehot'|'scatter'|'sort'|'radix'|'pallas'|'rsum'
    chunk: int           # rows per block between renormalizations
    cost: float          # per-row cost (0.0 for explicit requests)
    reason: str          # one line of cost-model rationale
    buckets: int = 1     # radix partition fan-out (1 = no partitioning)
    source: str = "model"  # 'model' | 'measured' | 'explicit'


def _cpu_costs(num_segments, nlev, extract, in_cache, buckets, candidates):
    """The JAX package's CPU cold-start model."""
    costs = {
        "onehot": extract + nlev * num_segments / _CPU_LANES,
        "scatter": extract + nlev * _SCATTER_COST *
        (1.0 if in_cache else _SPILL_FACTOR),
        "sort": extract + nlev * _SCATTER_COST +
        (0.0 if buckets == 1 else _PARTITION_COST + buckets / _CPU_LANES),
    }
    if "rsum" in candidates:
        # off the card the kernel's plain version runs: priced out of the
        # cold race, as the JAX package prices its interpret mode
        costs["rsum"] = extract + 1e3 * nlev
    return costs


def _cuda_costs(num_segments, ncols, nlev, in_cache, candidates,
                model=None):
    """The H100 cold-start model (``model``: ``_CUDA_COLD``), in ns per
    row."""
    model = _CUDA_COLD if model is None else model
    costs = {m: sum(c * f for c, f in zip(
        model[m], cal_mod.cold_features(m, num_segments, ncols, nlev)))
        for m in candidates}
    if not in_cache and "scatter" in costs:
        costs["scatter"] *= _SPILL_FACTOR
    return costs


def plan_groupby(n: int, num_segments: int, spec: ReproSpec, ncols: int = 1,
                 backend: str = "cuda", method: str = "auto",
                 chunk: int | None = None, levels=None,
                 calibration="auto") -> GroupbyPlan:
    """Choose an execution strategy for an (n rows, G groups, ncols columns)
    reproducible GROUPBY on ``backend`` (``"cuda"`` or ``"cpu"``).
    Deterministic in its arguments (plus, when a calibration cache is
    present, in that cache); any choice is bit-compatible with any other,
    so this is purely a throughput decision.

    ``levels`` is the prescan's live-level window; ``calibration`` is
    ``"auto"`` (use the cache if one exists), ``None`` (force the
    cold-start model), or a :class:`repro_torch.ops.calibrate.Calibration`.
    """
    buckets = radix_buckets(num_segments, ncols, spec, levels=levels)
    if method != "auto":
        if method not in METHODS:
            raise ValueError(f"unknown method {method!r}; want one of "
                             f"{('auto',) + METHODS}")
        if method == "rsum" and num_segments != 1:
            raise ValueError("method 'rsum' is the flat-aggregation kernel: "
                             f"it requires num_segments == 1, got "
                             f"{num_segments}")
        c = _clamp_chunk(
            method, chunk or pick_chunk(method, num_segments, ncols, spec,
                                        levels), spec)
        return _emit_plan(
            GroupbyPlan(method, c, 0.0, "explicit request",
                        buckets=buckets if method in ("sort", "radix")
                        else 1, source="explicit"),
            n, num_segments, ncols, backend, levels)

    cal = None
    if calibration is not None:
        cal = (cal_mod.for_planner(spec, backend)
               if calibration == "auto" else calibration)

    nlev = window_length(levels, spec)
    candidates = ["onehot", "scatter", "sort"]
    if backend == "cuda" and spec.m <= 30 \
            and takes_rows(n, num_segments, ncols, nlev):
        candidates.append("pallas")
    if num_segments == 1 and spec.m <= 30:
        # the flat-sum kernel: only valid with a single group
        candidates.append("rsum")

    costs, source = None, "model"
    if cal is not None:
        # fitted_cost returns None outside a method's measured-G envelope,
        # dropping it from the measured race rather than trusting a flat
        # extrapolation
        costs = {m: cal_mod.fitted_cost(cal, m, n, num_segments, ncols, spec,
                                        backend=backend)
                 for m in candidates}
        costs = {m: c for m, c in costs.items() if c is not None}
        if len(costs) >= 2:
            source = "measured"
        else:
            costs = None
    tb = table_bytes(num_segments, ncols, spec, levels)
    in_cache = tb <= _CACHE_BYTES
    if costs is None:
        if backend == "cuda":
            costs = _cuda_costs(num_segments, ncols, nlev, in_cache,
                                candidates)
        else:
            costs = _cpu_costs(num_segments, nlev, _EXTRACT_COST * nlev,
                               in_cache, buckets, candidates)

    best = min(costs, key=costs.get)
    fmt = ".1f" if backend == "cpu" else ".3g"
    reason = (f"{'calibrated' if source == 'measured' else 'cost model'}: "
              f"{best}={costs[best]:{fmt}}/row over "
              + ", ".join(f"{m}={c:{fmt}}" for m, c in sorted(costs.items())
                          if m != best)
              + f" (G={num_segments}, n={n}, ncols={ncols}, "
              f"table {'fits' if in_cache else 'spills'} cache"
              + (f", B={buckets}" if best in ("sort", "radix") else "")
              + f", {backend})")
    c = _clamp_chunk(best, chunk or pick_chunk(best, num_segments, ncols,
                                               spec, levels), spec)
    return _emit_plan(
        GroupbyPlan(best, c, costs[best], reason,
                    buckets=buckets if best in ("sort", "radix") else 1,
                    source=source),
        n, num_segments, ncols, backend, levels)


# ---------------------------------------------------------------------------
# partial planning: micro-batch strategy + merge amortization
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PartialPlan:
    """A dispatch decision for streaming partial aggregation.

    ``agg`` is the per-micro-batch plan.  ``merge_rows`` prices one store
    merge (demote + integer add + renorm over the whole ``(G, ncols,
    L_eff)`` table, independent of the batch size) in aggregated rows, and
    ``coalesce`` is the number of micro-batches worth buffering per store
    merge so the merge stays at or below ``merge_frac`` of the aggregation
    work.  ``pipeline`` is the Amdahl width of the pipelined service: the
    parallel prepare work per batch over the amortized serial merge share,
    clamped to the host's cores.  Every knob moves throughput, never bits.
    """

    agg: GroupbyPlan     # per-micro-batch execution plan
    merge_rows: float    # one store merge, in row-equivalents
    coalesce: int        # micro-batches to buffer per store merge
    reason: str          # one line of rationale
    pipeline: int = 1    # concurrent prepare workers worth running


def plan_partial(n: int, num_segments: int, spec: ReproSpec, ncols: int = 1,
                 backend: str = "cuda", method: str = "auto",
                 chunk: int | None = None, levels=None, calibration="auto",
                 merge_frac: float = 0.25,
                 max_coalesce: int = 64) -> PartialPlan:
    """Plan streaming partial aggregation for ``n``-row micro-batches into a
    ``(G, ncols)`` store on ``backend``.

    On ``"cpu"`` the merge and the rows are both in the JAX package's cost
    units, constant for constant, so both packages choose the same
    ``coalesce`` and ``pipeline``.  On ``"cuda"`` the per-row cost is in ns
    (the planner's H100 model or calibration), so the merge is priced in ns
    too (``_CUDA_MERGE_NS`` per table element, measured on the card).
    """
    agg = plan_groupby(n, num_segments, spec, ncols=ncols, backend=backend,
                       method=method, chunk=chunk, levels=levels,
                       calibration=calibration)
    nlev = window_length(levels, spec)
    elements = num_segments * max(int(ncols), 1) * nlev
    if backend == "cuda":
        per_row = agg.cost if agg.cost > 0 else _cuda_costs(
            num_segments, max(int(ncols), 1), nlev,
            table_bytes(num_segments, ncols, spec, levels) <= _CACHE_BYTES,
            [agg.method])[agg.method]
        merge_rows = _CUDA_MERGE_NS * elements / per_row
    else:
        per_row = agg.cost if agg.cost > 0 else _EXTRACT_COST * nlev
        merge_rows = _MERGE_COST * elements / per_row
    n = max(int(n), 1)
    coalesce = max(1, min(max_coalesce,
                          -(-int(merge_rows) // max(int(merge_frac * n), 1))))
    cores = os.cpu_count() or 1
    pipeline = int(max(1, min(cores,
                              n * coalesce // max(int(merge_rows), 1))))
    reason = (f"merge ≈ {merge_rows:.0f} row-equivalents vs {n}-row "
              f"batches; coalesce {coalesce} batch(es) holds merge "
              f"overhead ≤ {merge_frac:.0%}; pipeline width {pipeline} "
              f"of {cores} core(s) ({agg.method}/{agg.source}, {backend})")
    obs_trace.event("plan.partial", method=agg.method, chunk=agg.chunk,
                    merge_rows=merge_rows, coalesce=coalesce, n=n,
                    pipeline=pipeline, G=int(num_segments),
                    ncols=int(ncols), backend=backend, reason=reason)
    obs_metrics.counter("repro_plan_partial_total",
                        method=agg.method).inc()
    return PartialPlan(agg=agg, merge_rows=merge_rows, coalesce=coalesce,
                       reason=reason, pipeline=pipeline)
