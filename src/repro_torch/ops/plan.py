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
``"cuda"``.  On ``"cpu"`` the cold-start model is the JAX package's CPU
model, constant for constant, so both packages choose the same strategy.
On ``"cuda"`` the kernels join the race, priced by H100 cold-start
constants that have not been measured yet.  No calibration cache exists in
this package yet: ``calibration="auto"`` finds none and the model decides.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.aggregates import (  # noqa: F401  (re-exports)
    DEFAULT_CACHE_BYTES, default_chunk, onehot_block_bound, pad_and_chunk,
    radix_buckets, scatter_chunk_bound, table_bytes)
from repro_torch.core.prescan import window_length
from repro_torch.core.types import ReproSpec
from repro_torch.kernels.rsum.ops import max_block_rows
from repro_torch.kernels.segment_rsum.ops import group_tile
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

__all__ = [
    "GroupbyPlan", "plan_groupby", "pick_chunk", "default_chunk",
    "onehot_block_bound", "scatter_chunk_bound", "pad_and_chunk",
    "table_bytes", "radix_buckets", "METHODS",
]

METHODS = ("onehot", "scatter", "sort", "radix", "pallas", "rsum")

_CPU_LANES = 8        # effective CPU one-hot throughput (the JAX package's
                      # CPU constant)
_EXTRACT_COST = 4.0   # EFT + scale-to-int, per row per level
_SCATTER_COST = 32.0  # random table access, per row per level, in cache
_SPILL_FACTOR = 4.0   # penalty multiplier once the table leaves the cache
_PARTITION_COST = 8.0  # counting-sort partition: 2 streaming passes per row
_CACHE_BYTES = DEFAULT_CACHE_BYTES

# H100 cold-start constants.  NOT YET MEASURED on the card: they only order
# the strategies (kernels first at small G, scatter at huge G) until a
# measured calibration replaces them.
_CUDA_LANES = 1024        # dense one-hot accumulation width of a torch bmm
_CUDA_EAGER_COST = 16.0   # eager torch strategies: extracted ints (and the
                          # one-hot operand) round-trip device memory, per
                          # row per level
_CUDA_TILE_COST = 2.0     # segment kernel: one stream of the rows per group
                          # tile, per row per level
_CUDA_RSUM_COST = 0.5     # flat kernel: in-register int adds, per level


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
    source: str = "model"  # 'model' | 'explicit'


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


def _cuda_costs(num_segments, ncols, nlev, extract, in_cache, buckets,
                candidates):
    scatter = _SCATTER_COST * (1.0 if in_cache else _SPILL_FACTOR)
    costs = {
        "onehot": extract + nlev * (_CUDA_EAGER_COST
                                    + num_segments / _CUDA_LANES),
        "scatter": extract + nlev * (_CUDA_EAGER_COST + scatter),
        "sort": extract + nlev * (_CUDA_EAGER_COST + _SCATTER_COST) +
        (0.0 if buckets == 1 else _PARTITION_COST + buckets / _CUDA_LANES),
    }
    if "pallas" in candidates:
        tiles = -(-num_segments // group_tile(num_segments, ncols, nlev))
        costs["pallas"] = extract + nlev * _CUDA_TILE_COST * tiles
    if "rsum" in candidates:
        costs["rsum"] = extract + nlev * _CUDA_RSUM_COST
    return costs


def plan_groupby(n: int, num_segments: int, spec: ReproSpec, ncols: int = 1,
                 backend: str = "cuda", method: str = "auto",
                 chunk: int | None = None, levels=None,
                 calibration="auto") -> GroupbyPlan:
    """Choose an execution strategy for an (n rows, G groups, ncols columns)
    reproducible GROUPBY on ``backend`` (``"cuda"`` or ``"cpu"``).
    Deterministic in its arguments; any choice is bit-compatible with any
    other, so this is purely a throughput decision.  ``calibration`` is
    accepted for signature parity: no measured cache exists yet, so the
    cold-start model always decides.
    """
    del calibration
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

    candidates = ["onehot", "scatter", "sort"]
    if backend == "cuda" and spec.m <= 30:
        candidates.append("pallas")
    if num_segments == 1 and spec.m <= 30:
        # the flat-sum kernel: only valid with a single group
        candidates.append("rsum")

    nlev = window_length(levels, spec)
    extract = _EXTRACT_COST * nlev
    tb = table_bytes(num_segments, ncols, spec, levels)
    in_cache = tb <= _CACHE_BYTES
    if backend == "cuda":
        costs = _cuda_costs(num_segments, ncols, nlev, extract, in_cache,
                            buckets, candidates)
    else:
        costs = _cpu_costs(num_segments, nlev, extract, in_cache, buckets,
                           candidates)

    best = min(costs, key=costs.get)
    reason = (f"cost model: "
              f"{best}={costs[best]:.1f}/row over "
              + ", ".join(f"{m}={c:.1f}" for m, c in sorted(costs.items())
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
                    source="model"),
        n, num_segments, ncols, backend, levels)
