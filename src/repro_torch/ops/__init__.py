"""Relational operator layer: planned, fused aggregation.

* :mod:`repro_torch.ops.partial` — the partial/merge/finalize pipeline:
  ``partial_agg`` produces a mergeable ``PartialState``, ``merge`` combines
  partials bit-associatively, ``finalize`` extracts the result dict;
* :mod:`repro_torch.ops.groupby` — ``groupby_agg``, the unified
  multi-aggregate GROUPBY entry point, ``finalize(partial_agg(...))``;
* :mod:`repro_torch.ops.plan` — the cost-model planner dispatching between
  the torch strategies and the hand-written CUDA kernels.
"""
from repro_torch.ops.groupby import groupby_agg, agg_name, AGG_KINDS  # noqa: F401
from repro_torch.ops.partial import (  # noqa: F401
    AggSignature, PartialState, empty_partial, finalize, merge, merge_all,
    partial_agg,
)
from repro_torch.ops.plan import (  # noqa: F401
    GroupbyPlan, plan_groupby, pick_chunk, default_chunk, onehot_block_bound,
    scatter_chunk_bound, pad_and_chunk, table_bytes, radix_buckets, METHODS,
)
