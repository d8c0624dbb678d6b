"""Relational operator layer: planned, fused aggregation.

* :mod:`repro_torch.ops.partial` — the partial/merge/finalize pipeline:
  ``partial_agg`` produces a mergeable ``PartialState``, ``merge`` combines
  partials bit-associatively, ``finalize`` extracts the result dict, and
  ``PartialPipeline`` is the stream stores' per-batch stage;
* :mod:`repro_torch.ops.groupby` — ``groupby_agg``, the unified
  multi-aggregate GROUPBY entry point, ``finalize(partial_agg(...))``;
* :mod:`repro_torch.ops.plan` — the cost-model planner dispatching between
  the torch strategies and the hand-written CUDA kernels;
* :mod:`repro_torch.ops.calibrate` — the measured autotuner feeding the
  planner microbenchmarked per-row costs (JSON cache, opt-in autotune);
* :mod:`repro_torch.ops.sharded` — the ``torch.distributed`` GROUPBY,
  bit-identical to one device for any process count.
"""
from repro_torch.ops.groupby import groupby_agg, agg_name, AGG_KINDS  # noqa: F401
from repro_torch.ops.partial import (  # noqa: F401
    AggSignature, PartialPipeline, PartialState, empty_partial, finalize,
    merge, merge_all, partial_agg, pipeline_for, state_nbytes,
)
from repro_torch.ops.plan import (  # noqa: F401
    GroupbyPlan, PartialPlan, plan_groupby, plan_partial, pick_chunk, default_chunk, onehot_block_bound,
    scatter_chunk_bound, pad_and_chunk, table_bytes, radix_buckets, METHODS,
)
from repro_torch.ops import calibrate  # noqa: F401
from repro_torch.ops.sharded import (  # noqa: F401
    sharded_groupby_agg, sharded_partial_agg)
