"""repro_torch: bit-reproducible floating-point aggregation in PyTorch on
NVIDIA GPUs (Mueller et al., ICDE'18), with hand-written CUDA kernels.

The port of the JAX package ``repro``: the same canonical integer
accumulator, the same table dtypes and the same result bits.  Entry points
run on the CUDA device unless the caller passes ``device="cpu"``.
"""
from repro_torch.core import (  # noqa: F401
    ReproSpec, ReproAcc, from_values, finalize, merge, segment_rsum,
)
from repro_torch.ops import groupby_agg, plan_groupby  # noqa: F401

__version__ = "0.1.0"
