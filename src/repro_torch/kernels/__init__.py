"""Hand-written CUDA kernels (sm_90a) for the aggregation hot spots.

Each kernel ships as ``csrc/<name>.cu`` (the CUDA source, built by ``nvcc``
at first use through :mod:`repro_torch.kernels._build`), ``ops.py`` (the
wrapper, its launch count and its plain PyTorch version) and ``ref.py``
(the plain-torch oracle).  On a CUDA tensor a wrapper launches its kernel
or raises; on a CPU tensor it runs the plain version.
"""
from repro_torch.kernels.rsum.ops import rsum, rsum_acc  # noqa: F401
from repro_torch.kernels.segment_rsum.ops import (  # noqa: F401
    segment_agg_kernel, segment_rsum_kernel)
