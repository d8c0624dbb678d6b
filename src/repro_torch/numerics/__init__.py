"""Fixed-point baselines beside the reproducible float type."""
from repro_torch.numerics.decimal import (  # noqa: F401
    DecimalSpec, decimal_decode, decimal_encode, decimal_segment_sum)
