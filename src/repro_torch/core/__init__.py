"""Core reproducible-aggregation library (the paper's contribution in
PyTorch)."""
from repro_torch.core.types import ReproSpec, FloatSpec, float_spec  # noqa: F401
from repro_torch.core.accumulator import (  # noqa: F401
    ReproAcc, zeros, from_values, merge, merge_all, finalize, extract,
    renorm, demote_to, required_e1,
)
from repro_torch.core.segment import segment_rsum  # noqa: F401
from repro_torch.core.aggregates import segment_table, pad_and_chunk  # noqa: F401
from repro_torch.core import prescan  # noqa: F401
