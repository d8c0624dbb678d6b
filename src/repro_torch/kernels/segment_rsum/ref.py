"""Plain-torch oracles for the segment RSUM / fused GROUPBY kernels."""
from __future__ import annotations

from repro_torch.core.accumulator import ReproAcc
from repro_torch.core.aggregates import segment_table
from repro_torch.core.segment import segment_rsum
from repro_torch.core.types import ReproSpec

__all__ = ["segment_rsum_ref", "segment_agg_ref"]


def segment_rsum_ref(values, segment_ids, num_segments: int,
                     spec: ReproSpec = ReproSpec(), device=None) -> ReproAcc:
    """Must match ops.segment_rsum_kernel bit-for-bit."""
    return segment_rsum(values, segment_ids, num_segments, spec,
                        method="onehot", device=device)


def segment_agg_ref(values, segment_ids, num_segments: int,
                    spec: ReproSpec = ReproSpec(), e1=None,
                    levels=None, device=None) -> ReproAcc:
    """Must match ops.segment_agg_kernel bit-for-bit (values (n, ncols)),
    including under a pruned level window."""
    return segment_table(values, segment_ids, num_segments, spec,
                         method="onehot", e1=e1, levels=levels,
                         device=device)
