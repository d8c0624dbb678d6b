"""Fixed-point DECIMAL(p) baseline (paper §II-C / §VI).

The paper uses DECIMAL types backed by 32/64/128-bit integers as the
traditional-workload reference point: reproducible (integer adds), but
requiring a statically known scale and prone to overflow — exactly the
limitations that motivate the floating-point repro type.

DECIMAL(9) is int32 and DECIMAL(18) int64.  Values are scaled in float64
(every PyTorch device has it), so the encoding equals the JAX package's
under ``jax_enable_x64``.  Overflow is detected, not silently wrapped: the
paper's footnote 6 points out that overflow handling is what makes integer
summation potentially slow or non-reproducible; we surface a flag.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["DecimalSpec", "decimal_encode", "decimal_decode",
           "decimal_segment_sum"]


@dataclasses.dataclass(frozen=True)
class DecimalSpec:
    precision: int = 9          # decimal digits (paper: 9 / 19 / 38)
    scale: int = 4              # digits after the point

    @property
    def int_dtype(self) -> torch.dtype:
        return torch.int32 if self.precision <= 9 else torch.int64

    @property
    def factor(self) -> float:
        return float(10 ** self.scale)

    @property
    def max_abs(self) -> int:
        return 10 ** self.precision - 1


def decimal_encode(values, dspec: DecimalSpec):
    """Round floats to scaled integers (half to even); returns
    ``(ints, in_range_mask)``."""
    scaled = torch.round(torch.as_tensor(values).to(torch.float64)
                         * dspec.factor)
    ok = scaled.abs() <= dspec.max_abs
    return scaled.to(dspec.int_dtype), ok


def decimal_decode(ints, dspec: DecimalSpec) -> torch.Tensor:
    # the divisor is a tensor on the ints' device: PyTorch's CUDA division
    # by a host scalar multiplies by its reciprocal, which is not correctly
    # rounded (the CPU's and the JAX package's division is)
    factor = torch.tensor(dspec.factor, dtype=torch.float64,
                          device=ints.device)
    return ints.to(torch.float64) / factor


def decimal_segment_sum(values, segment_ids, num_segments: int,
                        dspec: DecimalSpec):
    """GROUPBY-SUM on DECIMAL(p): exact integer scatter-add + overflow flag.
    Returns ``(sums as float64, overflow flag per group, counts)``."""
    ints, ok = decimal_encode(values, dspec)
    idx = torch.as_tensor(segment_ids).to(device=ints.device,
                                          dtype=torch.int64)
    sums = ints.new_zeros(num_segments).index_add_(0, idx, ints)
    counts = ints.new_zeros(num_segments).index_add_(
        0, idx, torch.ones_like(ints))
    # conservative overflow check: |sum| could exceed p digits
    overflow = (sums.abs() > dspec.max_abs) | ~ok.all()
    return decimal_decode(sums, dspec), overflow, counts
