"""Shared numeric-format metadata for reproducible summation.

The paper's ``repro<ScalarT, L>`` type is parameterized by a scalar float type
and a number of extraction levels L.  This module centralizes the per-dtype
constants (mantissa width m, default extractor spacing W, exponent field
layout) and the derived bounds used throughout :mod:`repro_torch.core`.

Bit views use the *signed* integer of the same width (``torch.int32`` /
``torch.int64``): torch supports few operations on uint32/uint64, and every
mask below is a positive value of the signed type, so ``&`` and ``>>`` give
the same bits as the unsigned spelling.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

__all__ = [
    "FloatSpec",
    "FLOAT_SPECS",
    "ReproSpec",
    "float_spec",
    "dtype_name",
]


@dataclasses.dataclass(frozen=True)
class FloatSpec:
    """IEEE-754 layout constants for a binary float dtype."""

    dtype: torch.dtype        # torch float dtype
    int_dtype: torch.dtype    # same-width signed int dtype for bit views
    m: int                    # number of *stored* mantissa bits (f32: 23)
    exp_bits: int             # width of the exponent field
    bias: int                 # exponent bias
    default_w: int            # paper's recommended extractor spacing W

    @property
    def exp_mask(self) -> int:
        return ((1 << self.exp_bits) - 1) << self.m

    @property
    def half_bit(self) -> int:
        """Mantissa-field bit pattern of 0.5 (makes 1.5 * 2^e extractors)."""
        return 1 << (self.m - 1)

    @property
    def max_exp(self) -> int:
        """Largest unbiased exponent of a finite normal number."""
        return (1 << self.exp_bits) - 2 - self.bias

    @property
    def min_exp(self) -> int:
        """Smallest unbiased exponent of a normal number."""
        return 1 - self.bias


_F32 = FloatSpec(dtype=torch.float32, int_dtype=torch.int32, m=23,
                 exp_bits=8, bias=127, default_w=18)
_F64 = FloatSpec(dtype=torch.float64, int_dtype=torch.int64, m=52,
                 exp_bits=11, bias=1023, default_w=40)

FLOAT_SPECS = {
    torch.float32: _F32,
    torch.float64: _F64,
}

_NUMPY_TO_TORCH = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}


def _torch_dtype(dtype) -> torch.dtype | None:
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return _NUMPY_TO_TORCH.get(np.dtype(dtype))
    except TypeError:
        return None


def float_spec(dtype) -> FloatSpec:
    """Layout constants of a float dtype (torch, numpy or string spelling)."""
    d = _torch_dtype(dtype)
    if d not in FLOAT_SPECS:
        raise ValueError(
            f"repro accumulation supports float32/float64, got {dtype}. "
            "bf16/f16 inputs should be upcast (exact) before accumulation.")
    return FLOAT_SPECS[d]


def dtype_name(dtype) -> str:
    """numpy's name of a dtype ('float32', 'int64', ...)."""
    return str(dtype).rsplit(".", 1)[-1]


@dataclasses.dataclass(frozen=True)
class ReproSpec:
    """Static configuration of a reproducible accumulator.

    Mirrors the paper's ``repro<ScalarT, L>``:

    * ``dtype``  — the scalar float type of the running sums (ScalarT).
    * ``L``      — number of extraction levels (accuracy knob; L=2 ~ IEEE).
    * ``W``      — log2 ratio between consecutive extractors.  The paper's
      defaults are 18 (f32) and 40 (f64).
    """

    dtype: Any = torch.float32
    L: int = 2
    W: int | None = None

    def __post_init__(self):
        spec = float_spec(self.dtype)
        object.__setattr__(self, "dtype", spec.dtype)
        w = self.W if self.W is not None else spec.default_w
        object.__setattr__(self, "W", int(w))
        if not (1 <= self.L <= 8):
            raise ValueError(f"L must be in [1, 8], got {self.L}")
        if not (2 <= self.W <= spec.m - 2):
            raise ValueError(
                f"W must be in [2, m-2] = [2, {spec.m - 2}], got {self.W}")

    @property
    def fspec(self) -> FloatSpec:
        return float_spec(self.dtype)

    @property
    def m(self) -> int:
        return self.fspec.m

    def lattice_e1(self, max_exp):
        """Snap the level-1 extractor exponent onto the lattice W * Z
        (ceil towards +inf; works elementwise on int tensors)."""
        e_needed = max_exp + self.m - self.W + 2
        if isinstance(e_needed, torch.Tensor):
            return -torch.div(-e_needed, self.W, rounding_mode="floor") \
                * self.W
        return -((-e_needed) // self.W) * self.W

    @property
    def int_dtype(self) -> torch.dtype:
        """Integer dtype able to hold window offsets k in [0, 2^(m-2))."""
        return torch.int32 if self.m <= 30 else torch.int64

    @property
    def tree_group(self) -> int:
        """Safe fan-in for exact integer tree reduction of window offsets."""
        bits = 31 if self.m <= 30 else 63
        return max(2, 1 << (bits - (self.m - 2) - 1))

    @property
    def lattice_lo(self) -> int:
        """Smallest usable lattice e1 (extractor ladder stays normal)."""
        lo = self.fspec.min_exp + self.m + (self.L - 1) * self.W
        return -((-lo) // self.W) * self.W  # ceil to lattice

    @property
    def lattice_hi(self) -> int:
        """Largest usable lattice e1 (extractor + window stay finite)."""
        hi = self.fspec.max_exp - 1
        return (hi // self.W) * self.W  # floor to lattice

    def clamp_e1(self, e1: torch.Tensor) -> torch.Tensor:
        """Clamp e1 into the representable range *staying on the lattice*."""
        return torch.clamp(e1, self.lattice_lo, self.lattice_hi)
