"""Error-free transformation primitives (paper §III-A/B).

Branch-free bit manipulation plus IEEE float ops.  PyTorch runs each
elementwise operation as its own kernel and never reassociates floating-point
arithmetic across them, so ``(A + b) - A`` survives exactly as written; these
identities are the foundation of reproducibility.

Bit views go through ``Tensor.view`` onto the same-width *signed* integer
(see :mod:`repro_torch.core.types`).
"""
from __future__ import annotations

import torch

from repro_torch.core.types import float_spec

__all__ = ["exponent", "pow2", "extractor", "eft_fixed"]


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(float_spec(x.dtype).int_dtype)


def exponent(x: torch.Tensor) -> torch.Tensor:
    """Unbiased exponent of |x| (== floor(log2 |x|) for normals) as int32."""
    spec = float_spec(x.dtype)
    e = (_bits(x) & spec.exp_mask) >> spec.m
    return e.to(torch.int32) - spec.bias


def _biased(e, dtype) -> torch.Tensor:
    spec = float_spec(dtype)
    e = torch.as_tensor(e, dtype=torch.int32)
    return (e + spec.bias).to(spec.int_dtype) << spec.m


def pow2(e, dtype) -> torch.Tensor:
    """Exact 2^e for integer e within the normal range (no pow/exp calls)."""
    return _biased(e, dtype).view(float_spec(dtype).dtype)


def extractor(e, dtype) -> torch.Tensor:
    """The extractor value A = 1.5 * 2^e (mantissa = 1.1000...)."""
    spec = float_spec(dtype)
    return (_biased(e, dtype) | spec.half_bit).view(spec.dtype)


def eft_fixed(A: torch.Tensor, b: torch.Tensor):
    """EFT against a *constant* extractor A = 1.5 * 2^e.

    Returns (q, r): q = (A + b) - A an integer multiple of ulp(A), r = b - q
    exact.
    """
    q = (A + b) - A
    r = b - q
    return q, r
