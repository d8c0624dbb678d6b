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

__all__ = [
    "ufp", "ulp", "exponent", "pow2", "extractor", "eft", "eft_fixed",
    "scale_to_int", "int_to_scaled",
]


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(float_spec(x.dtype).int_dtype)


def exponent(x: torch.Tensor) -> torch.Tensor:
    """Unbiased exponent of |x| (== floor(log2 |x|) for normals) as int32."""
    spec = float_spec(x.dtype)
    e = (_bits(x) & spec.exp_mask) >> spec.m
    return e.to(torch.int32) - spec.bias


def ufp(x: torch.Tensor) -> torch.Tensor:
    """Unit in the first place: 2^exponent(x) (Goldberg).  ufp(0) = 0."""
    spec = float_spec(x.dtype)
    return (_bits(x) & spec.exp_mask).view(x.dtype)


def ulp(x: torch.Tensor) -> torch.Tensor:
    """Unit in the last place: 2^(exponent(x) - m)."""
    spec = float_spec(x.dtype)
    return pow2(exponent(x) - spec.m, x.dtype)


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


def eft(S: torch.Tensor, b: torch.Tensor):
    """Error-free transformation against a running sum S (paper Fig. 1).

    Returns (q, r) with q = (S + b) - S an integer multiple of ulp(S) and
    r = b - q exact.  Precondition: |b| < 2^(W-1) * ulp(S) and S in its
    window [1.5 ufp, 1.75 ufp) (maintained by carry propagation).
    """
    q = (S + b) - S
    r = b - q
    return q, r


def eft_fixed(A: torch.Tensor, b: torch.Tensor):
    """EFT against a *constant* extractor A = 1.5 * 2^e.

    Returns (q, r): q = (A + b) - A an integer multiple of ulp(A), r = b - q
    exact.
    """
    q = (A + b) - A
    r = b - q
    return q, r


def scale_to_int(q: torch.Tensor, e, m: int) -> torch.Tensor:
    """Exact integer k = q / 2^(e - m) for q a multiple of ulp = 2^(e-m).

    |k| <= 2^(W-1) + 1 always fits int32 for W <= 30.
    """
    e = torch.as_tensor(e, dtype=torch.int32, device=q.device)
    return (q * pow2(m - e, q.dtype)).to(torch.int32)


def int_to_scaled(k: torch.Tensor, e, m: int, dtype) -> torch.Tensor:
    """Exact float k * 2^(e - m) for |k| < 2^(m+1) (single rounding else)."""
    e = torch.as_tensor(e, dtype=torch.int32, device=k.device)
    return k.to(dtype) * pow2(e - m, dtype)
