"""Faithful reproductions of the paper's RSUM algorithms (§III).

* :func:`rsum_scalar`     — Algorithm 2 verbatim: per-element extraction
  against the L running sums, level demotion via a while-loop, carry
  propagation after every element.
* :func:`rsum_simd`       — Algorithm 3: V lane-parallel running sums,
  demotion check once per V*NB block, carry propagation every NB rounds,
  exact horizontal merge at the end (paper Eq. 2/3, with the cross-lane sum
  in exact integer arithmetic).
* :func:`rsum_simd_chunked` — the Fig. 6 usage pattern: state is stored to
  "memory" (the paper's summation-state format: one S and one C per level)
  after every chunk of c values and re-expanded for the next chunk.

These are the paper-faithful baselines: eager PyTorch, one operation at a
time, on whatever device the values live on.  The demotion test reads one
value back to the host per element (Algorithm 2) or per block (Algorithm 3).
The production path is :func:`repro_torch.core.accumulator.from_values`
and the kernels behind :func:`repro_torch.ops.groupby_agg`.
"""
from __future__ import annotations

import torch

from repro_torch.core import eft
from repro_torch.core.aggregates import pad_and_chunk
from repro_torch.core.types import ReproSpec
from repro_torch.device import resolve_device

__all__ = [
    "init_state", "choose_f", "rsum_scalar", "rsum_simd",
    "rsum_simd_chunked", "finalize_state", "conventional_sum",
]


def _as_values(values, spec: ReproSpec) -> torch.Tensor:
    return torch.as_tensor(values).to(spec.dtype).reshape(-1)


def choose_f(values, spec: ReproSpec) -> torch.Tensor:
    """Paper §III-C: f > log2|b_1| + m - W + 1 (we use the batch max)."""
    amax = torch.as_tensor(values).abs().amax()
    return eft.exponent(amax.to(spec.dtype)) + spec.m - spec.W + 2


def init_state(f, spec: ReproSpec, device=None):
    """S^(l) = 1.5 * 2^(f - (l-1) W), C^(l) = 0 (paper §III-C), on
    ``device`` (``None``: ``f``'s device if it is a tensor, else the
    card)."""
    if device is None and isinstance(f, torch.Tensor):
        device = f.device
    f = torch.as_tensor(f, dtype=torch.int32, device=resolve_device(device))
    es = f - torch.arange(spec.L, dtype=torch.int32, device=f.device) * spec.W
    S = eft.extractor(es, spec.dtype)
    C = torch.zeros(spec.L, dtype=torch.int32, device=f.device)
    return S, C


def _carry_propagate(S, C, spec: ReproSpec):
    """Alg. 2 lines 14-18: renormalize S into [1.5 ufp, 1.75 ufp)."""
    u = eft.ufp(S)
    d = torch.floor((S - 1.5 * u) / (0.25 * u)).to(torch.int32)
    S = S - d.to(spec.dtype) * (0.25 * u)   # exact: multiples of ulp
    return S, C + d


def _demote_once(S, C, spec: ReproSpec):
    """Alg. 2 lines 5-7: shift levels down, new coarser first level (every
    lane of a lane-parallel state at once)."""
    top = eft.extractor(eft.exponent(S.reshape(-1)[0]) + spec.W, spec.dtype)
    S = torch.roll(S, 1, dims=0)
    C = torch.roll(C, 1, dims=0)
    S[0] = top
    C[0] = 0
    return S, C


def _demote_while(S, C, amax, spec: ReproSpec):
    """While |b|max >= 2^(W-1) ulp(S^(1)): demote (Alg. 2 line 4)."""
    while True:
        s1 = S.reshape(-1)[0]
        thresh = eft.pow2(eft.exponent(s1) + spec.W - 1 - spec.m, spec.dtype)
        if not bool(amax >= thresh):
            return S, C
        S, C = _demote_once(S, C, spec)


def _extract_into(S, r, spec: ReproSpec):
    """Alg. 2 lines 9-13 for one value (or one lane-vector of values)."""
    S = S.clone()
    for l in range(spec.L):
        q = (r + S[l]) - S[l]
        S[l] = S[l] + q     # exact: q is a multiple of ulp(S^(l))
        r = r - q           # exact remainder
    return S


def rsum_scalar(values, spec: ReproSpec, f=None):
    """Paper Algorithm 2 (RSUM SCALAR).  Returns the paper state (S, C)."""
    values = _as_values(values, spec)
    if f is None:
        f = choose_f(values, spec) - spec.W  # start low: exercises Alg2 l.4
    S, C = init_state(f, spec, device=values.device)
    for b in values:
        S, C = _demote_while(S, C, b.abs(), spec)
        S = _extract_into(S, b, spec)
        S, C = _carry_propagate(S, C, spec)
    return S, C


def _expand_lanes(S, C, V: int, spec: ReproSpec):
    """Paper §III-D state load: lane 0 = memory state, others 1.5 ufp / 0."""
    Sl = (1.5 * eft.ufp(S))[:, None].expand(spec.L, V).to(spec.dtype).clone()
    Sl[:, 0] = S
    Cl = torch.zeros((spec.L, V), dtype=torch.int32, device=S.device)
    Cl[:, 0] = C
    return Sl, Cl


def _merge_lanes(S, C, spec: ReproSpec):
    """Paper Eq. 2/3 horizontal merge, done in exact integer arithmetic.

    All lanes share level exponents (demotion is applied lane-uniformly), so
    S_v = A_l + k_v ulp; Eq. 2's sum of (S_v - 1.5 ufp) is sum(k_v) * ulp,
    an exact integer reduction (V * 2^(m-2) << 2^31) whose window overflow
    folds into C — bit-identical to an exact evaluation of Eq. 2.
    """
    e = eft.exponent(S[:, 0])                               # (L,)
    A = eft.extractor(e, spec.dtype)
    k = (S - A[:, None]) * eft.pow2(spec.m - e, spec.dtype)[:, None]
    k = k.to(spec.int_dtype).sum(dim=1)                     # exact, int64
    d = k >> (spec.m - 2)
    k = k - (d << (spec.m - 2))
    S_out = A + k.to(spec.dtype) * eft.pow2(e - spec.m, spec.dtype)
    C_out = (C.sum(dim=1) + d.to(torch.int32)).to(torch.int32)
    return S_out, C_out


def _simd_blocks(S, C, blocks, spec: ReproSpec):
    """Algorithm 3's outer loop over (nblk, NB, V) blocks of lane state."""
    for block in blocks:
        S, C = _demote_while(S, C, block.abs().amax(), spec)
        for b_v in block:                                   # NB rounds of V
            S = _extract_into(S, b_v, spec)
        S, C = _carry_propagate(S, C, spec)
    return S, C


def rsum_simd(values, spec: ReproSpec, V: int = 64, f=None):
    """Paper Algorithm 3 (RSUM SIMD).  Returns the paper state (S, C)."""
    values = _as_values(values, spec)
    nb = spec.nb
    blocks = pad_and_chunk(values, V * nb).reshape(-1, nb, V)
    if f is None:
        f = choose_f(blocks, spec)
    S, C = _expand_lanes(*init_state(f, spec, device=values.device), V, spec)
    return _merge_lanes(*_simd_blocks(S, C, blocks, spec), spec)


def rsum_simd_chunked(values, spec: ReproSpec, c: int, V: int = 64):
    """Fig. 6 pattern: call RSUM SIMD per chunk of c values, persisting the
    scalar summation state between calls (load/expand + merge/store)."""
    values = _as_values(values, spec)
    nb = spec.nb
    # round c up to a whole number of V*NB SIMD blocks (min one block) so
    # every chunk reshapes exactly; zero-value padding is the identity of
    # the extraction, so the persisted state is unchanged by the round-up
    c = max(V * nb, -(-c // (V * nb)) * (V * nb))
    chunks = pad_and_chunk(values, c)
    S, C = init_state(choose_f(chunks, spec), spec, device=values.device)
    for chunk in chunks:
        Sl, Cl = _expand_lanes(S, C, V, spec)
        S, C = _merge_lanes(*_simd_blocks(Sl, Cl, chunk.reshape(-1, nb, V),
                                          spec), spec)
    return S, C


def finalize_state(S, C, spec: ReproSpec) -> torch.Tensor:
    """Paper Eq. 1, evaluated last level first to avoid cancellation."""
    u = eft.ufp(S)
    terms = (S - 1.5 * u) + (0.25 * u) * C.to(spec.dtype)
    total = torch.zeros((), dtype=spec.dtype, device=S.device)
    for l in range(spec.L - 1, -1, -1):
        total = total + terms[l]
    return total


def conventional_sum(values, dtype=None) -> torch.Tensor:
    """The paper's CONV baseline (std::accumulate): plain float reduction."""
    values = torch.as_tensor(values)
    if dtype is not None:
        values = values.to(dtype)
    return values.sum()
