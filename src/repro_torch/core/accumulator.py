"""The associative reproducible accumulator (paper §III/§IV).

Canonical representation: a level sum S^(l) of the paper is stored as
``A(e_l) + k_l * ulp(e_l)`` with

* ``k``  — int window offsets, invariant ``0 <= k < 2^(m-2)`` (canonical
           euclidean decomposition, restored by :func:`renorm` after every
           reduction so ``finalize`` is a pure function of the value),
* ``C``  — int carry counters in units of ``0.25 * ufp = 2^(m-2) ulp``,
* ``e1`` — the level-1 extractor exponent, always on the lattice ``W * Z``
           so any two accumulators have alignable level sets.

All arithmetic between extraction and finalization is integer arithmetic,
hence exact, associative and commutative: any reduction tree produces
bit-identical results.  Tables are int32 for float32 specs and int64 for
float64 specs, with an int32 ``e1``: the same dtypes as the JAX package, so
tables move between the two packages byte for byte.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import eft
from repro_torch.core.types import ReproSpec

__all__ = [
    "ReproAcc", "zeros", "extract", "pad_levels", "renorm", "from_values",
    "merge", "merge_all", "add_values", "finalize", "demote_to",
    "required_e1", "to_paper_state", "from_paper_state",
]


class ReproAcc(NamedTuple):
    """Accumulator; leading dims are batch dims, last dim is L."""

    k: torch.Tensor    # int (..., L) window offsets, canonical in [0, 2^(m-2))
    C: torch.Tensor    # int (..., L) carry counts (units of 2^(m-2) ulp)
    e1: torch.Tensor   # int32 (...)  lattice exponent of level 1

    @property
    def batch_shape(self):
        return self.k.shape[:-1]


def zeros(spec: ReproSpec, shape=(), device=None) -> ReproAcc:
    """An empty accumulator at the bottom of the lattice (identity of merge)."""
    idt = spec.int_dtype
    return ReproAcc(
        k=torch.zeros((*shape, spec.L), dtype=idt, device=device),
        C=torch.zeros((*shape, spec.L), dtype=idt, device=device),
        e1=torch.full(tuple(shape), spec.lattice_lo, dtype=torch.int32,
                      device=device),
    )


def required_e1(values: torch.Tensor, spec: ReproSpec, axis=None,
                keepdims: bool = False) -> torch.Tensor:
    """Lattice e1 admitting every value: from the exponent of max |b|."""
    a = values.abs()
    if axis is None:
        amax = a.amax() if a.numel() else a.new_zeros(())
    else:
        amax = a.amax(dim=axis, keepdim=keepdims)
    # exponent() of 0 is min_exp - 1 (all-zero exp field), harmless under clamp
    e = eft.exponent(amax.to(spec.dtype))
    return spec.clamp_e1(spec.lattice_e1(e)).to(torch.int32)


def extract(values: torch.Tensor, e1, spec: ReproSpec,
            levels: tuple[int, int] | None = None) -> torch.Tensor:
    """Per-element contributions as exact ints: k int[..., hi - lo].

    ``values`` float (...), ``e1`` int32 broadcastable to values.shape.
    ``levels = (lo, hi)`` restricts extraction to a prescan-proved window
    (see :mod:`repro_torch.core.prescan`); the result then equals the
    corresponding slice of the full extraction bit for bit.
    """
    lo, hi = levels if levels is not None else (0, spec.L)
    values = values.to(spec.dtype)
    e1 = torch.as_tensor(e1, dtype=torch.int32, device=values.device)
    r = values
    ks = []
    for l in range(lo, hi):
        e_l = e1 - l * spec.W
        A = eft.extractor(e_l, spec.dtype)
        q, r = eft.eft_fixed(A, r)
        ks.append((q * eft.pow2(spec.m - e_l, spec.dtype)).to(spec.int_dtype))
    return torch.stack(ks, dim=-1)


def pad_levels(k: torch.Tensor, levels: tuple[int, int] | None,
               spec: ReproSpec) -> torch.Tensor:
    """Embed a level-window array ``(..., hi - lo)`` into the canonical
    ``(..., L)`` layout with exact zeros on the pruned levels."""
    if levels is None:
        return k
    lo, hi = levels
    if (lo, hi) == (0, spec.L):
        return k
    out = k.new_zeros((*k.shape[:-1], spec.L))
    out[..., lo:hi] = k
    return out


def renorm(k: torch.Tensor, C: torch.Tensor, spec: ReproSpec):
    """Restore the canonical window invariant k in [0, 2^(m-2)).

    ``>>`` on signed integer tensors is an arithmetic shift (floor
    division), so the decomposition is euclidean and unique.
    """
    shift = spec.m - 2
    d = k >> shift
    return k - (d << shift), C + d.to(C.dtype)


def _tree_sum(k: torch.Tensor, C: torch.Tensor, spec: ReproSpec, axis: int):
    """Exact, order-independent reduction of (k, C) partials along ``axis``.

    Sums in groups of ``spec.tree_group`` with a renormalization between
    rounds so window offsets never overflow the integer dtype; every sum is
    pinned to the table's int dtype.
    """
    g = spec.tree_group
    k = torch.movedim(k, axis, 0)
    C = torch.movedim(C, axis, 0)
    while k.shape[0] > 1:
        n = k.shape[0]
        pad = (-n) % g
        if pad:
            k = torch.cat([k, k.new_zeros((pad, *k.shape[1:]))], 0)
            C = torch.cat([C, C.new_zeros((pad, *C.shape[1:]))], 0)
        rows = k.shape[0] // g
        k = k.reshape(rows, g, *k.shape[1:]).sum(dim=1, dtype=k.dtype)
        C = C.reshape(rows, g, *C.shape[1:]).sum(dim=1, dtype=C.dtype)
        k, C = renorm(k, C, spec)
    if k.shape[0] == 0:
        return (k.new_zeros(k.shape[1:]), C.new_zeros(C.shape[1:]))
    return renorm(k[0], C[0], spec)


def from_values(values, spec: ReproSpec, axis=None, e1=None) -> ReproAcc:
    """Reproducible sum of ``values`` over ``axis`` (default: all axes).

    Two logical passes, as in Demmel–Nguyen: (1) max -> lattice e1,
    (2) extract + exact integer reduction.  The result is independent of
    any ordering or regrouping of ``values`` along the reduced axes.
    """
    values = torch.as_tensor(values).to(spec.dtype)
    if axis is None:
        values = values.reshape(-1)
        axis = 0
    axis = axis % values.ndim
    batch_shape = values.shape[:axis] + values.shape[axis + 1:]
    if e1 is None:
        e1_b = required_e1(values, spec, axis=axis)     # (batch,)
    else:
        e1_b = torch.as_tensor(e1, dtype=torch.int32,
                               device=values.device).expand(batch_shape)
    k = extract(values, e1_b.unsqueeze(axis), spec)     # (..., L)
    k, C = _tree_sum(k, torch.zeros_like(k), spec, axis=axis)
    return ReproAcc(k=k, C=C, e1=e1_b)


def demote_to(acc: ReproAcc, e1_new, spec: ReproSpec) -> ReproAcc:
    """Shift an accumulator onto a coarser lattice point (paper Alg.2 l.5-7).

    New top levels are exactly zero; the bottom ``s = (e1_new - e1)/W``
    levels are discarded — the paper's demotion, order-independent.
    """
    e1_new = torch.as_tensor(e1_new, dtype=torch.int32,
                             device=acc.e1.device)
    s = torch.div(e1_new - acc.e1, spec.W, rounding_mode="floor")
    if acc.e1.ndim == 0 and e1_new.ndim == 0:
        # per-tensor lattice: the shift is clamped into [0, L]
        s = torch.clamp(s, 0, spec.L)
    # new level i takes old level i - s (zero where i - s < 0), selected
    # level by level: no index tensor of the accumulator's size is built
    # (a per-element e1 would make it (..., L) int64)
    zero = acc.k.new_zeros(())
    ks, Cs = [], []
    for i in range(spec.L):
        src = i - s
        valid = src >= 0
        src = torch.clamp(src, 0, spec.L - 1)
        ki = Ci = zero
        for j in range(spec.L):
            pick = valid & (src == j)
            ki = torch.where(pick, acc.k[..., j], ki)
            Ci = torch.where(pick, acc.C[..., j], Ci)
        ks.append(ki.expand(acc.k.shape[:-1]))
        Cs.append(Ci.expand(acc.C.shape[:-1]))
    return ReproAcc(k=torch.stack(ks, dim=-1), C=torch.stack(Cs, dim=-1),
                    e1=e1_new)


def merge(a: ReproAcc, b: ReproAcc, spec: ReproSpec) -> ReproAcc:
    """Exact associative merge (the paper's operator+=(repro) analogue)."""
    e1 = torch.maximum(a.e1, b.e1)
    a = demote_to(a, e1, spec)
    b = demote_to(b, e1, spec)
    k, C = renorm(a.k + b.k, a.C + b.C, spec)
    return ReproAcc(k=k, C=C, e1=e1)


def merge_all(accs, spec: ReproSpec) -> ReproAcc:
    """Exact k-way merge of same-shape accumulators: one demotion onto the
    elementwise-max lattice, then one integer tree reduction — bit-identical
    to any pairwise :func:`merge` fold over the same accumulators."""
    accs = list(accs)
    if not accs:
        raise ValueError("merge_all needs at least one accumulator")
    if len(accs) == 1:
        return accs[0]
    e1 = accs[0].e1
    for a in accs[1:]:
        e1 = torch.maximum(e1, a.e1)
    demoted = [demote_to(a, e1, spec) for a in accs]
    k = torch.stack([a.k for a in demoted], dim=0)
    C = torch.stack([a.C for a in demoted], dim=0)
    k, C = _tree_sum(k, C, spec, axis=0)
    return ReproAcc(k=k, C=C, e1=e1)


def add_values(acc: ReproAcc, values, spec: ReproSpec, axis=None) -> ReproAcc:
    """Streaming add of a batch of values (paper's operator+=(ScalarT)).

    Demotes the accumulator first if the batch max exceeds the admission
    threshold of its current lattice — the vectorized analogue of Alg.3
    line 4 (one max check per batch instead of per element).
    """
    return merge(acc, from_values(values, spec, axis=axis), spec)


def _level_exponents(e1: torch.Tensor, spec: ReproSpec) -> torch.Tensor:
    return e1[..., None] - torch.arange(
        spec.L, dtype=torch.int32, device=e1.device) * spec.W


def finalize(acc: ReproAcc, spec: ReproSpec) -> torch.Tensor:
    """Deterministic conversion to a float (paper Eq. 1).

    Summed from the last (finest) level up, in the accumulator's dtype, one
    eager operation at a time (no fused multiply-add).  Only this step
    rounds; it is a pure function of the canonical (k, C, e1).
    """
    dt = spec.dtype
    es = _level_exponents(acc.e1, spec)
    q = (acc.C.to(dt) * eft.pow2(es - 2, dt)
         + acc.k.to(dt) * eft.pow2(es - spec.m, dt))
    total = torch.zeros(acc.batch_shape, dtype=dt, device=acc.k.device)
    for l in range(spec.L - 1, -1, -1):
        total = total + q[..., l]
    return total


def to_paper_state(acc: ReproAcc, spec: ReproSpec):
    """Exact conversion to the paper's <S[L], C[L]> float representation."""
    es = _level_exponents(acc.e1, spec)
    A = eft.extractor(es, spec.dtype)
    S = A + acc.k.to(spec.dtype) * eft.pow2(es - spec.m, spec.dtype)
    return S, acc.C


def from_paper_state(S, C, e1, spec: ReproSpec) -> ReproAcc:
    """Exact inverse of :func:`to_paper_state` (S must lie in its window)."""
    S = torch.as_tensor(S)
    e1 = torch.as_tensor(e1, dtype=torch.int32, device=S.device)
    es = _level_exponents(e1, spec)
    A = eft.extractor(es, spec.dtype)
    k = ((S - A) * eft.pow2(spec.m - es, spec.dtype)).to(spec.int_dtype)
    k, C = renorm(k, torch.as_tensor(C, device=S.device).to(spec.int_dtype),
                  spec)
    return ReproAcc(k=k, C=C, e1=e1)
