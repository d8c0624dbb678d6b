"""Exponent prescan: magnitude statistics that bound the live lattice levels.

One vectorized stream over the rows yields, per chunk and per column, the
exponent of the largest magnitude AND of the smallest nonzero magnitude.
From those two numbers and the lattice exponent ``e1`` we can *prove* which
extraction levels receive no bits:

* **top levels** — every value with ``|b| <= 0.5 * ulp(A_l)`` rounds to the
  extractor exactly, so a chunk whose max exponent ``Emax`` satisfies
  ``e_l >= Emax + m + 2`` contributes exactly zero to level l;
* **bottom levels** — every residual is an integer multiple of the smallest
  value ulp ``2^(Emin - m)``; once ``e_{l-1} <= Emin`` the residual entering
  level l is provably zero.

Pruned extraction over the surviving window ``[lo, hi)`` — with zeros
embedded back into the canonical full-L table — is therefore bit-identical
to the unpruned path, for any data.  Torch runs eagerly, so every input is
concrete and the ``levels="auto"`` prescan always runs.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import eft
from repro_torch.core.types import ReproSpec

__all__ = [
    "ExponentStats", "column_stats", "chunk_stats", "top_skip",
    "level_window", "static_window", "window_length", "check_levels",
]


class ExponentStats(NamedTuple):
    """Per-(chunk,)column exponent statistics from one stream over the rows.

    ``max_exp`` is the unbiased exponent of the largest |value| (the all-zero
    sentinel is ``min_exp - 1``); ``min_nz_exp`` is the unbiased exponent of
    the smallest *nonzero* |value| (the all-zero sentinel is ``max_exp + 1``,
    the exponent field of +inf).
    """

    max_exp: torch.Tensor     # int32 (..., *F)
    min_nz_exp: torch.Tensor  # int32 (..., *F)


def _stats(absv: torch.Tensor, dim: int, spec: ReproSpec) -> ExponentStats:
    amax = absv.amax(dim=dim)
    amin = torch.where(absv == 0, torch.inf, absv).amin(dim=dim)
    return ExponentStats(max_exp=eft.exponent(amax.to(spec.dtype)),
                         min_nz_exp=eft.exponent(amin.to(spec.dtype)))


def column_stats(values: torch.Tensor, spec: ReproSpec) -> ExponentStats:
    """Whole-input stats over the row axis: ``(n, *F) -> (*F,)``."""
    return _stats(values.to(spec.dtype).abs(), 0, spec)


def chunk_stats(values: torch.Tensor, chunk: int,
                spec: ReproSpec) -> ExponentStats:
    """Per-chunk stats over rows cut into ``chunk``-row blocks:
    ``(n, *F) -> (ceil(n / chunk), *F)``.

    Equal to the stats of the zero-padded chunked rows (zero padding moves
    neither the max nor the smallest nonzero magnitude), without the copy
    that padding would make.
    """
    v = values.to(spec.dtype)
    n, feat = v.shape[0], v.shape[1:]
    full = n // chunk
    parts = []
    if full:
        parts.append(_stats(v[:full * chunk].reshape(full, chunk, *feat)
                            .abs(), 1, spec))
    if n % chunk:
        tail = _stats(v[full * chunk:].abs(), 0, spec)
        parts.append(ExponentStats(tail.max_exp[None], tail.min_nz_exp[None]))
    return ExponentStats(torch.cat([p.max_exp for p in parts]),
                         torch.cat([p.min_nz_exp for p in parts]))


def top_skip(e1, max_exp, spec: ReproSpec) -> torch.Tensor:
    """Number of *leading* levels provably receiving zero from every value:
    level l is dead when ``e_l >= max_exp + m + 2``."""
    skip = torch.div(e1 - max_exp - spec.m - 2, spec.W,
                     rounding_mode="floor") + 1
    return torch.clamp(skip, 0, spec.L)


def _bottom_keep(e1, min_nz_exp, spec: ReproSpec) -> torch.Tensor:
    """First provably-dead *trailing* level: l >= (e1 - Emin)/W + 1."""
    keep = -torch.div(-(e1 - min_nz_exp), spec.W, rounding_mode="floor") + 1
    return torch.clamp(keep, 0, spec.L)


def level_window(stats: ExponentStats, e1, spec: ReproSpec):
    """Elementwise live-level window ``(lo, hi)``: levels [lo, hi) may
    receive bits; levels outside are exactly zero in the full extraction."""
    return (top_skip(e1, stats.max_exp, spec),
            _bottom_keep(e1, stats.min_nz_exp, spec))


def static_window(values: torch.Tensor, e1, spec: ReproSpec):
    """Concrete global level window: the union of every column's live
    window, as Python ints.  Degenerate inputs collapse to ``(0, 1)``."""
    if values.shape[0] == 0:
        return 0, 1
    lo_a, hi_a = level_window(column_stats(values, spec), e1, spec)
    lo, hi = int(lo_a.min()), int(hi_a.max())
    if lo >= hi:
        return 0, 1
    return lo, hi


def window_length(levels, spec: ReproSpec) -> int:
    lo, hi = levels if levels is not None else (0, spec.L)
    return hi - lo


def check_levels(levels, spec: ReproSpec) -> tuple[int, int]:
    """Validate/normalize a static level window to concrete ints."""
    if levels is None:
        return 0, spec.L
    lo, hi = int(levels[0]), int(levels[1])
    if not (0 <= lo < hi <= spec.L):
        raise ValueError(f"level window {levels!r} not within [0, {spec.L}]")
    return lo, hi
