"""What decides ``correct``: the numbers compared and their limits.

Three numbers, each against the limit the configuration file states
(``limits``):

* ``max_err_ulp``: the widest gap between a result of the window and the
  plain reference's (float64) value, in units in the last place of a
  float32 at the reference's value, over every result of every group;
* ``window_diff``: result values of the window's sampled answers (the
  first, two drawn from the seed, the last) whose bits differ from the
  first answer's -- the guarantee "the same bits for every run"; where the
  cell runs as several ranks, also those of each other rank's first answer
  -- "every card returns the same bits";
* ``perm_diff``: result values whose bits differ between the window's first
  answer and the answer over a seeded permutation of the rows, run after
  the window -- the guarantee "the same bits for any row order" (across
  ranks, the permuted rows are dealt out again in equal shares: "and for
  any split of the rows").

A result name missing on one side, or a NaN or infinity where the reference
has a number, reads as an infinite gap.
"""
from __future__ import annotations

import math

import torch

NAMES = ("max_err_ulp", "window_diff", "perm_diff")
_BITS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def ulp32(ref: torch.Tensor) -> torch.Tensor:
    """The spacing of float32 numbers at each float64 value of ``ref``
    (2^-149 below the normal range)."""
    exp = torch.frexp(ref.abs()).exponent
    ulp = torch.ldexp(torch.ones_like(ref), exp - 24)
    return torch.clamp(ulp, min=2.0 ** -149)


def max_err_ulp(got: dict, ref: dict) -> float:
    if set(got) != set(ref):
        return math.inf
    worst = 0.0
    for name, r in ref.items():
        r = r.to(torch.float64)
        g = got[name].to(device=r.device, dtype=torch.float64)
        if g.shape != r.shape:
            return math.inf
        err = (g - r).abs() / ulp32(r)
        err = torch.where(torch.isnan(g) & torch.isnan(r),
                          torch.zeros_like(err), err)
        err = torch.nan_to_num(err, nan=math.inf)
        if err.numel():
            worst = max(worst, float(err.max()))
    return worst


def bit_diff(a: dict, b: dict) -> int:
    """Result values whose bits differ between two answers (a name on one
    side only counts all its values)."""
    diff = 0
    for name in set(a) | set(b):
        if name not in a or name not in b:
            diff += (a.get(name) if name in a else b[name]).numel()
            continue
        x, y = a[name], b[name]
        if x.dtype != y.dtype or x.shape != y.shape:
            diff += max(x.numel(), y.numel())
            continue
        bits = _BITS[x.element_size()]
        diff += int((x.contiguous().view(bits) != y.contiguous().view(bits))
                    .sum())
    return diff


def compare(window: list, permuted: dict, ref: dict, limits: dict,
            others=()) -> dict:
    """The numbers and their limits: ``{name: {"value", "limit"}}``.
    ``window`` holds the window's sampled answers, first answer first;
    ``others`` the other ranks' first answers."""
    first = window[0]
    values = {
        "max_err_ulp": max(max_err_ulp(w, ref) for w in window),
        "window_diff": sum(bit_diff(first, w)
                           for w in [*window[1:], *others]),
        "perm_diff": bit_diff(first, permuted),
    }
    return {k: {"value": values[k], "limit": limits[k]} for k in NAMES}


def passed(numbers: dict) -> bool:
    """Every number within its limit (a limit not yet set passes none)."""
    return all(n["limit"] is not None and n["value"] <= n["limit"]
               for n in numbers.values())
