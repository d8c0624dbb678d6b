"""The plain reference of a GROUP BY of SUM, AVG and COUNT: per-group sums
in plain torch, by default in float64.

It imports nothing of the program.  Small group counts are summed one group
at a time with ``torch.sum`` (a tree reduction: its rounding in float64 is
some 1e-15 of the sum, far below a float32 ulp); large group counts with
``index_add_``, where each group gets a handful of rows.  ``dtype`` sets the
precision the whole computation runs in: ``torch.bfloat16`` makes the
lower-precision control that ``checks.py`` has to refuse.

Result names: ``sum(<col>)``, ``mean(<col>)`` and ``count(*)``, each a (G,)
tensor in ``dtype``; a group with no rows has the mean NaN.
"""
from __future__ import annotations

import torch

SMALL_G = 64       # at most this many groups: one torch.sum per group


def group_sums(x: torch.Tensor, keys: torch.Tensor, groups: int
               ) -> torch.Tensor:
    """(G, C) sums of the rows of ``x`` (n, C) by ``keys``, in x's dtype."""
    if groups <= SMALL_G:
        return torch.stack([x[keys == g].sum(dim=0) for g in range(groups)])
    out = torch.zeros((groups, x.shape[1]), dtype=x.dtype, device=x.device)
    return out.index_add_(0, keys.to(torch.int64), x)


def results(values: torch.Tensor, keys: torch.Tensor, groups: int, aggs,
            dtype=torch.float64) -> dict:
    aggs = [tuple(a) for a in aggs]
    for a in aggs:
        if a[0] not in ("sum", "mean", "count"):
            raise NotImplementedError(f"no plain reference for {a!r}")
    cols = sorted({a[1] for a in aggs if a[0] != "count"})
    x = torch.cat([values[:, cols].to(dtype),
                   torch.ones((values.shape[0], 1), dtype=dtype,
                              device=values.device)], dim=1)
    sums = group_sums(x, keys, groups)
    del x
    count = sums[:, -1]
    out = {}
    for a in aggs:
        if a[0] == "count":
            out["count(*)"] = count
        elif a[0] == "sum":
            out[f"sum({a[1]})"] = sums[:, cols.index(a[1])]
        else:
            out[f"mean({a[1]})"] = sums[:, cols.index(a[1])] / count
    return out
