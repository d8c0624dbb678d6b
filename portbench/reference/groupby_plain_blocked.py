"""The plain reference of a GROUP BY of SUM, AVG and COUNT over a table too
large to widen at once: ``groupby_plain.py``'s semantics and result names,
summed over blocks of at most :data:`BLOCK_ROWS` rows.

It imports nothing of the program.  Each block's rows are widened to
``dtype`` (float64 by default) and summed by ``groupby_plain.group_sums``
(a tree reduction a group at a time); the blocks' sums are added in
``dtype``, in block order.  In float64 a block's sum is off by some 1e-15
of itself and each of the few dozen additions of blocks by at most
1.1e-16, so a result is within ~1e-15 of the exact sum: far below a
float32 ulp (6e-8).  A block's widened columns take 1.3 GB in float64,
where the whole of 591.6 M rows would take some 57 GB of temporaries.
``dtype=torch.bfloat16`` gives the lower-precision control.

Result names: ``sum(<col>)``, ``mean(<col>)`` and ``count(*)``, each a (G,)
tensor in ``dtype``; a group with no rows has the mean NaN.
"""
from __future__ import annotations

import torch

from portbench.reference.groupby_plain import group_sums

BLOCK_ROWS = 1 << 25


def results(values: torch.Tensor, keys: torch.Tensor, groups: int, aggs,
            dtype=torch.float64, block_rows: int = BLOCK_ROWS) -> dict:
    aggs = [tuple(a) for a in aggs]
    for a in aggs:
        if a[0] not in ("sum", "mean", "count"):
            raise NotImplementedError(f"no plain reference for {a!r}")
    cols = sorted({a[1] for a in aggs if a[0] != "count"})
    sums = torch.zeros((groups, len(cols) + 1), dtype=dtype,
                       device=values.device)
    for start in range(0, values.shape[0], block_rows):
        block = values[start:start + block_rows]
        x = torch.cat([block[:, cols].to(dtype),
                       torch.ones((block.shape[0], 1), dtype=dtype,
                                  device=values.device)], dim=1)
        sums += group_sums(x, keys[start:start + block_rows], groups)
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
