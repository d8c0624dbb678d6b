"""Plain-torch oracles for the flat reproducible-sum kernel."""
from __future__ import annotations

import torch

from repro_torch.core import accumulator as acc_mod
from repro_torch.core.accumulator import ReproAcc
from repro_torch.core.types import ReproSpec

__all__ = ["rsum_ref", "rsum_acc_ref", "rsum_table_ref"]


def rsum_acc_ref(x, spec: ReproSpec = ReproSpec()) -> ReproAcc:
    """Canonical accumulator of sum(x) — must match ops.rsum_acc bitwise."""
    return acc_mod.from_values(x, spec)


def rsum_ref(x, spec: ReproSpec = ReproSpec()) -> torch.Tensor:
    return acc_mod.finalize(rsum_acc_ref(x, spec), spec)


def rsum_table_ref(values, spec: ReproSpec = ReproSpec(), e1=None) -> ReproAcc:
    """Stacked (1, ncols, L) oracle — must match ops.rsum_table bitwise."""
    values = torch.as_tensor(values).to(spec.dtype)
    if values.ndim == 1:
        values = values[:, None]
    acc = acc_mod.from_values(values, spec, axis=0, e1=e1)   # (ncols, L)
    return ReproAcc(k=acc.k[None], C=acc.C[None], e1=acc.e1[None])
