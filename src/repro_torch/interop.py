"""Partial states carried across from, and back to, the JAX package.

A state is its leaves — ``table.k``, ``table.C``, ``table.e1``, ``minv``,
``maxv``, ``rows`` — plus its signature's JSON (``AggSignature.to_json``,
the same bytes in both packages).  Tables keep their int32/int64 dtypes and
every leaf keeps its shape, so the bytes move unchanged and a carried state
merges and finalizes as if the port had computed it.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.accumulator import ReproAcc
from repro_torch.device import resolve_device
from repro_torch.ops.partial import AggSignature, PartialState

__all__ = ["LEAVES", "state_from_numpy", "state_to_numpy"]

LEAVES = ("k", "C", "e1", "minv", "maxv", "rows")


def state_from_numpy(leaves, sig_json: dict, device=None) -> PartialState:
    """Build the port's :class:`PartialState` from numpy leaves, given in
    the order of ``LEAVES`` or as a mapping with those names."""
    dev = resolve_device(device)
    if isinstance(leaves, dict):
        leaves = [leaves[name] for name in LEAVES]
    k, C, e1, minv, maxv, rows = (
        torch.from_numpy(np.array(a)).to(dev) for a in leaves)
    sig = AggSignature.from_json(sig_json)
    idt, fdt = sig.spec.int_dtype, sig.spec.dtype
    for name, t, dt in (("k", k, idt), ("C", C, idt), ("e1", e1, torch.int32),
                        ("minv", minv, fdt), ("maxv", maxv, fdt),
                        ("rows", rows, torch.int32)):
        if t.dtype != dt:
            raise ValueError(f"leaf {name} has dtype {t.dtype}, the "
                             f"signature wants {dt}")
    return PartialState(table=ReproAcc(k=k, C=C, e1=e1), minv=minv,
                        maxv=maxv, rows=rows, sig=sig)


def state_to_numpy(state: PartialState):
    """``(leaves, sig_json)``: numpy leaves in the order of ``LEAVES`` and
    the signature's JSON."""
    leaves = tuple(t.detach().cpu().numpy() for t in (
        state.table.k, state.table.C, state.table.e1, state.minv,
        state.maxv, state.rows))
    return leaves, state.sig.to_json()
