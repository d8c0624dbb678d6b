"""Accumulators and partial states carried across from, and back to, the
JAX package.

A state is its leaves — ``table.k``, ``table.C``, ``table.e1``, ``minv``,
``maxv``, ``rows`` — plus its signature's JSON (``AggSignature.to_json``,
the same bytes in both packages).  Tables keep their int32/int64 dtypes and
every leaf keeps its shape, so the bytes move unchanged and a carried state
merges and finalizes as if the port had computed it.

Model weights cross as nested dicts of arrays with the JAX package's keys
and shapes (:func:`lm_params_from_numpy`, :func:`lm_params_to_numpy`), so
both packages compute from the same weights.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import tree as tree_mod
from repro_torch.core.accumulator import ReproAcc
from repro_torch.core.types import ReproSpec
from repro_torch.device import resolve_device
from repro_torch.ops.partial import AggSignature, PartialState

__all__ = ["LEAVES", "acc_from_numpy", "acc_to_numpy", "state_from_numpy",
           "state_to_numpy", "lm_params_from_numpy", "lm_params_to_numpy"]

LEAVES = ("k", "C", "e1", "minv", "maxv", "rows")


def _tensors(leaves, names, dtypes, dev):
    """numpy leaves -> tensors on ``dev``, each of its expected dtype."""
    out = []
    for a, name, dt in zip(leaves, names, dtypes):
        t = torch.from_numpy(np.array(a)).to(dev)
        if t.dtype != dt:
            raise ValueError(f"leaf {name} has dtype {t.dtype}, the spec "
                             f"wants {dt}")
        out.append(t)
    return out


def acc_from_numpy(leaves, spec: ReproSpec, device=None) -> ReproAcc:
    """The port's :class:`ReproAcc` from a reference ``ReproAcc`` (or any
    ``(k, C, e1)`` of numpy leaves); the dtypes must be the spec's."""
    return ReproAcc(*_tensors(leaves, LEAVES[:3], (
        spec.int_dtype, spec.int_dtype, torch.int32), resolve_device(device)))


def acc_to_numpy(acc: ReproAcc):
    """``(k, C, e1)`` as numpy arrays, the leaves of a reference
    ``ReproAcc``."""
    return tuple(t.detach().cpu().numpy() for t in acc)


def state_from_numpy(leaves, sig_json: dict, device=None) -> PartialState:
    """Build the port's :class:`PartialState` from numpy leaves, given in
    the order of ``LEAVES`` or as a mapping with those names."""
    if isinstance(leaves, dict):
        leaves = [leaves[name] for name in LEAVES]
    sig = AggSignature.from_json(sig_json)
    idt, fdt = sig.spec.int_dtype, sig.spec.dtype
    k, C, e1, minv, maxv, rows = _tensors(
        leaves, LEAVES, (idt, idt, torch.int32, fdt, fdt, torch.int32),
        resolve_device(device))
    return PartialState(table=ReproAcc(k=k, C=C, e1=e1), minv=minv,
                        maxv=maxv, rows=rows, sig=sig)


def state_to_numpy(state: PartialState):
    """``(leaves, sig_json)``: numpy leaves in the order of ``LEAVES`` and
    the signature's JSON."""
    leaves = tuple(t.detach().cpu().numpy() for t in (
        state.table.k, state.table.C, state.table.e1, state.minv,
        state.maxv, state.rows))
    return leaves, state.sig.to_json()


def _tensor_of(a) -> torch.Tensor:
    """A numpy array (bfloat16 ones through their 16 bits) as a tensor."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def lm_params_from_numpy(tree, device=None):
    """The port's parameter tree from the JAX package's ``init_params`` tree
    as numpy arrays (``jax.tree.map(np.asarray, params)``): the same keys,
    shapes, dtypes and bits, on ``device``."""
    dev = resolve_device(device)
    return tree_mod.tree_map(lambda a: _tensor_of(a).to(dev), tree)


def _array_of(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes       # numpy's bfloat16 (a dependency of JAX)
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy().copy()


def lm_params_to_numpy(params):
    """Inverse of :func:`lm_params_from_numpy`: a nested dict of numpy
    arrays (bfloat16 as ``ml_dtypes.bfloat16``)."""
    return tree_mod.tree_map(_array_of, params)
