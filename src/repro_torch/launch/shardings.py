"""Where the ZeRO shard of each parameter lies.

The JAX package's sharding rules, cut to what ZeRO-2 needs with a model
axis of size 1.  A spec is a tuple with one entry per tensor dimension:
``None``, ``"model"`` or a data-axis name.  ``param_pspec`` gives the
tensor-parallel layout (Megatron style: embeddings vocab-sharded, column-
and row-parallel projections), ``validate_pspec`` drops entries whose axis
does not divide the dimension, and ``zero_pspec`` puts the data axis on
the first free dimension it divides — the dimension the optimizer state,
master weights and gradient shards of ``repro_zero2`` are cut along.
Paths are tuples of dict keys (:func:`repro_torch.tree.paths`); stacked
block weights carry a leading unit axis.
"""
from __future__ import annotations

from typing import Optional

__all__ = ["param_pspec", "zero_pspec", "validate_pspec", "zero_dim"]

_COL = {"wq", "wk", "wv", "w_gate", "w_up", "w_in", "w_zifo", "w_gates"}
_ROW = {"wo", "w_down", "w_out", "w_bcdt"}
_VOCAB = {"embed", "lm_head"}


def param_pspec(path: tuple, ndim: int) -> tuple:
    names = tuple(str(p) for p in path)
    last = names[-1] if names else ""

    def with_stack(tail):
        """prepend Nones so the tail aligns to the last dims"""
        return (None,) * (ndim - len(tail)) + tuple(tail)

    if last in _VOCAB:
        return ("model", None)
    if "moe" in names and last in {"w_gate", "w_up", "w_down"}:
        return with_stack(["model", None, None])
    if last == "router":
        return with_stack([None, None])
    if last in _COL:
        return with_stack([None, "model"])
    if last in _ROW:
        return with_stack(["model", None])
    return (None,) * ndim                 # norms, scalars, vectors


def validate_pspec(pspec: tuple, shape, axis_sizes: dict) -> tuple:
    """Drop entries whose mesh-axis product does not divide the dim."""
    entries = tuple(pspec) + (None,) * (len(shape) - len(pspec))
    out = []
    for dim, e in zip(shape, entries):
        if e is None:
            out.append(None)
            continue
        names = e if isinstance(e, (tuple, list)) else (e,)
        factor = 1
        for n in names:
            factor *= axis_sizes[n]
        out.append(e if dim % factor == 0 else None)
    return tuple(out)


def zero_pspec(path: tuple, shape, data_size: int, dp=("data",),
               axis_sizes: Optional[dict] = None) -> tuple:
    """Sharding for optimizer-state / master copies of this parameter:
    the (validated) param spec + the data axis on the first eligible dim."""
    base = param_pspec(path, len(shape))
    if axis_sizes is not None:
        base = validate_pspec(base, shape, axis_sizes)
    entries = list(base) + [None] * (len(shape) - len(base))
    dp_entry = tuple(dp) if len(dp) > 1 else dp[0]
    for i, (dim, e) in enumerate(zip(shape, entries)):
        if e is None and dim % data_size == 0 and dim >= data_size:
            entries[i] = dp_entry
            return tuple(entries)
    return tuple(base)                    # small leaf: stays unsharded


def zero_dim(path: tuple, shape, data_size: int) -> Optional[int]:
    """The tensor dim carrying the ZeRO shard (None = replicated), with a
    model axis of size 1."""
    sizes = {"data": data_size, "model": 1}
    spec = zero_pspec(path, shape, data_size, ("data",), sizes)
    base = validate_pspec(param_pspec(path, len(shape)), shape, sizes)
    for i, (e, b) in enumerate(zip(spec, base)):
        if e is not None and b is None:
            return i
    return None
