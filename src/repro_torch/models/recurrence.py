"""Time-chunked recurrent scan with gradient checkpointing.

A plain loop over S timesteps keeps every carried state for the backward
pass — for mLSTM's (B, H, hd, hd) matrix memory that is S x 1 MB of
residuals per block.  Scanning over chunks of :data:`TIME_CHUNK` steps,
each recomputed in backward (``torch.utils.checkpoint``, the JAX
package's ``jax.checkpoint``), keeps only the per-chunk boundary states
for a ~2x recompute of the (cheap, element-wise) recurrence.  Without
autograd (``no_grad``, ``inference_mode``) the chunks run plainly.

``step(state, xs_t) -> (state, y_t)``: ``state`` is a tensor or a
NamedTuple of tensors, ``xs`` a tensor or a tuple of tensors with a
leading time axis, ``y_t`` a tensor or a tuple of tensors.  The ``ys``
come back stacked on a leading time axis, as ``lax.scan`` stacks them.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

__all__ = ["TIME_CHUNK", "scan", "chunked_time_scan"]

TIME_CHUNK = 64


def _at(xs, t):
    return tuple(x[t] for x in xs) if isinstance(xs, tuple) else xs[t]


def _like(proto: tuple, items) -> tuple:
    """A tuple (or NamedTuple) of ``proto``'s type holding ``items``."""
    items = list(items)
    return type(proto)(*items) if hasattr(proto, "_fields") else tuple(items)


def _stack(ys: list):
    if isinstance(ys[0], tuple):
        return _like(ys[0], (torch.stack(ts) for ts in zip(*ys)))
    return torch.stack(ys)


def _cat(parts: list):
    if isinstance(parts[0], tuple):
        return _like(parts[0], (torch.cat(ts) for ts in zip(*parts)))
    return torch.cat(parts)


def _slice(xs, lo: int, hi: int):
    return tuple(x[lo:hi] for x in xs) if isinstance(xs, tuple) \
        else xs[lo:hi]


def scan(step, state, xs):
    """``lax.scan(step, state, xs)``: one ``step`` per timestep, in
    order."""
    S = (xs[0] if isinstance(xs, tuple) else xs).shape[0]
    ys = []
    for t in range(S):
        state, y = step(state, _at(xs, t))
        ys.append(y)
    return state, _stack(ys)


def chunked_time_scan(step, state0, xs, chunk: int = TIME_CHUNK):
    """:func:`scan` with checkpointed time chunks of ``chunk`` steps; the
    remainder runs as an exact tail pass (padding would corrupt the final
    carry).  Same steps in the same order as :func:`scan`, so the same
    bits."""
    S = (xs[0] if isinstance(xs, tuple) else xs).shape[0]
    if S <= chunk:
        return scan(step, state0, xs)
    remat = torch.is_grad_enabled()
    st, parts = state0, []
    for lo in range(0, S - S % chunk, chunk):
        xc = _slice(xs, lo, lo + chunk)
        if remat:
            st, ys = checkpoint(scan, step, st, xc, use_reentrant=False)
        else:
            st, ys = scan(step, st, xc)
        parts.append(ys)
    if S % chunk:
        st, tail = scan(step, st, _slice(xs, S - S % chunk, S))
        parts.append(tail)
    return st, _cat(parts)
