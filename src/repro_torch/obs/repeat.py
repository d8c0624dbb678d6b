"""Identical iterations traced once and counted as many times as they run.

A loop whose iterations all have one shape (the training step's
microbatch quanta, the recurrent scan's time chunks) takes its indices
from :func:`trips`.  Without a counter that honours repeats that is every
index, one at a time, and nothing else changes: a real run is the same
run whether or not it goes through here.  Under such a counter (the dry
run's, :class:`repro_torch.launch.dryrun.Counter`, on fake tensors) a loop
of ``n > 3`` iterations runs three: the first and the last, which keep
what is particular to them (an accumulator's first write, the order in
which backward adds the iterations' gradients), and iteration 1 standing
for the ``n - 2`` in the middle.  The counter multiplies what that one
dispatches by ``n - 2``:

* forward: while it runs, its factor is open (:meth:`Repeats.factor`);
* backward: the autograd nodes it created carry sequence numbers in one
  range; an op dispatched while the engine evaluates such a node
  (``torch._C._current_autograd_node``) is multiplied too.  That covers
  the node's own backward, a checkpoint's recomputation it triggers and
  the gradient additions the engine makes for its outputs.

Memory is not multiplied.  The iterations that were not run would hold
tensors of their own; the loop keeps uncounted stand-ins for them
(:func:`copies`, :func:`hold`) where the real ones would be kept, so the
trace holds at its peak what the whole loop holds.
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch

__all__ = ["Repeats", "honoured", "trips", "copies", "hold"]

_ACTIVE: Optional["Repeats"] = None


class Repeats:
    """What a counter that honours repeats keeps: the open factors, the
    closed ranges of autograd sequence numbers with theirs, and per loop
    site the trip counts it scaled (the record's ``corrected``)."""

    def __init__(self):
        self.open: list[int] = []
        self.closed: list[tuple[int, int, int]] = []
        self.sites: dict[str, dict[int, int]] = {}

    def factor(self) -> int:
        """How many times the op being dispatched now counts."""
        f = math.prod(self.open)
        if self.closed:
            node = torch._C._current_autograd_node()
            if node is not None:
                seq = node._sequence_nr()
                for lo, hi, k in self.closed:
                    if lo <= seq < hi:
                        f *= k
        return f

    @contextlib.contextmanager
    def scaled(self, k: int, site: str, n: int):
        """Count what runs inside ``k`` times, and its backward too (one
        iteration standing for ``k`` of a loop of ``n`` at ``site``).  A
        range is recorded only outside backward: nodes that a checkpoint's
        recomputation creates are never evaluated."""
        forward = torch._C._current_autograd_node() is None
        lo = torch._C._autograd._get_sequence_nr()
        self.open.append(k)
        try:
            yield
        finally:
            self.open.pop()
        hi = torch._C._autograd._get_sequence_nr()
        if forward:
            if hi > lo:
                self.closed.append((lo, hi, k))
            seen = self.sites.setdefault(site, {})
            seen[n] = seen.get(n, 0) + 1

    def corrected(self) -> dict:
        """Per site: the trip counts scaled and how many loops had each."""
        return {site: {str(n): c for n, c in sorted(seen.items())}
                for site, seen in sorted(self.sites.items())}


@contextlib.contextmanager
def honoured(repeats: Repeats):
    """Make loops run three iterations for ``repeats``' counter."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, repeats
    try:
        yield repeats
    finally:
        _ACTIVE = prev


def trips(n: int, site: str):
    """``(index, iterations it stands for)`` of a loop of ``n`` iterations
    of one shape: every index with 1, or under a counter that honours
    repeats and ``n > 3``, ``(0, 1), (1, n - 2), (n - 1, 1)`` with the
    middle one counted ``n - 2`` times (``site`` names the loop)."""
    r = _ACTIVE
    if r is None or n <= 3:
        for i in range(n):
            yield i, 1
        return
    yield 0, 1
    with r.scaled(n - 2, site, n):
        yield 1, n - 2
    yield n - 1, 1


def _map(fn, x):
    return type(x)(*(fn(t) for t in x)) if hasattr(x, "_fields") else \
        tuple(fn(t) for t in x) if isinstance(x, tuple) else fn(x)


def copies(x, n: int) -> list:
    """``n`` uninitialised tensors (or tuples of them) shaped like ``x``:
    the stand-ins for what ``n`` iterations that were not run would hold.
    Allocation moves no bytes, so the counter counts nothing for them."""
    return [_map(torch.empty_like, x) for _ in range(n)]



class _Hold(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, *held):
        ctx.save_for_backward(*held)
        ctx.n = len(held)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return (grad,) + (None,) * ctx.n


def hold(x, held: list):
    """``x`` (a tensor or a tuple of them), with the tensors of ``held``
    (tensors or tuples of them) saved for backward by the first op that
    uses it: they live as the saved inputs of checkpoints that were not
    run would live (dropped and recomputed under an enclosing checkpoint,
    as those are) until backward has gone back through that op.  Without a
    tensor in ``x`` that requires grad there is no backward to keep them
    for."""
    tensors = [t for h in held for t in (h if isinstance(h, tuple) else (h,))]
    fields = list(x) if isinstance(x, tuple) else [x]
    for i, t in enumerate(fields):
        if t.requires_grad:
            fields[i] = _Hold.apply(t, *tensors)
            break
    if not isinstance(x, tuple):
        return fields[0]
    return type(x)(*fields) if hasattr(x, "_fields") else tuple(fields)
