"""Tensor parallelism over the ``model`` axis, with its collectives stated.

The JAX package lays parameters out Megatron style over the mesh's
``model`` axis (``launch/shardings.py``) and lets GSPMD place the
collectives.  The port places them itself, here, as autograd functions:

* :func:`copy_to_model`: identity forward; the backward sums the model
  ranks' partial gradients (the input of a column-parallel product);
* :func:`reduce_from_model`: sums the ranks' partial outputs (the output
  of a row-parallel product); identity backward;
* :func:`gather_from_model` / :func:`scatter_to_model`: concatenate the
  ranks' shards along a dimension / take this rank's shard of a
  replicated tensor (each the other's backward; no float is added);
* :func:`vocab_logsumexp` and :func:`vocab_argmax` over a vocabulary
  split in contiguous shards.

Every float sum across model ranks is
:func:`repro_torch.core.collectives.model_sum`: an all-gather followed by
a sum in model-rank order, ``((x0 + x1) + x2) + ...``, never a backend
``all_reduce``: every model rank then holds the same bits (so replicated
parameters stay equal across the axis after every update), and gloo on
the CPU, gloo with card tensors and NCCL give the same bits.  Maxima and
argmaxima are exact; an argmax tie goes to the lowest global index.

A :class:`TP` of size 1, or ``None``, makes every function return its
input: a model that runs without tensor parallelism keeps its bits.
Layers find whether a weight is a shard from its shape (:func:`split`).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.collectives import TP, model_active as active
from repro_torch.core.collectives import model_all_gather, model_stack, \
    model_sum
from repro_torch.models.config import ModelConfig

__all__ = ["TP", "active", "split", "attn_heads_split", "copy_to_model",
           "reduce_from_model", "gather_from_model", "scatter_to_model",
           "column", "row", "vocab_logsumexp", "vocab_argmax"]


def split(tp: Optional[TP], local: int, full: int) -> Optional[TP]:
    """``tp`` where a dimension of ``full`` entries is held as a shard of
    ``local`` entries (the layout split it over the model axis); ``None``
    where it is held whole (replicated)."""
    return tp if active(tp) and local != full else None


def attn_heads_split(cfg: ModelConfig, model_size: int) -> bool:
    """Whether attention runs head-parallel at this model size.

    ``cfg.attn_shard``: ``"replicate"`` keeps attention whole on every
    rank; ``"heads"`` splits the query and KV heads (both counts must
    divide the model size); ``"auto"`` splits them where both divide and
    replicates otherwise.  The port never splits a head (the JAX
    package's layout cuts smollm's 576-wide ``wq`` mid-head and lets GSPMD
    reshard)."""
    fits = cfg.n_heads % model_size == 0 and \
        cfg.n_kv_heads % model_size == 0
    if model_size == 1 or cfg.attn_shard == "replicate":
        return False
    if cfg.attn_shard == "heads" and not fits:
        raise ValueError(
            f"{cfg.name}: attn_shard='heads' needs n_heads {cfg.n_heads} "
            f"and n_kv_heads {cfg.n_kv_heads} to divide the model axis "
            f"({model_size})")
    if cfg.attn_shard not in ("auto", "heads"):
        raise ValueError(f"attn_shard {cfg.attn_shard!r} not in "
                         "('auto', 'heads', 'replicate')")
    return fits


# ---------------------------------------------------------------------------
# autograd functions
# ---------------------------------------------------------------------------

def _shard(x: torch.Tensor, tp: TP, dim: int) -> torch.Tensor:
    n = x.shape[dim] // tp.size
    return x.narrow(dim, tp.rank * n, n).contiguous()

class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return model_sum(g, ctx.tp), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return model_sum(x, tp)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        return model_all_gather(x, tp, dim)

    @staticmethod
    def backward(ctx, g):
        return _shard(g, ctx.tp, ctx.dim), None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        return _shard(x, tp, dim)

    @staticmethod
    def backward(ctx, g):
        return model_all_gather(g, ctx.tp, ctx.dim), None, None


def copy_to_model(x: torch.Tensor, tp: Optional[TP]) -> torch.Tensor:
    """Identity forward; the backward sums the ranks' gradients in rank
    order."""
    return _Copy.apply(x, tp) if active(tp) else x


def reduce_from_model(x: torch.Tensor, tp: Optional[TP]) -> torch.Tensor:
    """Sum of the ranks' ``x`` in rank order; identity backward."""
    return _Reduce.apply(x, tp) if active(tp) else x


def gather_from_model(x: torch.Tensor, tp: Optional[TP],
                      dim: int = -1) -> torch.Tensor:
    """The ranks' shards concatenated along ``dim``; the backward keeps
    this rank's shard of the gradient."""
    return _Gather.apply(x, tp, dim % x.ndim) if active(tp) else x


def scatter_to_model(x: torch.Tensor, tp: Optional[TP],
                     dim: int = -1) -> torch.Tensor:
    """This rank's contiguous shard of a replicated ``x`` along ``dim``;
    the backward gathers the gradient."""
    return _Scatter.apply(x, tp, dim % x.ndim) if active(tp) else x


def column(x: torch.Tensor, w: torch.Tensor, full: int,
           tp: Optional[TP]) -> torch.Tensor:
    """``x @ w`` whole on every rank, for a column-parallel ``w`` of
    ``full`` output columns held whole or as this rank's column shard."""
    t = split(tp, w.shape[-1], full)
    if t is None:
        return x @ w
    return gather_from_model(copy_to_model(x, t) @ w, t)


def row(y: torch.Tensor, w: torch.Tensor, full: int,
        tp: Optional[TP]) -> torch.Tensor:
    """``y @ w`` for a replicated ``y`` and a row-parallel ``w`` of
    ``full`` input rows held whole or as this rank's row shard."""
    t = split(tp, w.shape[0], full)
    if t is None:
        return y @ w
    return reduce_from_model(scatter_to_model(y, t) @ w, t)


# ---------------------------------------------------------------------------
# a vocabulary in contiguous shards
# ---------------------------------------------------------------------------

def _vocab_max(x: torch.Tensor, tp: TP) -> torch.Tensor:
    parts = model_stack(x.amax(dim=-1), tp)
    out = parts[0]
    for r in range(1, tp.size):
        out = torch.maximum(out, parts[r])
    return out


class _LogSumExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        m = _vocab_max(x, tp)
        s = model_sum(torch.exp(x - m[..., None]).sum(dim=-1), tp)
        lse = m + torch.log(s)
        ctx.save_for_backward(x, lse)
        return lse

    @staticmethod
    def backward(ctx, g):
        x, lse = ctx.saved_tensors
        return g[..., None] * torch.exp(x - lse[..., None]), None


def vocab_logsumexp(x: torch.Tensor, tp: Optional[TP]) -> torch.Tensor:
    """``logsumexp`` over the last dim of a vocabulary split over the
    model axis (``x``: this rank's shard of the logits): the global max,
    then the ordered sum of each shard's ``sum(exp(x - max))``."""
    if not active(tp):
        return torch.logsumexp(x, dim=-1)
    return _LogSumExp.apply(x, tp)


def vocab_argmax(x: torch.Tensor, tp: Optional[TP]) -> torch.Tensor:
    """Global index (int64) of the largest entry of the last dim, the
    lowest index on a tie (``jnp.argmax``'s rule), for ``x`` this rank's
    contiguous shard of the vocabulary."""
    idx = torch.argmax(x, dim=-1)
    if not active(tp):
        return idx
    val = torch.gather(x, -1, idx[..., None])[..., 0].to(torch.float32)
    vals = model_stack(val, tp)
    idxs = model_stack((idx + tp.rank * x.shape[-1]).to(torch.int32), tp)
    best, at = vals[0], idxs[0]
    for r in range(1, tp.size):
        take = vals[r] > best           # a tie keeps the lower rank
        best = torch.where(take, vals[r], best)
        at = torch.where(take, idxs[r], at)
    return at.to(torch.int64)
