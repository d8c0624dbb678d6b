"""Shared model layers: norms, embeddings, rotary embeddings, MLPs, losses.

Functional style, as in the JAX package: ``*_init`` builds parameter trees
(plain dicts of tensors), the layers are pure functions of tensors.
Initializers draw from an explicit ``torch.Generator`` (on the CPU, so every
process builds the same weights; a generator on the card draws there, which
is what a model of billions of parameters wants) and move them to
``device``; on the ``meta`` device they only give shapes and dtypes.

Under tensor parallelism (:mod:`repro_torch.models.tp`) the embedding and
the loss run over a vocabulary split in contiguous shards and the MLP is
column/row parallel; a layer whose weights are whole runs as without it.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core import accumulator as acc_mod
from repro_torch.core import segment as segment_mod
from repro_torch.core.types import ReproSpec
from repro_torch.models import tp as tp_mod
from repro_torch.models.config import ModelConfig

__all__ = ["dense_init", "embed_init", "rmsnorm_init", "rmsnorm",
           "apply_rope", "apply_mrope", "mlp_init", "mlp", "softcap",
           "EmbedRepro", "embed_lookup", "chunked_xent"]


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

def _normal(gen: torch.Generator, shape, device) -> torch.Tensor:
    if device is not None and torch.device(device).type == "meta":
        return torch.empty(shape, dtype=torch.float32, device="meta")
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=gen.device).to(device)


def dense_init(gen: torch.Generator, shape, dtype, scale: Optional[float] =
               None, device=None):
    fan_in = shape[0] if len(shape) >= 2 else 1
    scale = scale if scale is not None else fan_in ** -0.5
    return (_normal(gen, shape, device) * scale).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype, device=None):
    return (_normal(gen, shape, device) * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

def rmsnorm_init(d, dtype, device=None):
    return {"scale": torch.zeros((d,), dtype=dtype, device=device)}


def rmsnorm(x: torch.Tensor, params, eps: float) -> torch.Tensor:
    """Gemma-style RMSNorm, ``x * rsqrt(mean(x^2) + eps) * (1 + scale)`` in
    float32, back in x's dtype."""
    dt = x.dtype
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + params["scale"].to(torch.float32))).to(dt)


# ---------------------------------------------------------------------------
# Rotary position embeddings (RoPE + qwen2-vl M-RoPE)
# ---------------------------------------------------------------------------

def _rope_freqs(hd: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exps)


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: (B, S, H, hd); positions: (B, S) int32."""
    freqs = _rope_freqs(x.shape[-1], theta, x.device)      # (hd/2,)
    ang = positions[..., None].to(torch.float32) * freqs    # (B, S, hd/2)
    return _rotate(x, ang)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections):
    """qwen2-vl M-RoPE: positions3 (B, 3, S) — temporal/height/width ids;
    the head dim's rotary pairs are split into per-component sections."""
    hd = x.shape[-1]
    freqs = _rope_freqs(hd, theta, x.device)               # (hd/2,)
    # each rotary pair's component, built on the host from the config: a
    # repeat_interleave over tensor counts has a data-dependent shape,
    # which a trace on fake tensors (launch/dryrun.py) cannot follow
    comp = torch.tensor([c for c, n in enumerate(sections)
                         for _ in range(n)][: hd // 2], device=x.device)
    pos = positions3.to(torch.float32)[:, comp, :]         # (B, hd/2, S)
    ang = torch.einsum("bfs,f->bsf", pos, freqs)           # (B, S, hd/2)
    return _rotate(x, ang)


# ---------------------------------------------------------------------------
# Gated MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------

def mlp_init(gen: torch.Generator, d, d_ff, dtype, device=None):
    return {
        "w_gate": dense_init(gen, (d, d_ff), dtype, device=device),
        "w_up": dense_init(gen, (d, d_ff), dtype, device=device),
        "w_down": dense_init(gen, (d_ff, d), dtype, device=device),
    }


def mlp(x: torch.Tensor, params, act: str, compute_dtype,
        tp: Optional[tp_mod.TP] = None) -> torch.Tensor:
    """``tp``: the model axis when the weights are its column (``w_gate``,
    ``w_up``) and row (``w_down``) shards: the partial products are summed
    across it in rank order."""
    w_g = params["w_gate"].to(compute_dtype)
    w_u = params["w_up"].to(compute_dtype)
    w_d = params["w_down"].to(compute_dtype)
    x = tp_mod.copy_to_model(x, tp)
    g = x @ w_g
    # jax.nn.gelu's default is the tanh approximation
    g = F.silu(g) if act == "silu" else F.gelu(g, approximate="tanh")
    return tp_mod.reduce_from_model((g * (x @ w_u)) @ w_d, tp)


# ---------------------------------------------------------------------------
# softcap (gemma2)
# ---------------------------------------------------------------------------

def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if not cap:
        return x
    return torch.tanh(x / cap) * cap


# ---------------------------------------------------------------------------
# Embedding with optional reproducible gradient (GROUPBY over token ids)
# ---------------------------------------------------------------------------

class EmbedRepro(torch.autograd.Function):
    """``table[ids]`` whose backward is a reproducible GROUPBY-SUM of the
    cotangent rows over token ids — the paper's operation inside the
    training loop, bit-identical for any order or split of the rows."""

    @staticmethod
    def forward(ctx, table, ids, spec: ReproSpec, chunk: int):
        ctx.save_for_backward(ids)
        ctx.vocab, ctx.d, ctx.dtype = table.shape[0], table.shape[1], \
            table.dtype
        ctx.spec, ctx.chunk = spec, chunk
        return F.embedding(ids, table)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        flat_ids = ids.reshape(-1)
        flat_g = g.reshape(-1, ctx.d).to(torch.float32)
        acc = segment_mod.segment_rsum(flat_g, flat_ids, ctx.vocab, ctx.spec,
                                       method="scatter", chunk=ctx.chunk,
                                       device=g.device)
        grad = acc_mod.finalize(acc, ctx.spec).to(ctx.dtype)
        return grad, None, None, None


def embed_lookup(table: torch.Tensor, ids: torch.Tensor,
                 repro_spec: Optional[ReproSpec] = None,
                 chunk: int = 4096,
                 tp: Optional[tp_mod.TP] = None) -> torch.Tensor:
    """``table[ids]``.  ``tp``: the model axis when ``table`` is this
    rank's contiguous vocabulary shard: each rank looks up the ids it
    holds (zero rows elsewhere) and the rows are summed across the axis,
    exactly, since one rank holds each id.  The zero rows add nothing to
    the gradient's GROUPBY, which then runs over the shard's
    ``vocab / model`` groups."""
    if tp_mod.active(tp):
        vl = table.shape[0]
        local = ids - tp.rank * vl
        held = (local >= 0) & (local < vl)
        rows = embed_lookup(table, torch.where(held, local, 0), repro_spec,
                            chunk)
        rows = rows * held[..., None].to(rows.dtype)
        return tp_mod.reduce_from_model(rows, tp)
    if repro_spec is None:
        return F.embedding(ids, table)
    return EmbedRepro.apply(table, ids, repro_spec, chunk)


# ---------------------------------------------------------------------------
# Chunked softmax cross-entropy
# ---------------------------------------------------------------------------

def _picked(logits, t_c, tp: Optional[tp_mod.TP]):
    """The target's logit; over a vocabulary shard, the one rank holding
    it gives it and the others zero, summed across the axis (exact)."""
    if not tp_mod.active(tp):
        return torch.gather(logits, -1, torch.clamp(t_c, min=0).to(
            torch.int64)[..., None])[..., 0]
    vl = logits.shape[-1]
    local = t_c.to(torch.int64) - tp.rank * vl
    held = (local >= 0) & (local < vl)
    got = torch.gather(logits, -1, torch.where(held, local, 0)[..., None]
                       )[..., 0]
    return tp_mod.reduce_from_model(got * held.to(got.dtype), tp)


def _chunk_loss(h_c, t_c, table, cfg: ModelConfig, tp=None):
    logits = (h_c.to(cfg.cdtype) @ table.T).to(torch.float32)
    if cfg.softcap_final:
        logits = softcap(logits, cfg.softcap_final)
    if cfg.logit_scale:
        logits = logits * cfg.logit_scale
    lse = tp_mod.vocab_logsumexp(logits, tp)
    picked = _picked(logits, t_c, tp)
    mask = (t_c >= 0).to(torch.float32)
    return ((lse - picked) * mask).sum(), mask.sum()


def chunked_xent(hidden: torch.Tensor, embed_table: torch.Tensor,
                 targets: torch.Tensor, cfg: ModelConfig,
                 chunk: int = 512,
                 tp: Optional[tp_mod.TP] = None) -> torch.Tensor:
    """hidden: (B, S, D) -> mean xent against targets (B, S).

    Computes logits one sequence chunk at a time so the (B, S, V) logit
    tensor is never materialized; under autograd each chunk is recomputed
    in backward (``torch.utils.checkpoint``).  Chunk sums are added in
    order, as the JAX package's scan does.  ``tp``: the model axis when
    ``embed_table`` is this rank's vocabulary shard (the max and the sum
    of exponentials are combined across it, :func:`~repro_torch.models.
    tp.vocab_logsumexp`).
    """
    hidden = tp_mod.copy_to_model(hidden, tp)
    B, S, D = hidden.shape
    chunk = min(chunk, S)
    pad = (-S) % chunk
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad), value=-1)
    table = embed_table.to(cfg.cdtype)
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(hidden.shape[1] // chunk):
        h_c = hidden[:, i * chunk:(i + 1) * chunk]
        t_c = targets[:, i * chunk:(i + 1) * chunk]
        if torch.is_grad_enabled():
            l, c = checkpoint(_chunk_loss, h_c, t_c, table, cfg, tp,
                              use_reentrant=False)
        else:
            l, c = _chunk_loss(h_c, t_c, table, cfg, tp)
        tot, cnt = tot + l, cnt + c
    return tot / torch.clamp(cnt, min=1.0)

