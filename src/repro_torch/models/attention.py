"""GQA attention: chunked online-softmax prefill/train + ring-buffer KV decode.

Supports sliding windows (gemma2 local layers), logit softcapping (gemma2),
GQA head grouping, RoPE/M-RoPE applied by the caller.

:func:`flash_attention` is the JAX package's chunked attention in plain
torch: it walks the KV blocks with running (max, denom, out) accumulators,
so the (S x S) score matrix is never materialized.  Scores and the
weighted values are taken in float32 from the compute-dtype inputs, as the
reference's ``preferred_element_type=float32`` products.  The KV cache is
a ring buffer over ``slots`` (= seq_len for full attention, = window for
sliding windows).

Under tensor parallelism the heads split over the model axis where the
layout splits ``wq``/``wk``/``wv`` by columns and ``wo`` by rows
(:func:`repro_torch.models.tp.attn_heads_split`, the port of the JAX
package's ``attn_shard`` modes): each rank attends with its own query and
KV heads and caches its own KV heads, and the ranks' ``wo`` products are
summed in rank order.  Otherwise attention runs whole on every rank.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.models import common
from repro_torch.models import tp as tp_mod
from repro_torch.models.config import ModelConfig

__all__ = ["NEG_INF", "attn_init", "flash_attention", "KVCache",
           "cache_init", "cache_update", "cache_fill", "decode_attention",
           "attention_block"]

NEG_INF = -1e30


def attn_init(gen: torch.Generator, cfg: ModelConfig, window: bool,
              device=None):
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p = {
        "wq": common.dense_init(gen, (D, H * hd), cfg.pdtype, device=device),
        "wk": common.dense_init(gen, (D, KV * hd), cfg.pdtype, device=device),
        "wv": common.dense_init(gen, (D, KV * hd), cfg.pdtype, device=device),
        "wo": common.dense_init(gen, (H * hd, D), cfg.pdtype, device=device),
    }
    if cfg.qk_norm:
        p["q_norm"] = common.rmsnorm_init(hd, cfg.pdtype, device)
        p["k_norm"] = common.rmsnorm_init(hd, cfg.pdtype, device)
    return p


def _project_qkv(x, p, cfg: ModelConfig, positions, tp=None):
    """q, k, v of the heads ``p`` holds (all, or this rank's; ``tp``: the
    model axis then, whose ranks' gradients of the whole ``q_norm`` and
    ``k_norm`` scales are summed)."""
    B, S, D = x.shape
    hd = cfg.hd
    H, KV = p["wq"].shape[-1] // hd, p["wk"].shape[-1] // hd
    cd = cfg.cdtype
    q = (x @ p["wq"].to(cd)).reshape(B, S, H, hd)
    k = (x @ p["wk"].to(cd)).reshape(B, S, KV, hd)
    v = (x @ p["wv"].to(cd)).reshape(B, S, KV, hd)
    if cfg.qk_norm:
        q = common.rmsnorm(q, {"scale": tp_mod.copy_to_model(
            p["q_norm"]["scale"], tp)}, cfg.norm_eps)
        k = common.rmsnorm(k, {"scale": tp_mod.copy_to_model(
            p["k_norm"]["scale"], tp)}, cfg.norm_eps)
    if cfg.rope_kind == "rope":
        q = common.apply_rope(q, positions, cfg.rope_theta)
        k = common.apply_rope(k, positions, cfg.rope_theta)
    elif cfg.rope_kind == "mrope":
        q = common.apply_mrope(q, positions, cfg.rope_theta,
                               cfg.mrope_sections)
        k = common.apply_mrope(k, positions, cfg.rope_theta,
                               cfg.mrope_sections)
    return q, k, v


def flash_attention(q, k, v, q_pos, kv_pos, *, window: int = 0,
                    softcap: float = 0.0, kv_chunk: int = 512):
    """Causal chunked attention.

    q: (B, Sq, H, hd); k/v: (B, Skv, KV, hd); q_pos: (B, Sq); kv_pos: (B, Skv).
    """
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = hd ** -0.5
    qg = (q * scale).reshape(B, Sq, KV, G, hd).to(torch.float32)

    Skv = k.shape[1]
    kv_chunk = min(kv_chunk, Skv)
    pad = (-Skv) % kv_chunk
    if pad:
        zpad = k.new_zeros((B, pad, KV, hd))
        k = torch.cat([k, zpad], 1)
        v = torch.cat([v, zpad], 1)
        kv_pos = torch.cat([kv_pos, kv_pos.new_full((B, pad), 2 ** 30)], 1)

    m = q.new_full((B, Sq, KV, G), NEG_INF, dtype=torch.float32)
    l = q.new_zeros((B, Sq, KV, G), dtype=torch.float32)
    o = q.new_zeros((B, Sq, KV, G, hd), dtype=torch.float32)
    for c in range(k.shape[1] // kv_chunk):
        cut = slice(c * kv_chunk, (c + 1) * kv_chunk)
        k_c = k[:, cut].to(torch.float32)
        v_c = v[:, cut].to(torch.float32)
        p_c = kv_pos[:, cut]
        s = torch.einsum("bqkgh,bckh->bqkgc", qg, k_c)
        if softcap:
            s = common.softcap(s, softcap)
        mask = p_c[:, None, :] <= q_pos[:, :, None]          # causal
        if window:
            mask = mask & ((q_pos[:, :, None] - p_c[:, None, :]) < window)
        s = torch.where(mask[:, :, None, None, :], s,
                        torch.tensor(NEG_INF, dtype=s.dtype, device=s.device))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        o = o * corr[..., None] + torch.einsum("bqkgc,bckh->bqkgh", p, v_c)
        m = m_new
    out = o / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, Sq, H, hd).to(q.dtype)


class KVCache(NamedTuple):
    """Ring-buffer cache: slots = window for sliding layers else seq_len."""
    k: torch.Tensor       # (B, slots, KV, hd)
    v: torch.Tensor       # (B, slots, KV, hd)
    pos: torch.Tensor     # (B, slots) int32, -1 = empty


def cache_init(batch, slots, cfg: ModelConfig, dtype=None, device=None,
               kv_heads: Optional[int] = None):
    """The cache of ``kv_heads`` KV heads (default all of them; under
    tensor parallelism, the heads this rank's ``wk`` shard holds)."""
    KV, hd = kv_heads or cfg.n_kv_heads, cfg.hd
    dt = dtype or cfg.cdtype
    return KVCache(
        k=torch.zeros((batch, slots, KV, hd), dtype=dt, device=device),
        v=torch.zeros((batch, slots, KV, hd), dtype=dt, device=device),
        pos=torch.full((batch, slots), -1, dtype=torch.int32, device=device),
    )


def cache_update(cache: KVCache, k_new, v_new, pos) -> KVCache:
    """Insert one token per sequence.  k_new/v_new: (B, 1, KV, hd);
    pos: (B,) int32 absolute positions."""
    slots = cache.k.shape[1]
    slot = torch.remainder(pos, slots).to(torch.int64)       # (B,)
    b_idx = torch.arange(cache.k.shape[0], device=cache.k.device)
    k, v, p = cache.k.clone(), cache.v.clone(), cache.pos.clone()
    k[b_idx, slot] = k_new[:, 0].to(k.dtype)
    v[b_idx, slot] = v_new[:, 0].to(v.dtype)
    p[b_idx, slot] = pos.to(torch.int32)
    return KVCache(k=k, v=v, pos=p)


def cache_fill(cache: KVCache, k, v, positions) -> KVCache:
    """Bulk-fill the cache from a prefill pass.  k/v: (B, S, KV, hd);
    positions: (B, S).  If S > slots, only the last ``slots`` tokens are
    kept (ring semantics, deterministic last-write-wins)."""
    slots = cache.k.shape[1]
    if k.shape[1] > slots:
        k, v, positions = k[:, -slots:], v[:, -slots:], positions[:, -slots:]
    slot = torch.remainder(positions, slots).to(torch.int64)  # (B, S)
    b_idx = torch.arange(k.shape[0], device=k.device)[:, None]
    ck, cv, cp = cache.k.clone(), cache.v.clone(), cache.pos.clone()
    ck[b_idx, slot] = k.to(ck.dtype)
    cv[b_idx, slot] = v.to(cv.dtype)
    cp[b_idx, slot] = positions.to(torch.int32)
    return KVCache(k=ck, v=cv, pos=cp)


def decode_attention(q, cache: KVCache, q_pos, *, window: int = 0,
                     softcap: float = 0.0):
    """Single-step attention against the cache.  q: (B, 1, H, hd)."""
    B, _, H, hd = q.shape
    KV = cache.k.shape[2]
    G = H // KV
    scale = hd ** -0.5
    qg = (q * scale).reshape(B, KV, G, hd).to(torch.float32)
    s = torch.einsum("bkgh,bskh->bkgs", qg, cache.k.to(torch.float32))
    if softcap:
        s = common.softcap(s, softcap)
    mask = (cache.pos >= 0) & (cache.pos <= q_pos[:, None])
    if window:
        mask = mask & ((q_pos[:, None] - cache.pos) < window)
    s = torch.where(mask[:, None, None, :], s,
                    torch.tensor(NEG_INF, dtype=s.dtype, device=s.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskh->bkgh", p, cache.v.to(torch.float32))
    return out.reshape(B, 1, H, hd).to(q.dtype)


def attention_block(x, p, cfg: ModelConfig, positions, *, window: int,
                    cache: Optional[KVCache] = None,
                    tp: Optional[tp_mod.TP] = None):
    """Full attention sublayer.  In decode mode (cache given, S==1) the
    cache is updated and attended; otherwise chunked attention over x
    itself.  Returns (out, new_cache)."""
    B, S, D = x.shape
    tp = tp_mod.split(tp, p["wq"].shape[-1], cfg.n_heads * cfg.hd)
    x = tp_mod.copy_to_model(x, tp)
    q, k, v = _project_qkv(x, p, cfg, positions, tp)
    if cache is not None and S == 1:
        pos = positions if positions.ndim == 1 else positions[:, 0]
        if cfg.rope_kind == "mrope":
            pos = positions[:, 0, 0]                        # temporal id
        cache = cache_update(cache, k, v, pos)
        out = decode_attention(q, cache, pos, window=window,
                               softcap=cfg.softcap_attn)
    else:
        qp = positions if positions.ndim == 2 else positions[:, 0]
        if cfg.rope_kind == "mrope":
            qp = positions[:, 0, :]
        if cache is not None:                               # prefill: fill
            cache = cache_fill(cache, k, v, qp)
        out = flash_attention(q, k, v, qp, qp, window=window,
                              softcap=cfg.softcap_attn)
    out = out.reshape(B, S, q.shape[2] * cfg.hd)
    return tp_mod.reduce_from_model(out @ p["wo"].to(cfg.cdtype), tp), cache
