"""Block assembly and the stacked-unit layer loop.

One *unit* is the structure repeated down the stack:

* dense/audio/vlm      : 1 transformer layer (attention + FFN)
* gemma2 alternating   : 2 layers (sliding-window attn layer + full-attn layer)

Unit weights are stacked on a leading (n_units,) axis, as the JAX package
holds them under its ``lax.scan``: one tensor per weight for the whole
stack, so a gradient tree has the reference's leaves (one lattice exponent
per leaf in the reproducible accumulators).  :func:`run_stack` walks the
units in a Python loop; training recomputes each unit in backward
(``torch.utils.checkpoint``), the reference's ``jax.checkpoint`` remat.

The MoE, hybrid (attention + SSM) and xLSTM units are not ported yet.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch import tree as tree_mod
from repro_torch.models import attention, common
from repro_torch.models.config import ModelConfig

__all__ = ["layers_per_unit", "n_units", "unit_init", "stack_init",
           "unit_cache_init", "stack_cache_init", "unit_apply", "run_stack",
           "REMAT_POLICIES"]

REMAT_POLICIES = ("nothing", "dots", "none")


def _unported(cfg: ModelConfig):
    raise NotImplementedError(
        f"{cfg.name}: the {cfg.family} family's units (MoE, SSM, xLSTM) are "
        "not ported to repro_torch yet (ROADMAP queue 1, models/"
        "{moe,ssm,xlstm,recurrence}.py)")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family in ("moe", "hybrid", "xlstm") or cfg.moe is not None \
            or cfg.ssm is not None:
        _unported(cfg)


def layers_per_unit(cfg: ModelConfig) -> int:
    if cfg.family == "xlstm" or cfg.attn_kind == "alternating":
        return 2
    return 1


def n_units(cfg: ModelConfig) -> int:
    lpu = layers_per_unit(cfg)
    if cfg.n_layers % lpu:
        raise ValueError(f"{cfg.n_layers} layers do not split into units "
                         f"of {lpu}")
    return cfg.n_layers // lpu


# ---------------------------------------------------------------------------
# unit init
# ---------------------------------------------------------------------------

def _dense_layer_init(gen, cfg: ModelConfig, window: bool, device):
    p = {
        "ln_attn": common.rmsnorm_init(cfg.d_model, cfg.pdtype, device),
        "attn": attention.attn_init(gen, cfg, window, device),
        "ln_ffn": common.rmsnorm_init(cfg.d_model, cfg.pdtype, device),
        "mlp": common.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.pdtype,
                               device),
    }
    if cfg.post_block_norm:
        p["post_attn"] = common.rmsnorm_init(cfg.d_model, cfg.pdtype, device)
        p["post_ffn"] = common.rmsnorm_init(cfg.d_model, cfg.pdtype, device)
    return p


def unit_init(gen: torch.Generator, cfg: ModelConfig, device=None):
    _check_family(cfg)
    if cfg.attn_kind == "alternating":
        return {"local": _dense_layer_init(gen, cfg, True, device),
                "global": _dense_layer_init(gen, cfg, False, device)}
    return _dense_layer_init(gen, cfg, cfg.attn_kind == "sliding", device)


def _stack(trees):
    return tree_mod.tree_map(lambda *xs: torch.stack(xs), *trees)


def stack_init(gen: torch.Generator, cfg: ModelConfig, device=None):
    return _stack([unit_init(gen, cfg, device) for _ in range(n_units(cfg))])


def _units(stacked, u: int) -> list:
    """Per-unit views of a stacked tree (one ``unbind`` per leaf, so the
    backward stacks the units' gradients in one operation)."""
    parts = [(path, leaf.unbind(0)) for path, leaf in tree_mod.paths(stacked)]
    return [tree_mod.from_paths((path, views[i]) for path, views in parts)
            for i in range(u)]


# ---------------------------------------------------------------------------
# caches per unit
# ---------------------------------------------------------------------------

def unit_cache_init(batch: int, max_seq: int, cfg: ModelConfig,
                    device=None):
    """Decode-time state for one unit."""
    _check_family(cfg)
    if cfg.attn_kind == "alternating":
        return {"local": attention.cache_init(
                    batch, min(cfg.window, max_seq), cfg, device=device),
                "global": attention.cache_init(batch, max_seq, cfg,
                                               device=device)}
    slots = min(cfg.window, max_seq) if cfg.attn_kind == "sliding" else max_seq
    return {"attn": attention.cache_init(batch, slots, cfg, device=device)}


def stack_cache_init(batch: int, max_seq: int, cfg: ModelConfig,
                     device=None):
    unit = unit_cache_init(batch, max_seq, cfg, device)
    u = n_units(cfg)

    def rep(c):
        return attention.KVCache(*(t.expand(u, *t.shape).clone()
                                   for t in c))
    return {k: rep(c) for k, c in unit.items()}


def _cache_at(caches, i: int):
    return {k: attention.KVCache(*(t[i] for t in c))
            for k, c in caches.items()}


def _stack_caches(per_unit):
    return {k: attention.KVCache(*(torch.stack(ts) for ts in zip(
        *(c[k] for c in per_unit)))) for k in per_unit[0]}


# ---------------------------------------------------------------------------
# unit apply
# ---------------------------------------------------------------------------

def _dense_layer_apply(x, p, cfg: ModelConfig, positions, cache,
                       window: int):
    h = common.rmsnorm(x, p["ln_attn"], cfg.norm_eps)
    out, cache = attention.attention_block(h, p["attn"], cfg, positions,
                                           window=window, cache=cache)
    if cfg.post_block_norm:
        out = common.rmsnorm(out, p["post_attn"], cfg.norm_eps)
    x = x + out
    h = common.rmsnorm(x, p["ln_ffn"], cfg.norm_eps)
    out = common.mlp(h, p["mlp"], cfg.act, cfg.cdtype)
    if cfg.post_block_norm:
        out = common.rmsnorm(out, p["post_ffn"], cfg.norm_eps)
    return x + out, cache


def unit_apply(p, x, positions, cache, cfg: ModelConfig):
    """Returns (x, new_cache, aux_loss_scalar)."""
    _check_family(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.attn_kind == "alternating":
        lc = cache["local"] if cache is not None else None
        gc = cache["global"] if cache is not None else None
        x, lc = _dense_layer_apply(x, p["local"], cfg, positions, lc,
                                   window=cfg.window)
        x, gc = _dense_layer_apply(x, p["global"], cfg, positions, gc,
                                   window=0)
        return x, (None if cache is None else {"local": lc, "global": gc}), \
            aux
    window = cfg.window if cfg.attn_kind == "sliding" else 0
    ac = cache["attn"] if cache is not None else None
    x, ac = _dense_layer_apply(x, p, cfg, positions, ac, window=window)
    return x, (None if cache is None else {"attn": ac}), aux


# ---------------------------------------------------------------------------
# the stack
# ---------------------------------------------------------------------------

_SAVED_DOTS = {torch.ops.aten.mm.default, torch.ops.aten.addmm.default}


def _dots_policy(ctx, op, *args, **kwargs):
    """Keep matrix products without batch dimensions (the weight products,
    ``mm``; attention's batched products are ``bmm``), recompute the rest:
    the reference's ``checkpoint_dots_with_no_batch_dims``."""
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _train_unit(p_unit, h, positions, cfg: ModelConfig):
    h, _, a = unit_apply(p_unit, h, positions, None, cfg)
    return h, a


def run_stack(stacked_params, x, positions, cfg: ModelConfig,
              caches=None, train: bool = False,
              remat_policy: str = "nothing"):
    """Run all units.  caches: stacked caches or None (train mode).

    ``remat_policy`` in training: ``"nothing"`` recomputes each unit in
    backward, ``"dots"`` keeps its matrix products, ``"none"`` keeps all.
    """
    if remat_policy not in REMAT_POLICIES:
        raise ValueError(f"remat_policy {remat_policy!r} not in "
                         f"{REMAT_POLICIES}")
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    U = n_units(cfg)
    if caches is None:
        remat = train and remat_policy != "none" and torch.is_grad_enabled()
        for p_unit in _units(stacked_params, U):
            if not remat:
                x, a = _train_unit(p_unit, x, positions, cfg)
            elif remat_policy == "dots":
                x, a = checkpoint(
                    _train_unit, p_unit, x, positions, cfg,
                    use_reentrant=False,
                    context_fn=lambda: create_selective_checkpoint_contexts(
                        _dots_policy))
            else:
                x, a = checkpoint(_train_unit, p_unit, x, positions, cfg,
                                  use_reentrant=False)
            aux = aux + a
        return x, None, aux

    new_caches = []
    for i, p_unit in enumerate(_units(stacked_params, U)):
        x, c, a = unit_apply(p_unit, x, positions, _cache_at(caches, i), cfg)
        new_caches.append(c)
        aux = aux + a
    return x, _stack_caches(new_caches), aux
