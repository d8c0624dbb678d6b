"""Block assembly and the stacked-unit layer loop.

One *unit* is the structure repeated down the stack:

* dense/moe/audio/vlm  : 1 transformer layer (attention + [MoE-]FFN)
* gemma2 alternating   : 2 layers (sliding-window attn layer + full-attn layer)
* hymba hybrid         : 1 layer with parallel attention + SSM heads
* xlstm                : 2 blocks (mLSTM + sLSTM)

Unit weights are stacked on a leading (n_units,) axis, as the JAX package
holds them under its ``lax.scan``: one tensor per weight for the whole
stack, so a gradient tree has the reference's leaves (one lattice exponent
per leaf in the reproducible accumulators).  :func:`run_stack` walks the
units in a Python loop; training recomputes each unit in backward
(``torch.utils.checkpoint``), the reference's ``jax.checkpoint`` remat.
A unit's decode-time state is a dict of NamedTuples of tensors under the
reference's keys (``attn``/``local``/``global``: :class:`KVCache`;
``ssm``: :class:`SSMState`; ``mlstm``/``slstm``: the xLSTM states).
Under tensor parallelism the unit weights are this rank's model-axis shards
and ``tp`` (:class:`repro_torch.models.tp.TP`) is threaded to every layer;
caches are sized from the weights, so they hold this rank's KV heads and
SSM channels where those split.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch import tree as tree_mod
from repro_torch.models import attention, common, moe, ssm, xlstm
from repro_torch.models import tp as tp_mod
from repro_torch.models.config import ModelConfig

__all__ = ["layers_per_unit", "n_units", "unit_init", "stack_init",
           "unit_cache_init", "stack_cache_init", "unit_apply", "run_stack",
           "REMAT_POLICIES"]

REMAT_POLICIES = ("nothing", "dots", "none")


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
    }
    if cfg.moe is not None:
        p["moe"] = moe.moe_init(gen, cfg, device)
    else:
        p["mlp"] = common.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.pdtype,
                                   device)
    if cfg.post_block_norm:
        p["post_attn"] = common.rmsnorm_init(cfg.d_model, cfg.pdtype, device)
        p["post_ffn"] = common.rmsnorm_init(cfg.d_model, cfg.pdtype, device)
    return p


def _hymba_layer_init(gen, cfg: ModelConfig, device):
    return {
        "ln_mix": common.rmsnorm_init(cfg.d_model, cfg.pdtype, device),
        "attn": attention.attn_init(gen, cfg, True, device),
        "ssm": ssm.ssm_init(gen, cfg, device),
        "ln_ffn": common.rmsnorm_init(cfg.d_model, cfg.pdtype, device),
        "mlp": common.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.pdtype,
                               device),
    }


def unit_init(gen: torch.Generator, cfg: ModelConfig, device=None):
    if cfg.family == "xlstm":
        return {"mlstm": xlstm.mlstm_init(gen, cfg, device),
                "slstm": xlstm.slstm_init(gen, cfg, device)}
    if cfg.family == "hybrid":
        return _hymba_layer_init(gen, cfg, device)
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
                    device=None, blocks=None):
    """Decode-time state for one unit.  ``blocks``: the (stacked) unit
    weights it serves; their ``wk`` and ``w_in`` give the KV heads and SSM
    channels to hold (under tensor parallelism, this rank's shard; by
    default all of them)."""
    def kv(*keys):
        if blocks is None:
            return None
        p = blocks
        for k in keys:
            p = p[k]
        return p["wk"].shape[-1] // cfg.hd

    if cfg.family == "xlstm":
        return {"mlstm": xlstm.mlstm_state_init(batch, cfg, device),
                "slstm": xlstm.slstm_state_init(batch, cfg, device)}
    if cfg.family == "hybrid":
        di = None if blocks is None else blocks["ssm"]["w_in"].shape[-1]
        return {"attn": attention.cache_init(
                    batch, min(cfg.window, max_seq), cfg, device=device,
                    kv_heads=kv("attn")),
                "ssm": ssm.ssm_state_init(batch, cfg, device, di)}
    if cfg.attn_kind == "alternating":
        return {"local": attention.cache_init(
                    batch, min(cfg.window, max_seq), cfg, device=device,
                    kv_heads=kv("local", "attn")),
                "global": attention.cache_init(
                    batch, max_seq, cfg, device=device,
                    kv_heads=kv("global", "attn"))}
    slots = min(cfg.window, max_seq) if cfg.attn_kind == "sliding" else max_seq
    return {"attn": attention.cache_init(batch, slots, cfg, device=device,
                                         kv_heads=kv("attn"))}


def _state_map(fn, state):
    """``fn`` over the tensors of a NamedTuple state, same type back."""
    return type(state)(*(fn(t) for t in state))


def stack_cache_init(batch: int, max_seq: int, cfg: ModelConfig,
                     device=None, blocks=None):
    unit = unit_cache_init(batch, max_seq, cfg, device, blocks)
    u = n_units(cfg)
    return {k: _state_map(lambda t: t.expand(u, *t.shape).clone(), c)
            for k, c in unit.items()}


def _cache_at(caches, i: int):
    return {k: _state_map(lambda t: t[i], c) for k, c in caches.items()}


def _stack_caches(per_unit):
    return {k: type(c)(*(torch.stack(ts) for ts in zip(
        *(u[k] for u in per_unit)))) for k, c in per_unit[0].items()}


# ---------------------------------------------------------------------------
# unit apply
# ---------------------------------------------------------------------------

def _mlp(h, p, cfg: ModelConfig, tp):
    t = tp_mod.split(tp, p["w_down"].shape[0], cfg.d_ff)
    return common.mlp(h, p, cfg.act, cfg.cdtype, t)


def _dense_layer_apply(x, p, cfg: ModelConfig, positions, cache,
                       window: int, tp=None):
    h = common.rmsnorm(x, p["ln_attn"], cfg.norm_eps)
    out, cache = attention.attention_block(h, p["attn"], cfg, positions,
                                           window=window, cache=cache, tp=tp)
    if cfg.post_block_norm:
        out = common.rmsnorm(out, p["post_attn"], cfg.norm_eps)
    x = x + out
    h = common.rmsnorm(x, p["ln_ffn"], cfg.norm_eps)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.moe is not None:
        out, aux_d = moe.moe_block(h, p["moe"], cfg,
                                   group=min(cfg.moe_group, h.shape[1]),
                                   tp=tp)
        # the reference's sum(aux_d.values()), in its key order
        aux = aux_d["moe_load_balance"] + aux_d["moe_z_loss"]
    else:
        out = _mlp(h, p["mlp"], cfg, tp)
    if cfg.post_block_norm:
        out = common.rmsnorm(out, p["post_ffn"], cfg.norm_eps)
    return x + out, cache, aux


def _hymba_layer_apply(x, p, cfg: ModelConfig, positions, cache, tp=None):
    h = common.rmsnorm(x, p["ln_mix"], cfg.norm_eps)
    attn_cache = cache["attn"] if cache is not None else None
    ssm_state = cache["ssm"] if cache is not None else None
    a_out, attn_cache = attention.attention_block(
        h, p["attn"], cfg, positions, window=cfg.window, cache=attn_cache,
        tp=tp)
    s_out, ssm_state = ssm.ssm_block(h, p["ssm"], cfg, state=ssm_state,
                                     tp=tp)
    x = x + 0.5 * (a_out + s_out)                   # fused parallel heads
    h = common.rmsnorm(x, p["ln_ffn"], cfg.norm_eps)
    x = x + _mlp(h, p["mlp"], cfg, tp)
    cache = (None if cache is None
             else {"attn": attn_cache, "ssm": ssm_state})
    return x, cache, torch.zeros((), dtype=torch.float32, device=x.device)


def unit_apply(p, x, positions, cache, cfg: ModelConfig, tp=None):
    """Returns (x, new_cache, aux_loss_scalar)."""
    if cfg.family == "xlstm":
        m_st = cache["mlstm"] if cache is not None else None
        s_st = cache["slstm"] if cache is not None else None
        x, m_st = xlstm.mlstm_block(x, p["mlstm"], cfg, state=m_st, tp=tp)
        x, s_st = xlstm.slstm_block(x, p["slstm"], cfg, state=s_st, tp=tp)
        cache = None if cache is None else {"mlstm": m_st, "slstm": s_st}
        return x, cache, torch.zeros((), dtype=torch.float32,
                                     device=x.device)
    if cfg.family == "hybrid":
        return _hymba_layer_apply(x, p, cfg, positions, cache, tp)
    if cfg.attn_kind == "alternating":
        lc = cache["local"] if cache is not None else None
        gc = cache["global"] if cache is not None else None
        x, lc, a1 = _dense_layer_apply(x, p["local"], cfg, positions, lc,
                                       window=cfg.window, tp=tp)
        x, gc, a2 = _dense_layer_apply(x, p["global"], cfg, positions, gc,
                                       window=0, tp=tp)
        cache = None if cache is None else {"local": lc, "global": gc}
        return x, cache, a1 + a2
    window = cfg.window if cfg.attn_kind == "sliding" else 0
    ac = cache["attn"] if cache is not None else None
    x, ac, aux = _dense_layer_apply(x, p, cfg, positions, ac, window=window,
                                    tp=tp)
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


def _train_unit(p_unit, h, positions, cfg: ModelConfig, tp=None):
    h, _, a = unit_apply(p_unit, h, positions, None, cfg, tp)
    return h, a


def run_stack(stacked_params, x, positions, cfg: ModelConfig,
              caches=None, train: bool = False,
              remat_policy: str = "nothing", tp=None):
    """Run all units.  caches: stacked caches or None (train mode).

    ``remat_policy`` in training: ``"nothing"`` recomputes each unit in
    backward, ``"dots"`` keeps its matrix products, ``"none"`` keeps all.
    A recomputed unit issues its model-axis collectives again, on every
    rank alike.
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
                x, a = _train_unit(p_unit, x, positions, cfg, tp)
            elif remat_policy == "dots":
                x, a = checkpoint(
                    _train_unit, p_unit, x, positions, cfg, tp,
                    use_reentrant=False,
                    context_fn=lambda: create_selective_checkpoint_contexts(
                        _dots_policy))
            else:
                x, a = checkpoint(_train_unit, p_unit, x, positions, cfg, tp,
                                  use_reentrant=False)
            aux = aux + a
        return x, None, aux

    new_caches = []
    for i, p_unit in enumerate(_units(stacked_params, U)):
        x, c, a = unit_apply(p_unit, x, positions, _cache_at(caches, i), cfg,
                             tp)
        new_caches.append(c)
        aux = aux + a
    return x, _stack_caches(new_caches), aux
