"""The language model: embeddings -> stack -> (chunked) loss / logits.

Entry points matching the input-shape kinds:

* :func:`loss_fn`       — training objective (chunked xent, aux losses).
* :func:`prefill_step`  — inference prefill: fills KV caches, returns the
                          last-position logits.
* :func:`decode_step`   — one-token decode against caches.

Parameters are a nested dict of tensors with the JAX package's keys and
shapes (per-unit weights stacked under ``blocks``); :class:`LM` is an
``nn.Module`` that holds one such tree as its parameters.
``embed_frontend == "stub"`` architectures (musicgen frames, qwen2-vl
patches) accept precomputed ``embeds`` instead of token ids.

Tensor parallelism: every entry point takes ``tp``
(:class:`repro_torch.models.tp.TP`, ``None`` for none) and then expects
this rank's model-axis shard of the parameters
(:func:`repro_torch.launch.shardings.shard_params` of the full tree).
Logits come back as this rank's vocabulary shard where the head table is
split (:func:`repro_torch.models.tp.vocab_argmax` picks a token from
them).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from repro_torch import tree as tree_mod
from repro_torch.core.types import ReproSpec
from repro_torch.device import resolve_device
from repro_torch.models import common, transformer
from repro_torch.models import tp as tp_mod
from repro_torch.models.config import ModelConfig

__all__ = ["init_params", "param_count", "head_table", "forward",
           "loss_fn", "logits_at", "prefill_step", "decode_step", "LM"]


def _generator(key) -> torch.Generator:
    if isinstance(key, torch.Generator):
        return key
    gen = torch.Generator()
    gen.manual_seed(int(key))
    return gen


def init_params(key, cfg: ModelConfig, device=None):
    """Random weights from ``key`` (a seed or a ``torch.Generator``; a seed
    or a CPU generator gives the same tensors in every process, a
    generator on the card draws there), placed on ``device`` (the card
    unless the caller asks for the CPU).  The draws are not the JAX
    package's; carry its weights across with
    :func:`repro_torch.interop.lm_params_from_numpy`."""
    dev = resolve_device(device)
    gen = _generator(key)
    params = {
        "embed": common.embed_init(gen, (cfg.vocab, cfg.d_model),
                                   cfg.pdtype, dev),
        "blocks": transformer.stack_init(gen, cfg, dev),
        "final_norm": common.rmsnorm_init(cfg.d_model, cfg.pdtype, dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = common.embed_init(
            gen, (cfg.vocab, cfg.d_model), cfg.pdtype, dev)
    return params


def param_count(params) -> int:
    return sum(int(math.prod(x.shape)) for x in tree_mod.leaves(params))


def _vocab_tp(table, cfg: ModelConfig, tp):
    """``tp`` where ``table`` is a vocabulary shard, else ``None``."""
    return tp_mod.split(tp, table.shape[0], cfg.vocab)


def _embed(params, batch, cfg: ModelConfig,
           repro_embed: Optional[ReproSpec] = None,
           embed_chunk: int = 4096, tp=None):
    if cfg.embed_frontend == "stub" and "embeds" in batch:
        x = batch["embeds"].to(cfg.cdtype)
    else:
        table = params["embed"]
        x = common.embed_lookup(table, batch["tokens"], repro_embed,
                                chunk=embed_chunk,
                                tp=_vocab_tp(table, cfg, tp)).to(cfg.cdtype)
    if cfg.scale_embed:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=cfg.cdtype,
                             device=x.device)
    return x


def _positions(batch, cfg: ModelConfig, S: int, B: int, device):
    if "positions" in batch:
        return batch["positions"]
    return torch.arange(S, dtype=torch.int32, device=device)[None].expand(
        B, S)


def head_table(params, cfg: ModelConfig):
    """The output projection's table (the embedding where tied)."""
    return params["embed"] if cfg.tie_embeddings else params["lm_head"]


def forward(params, batch, cfg: ModelConfig, caches=None,
            train: bool = False, remat_policy: str = "nothing",
            repro_embed: Optional[ReproSpec] = None,
            embed_chunk: int = 4096, tp=None):
    """Returns (hidden (B,S,D), new_caches, aux_loss)."""
    x = _embed(params, batch, cfg, repro_embed, embed_chunk, tp)
    B, S = x.shape[:2]
    positions = _positions(batch, cfg, S, B, x.device)
    x, caches, aux = transformer.run_stack(
        params["blocks"], x, positions, cfg, caches=caches, train=train,
        remat_policy=remat_policy, tp=tp)
    x = common.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return x, caches, aux


def loss_fn(params, batch, cfg: ModelConfig, remat_policy: str = "nothing",
            repro_embed: Optional[ReproSpec] = None, xent_chunk: int = 512,
            embed_chunk: int = 4096, tp=None):
    """batch: tokens/embeds (B, S), targets (B, S) (-1 = masked).

    ``embed_chunk`` is the reproducible embedding-gradient GROUPBY chunk:
    unlike ``xent_chunk`` (plain float accumulation, order-sensitive) it
    changes no bit, by the ReproAcc contract."""
    hidden, _, aux = forward(params, batch, cfg, train=True,
                             remat_policy=remat_policy,
                             repro_embed=repro_embed,
                             embed_chunk=embed_chunk, tp=tp)
    table = head_table(params, cfg)
    xent = common.chunked_xent(hidden, table, batch["targets"], cfg,
                               chunk=xent_chunk,
                               tp=_vocab_tp(table, cfg, tp))
    loss = xent + aux
    return loss, {"xent": xent, "aux": aux}


def logits_at(hidden, params, cfg: ModelConfig, tp=None):
    """Logits of given hidden states (the last position / decode): this
    rank's vocabulary shard where the head table is split."""
    table = head_table(params, cfg)
    hidden = tp_mod.copy_to_model(hidden, _vocab_tp(table, cfg, tp))
    table = table.to(cfg.cdtype)
    logits = (hidden.to(cfg.cdtype) @ table.T).to(torch.float32)
    if cfg.softcap_final:
        logits = common.softcap(logits, cfg.softcap_final)
    if cfg.logit_scale:
        logits = logits * cfg.logit_scale
    return logits


def prefill_step(params, batch, cfg: ModelConfig, max_seq: int, tp=None):
    """Prefill: run the prompt, fill caches, return last-position logits."""
    if cfg.embed_frontend == "stub" and "embeds" in batch:
        B, S = batch["embeds"].shape[:2]
        dev = batch["embeds"].device
    else:
        B, S = batch["tokens"].shape
        dev = batch["tokens"].device
    caches = transformer.stack_cache_init(B, max_seq, cfg, device=dev,
                                          blocks=params["blocks"])
    hidden, caches, _ = forward(params, batch, cfg, caches=caches, tp=tp)
    return logits_at(hidden[:, -1:, :], params, cfg, tp), caches


def decode_step(params, caches, batch, cfg: ModelConfig, tp=None):
    """One decode step.  batch: tokens (B, 1) [or embeds (B,1,D)] +
    positions (B, 1) (or (B, 3, 1) for mrope).  Returns (logits, caches)."""
    hidden, caches, _ = forward(params, batch, cfg, caches=caches, tp=tp)
    return logits_at(hidden, params, cfg, tp), caches


class LM(nn.Module):
    """An ``nn.Module`` holding one parameter tree (names are the tree's
    paths joined by ``.``, e.g. ``blocks.attn.wq``)."""

    def __init__(self, cfg: ModelConfig, params):
        super().__init__()
        self.cfg = cfg
        self._paths = [path for path, _ in tree_mod.paths(params)]
        for path, leaf in tree_mod.paths(params):
            mod = self
            for k in path[:-1]:
                if k not in mod._modules:
                    mod.add_module(k, nn.Module())
                mod = mod._modules[k]
            mod.register_parameter(path[-1], nn.Parameter(leaf.detach()))

    def tree(self):
        """The parameters as the nested dict the functions take."""
        out = []
        for path in self._paths:
            mod = self
            for k in path[:-1]:
                mod = mod._modules[k]
            out.append((path, getattr(mod, path[-1])))
        return tree_mod.from_paths(out)

    def forward(self, batch, **kwargs):
        """The training loss: ``(loss, {"xent", "aux"})``."""
        return loss_fn(self.tree(), batch, self.cfg, **kwargs)
