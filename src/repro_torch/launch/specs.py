"""Shape, dtype and sharding of everything a cell's step consumes.

The single source of truth for parameters, optimizer state, batches,
decode caches and logits of every (arch, shape, mesh) cell, as the JAX
package's ``launch/specs.py`` is for its dry run.  Each leaf is a
:class:`TensorSpec`: the full shape, the dtype, the spec over the mesh's
axes (:mod:`repro_torch.launch.shardings`) and the shape one rank holds.
Nothing is allocated: parameters and caches are built on the ``meta``
device.  ``mesh`` is a :class:`~repro_torch.launch.mesh.Mesh` or a
mapping of axis sizes (``{"data": 2, "model": 2}``, with ``"pod"`` for a
multi-pod mesh).

The port's trainer builds its shard layout, its checkpoint skeleton and
its per-rank bytes from these.  Where the port differs from the
reference, the spec says what the port does:

* attention weights replicate where the heads do not split
  (:func:`repro_torch.launch.shardings.layout_pspec`);
* decode caches are laid out as the model sizes them from this rank's
  weight shards (:func:`repro_torch.models.transformer.stack_cache_init`):
  KV heads over ``model`` where attention splits its heads, SSM channels
  where ``w_in`` splits, xLSTM states whole; the reference puts the
  largest ``model``-divisible trailing dim on ``model`` (KV slots:
  context parallelism);
* the training batch's stub-frontend ``embeds`` are float32, as the
  port's data pipeline draws them (the reference declares bfloat16).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch import tree as tree_mod
from repro_torch.launch import shardings as sh
from repro_torch.launch.mesh import Mesh
from repro_torch.models import lm, transformer
from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.optim import adamw as adamw_mod

__all__ = ["TensorSpec", "param_specs", "opt_specs", "opt_pspecs",
           "train_batch_specs", "prefill_batch_specs", "decode_cache_specs",
           "cache_shardings", "logits_sharding", "decode_batch_specs",
           "local_bytes"]


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    shape: tuple
    dtype: torch.dtype
    pspec: tuple
    local_shape: tuple

    @property
    def local_nbytes(self) -> int:
        return math.prod(self.local_shape) * \
            torch.empty((), dtype=self.dtype).element_size()


def _sizes(mesh) -> dict:
    return dict(mesh.shape) if isinstance(mesh, Mesh) else dict(mesh)


def _dp_names(sizes: dict) -> tuple:
    return tuple(a for a in ("pod", "data") if a in sizes)


def _dp(sizes: dict):
    names = _dp_names(sizes)
    return names if len(names) > 1 else names[0]


def _dp_size(sizes: dict) -> int:
    return math.prod(sizes[a] for a in _dp_names(sizes))


def _spec(shape, dtype, pspec, sizes: dict) -> TensorSpec:
    shape, pspec = tuple(shape), tuple(pspec)
    local = []
    for dim, e in zip(shape, pspec + (None,) * (len(shape) - len(pspec))):
        names = () if e is None else (e if isinstance(e, tuple) else (e,))
        local.append(dim // math.prod(sizes[n] for n in names))
    return TensorSpec(shape, dtype, pspec, tuple(local))


def _meta_params(cfg: ModelConfig):
    return lm.init_params(0, cfg, "meta")


def param_specs(cfg: ModelConfig, mesh):
    """Parameters with the port's model-axis layout."""
    sizes = _sizes(mesh)
    return tree_mod.tree_map_with_path(
        lambda path, t: _spec(t.shape, t.dtype, sh.layout_pspec(
            path, t.shape, cfg, sizes), sizes), _meta_params(cfg))


def opt_pspecs(cfg: ModelConfig, mesh, zero: bool = True):
    """AdamW state's specs: moments and master weights ZeRO-sharded over
    the data axes (``zero``) on top of the model layout."""
    sizes = _sizes(mesh)
    dsize, dp = _dp_size(sizes), _dp_names(sizes)

    def one(path, t):
        if zero:
            return sh.zero_pspec(path, t.shape, dsize, dp, sizes, cfg)
        return sh.layout_pspec(path, t.shape, cfg, sizes)
    tree = tree_mod.tree_map_with_path(one, _meta_params(cfg))
    return adamw_mod.AdamWState(mu=tree, nu=tree, master=tree, count=())


def opt_specs(cfg: ModelConfig, mesh, zero: bool = True):
    """Abstract AdamW state (float32 moments and master weights)."""
    sizes = _sizes(mesh)
    pspecs = opt_pspecs(cfg, mesh, zero)
    shapes = sh.full_shapes(cfg)

    def one(tree):
        return tree_mod.tree_map(
            lambda shape, ps: _spec(shape, torch.float32, ps, sizes),
            shapes, tree)
    return adamw_mod.AdamWState(
        mu=one(pspecs.mu), nu=one(pspecs.nu), master=one(pspecs.master),
        count=_spec((), torch.int32, (), sizes))


def train_batch_specs(cfg: ModelConfig, shape: ShapeConfig, train_cfg,
                      mesh):
    """Batch: (n_quanta, mb, ...) with quanta sharded over the data axes."""
    sizes = _sizes(mesh)
    nq = shape.global_batch // train_cfg.mb_size
    mb, S = train_cfg.mb_size, shape.seq_len
    dp = (_dp(sizes),)
    batch = {"targets": _spec((nq, mb, S), torch.int32, dp, sizes)}
    if cfg.embed_frontend == "stub":
        batch["embeds"] = _spec((nq, mb, S, cfg.d_model), torch.float32, dp,
                                sizes)
    else:
        batch["tokens"] = _spec((nq, mb, S), torch.int32, dp, sizes)
    if cfg.rope_kind == "mrope":
        batch["positions"] = _spec((nq, mb, 3, S), torch.int32, dp, sizes)
    return batch


def _maybe_dp(sizes: dict, n: int):
    """The data axes where ``n`` divides over them."""
    return _dp(sizes) if n % _dp_size(sizes) == 0 else None


def _serve_batch(cfg: ModelConfig, B: int, S: int, sizes: dict,
                 positions: bool) -> dict:
    dp = (_maybe_dp(sizes, B),)
    batch = {}
    if cfg.embed_frontend == "stub":
        batch["embeds"] = _spec((B, S, cfg.d_model), torch.bfloat16, dp,
                                sizes)
    else:
        batch["tokens"] = _spec((B, S), torch.int32, dp, sizes)
    if cfg.rope_kind == "mrope":
        batch["positions"] = _spec((B, 3, S), torch.int32, dp, sizes)
    elif positions:
        batch["positions"] = _spec((B, S), torch.int32, dp, sizes)
    return batch


def prefill_batch_specs(cfg: ModelConfig, shape: ShapeConfig, mesh):
    return _serve_batch(cfg, shape.global_batch, shape.seq_len,
                        _sizes(mesh), positions=False)


def decode_batch_specs(cfg: ModelConfig, shape: ShapeConfig, mesh):
    return _serve_batch(cfg, shape.global_batch, 1, _sizes(mesh),
                        positions=True)


def _cache_tree(cfg: ModelConfig, shape: ShapeConfig, blocks=None):
    """Stacked caches on the meta device, as a tree of tensors keyed like
    the port's (``attn``/``ssm``/... -> field), sized for ``blocks``."""
    caches = transformer.stack_cache_init(shape.global_batch, shape.seq_len,
                                          cfg, device="meta", blocks=blocks)
    return {k: dict(c._asdict()) for k, c in caches.items()}


def decode_cache_specs(cfg: ModelConfig, shape: ShapeConfig, mesh):
    """(units, B, ...) caches: the batch over the data axes where it
    divides, and over ``model`` every dim that the model, sizing its
    caches from this rank's weight shards, holds in part."""
    sizes = _sizes(mesh)
    blocks = tree_mod.tree_map(
        lambda s: torch.empty(s.local_shape, dtype=s.dtype, device="meta"),
        param_specs(cfg, sizes)["blocks"])

    def one(path, full, local):
        entries = [None] * full.ndim
        if full.ndim >= 2:
            entries[1] = _maybe_dp(sizes, full.shape[1])
        for i, (a, b) in enumerate(zip(full.shape, local.shape)):
            if a != b:
                entries[i] = "model"
        return _spec(full.shape, full.dtype, entries, sizes)
    return tree_mod.tree_map_with_path(
        one, _cache_tree(cfg, shape), _cache_tree(cfg, shape, blocks))


def cache_shardings(cfg: ModelConfig, shape: ShapeConfig, mesh):
    """The caches' specs alone (what a prefill hands its decode steps)."""
    return tree_mod.tree_map(lambda s: s.pspec,
                             decode_cache_specs(cfg, shape, mesh))


def logits_sharding(cfg: ModelConfig, shape: ShapeConfig, mesh) -> tuple:
    """(B, S, vocab): batch over the data axes, vocabulary over
    ``model`` where it divides."""
    sizes = _sizes(mesh)
    v = "model" if cfg.vocab % sizes.get("model", 1) == 0 else None
    return (_maybe_dp(sizes, shape.global_batch), None, v)


def local_bytes(specs) -> int:
    """Bytes one rank holds of a tree (or an ``AdamWState``) of
    :class:`TensorSpec`."""
    if isinstance(specs, adamw_mod.AdamWState):
        return sum(local_bytes(t) for t in specs)
    return sum(s.local_nbytes for s in tree_mod.leaves(specs))
