"""Where each parameter, optimizer slice and batch lies on the mesh.

The JAX package's sharding rules.  A spec is a tuple with one entry per
tensor dimension: ``None``, ``"model"``, a data-axis name or a tuple of
them.  Megatron-style tensor parallelism over ``model``:

* embeddings and ``lm_head``: vocabulary-sharded;
* attention ``wq``/``wk``/``wv``: column-parallel; ``wo``: row-parallel;
* MLP ``w_gate``/``w_up``: column-parallel; ``w_down``: row-parallel;
* MoE expert weights: expert-parallel (E over ``model``); the router
  replicated;
* SSM and xLSTM projections: the column/row analogues (``_COL``/``_ROW``).

``param_pspec`` is the reference's rule, ``validate_pspec`` drops entries
whose axis does not divide the dimension, and ``zero_pspec`` puts the data
axes on the first free dimension they divide: the dimension the optimizer
state, master weights and gradient shards of ``repro_zero2`` are cut
along.  Paths are tuples of dict keys (:func:`repro_torch.tree.paths`);
stacked block weights carry a leading unit axis.

**One deliberate difference.**  ``wq``/``wk``/``wv``/``wo`` of an
attention layer shard over ``model`` only where both ``n_heads`` and
``n_kv_heads`` divide the model size (and ``cfg.attn_shard`` is not
``"replicate"``, :func:`repro_torch.models.tp.attn_heads_split`);
otherwise attention stays replicated, the reference's
``attn_shard="replicate"`` case.  The reference's ``validate_pspec`` cuts
smollm's 576-wide ``wq`` in the middle of a head and lets GSPMD reshard;
an explicit port cannot split a head.  :func:`layout_pspec` is the
port's layout (the reference's rule plus this one), and every function
that takes ``cfg`` uses it.

:func:`shard_params` / :func:`gather_params` take a full tree to this
rank's model shard and back (:func:`shard_leaf` / :func:`gather_leaf` one
leaf): the only code that cuts or joins a model shard.  The trees of
specs and batch layouts (the reference's ``param_pspecs``,
``zero_pspecs``, ``batch_pspec`` and ``cache_pspecs``) are
:mod:`repro_torch.launch.specs`'s; the reference's
``manual_only`` and ``tree_manual_only`` serve ``shard_map`` and are not
ported.
"""
from __future__ import annotations

from typing import Optional

from repro_torch import tree as tree_mod
from repro_torch.core import collectives
from repro_torch.models import lm
from repro_torch.models import tp as tp_mod
from repro_torch.models.config import ModelConfig

__all__ = ["param_pspec", "validate_pspec", "layout_pspec", "zero_pspec",
           "zero_dim", "model_dim", "full_shapes",
           "shard_leaf", "gather_leaf", "shard_params", "gather_params"]

_COL = {"wq", "wk", "wv", "w_gate", "w_up", "w_in", "w_zifo", "w_gates"}
_ROW = {"wo", "w_down", "w_out", "w_bcdt"}
_VOCAB = {"embed", "lm_head"}
_ATTN = {"wq", "wk", "wv", "wo"}


def _shape(leaf) -> tuple:
    """A leaf's shape: a tensor's, a spec's, or the leaf itself."""
    return tuple(getattr(leaf, "shape", leaf))


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


def layout_pspec(path: tuple, shape, cfg: ModelConfig,
                 axis_sizes: dict) -> tuple:
    """The port's model-axis layout of one parameter: the validated
    reference spec, with attention replicated where its heads do not
    split."""
    shape = _shape(shape)
    spec = validate_pspec(param_pspec(path, len(shape)), shape, axis_sizes)
    if "attn" in path and path[-1] in _ATTN and \
            not tp_mod.attn_heads_split(cfg, axis_sizes.get("model", 1)):
        return (None,) * len(shape)
    return spec


def model_dim(pspec: tuple) -> Optional[int]:
    """The dimension split over ``model`` (None: replicated on it)."""
    for i, e in enumerate(pspec):
        if e == "model":
            return i
    return None


def zero_pspec(path: tuple, shape, data_size: int, dp=("data",),
               axis_sizes: Optional[dict] = None,
               cfg: Optional[ModelConfig] = None) -> tuple:
    """Sharding for optimizer-state / master copies of this parameter:
    the (validated) param spec + the data axes on the first eligible dim.
    With ``cfg`` the base is the port's :func:`layout_pspec`."""
    shape = _shape(shape)
    if cfg is not None:
        base = layout_pspec(path, shape, cfg, axis_sizes)
    else:
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


def zero_dim(path: tuple, shape, data_size: int, model_size: int = 1,
             cfg: Optional[ModelConfig] = None) -> Optional[int]:
    """The dim of the full ``shape`` carrying the ZeRO shard over the data
    axes (None = replicated over them); the port's layout when ``cfg`` is
    given."""
    sizes = {"data": data_size, "model": model_size}
    spec = zero_pspec(path, shape, data_size, ("data",), sizes, cfg)
    for i, e in enumerate(spec):
        if e == "data":
            return i
    return None


def shard_leaf(t, dim: Optional[int], tp):
    """This rank's contiguous model shard of a full leaf along ``dim``
    (``None``: held whole)."""
    if dim is None or not collectives.model_active(tp):
        return t
    n = t.shape[dim] // tp.size
    return t.narrow(dim, tp.rank * n, n).contiguous()


def gather_leaf(t, dim: Optional[int], tp):
    """The full leaf from every model rank's shard along ``dim`` (a
    collective over the model group): the inverse of :func:`shard_leaf`."""
    if dim is None:
        return t
    return collectives.model_all_gather(t, tp, dim)


def _model_dim(path: tuple, shape, cfg: ModelConfig, sizes: dict):
    return model_dim(layout_pspec(path, shape, cfg, sizes))


def shard_params(tree, mesh, cfg: ModelConfig):
    """This rank's model-axis shard of a full-shape parameter tree (or of
    any tree of the same keys and shapes, such as optimizer moments)."""
    if not collectives.model_active(mesh.tp):
        return tree
    sizes = dict(mesh.shape)
    return tree_mod.tree_map_with_path(
        lambda path, t: shard_leaf(t, _model_dim(path, t.shape, cfg, sizes),
                                   mesh.tp), tree)


def full_shapes(cfg: ModelConfig):
    """The parameter tree's full shapes (drawn on the ``meta`` device, so
    nothing is allocated)."""
    return tree_mod.tree_map(lambda t: tuple(t.shape),
                             lm.init_params(0, cfg, "meta"))


def gather_params(tree, mesh, cfg: ModelConfig):
    """The full-shape tree from every model rank's shard (a collective
    over the model group): the inverse of :func:`shard_params`."""
    if not collectives.model_active(mesh.tp):
        return tree
    sizes = dict(mesh.shape)
    return tree_mod.tree_map_with_path(
        lambda path, t, full: gather_leaf(
            t, _model_dim(path, full, cfg, sizes), mesh.tp),
        tree, full_shapes(cfg))
