"""The data-parallel training step over ``torch.distributed``.

Each rank takes its share of the step's microbatch quanta; every quantum
is its own forward and backward of fixed shape (``mb_size`` sequences), so
its gradient has the same bits on any rank and at any data-parallel width.
Three gradient paths, selectable per run:

  repro_zero2 (default) — per-microbatch exact integer reduce-scatter of
      accumulators; optimizer state, master weights and gradient shards
      live on 1/N slices; parameters all-gathered after the update.
      Bitwise width-invariant and memory-minimal.
  repro                 — accumulate full-shape accumulator trees locally,
      one exact all-reduce at the end.  Bitwise width-invariant.
  baseline              — conventional float accumulate + all-reduce (the
      paper's "built-in float" baseline; not width-invariant).

``repro`` and ``repro_zero2`` give the same bits.  On the card the repro
modes need a deterministic forward and backward: :func:`set_deterministic`
(cuBLAS workspace, deterministic algorithms, cuDNN) is applied when the
step is built for a CUDA device.

On a mesh with a ``model`` axis each rank holds its model shard of the
parameters (:func:`repro_torch.launch.shardings.shard_params`, the layout
of :func:`repro_torch.launch.specs.param_specs`), so a sharded leaf's
gradient is a local shard: the gradient reductions and ZeRO slices run
over the data groups only, per model shard, as the JAX package's nested
``shard_map`` over ``model`` does.  The global norm counts every element
once across both axes.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch import tree as tree_mod
from repro_torch.core import accumulator as acc_mod
from repro_torch.core import collectives
from repro_torch.core.types import ReproSpec
from repro_torch.launch import shardings as sh
from repro_torch.launch import specs as specs_mod
from repro_torch.launch.mesh import Mesh, make_mesh
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.obs import repeat
from repro_torch.obs import trace as obs_trace
from repro_torch.optim import adamw as adamw_mod
from repro_torch.optim import grad as grad_mod

__all__ = ["GRAD_MODES", "TrainConfig", "TrainStep", "make_train_step",
           "set_deterministic", "local_quanta"]

GRAD_MODES = ("repro_zero2", "repro", "baseline")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    grad_mode: str = "repro_zero2"   # repro_zero2 | repro | baseline
    repro_L: int = 2
    repro_W: Optional[int] = None
    mb_size: int = 1                 # sequences per microbatch quantum
    remat: str = "nothing"
    repro_embed: bool = False        # reproducible embedding grads
    packed_wire: bool = False        # packed all-gather wire format
    adamw: adamw_mod.AdamWConfig = adamw_mod.AdamWConfig()
    xent_chunk: int = 512
    embed_chunk: int = 4096          # repro embed-grad GROUPBY chunk

    def __post_init__(self):
        if self.grad_mode not in GRAD_MODES:
            raise ValueError(f"grad_mode {self.grad_mode!r} not in "
                             f"{GRAD_MODES}")

    @property
    def spec(self) -> Optional[ReproSpec]:
        if self.grad_mode == "baseline":
            return None
        return ReproSpec(dtype=torch.float32, L=self.repro_L, W=self.repro_W)


def set_deterministic() -> None:
    """Run-to-run determinism on the card: cuBLAS's fixed workspace
    (``CUBLAS_WORKSPACE_CONFIG=:4096:8``, read when cuBLAS first sets up,
    so set it before the process's first product), torch's deterministic
    algorithms (warn only: the port's integer scatters are order-free by
    construction) and deterministic cuDNN."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def local_quanta(mesh: Mesh, n_quanta: int) -> tuple[int, int]:
    """The quanta [lo, hi) of a step that ``mesh``'s rank computes: a
    contiguous 1/N share over the data axes (the model ranks of one data
    rank take the same quanta), as the JAX package's batch sharding
    gives."""
    if n_quanta % mesh.size:
        raise ValueError(f"{n_quanta} quanta do not split over "
                         f"{mesh.size} ranks")
    per = n_quanta // mesh.size
    return mesh.rank * per, (mesh.rank + 1) * per


def _all_gather(t: torch.Tensor, dim: int, groups) -> torch.Tensor:
    """Concatenate every rank's ``t`` along ``dim`` (tiled all-gather),
    contiguous: a parameter gathered along a later dim then has the
    layout it has at data size 1 (cuBLAS may pick another kernel, and
    round otherwise, for a transposed operand)."""
    for g in reversed(collectives._groups(groups)):
        size = dist.get_world_size(g)
        src = torch.movedim(t, dim, 0).contiguous()
        out = src.new_empty((src.shape[0] * size, *src.shape[1:]))
        dist.all_gather_into_tensor(out, src, group=g)
        t = torch.movedim(out, 0, dim).contiguous()
    return t


class TrainStep:
    """``step(params, opt, batch) -> (params, opt, metrics)``.

    ``batch`` holds this rank's quanta: tensors of shape (n_local, mb, ...)
    (:func:`local_quanta`).  ``params`` is this rank's model shard of the
    parameter tree (the full tree at model size 1); ``opt`` is
    :func:`init_opt`'s state (1/N slices over the data axes in
    ``repro_zero2``).  ``metrics`` are the global means of the per-quantum
    loss and xent (reproducible in the repro modes) and the grad norm.
    """

    def __init__(self, model_cfg: ModelConfig, train_cfg: TrainConfig,
                 mesh: Mesh, shape: ShapeConfig):
        self.model_cfg = model_cfg
        self.cfg = train_cfg
        self.mesh = mesh
        self.spec = train_cfg.spec
        self.n_quanta = shape.global_batch // train_cfg.mb_size
        if shape.global_batch % (train_cfg.mb_size * mesh.size):
            raise ValueError("global batch must divide over DP x microbatch")
        self.repro_embed = ReproSpec(torch.float32, L=train_cfg.repro_L) \
            if train_cfg.repro_embed else None
        self.zero = train_cfg.grad_mode == "repro_zero2"
        self.specs = specs_mod.param_specs(model_cfg, mesh)
        # per leaf: the dim carrying the ZeRO shard over the data axes,
        # and the dim split over the model axis (None = held whole)
        self.zdims = tree_mod.tree_map_with_path(
            lambda path, s: sh.zero_dim(path, s.shape, mesh.size,
                                        mesh.model_size, model_cfg),
            self.specs)
        self.mdims = tree_mod.tree_map(lambda s: sh.model_dim(s.pspec),
                                       self.specs)

    # -- pieces ------------------------------------------------------------

    def grad_fn(self, params, mb):
        """One quantum's gradients (parameter dtypes) and metrics."""
        items = list(tree_mod.paths(params))
        req = [p.detach().requires_grad_(True) for _, p in items]
        p_tree = tree_mod.from_paths(
            (path, r) for (path, _), r in zip(items, req))
        with torch.enable_grad():
            loss, aux = lm.loss_fn(p_tree, mb, self.model_cfg,
                                   remat_policy=self.cfg.remat,
                                   repro_embed=self.repro_embed,
                                   xent_chunk=self.cfg.xent_chunk,
                                   embed_chunk=self.cfg.embed_chunk,
                                   tp=self.mesh.tp)
            grads = torch.autograd.grad(loss, req, allow_unused=True)
        grads = [torch.zeros_like(r) if g is None else g
                 for g, r in zip(grads, req)]
        g_tree = tree_mod.from_paths(
            (path, g) for (path, _), g in zip(items, grads))
        return g_tree, {"loss": loss.detach(), "xent": aux["xent"].detach()}

    def _slice(self, p: torch.Tensor, zdim):
        if zdim is None:
            return p
        nsh = p.shape[zdim] // self.mesh.size
        return p.narrow(zdim, self.mesh.rank * nsh, nsh)

    def shard(self, tree):
        """This rank's ZeRO slices of a tree of model shards."""
        return tree_mod.tree_map(self._slice, tree, self.zdims)

    def gather(self, tree):
        """The model shards from every data rank's ZeRO slices."""
        return tree_mod.tree_map(
            lambda t, z: t if z is None else _all_gather(
                t, z, self.mesh.groups), tree, self.zdims)

    def init_opt(self, params) -> adamw_mod.AdamWState:
        if self.zero:
            params = self.shard(params)
        return adamw_mod.init(params)

    def _whole(self, t: torch.Tensor, zdim, mdim, keep: bool):
        """One leaf whole: gathered over the data axes (``zdim``), then
        over the model axis (``mdim``), then moved to the host (``None``
        where not ``keep``: the rank takes part in the collectives only),
        so the card holds one gathered leaf at a time."""
        if zdim is not None:
            t = _all_gather(t, zdim, self.mesh.groups)
        t = sh.gather_leaf(t, mdim, self.mesh.tp)
        return t.cpu() if keep else None

    def _part(self, t: torch.Tensor, zdim, mdim) -> torch.Tensor:
        """Inverse of :meth:`_whole` (on ``t``'s device)."""
        return self._slice(sh.shard_leaf(t, mdim, self.mesh.tp), zdim)

    def full_params(self, params, keep: bool = True):
        """The full-shape parameters on the host (a collective over the
        model axis; ``None`` leaves where not ``keep``).  Its inverse is
        :func:`repro_torch.launch.shardings.shard_params`."""
        return tree_mod.tree_map(lambda t, m: self._whole(t, None, m, keep),
                                 params, self.mdims)

    def full_opt(self, opt, keep: bool = True) -> adamw_mod.AdamWState:
        """The optimizer state at full shape on the host (collectives over
        the data axes in ``repro_zero2`` and over the model axis; ``None``
        leaves where not ``keep``): what a checkpoint stores, independent
        of the mesh."""
        def full(tree):
            return tree_mod.tree_map(
                lambda t, z, m: self._whole(t, z if self.zero else None, m,
                                            keep),
                tree, self.zdims, self.mdims)
        return opt._replace(mu=full(opt.mu), nu=full(opt.nu),
                            master=full(opt.master))

    def local_opt(self, opt_full) -> adamw_mod.AdamWState:
        """Inverse of :meth:`full_opt` (this rank's slices, on the full
        tree's device)."""
        def local(tree):
            return tree_mod.tree_map(
                lambda t, z, m: self._part(t, z if self.zero else None, m),
                tree, self.zdims, self.mdims)
        return opt_full._replace(mu=local(opt_full.mu),
                                 nu=local(opt_full.nu),
                                 master=local(opt_full.master))

    def _norm_weights(self, data_split: bool, device) -> list:
        """Per leaf, ``None`` where this rank counts every entry it holds
        in the global norm, else a 0/1 scalar: a leaf held whole over the
        model axis counts on model rank 0; with ``data_split`` (ZeRO
        slices), a leaf held whole over the data axes counts on data rank
        0.  A mask, not a skipped leaf or a /N rescale, keeps the summed
        values and the rsum launches the same at every width."""
        out = []
        for z, m in zip(tree_mod.leaves(self.zdims),
                        tree_mod.leaves(self.mdims)):
            whole_dp = data_split and z is None
            whole_mp = m is None and self.mesh.model_size > 1
            count = (not whole_dp or self.mesh.rank == 0) and \
                (not whole_mp or self.mesh.model_rank == 0)
            out.append(torch.tensor(float(count), device=device)
                       if whole_dp or whole_mp else None)
        return out

    def _metrics_reduce(self, m_local_sums):
        """Reproducible global mean of per-quantum metrics; the single
        division is by the global quantum count."""
        if self.spec is None:
            return tree_mod.tree_map(
                lambda x: grad_mod.div_count(
                    grad_mod.all_reduce_sum(x, self.mesh.groups),
                    self.n_quanta), m_local_sums)

        def red(acc):
            acc = collectives.repro_psum(acc, self.spec, self.mesh.groups)
            return grad_mod.div_count(acc_mod.finalize(acc, self.spec),
                                      self.n_quanta)
        return tree_mod.tree_map(red, m_local_sums)

    # -- the step ----------------------------------------------------------

    def __call__(self, params, opt, batch):
        obs_trace.event("train.step_config", grad_mode=self.cfg.grad_mode,
                        n_quanta=self.n_quanta, mb_size=self.cfg.mb_size,
                        dp_size=self.mesh.size,
                        model_size=self.mesh.model_size,
                        repro_L=self.cfg.repro_L,
                        embed_chunk=self.cfg.embed_chunk)
        if self.zero:
            return self._zero2_step(params, opt, batch)
        spec = self.spec
        with obs_trace.span("repro_grad_accumulate"):
            accs, metrics = grad_mod.accumulate_microbatches(
                self.grad_fn, params, batch, spec)
        with obs_trace.span("repro_grad_reduce"):
            grads = grad_mod.reduce_grads(accs, spec, self.mesh.groups,
                                          self.n_quanta,
                                          packed=self.cfg.packed_wire)
            del accs                 # 16-20 bytes per element, not needed
            gnorm = grad_mod.repro_global_norm(
                grads, spec, self._norm_weights(
                    False, tree_mod.leaves(grads)[0].device),
                tp=self.mesh.tp)
        with obs_trace.span("optimizer_update"):
            new_params, new_opt = adamw_mod.update(
                grads, opt, params, self.cfg.adamw, grad_norm=gnorm)
        metrics = self._metrics_reduce(metrics)
        metrics["grad_norm"] = gnorm
        return new_params, new_opt, metrics

    def _scatter_one(self, acc, zdim):
        if zdim is None:
            return collectives.repro_psum(acc, self.spec, self.mesh.groups)
        return collectives.repro_psum_scatter(acc, self.spec,
                                              self.mesh.groups, dim=zdim)

    def _zero2_step(self, params, opt, batch):
        spec = self.spec
        zero = self.zdims
        shard_accs = msum = None
        n_local = next(iter(batch.values())).shape[0]
        with obs_trace.span("repro_zero2_accumulate_scatter"):
            for i, _ in repeat.trips(n_local, "train.quanta"):
                g, m = self.grad_fn(params,
                                    {k: v[i] for k, v in batch.items()})
                # leaf by leaf: one leaf's full-shape accumulator at a time
                accs = tree_mod.tree_map(
                    lambda x, z: self._scatter_one(
                        grad_mod.tree_to_acc(x, spec), z), g, zero)
                del g
                if shard_accs is None:
                    shard_accs = tree_mod.tree_map(
                        lambda a: acc_mod.zeros(spec, a.k.shape[:-1],
                                                device=a.k.device), accs)
                shard_accs = grad_mod.acc_merge_tree(shard_accs, accs, spec)
                msum = {k: grad_mod.metric_add(
                    None if msum is None else msum[k], v, spec)
                    for k, v in m.items()}
        with obs_trace.span("repro_zero2_finalize"):
            g_shards = tree_mod.tree_map(
                lambda g: grad_mod.div_count(g, self.n_quanta),
                grad_mod.acc_finalize_tree(shard_accs, spec))
            del shard_accs
            gnorm = grad_mod.repro_global_norm(
                g_shards, spec, self._norm_weights(
                    True, tree_mod.leaves(g_shards)[0].device),
                self.mesh.groups, self.mesh.tp)
        p_shards = self.shard(params)
        with obs_trace.span("optimizer_update"):
            new_p_shards, new_opt = adamw_mod.update(
                g_shards, opt, p_shards, self.cfg.adamw, grad_norm=gnorm)
        with obs_trace.span("zero2_param_allgather"):
            new_params = self.gather(new_p_shards)
        metrics = self._metrics_reduce(msum)
        metrics["grad_norm"] = gnorm
        return new_params, new_opt, metrics


def make_train_step(model_cfg: ModelConfig, train_cfg: TrainConfig,
                    mesh: Optional[Mesh], shape: ShapeConfig,
                    device=None) -> TrainStep:
    """The step for ``mesh`` (``None``: the world, or one process).  For a
    CUDA ``device`` in a repro mode, :func:`set_deterministic` first."""
    mesh = mesh if mesh is not None else make_mesh()
    if train_cfg.spec is not None and device is not None \
            and torch.device(device).type == "cuda":
        set_deterministic()
    return TrainStep(model_cfg, train_cfg, mesh, shape)
