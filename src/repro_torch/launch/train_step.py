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
from repro_torch.launch.mesh import Mesh, make_mesh
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.obs import trace as obs_trace
from repro_torch.ops.partial import _sqrt_rn
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
    contiguous 1/N share, as the JAX package's batch sharding gives."""
    if n_quanta % mesh.size:
        raise ValueError(f"{n_quanta} quanta do not split over "
                         f"{mesh.size} ranks")
    per = n_quanta // mesh.size
    return mesh.rank * per, (mesh.rank + 1) * per


def _all_gather(t: torch.Tensor, dim: int, groups) -> torch.Tensor:
    """Concatenate every rank's ``t`` along ``dim`` (tiled all-gather)."""
    for g in reversed(collectives._groups(groups)):
        size = dist.get_world_size(g)
        src = torch.movedim(t, dim, 0).contiguous()
        out = src.new_empty((src.shape[0] * size, *src.shape[1:]))
        dist.all_gather_into_tensor(out, src, group=g)
        t = torch.movedim(out, 0, dim)
    return t


class TrainStep:
    """``step(params, opt, batch) -> (params, opt, metrics)``.

    ``batch`` holds this rank's quanta: tensors of shape (n_local, mb, ...)
    (:func:`local_quanta`).  ``params`` is the full parameter tree on every
    rank; ``opt`` is :func:`init_opt`'s state (1/N slices in
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
                                   embed_chunk=self.cfg.embed_chunk)
            grads = torch.autograd.grad(loss, req, allow_unused=True)
        grads = [torch.zeros_like(r) if g is None else g
                 for g, r in zip(grads, req)]
        g_tree = tree_mod.from_paths(
            (path, g) for (path, _), g in zip(items, grads))
        return g_tree, {"loss": loss.detach(), "xent": aux["xent"].detach()}

    def zero_dims(self, params):
        """Per leaf: the tensor dim carrying the ZeRO shard (None =
        replicated)."""
        return tree_mod.tree_map_with_path(
            lambda path, p: sh.zero_dim(path, p.shape, self.mesh.size),
            params)

    def _slice(self, p: torch.Tensor, zdim):
        if zdim is None:
            return p
        nsh = p.shape[zdim] // self.mesh.size
        return p.narrow(zdim, self.mesh.rank * nsh, nsh)

    def shard(self, tree, like):
        """This rank's slices of a full-shape tree (``like``: the params)."""
        return tree_mod.tree_map(self._slice, tree, self.zero_dims(like))

    def gather(self, tree, like):
        """Full-shape tree from every rank's slices."""
        return tree_mod.tree_map(
            lambda t, z: t if z is None else _all_gather(
                t, z, self.mesh.groups), tree, self.zero_dims(like))

    def init_opt(self, params) -> adamw_mod.AdamWState:
        if self.zero:
            params = self.shard(params, params)
        return adamw_mod.init(params)

    def full_opt(self, opt, params) -> adamw_mod.AdamWState:
        """The optimizer state at full shape (a collective in
        ``repro_zero2``): what a checkpoint stores, width-independent."""
        if not self.zero:
            return opt
        return opt._replace(mu=self.gather(opt.mu, params),
                            nu=self.gather(opt.nu, params),
                            master=self.gather(opt.master, params))

    def local_opt(self, opt_full, params) -> adamw_mod.AdamWState:
        """Inverse of :meth:`full_opt` (this rank's slices)."""
        if not self.zero:
            return opt_full
        return opt_full._replace(mu=self.shard(opt_full.mu, params),
                                 nu=self.shard(opt_full.nu, params),
                                 master=self.shard(opt_full.master, params))

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
                        dp_size=self.mesh.size, repro_L=self.cfg.repro_L,
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
            gnorm = grad_mod.repro_global_norm(grads, spec)
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
        zero = self.zero_dims(params)
        shard_accs = msum = None
        n_local = next(iter(batch.values())).shape[0]
        with obs_trace.span("repro_zero2_accumulate_scatter"):
            for i in range(n_local):
                g, m = self.grad_fn(params,
                                    {k: v[i] for k, v in batch.items()})
                accs = tree_mod.tree_map(self._scatter_one,
                                         grad_mod.tree_to_acc(g, spec), zero)
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
            gnorm = self._shard_global_norm(g_shards, zero)
        p_shards = self.shard(params, params)
        with obs_trace.span("optimizer_update"):
            new_p_shards, new_opt = adamw_mod.update(
                g_shards, opt, p_shards, self.cfg.adamw, grad_norm=gnorm)
        with obs_trace.span("zero2_param_allgather"):
            new_params = self.gather(new_p_shards, params)
        metrics = self._metrics_reduce(msum)
        metrics["grad_norm"] = gnorm
        return new_params, new_opt, metrics

    def _shard_global_norm(self, g_shards, zero):
        """Norm over ZeRO shards.  Replicated (unsharded) leaves contribute
        from rank 0 only — multiplying by an index mask keeps the summed
        *values* independent of the width (a /N rescale would not)."""
        spec = self.spec
        leaves = tree_mod.leaves(g_shards)
        acc = acc_mod.zeros(spec, device=leaves[0].device)
        first = torch.tensor(float(self.mesh.rank == 0),
                             device=leaves[0].device)
        for g, z in zip(leaves, tree_mod.leaves(zero)):
            sq = torch.square(g.to(torch.float32)).reshape(-1)
            if z is None:
                sq = sq * first          # replicated: count exactly once
            acc = acc_mod.merge(acc, grad_mod.flat_sum_acc(
                sq.to(spec.dtype), spec), spec)
        acc = collectives.repro_psum(acc, spec, self.mesh.groups)
        return _sqrt_rn(acc_mod.finalize(acc, spec))


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
