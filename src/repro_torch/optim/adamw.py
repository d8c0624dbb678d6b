"""AdamW with float32 master weights, over nested-dict parameter trees.

Functional: ``init`` builds the state, ``update`` returns new parameters
and a new state.  The update is elementwise, hence bit-deterministic given
deterministic gradients — the reproducibility work happens upstream in
:mod:`repro_torch.optim.grad`.  Every operation is correctly rounded on
every device: the square root is :func:`repro_torch.ops.partial._sqrt_rn`
(CPU ``torch.sqrt`` is not), and divisions are tensor by tensor (CUDA's
division by a host scalar multiplies by its reciprocal).  The step's
scalars (learning rate, bias corrections) are computed on the host in
float32, so they are the same on every device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch

from repro_torch import tree as tree_mod
from repro_torch.ops.partial import _sqrt_rn

__all__ = ["AdamWConfig", "AdamWState", "init", "schedule", "update"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


class AdamWState(NamedTuple):
    mu: dict
    nu: dict
    master: dict          # float32 master weights (== params when f32)
    count: torch.Tensor   # int32 ()


def init(params) -> AdamWState:
    zeros = lambda tree: tree_mod.tree_map(          # noqa: E731
        lambda x: torch.zeros(x.shape, dtype=torch.float32,
                              device=x.device), tree)
    master = tree_mod.tree_map(
        lambda x: x.detach().to(torch.float32).clone(), params)
    dev = tree_mod.leaves(params)[0].device
    return AdamWState(mu=zeros(params), nu=zeros(params), master=master,
                      count=torch.zeros((), dtype=torch.int32, device=dev))


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def schedule(cfg: AdamWConfig, count) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_ratio; a float32 scalar on
    the host."""
    c = torch.as_tensor(count).cpu().to(torch.float32)
    warm = torch.minimum(_f32(1.0), (c + 1.0) / _f32(max(cfg.warmup_steps,
                                                         1)))
    frac = torch.clamp((c - cfg.warmup_steps)
                       / _f32(max(cfg.total_steps - cfg.warmup_steps, 1)),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(_f32(math.pi) * frac))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


# A leaf of more elements than this is updated in slices of it, one after
# another (every step is elementwise, so the bits are those of one pass):
# the temporaries, float64 ones among them (``_sqrt_rn``), stay this size.
SLICE = 1 << 23


def update(grads, state: AdamWState, params, cfg: AdamWConfig,
           grad_norm: Optional[torch.Tensor] = None):
    """Returns (new_params, new_state).  ``grad_norm`` (if given) is the
    reproducibly computed global norm used for clipping."""
    count = state.count + 1
    dev = state.count.device
    if grad_norm is None:
        grad_norm = _sqrt_rn(sum(
            torch.sum(torch.square(g.to(torch.float32)))
            for g in tree_mod.leaves(grads)))
    gn = torch.clamp(grad_norm.to(torch.float32), min=1e-9)
    scale = torch.clamp(torch.full_like(gn, cfg.clip_norm) / gn, max=1.0)
    lr = schedule(cfg, state.count).to(dev)
    c = count.cpu().to(torch.float32)
    b1c = (1.0 - _f32(cfg.b1) ** c).to(dev)
    b2c = (1.0 - _f32(cfg.b2) ** c).to(dev)

    def upd(p, g, m, v, w, matrix: bool):
        g = g.to(torch.float32) * scale
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g * g
        mh, vh = m / b1c, v / b2c
        step = mh / (_sqrt_rn(vh) + cfg.eps)
        if matrix:                            # decoupled wd on matrices only
            step = step + cfg.weight_decay * w
        w = w - lr * step                     # f32 master update
        return w.to(p.dtype), m, v, w

    def leaf(p, g, m, v, w):
        """``upd`` of one leaf, in slices of :data:`SLICE` elements where
        it is larger (elementwise: the same bits)."""
        if p.numel() <= SLICE:
            return upd(p, g, m, v, w, p.ndim >= 2)
        outs = tuple(torch.empty(t.shape, dtype=t.dtype, device=t.device)
                     for t in (p, m, v, w))
        flat = [t.reshape(-1) for t in (p, g, m, v, w)]
        for lo in range(0, p.numel(), SLICE):
            part = upd(*(t[lo:lo + SLICE] for t in flat), p.ndim >= 2)
            for o, r in zip(outs, part):
                o.view(-1)[lo:lo + SLICE] = r
        return outs

    out = tree_mod.tree_map(leaf, params, grads, state.mu, state.nu,
                            state.master)
    pick = lambda i: tree_mod.tree_map(lambda t: t[i], out)  # noqa: E731
    return pick(0), AdamWState(mu=pick(1), nu=pick(2), master=pick(3),
                               count=count)
