"""Mixture-of-Experts FFN with grouped top-k capacity dispatch.

GShard-style dispatch with one twist for reproducibility: capacity and slot
assignment are computed within fixed-size *token groups that never cross
sequence boundaries*, so the token -> slot mapping is a pure function of the
sequence content, independent of how sequences are split over data-parallel
ranks (DESIGN.md §6).  A global capacity pool would couple the dropping
pattern to the width and break bitwise width invariance.

The dispatch is the JAX package's dense one-hot formulation: 0/1 dispatch
and combine tensors and batched products over stacked (E, ...) expert
weights.  Two rules keep the integers the reference's:

* top-k ties go to the lower expert index (``lax.top_k``'s order), taken
  from a stable descending sort; ``torch.topk`` orders ties arbitrarily on
  CUDA, and a different pick in the recomputed forward of a checkpointed
  unit would also corrupt the gradients;
* the slot cumsum is done in int32.

Under tensor parallelism the experts split over the model axis (E / M per
rank, the layout's expert-parallel ``w_gate``/``w_up``/``w_down``).  The
router, the gates and the dispatch run whole on every rank; each rank runs
its own experts, the expert outputs are gathered across the axis, and the
combine sums them as at model size 1.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import common
from repro_torch.models import tp as tp_mod
from repro_torch.models.config import ModelConfig

__all__ = ["moe_init", "group_capacity", "top_k", "moe_block"]


def moe_init(gen: torch.Generator, cfg: ModelConfig, device=None):
    mo = cfg.moe
    D, Fe, E = cfg.d_model, mo.d_ff_expert, mo.num_experts
    pd = cfg.pdtype
    return {
        "router": common.dense_init(gen, (D, E), torch.float32,
                                    device=device),
        "w_gate": common.dense_init(gen, (E, D, Fe), pd, device=device),
        "w_up": common.dense_init(gen, (E, D, Fe), pd, device=device),
        "w_down": common.dense_init(gen, (E, Fe, D), pd, device=device),
    }


def group_capacity(group: int, cfg: ModelConfig) -> int:
    mo = cfg.moe
    cap = math.ceil(group * mo.top_k * mo.capacity_factor / mo.num_experts)
    return max(mo.top_k, min(cap, group))


def top_k(probs: torch.Tensor, k: int):
    """The ``k`` largest entries of the last axis, largest first, ties in
    ascending index order: ``jax.lax.top_k``'s rule on every device."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_block(x, p, cfg: ModelConfig, group: int = 1024,
              tp: Optional[tp_mod.TP] = None) -> Tuple[torch.Tensor, dict]:
    """x: (B, S, D) -> (out (B, S, D), aux-loss dict).  ``tp``: the model
    axis, over which ``p``'s experts may be split."""
    B, S, D = x.shape
    mo = cfg.moe
    E, K = mo.num_experts, mo.top_k
    cd = cfg.cdtype
    f32 = torch.float32
    g = min(group, S)
    if S % g:
        raise ValueError(
            f"MoE dispatch groups must not cross sequences: a sequence of "
            f"{S} tokens does not split into groups of {g} (the length must "
            f"be a multiple of min(moe_group, length))")
    C = group_capacity(g, cfg)
    N = B * (S // g)
    xg = x.reshape(N, g, D)

    logits = (xg @ p["router"].to(cd)).to(f32)                  # (N, g, E)
    probs = torch.softmax(logits, dim=-1)
    gates, idx = top_k(probs, K)                                # (N, g, K)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)

    # slot assignment: cumulative per-expert counts over (k-slot, token)
    # order, in int32 (the reference's float32 counts are these integers)
    onehot_i = F.one_hot(idx, E).to(torch.int32)                # (N,g,K,E)
    flat = onehot_i.transpose(1, 2).reshape(N, K * g, E)        # k-major
    pos = torch.cumsum(flat, dim=1, dtype=torch.int32) - flat
    pos = pos.reshape(N, K, g, E).transpose(1, 2)               # (N,g,K,E)
    slot = (pos * onehot_i).sum(-1, dtype=torch.int32)          # (N, g, K)
    keep = (slot < C) & (gates > 0)
    onehot = onehot_i.to(f32)

    # combine[n,g,e,c] = sum_k w[n,g,k] onehot[n,g,k,e] slot_oh[n,g,k,c]:
    # the k picked at one token are distinct experts, so at most one term
    # is non-zero and the sum is exact in any order.  A dropped pick
    # (slot >= C) has w = 0, so where its one-hot points does not matter
    w = gates * keep.to(f32)
    slot_oh = F.one_hot(slot.clamp(max=C - 1).to(torch.int64),
                        C).to(f32)                              # (N,g,K,C)
    combine = torch.einsum("ngke,ngkc->ngec", onehot * w[..., None],
                           slot_oh)                             # (N,g,E,C)
    dispatch = (combine > 0).to(cd)

    # this rank's experts [lo, lo + El) (all of them unless split)
    El = p["w_gate"].shape[0]
    tp = tp_mod.split(tp, El, E)
    lo = tp.rank * El if tp is not None else 0
    expert_in = torch.einsum("ngec,ngd->necd", dispatch[:, :, lo:lo + El],
                             tp_mod.copy_to_model(xg, tp).to(cd))  # N,El,C,D
    h_g = torch.einsum("necd,edf->necf", expert_in, p["w_gate"].to(cd))
    h_u = torch.einsum("necd,edf->necf", expert_in, p["w_up"].to(cd))
    act = F.silu(h_g) if cfg.act == "silu" else \
        F.gelu(h_g, approximate="tanh")
    expert_out = tp_mod.gather_from_model(torch.einsum(
        "necf,efd->necd", act * h_u, p["w_down"].to(cd)), tp,
        dim=1)                                                  # (N,E,C,D)
    out = torch.einsum("ngec,necd->ngd", combine.to(cd), expert_out)

    # auxiliary losses (float32; per group, then means)
    me = probs.mean(dim=1)                                      # (N, E)
    ce = onehot.sum(dim=2).mean(dim=1)                          # (N, E)
    load_balance = E * torch.mean(torch.sum(me * ce, dim=-1))
    z_loss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    aux = {
        "moe_load_balance": mo.load_balance_coef * load_balance,
        "moe_z_loss": mo.router_z_coef * z_loss,
    }
    return out.reshape(B, S, D), aux
