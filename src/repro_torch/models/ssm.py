"""Mamba-style selective SSM head (for the hymba hybrid architecture).

Hymba runs attention heads and SSM heads *in parallel* within each block and
fuses their (normalized) outputs.  A selective state-space scan:

    h_t = exp(dt_t * A) * h_{t-1} + dt_t * B_t * x_t
    y_t = C_t . h_t + D * x_t

with per-channel A < 0 and input-dependent (B_t, C_t, dt_t).  Train and
prefill scan over time (:func:`~repro_torch.models.recurrence.
chunked_time_scan`); decode updates the O(d_inner * state_dim) recurrent
state.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.models import common
from repro_torch.models.config import ModelConfig
from repro_torch.models.recurrence import chunked_time_scan

__all__ = ["SSMState", "ssm_init", "ssm_block", "ssm_state_init"]


class SSMState(NamedTuple):
    h: torch.Tensor         # (B, d_inner, state) float32


def ssm_init(gen: torch.Generator, cfg: ModelConfig, device=None):
    d = cfg.d_model
    n = cfg.ssm.state_dim
    di = cfg.ssm.expand * d
    pd = cfg.pdtype
    return {
        "w_in": common.dense_init(gen, (d, di), pd, device=device),
        "w_bcdt": common.dense_init(gen, (di, 2 * n + 1), pd, device=device),
        "a_log": torch.zeros((di,), dtype=pd, device=device),  # A=-exp(.)
        "d_skip": torch.ones((di,), dtype=pd, device=device),
        "dt_bias": torch.full((), -4.6, dtype=pd, device=device),
        "w_out": common.dense_init(gen, (di, d), pd, device=device),
        "out_norm": common.rmsnorm_init(di, pd, device),
    }


def _step(h, xs):
    dec, drv = xs                                          # (B,di),(B,di,n)
    h = h * dec[..., None] + drv
    return h, h


def ssm_block(x, p, cfg: ModelConfig, state: Optional[SSMState] = None):
    """x: (B, S, D) -> (out (B, S, D), new_state).

    If ``state`` is given and S == 1, performs one recurrent decode step."""
    B, S, D = x.shape
    cd = cfg.cdtype
    n = cfg.ssm.state_dim
    f32 = torch.float32
    x_in = F.silu(x @ p["w_in"].to(cd))                    # (B, S, di)
    di = x_in.shape[-1]

    bcdt = x_in @ p["w_bcdt"].to(cd)                       # (B, S, 2n+1)
    Bm = bcdt[..., :n].to(f32)                             # (B, S, n)
    Cm = bcdt[..., n:2 * n].to(f32)                        # (B, S, n)
    # jax.nn.softplus is logaddexp(x, 0); above torch's threshold (20) both
    # round to x in float32
    dt = F.softplus(bcdt[..., 2 * n].to(f32)
                    + p["dt_bias"].to(f32))                # (B, S)

    A = -torch.exp(p["a_log"].to(f32))                     # (di,)
    xf = x_in.to(f32)
    decay = torch.exp(dt[..., None] * A[None, None, :])    # (B, S, di)
    drive = (dt[..., None] * xf)[..., None] * Bm[:, :, None, :]  # B,S,di,n

    if state is not None and S == 1:
        h = state.h * decay[:, 0, :, None] + drive[:, 0]
        y = torch.einsum("bdn,bn->bd", h, Cm[:, 0])[:, None, :]
        new_state = SSMState(h=h)
    else:
        h0 = torch.zeros((B, di, n), dtype=f32, device=x.device) \
            if state is None else state.h
        hT, hs = chunked_time_scan(_step, h0, (decay.transpose(0, 1),
                                               drive.transpose(0, 1)))
        y = torch.einsum("sbdn,bsn->bsd", hs, Cm)
        new_state = SSMState(h=hT)

    y = y + xf * p["d_skip"].to(f32)
    y = common.rmsnorm(y.to(cd), p["out_norm"], cfg.norm_eps)
    return y @ p["w_out"].to(cd), new_state


def ssm_state_init(batch, cfg: ModelConfig, device=None) -> SSMState:
    return SSMState(h=torch.zeros((batch, cfg.ssm.expand * cfg.d_model,
                                   cfg.ssm.state_dim), dtype=torch.float32,
                                  device=device))
