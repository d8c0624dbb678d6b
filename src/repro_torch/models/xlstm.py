"""xLSTM blocks (arXiv:2405.04517): alternating mLSTM and sLSTM.

* mLSTM: matrix memory C (hd x hd per head) with exponential input gate and
  a stabilizer state; parallel over heads, recurrent over time.
* sLSTM: scalar memory per channel with exponential gating.

Both are recurrent in time (a chunked scan for train/prefill, O(1)-state
decode).  ``d_ff == 0`` in the xlstm config: blocks carry their own up/down
projections instead of a separate FFN.  The inner recurrences run in
float32 with stabilisers that start at -1e30.

Under tensor parallelism the projections are column (``wq``, ``wk``,
``wv``, ``w_gates``, ``w_zifo``, ``w_up``) and row (``wo``, ``w_down``)
shards, as the JAX package lays them out; their outputs are gathered
whole before the recurrences, which run replicated on every model rank as
the reference pins them, so no collective runs per timestep.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.models import common
from repro_torch.models import tp as tp_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.recurrence import chunked_time_scan

__all__ = ["MLSTMState", "SLSTMState", "XLSTMState", "mlstm_init",
           "slstm_init", "mlstm_block", "slstm_block", "mlstm_state_init",
           "slstm_state_init"]


class MLSTMState(NamedTuple):
    c: torch.Tensor     # (B, H, hd, hd) matrix memory
    n: torch.Tensor     # (B, H, hd)    normalizer
    m: torch.Tensor     # (B, H)        stabilizer (log-space max)


class SLSTMState(NamedTuple):
    c: torch.Tensor     # (B, D)
    n: torch.Tensor     # (B, D)
    m: torch.Tensor     # (B, D)


class XLSTMState(NamedTuple):
    mlstm: MLSTMState
    slstm: SLSTMState


def mlstm_init(gen: torch.Generator, cfg: ModelConfig, device=None):
    D, H, hd = cfg.d_model, cfg.n_heads, cfg.hd
    pd = cfg.pdtype
    return {
        "wq": common.dense_init(gen, (D, H * hd), pd, device=device),
        "wk": common.dense_init(gen, (D, H * hd), pd, device=device),
        "wv": common.dense_init(gen, (D, H * hd), pd, device=device),
        "w_gates": common.dense_init(gen, (D, 2 * H), pd, device=device),
        "wo": common.dense_init(gen, (H * hd, D), pd, device=device),
        "norm": common.rmsnorm_init(D, pd, device),
    }


def slstm_init(gen: torch.Generator, cfg: ModelConfig, device=None):
    D = cfg.d_model
    pd = cfg.pdtype
    return {
        "w_zifo": common.dense_init(gen, (D, 4 * D), pd, device=device),
        "w_up": common.dense_init(gen, (D, 4 * D), pd, device=device),
        "w_down": common.dense_init(gen, (2 * D, D), pd, device=device),
        "norm": common.rmsnorm_init(D, pd, device),
    }


def _mlstm_step(state: MLSTMState, q, k, v, i_log, f_log):
    """One time step.  q/k/v: (B, H, hd); i_log/f_log: (B, H) log-gates."""
    m_new = torch.maximum(f_log + state.m, i_log)
    i_g = torch.exp(i_log - m_new)                         # (B, H)
    f_g = torch.exp(f_log + state.m - m_new)
    c = f_g[..., None, None] * state.c + i_g[..., None, None] * (
        v[..., :, None] * k[..., None, :])                 # (B,H,hd,hd)
    n = f_g[..., None] * state.n + i_g[..., None] * k
    num = torch.einsum("bhij,bhj->bhi", c, q)
    den = torch.clamp(torch.abs(torch.einsum("bhj,bhj->bh", n, q)),
                      min=1.0)
    return MLSTMState(c=c, n=n, m=m_new), num / den[..., None]


def _replicate_tp(h, p, names, fulls, cd, tp):
    """``h @ p[name]`` for each column-parallel projection, whole on every
    model rank: the recurrent inner math runs replicated over the model
    axis, as the JAX package's sharding constraint pins it."""
    return tuple(tp_mod.column(h, p[name].to(cd), full, tp)
                 for name, full in zip(names, fulls))


def _mlstm_scan_step(st, xs):
    return _mlstm_step(st, *xs)


def mlstm_block(x, p, cfg: ModelConfig,
                state: Optional[MLSTMState] = None,
                tp: Optional[tp_mod.TP] = None):
    B, S, D = x.shape
    H, hd = cfg.n_heads, cfg.hd
    cd = cfg.cdtype
    f32 = torch.float32
    h = common.rmsnorm(x, p["norm"], cfg.norm_eps)
    q, k, v, gates = _replicate_tp(h, p, ("wq", "wk", "wv", "w_gates"),
                                   (H * hd,) * 3 + (2 * H,), cd, tp)
    q = q.reshape(B, S, H, hd).to(f32)
    k = k.reshape(B, S, H, hd).to(f32)
    k = k * (hd ** -0.5)
    v = v.reshape(B, S, H, hd).to(f32)
    gates = gates.reshape(B, S, 2, H)
    i_log = gates[:, :, 0].to(f32)
    f_log = F.logsigmoid(gates[:, :, 1].to(f32))

    if state is None:
        state = mlstm_state_init(B, cfg, device=x.device)

    if S == 1:
        st, y = _mlstm_step(state, q[:, 0], k[:, 0], v[:, 0],
                            i_log[:, 0], f_log[:, 0])
        y = y[:, None]
    else:
        st, ys = chunked_time_scan(
            _mlstm_scan_step, state,
            (q.transpose(0, 1), k.transpose(0, 1), v.transpose(0, 1),
             i_log.transpose(0, 1), f_log.transpose(0, 1)))
        y = ys.transpose(0, 1)                             # (B, S, H, hd)

    out = tp_mod.row(y.reshape(B, S, H * hd).to(cd), p["wo"].to(cd), H * hd,
                     tp)
    return x + out, st


def _slstm_step(state: SLSTMState, z, i_raw, f_raw, o_raw):
    m_new = torch.maximum(f_raw + state.m, i_raw)          # log-space
    i_g = torch.exp(i_raw - m_new)
    f_g = torch.exp(f_raw + state.m - m_new)
    c = f_g * state.c + i_g * torch.tanh(z)
    n = f_g * state.n + i_g
    h = torch.sigmoid(o_raw) * c / torch.clamp(n, min=1.0)
    return SLSTMState(c=c, n=n, m=m_new), h


def _slstm_scan_step(st, xs):
    return _slstm_step(st, *xs)


def slstm_block(x, p, cfg: ModelConfig,
                state: Optional[SLSTMState] = None,
                tp: Optional[tp_mod.TP] = None):
    B, S, D = x.shape
    cd = cfg.cdtype
    f32 = torch.float32
    h = common.rmsnorm(x, p["norm"], cfg.norm_eps)
    (zifo,) = _replicate_tp(h, p, ("w_zifo",), (4 * D,), cd, tp)
    zifo = zifo.reshape(B, S, 4, D)
    z = zifo[:, :, 0].to(f32)
    i_raw = zifo[:, :, 1].to(f32)
    f_raw = F.logsigmoid(zifo[:, :, 2].to(f32))
    o_raw = zifo[:, :, 3].to(f32)

    if state is None:
        state = slstm_state_init(B, cfg, device=x.device)

    if S == 1:
        st, y = _slstm_step(state, z[:, 0], i_raw[:, 0], f_raw[:, 0],
                            o_raw[:, 0])
        y = y[:, None]
    else:
        st, ys = chunked_time_scan(
            _slstm_scan_step, state,
            (z.transpose(0, 1), i_raw.transpose(0, 1), f_raw.transpose(0, 1),
             o_raw.transpose(0, 1)))
        y = ys.transpose(0, 1)

    y = y.to(cd)
    up = tp_mod.column(y, p["w_up"].to(cd), 4 * D, tp)
    a, b = torch.chunk(up, 2, dim=-1)
    # jax.nn.gelu's default is the tanh approximation
    out = tp_mod.row(F.gelu(a, approximate="tanh") * b, p["w_down"].to(cd),
                     2 * D, tp)
    return x + out, st


def mlstm_state_init(batch, cfg: ModelConfig, device=None) -> MLSTMState:
    H, hd = cfg.n_heads, cfg.hd
    f32 = torch.float32
    return MLSTMState(
        c=torch.zeros((batch, H, hd, hd), dtype=f32, device=device),
        n=torch.zeros((batch, H, hd), dtype=f32, device=device),
        m=torch.full((batch, H), -1e30, dtype=f32, device=device),
    )


def slstm_state_init(batch, cfg: ModelConfig, device=None) -> SLSTMState:
    D = cfg.d_model
    f32 = torch.float32
    return SLSTMState(
        c=torch.zeros((batch, D), dtype=f32, device=device),
        n=torch.zeros((batch, D), dtype=f32, device=device),
        m=torch.full((batch, D), -1e30, dtype=f32, device=device),
    )
