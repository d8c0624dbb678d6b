"""Summation buffers (paper §V-A), faithfully.

A summation buffer is a per-group array of pending input values plus a
``next`` offset; values are appended until the buffer fills, at which point
the whole buffer is flushed through the vectorized summation routine into the
group's ``repro`` accumulator.

:func:`append` reproduces the paper's per-tuple control flow exactly (lookup
-> append -> flush-on-full), one tuple at a time; it is the baseline for the
fidelity tests and microbenchmarks at small n.  The group ids and the
``next`` offsets are read to the host once per call, so the per-tuple
control flow costs no device synchronisation.  The throughput path is the
segment kernel behind :func:`repro_torch.ops.groupby_agg`.

The buffer-size model (paper Eq. 4) is :func:`optimal_bsz`.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import accumulator as acc_mod
from repro_torch.core.accumulator import ReproAcc
from repro_torch.core.types import ReproSpec
from repro_torch.device import resolve_device

__all__ = ["BufferState", "init", "append", "flush_all", "optimal_bsz"]

LLC_BYTES_PER_CORE = 1 * 2 ** 20        # paper §VI-D: ~1 MiB effective / core


def optimal_bsz(n_groups: int, fanout: int, itemsize: int,
                cache_bytes: int = LLC_BYTES_PER_CORE,
                bsz_max: int = 4096) -> int:
    """Paper Eq. 4: bsz = min(|cache| / (n_groups/F * sizeof), bsz_max)."""
    per_partition = max(1, n_groups // max(1, fanout))
    bsz = cache_bytes // (per_partition * itemsize)
    return int(max(1, min(bsz, bsz_max)))


class BufferState(NamedTuple):
    buf: torch.Tensor   # (G, bsz) pending values
    nxt: torch.Tensor   # (G,) int32 next free slot
    acc: ReproAcc       # (G,) group accumulators


def init(num_groups: int, bsz: int, spec: ReproSpec,
         device=None) -> BufferState:
    """Empty buffers and zero accumulators for ``num_groups`` groups, on
    ``device`` (``None``: the card)."""
    device = resolve_device(device)
    return BufferState(
        buf=torch.zeros((num_groups, bsz), dtype=spec.dtype, device=device),
        nxt=torch.zeros((num_groups,), dtype=torch.int32, device=device),
        acc=acc_mod.zeros(spec, (num_groups,), device=device),
    )


def _flush_row(acc: ReproAcc, row, gid: int, spec: ReproSpec) -> None:
    """acc[gid] += rsum(row), in place — one buffer flush through the
    summation routine."""
    part = acc_mod.from_values(row, spec)
    gacc = ReproAcc(k=acc.k[gid], C=acc.C[gid], e1=acc.e1[gid])
    acc.k[gid], acc.C[gid], acc.e1[gid] = acc_mod.merge(gacc, part, spec)


def append(state: BufferState, segment_ids, values, spec: ReproSpec
           ) -> BufferState:
    """Process <key, value> pairs one tuple at a time (paper §V-A)."""
    bsz = state.buf.shape[1]
    dev = state.buf.device
    values = torch.as_tensor(values).to(device=dev, dtype=spec.dtype)
    buf = state.buf.clone()
    acc = ReproAcc(*(t.clone() for t in state.acc))
    nxt = state.nxt.tolist()
    for i, gid in enumerate(torch.as_tensor(segment_ids).tolist()):
        buf[gid, nxt[gid]] = values[i]
        nxt[gid] += 1
        if nxt[gid] == bsz:
            _flush_row(acc, buf[gid], gid, spec)
            nxt[gid] = 0
    return BufferState(buf, torch.tensor(nxt, dtype=torch.int32, device=dev),
                       acc)


def flush_all(state: BufferState, spec: ReproSpec) -> ReproAcc:
    """Flush every partially-filled buffer (end of input) and return the
    per-group accumulators (vectorized over groups)."""
    bsz = state.buf.shape[1]
    mask = torch.arange(bsz, device=state.buf.device) < \
        state.nxt[:, None]
    vals = torch.where(mask, state.buf, 0)
    tail = acc_mod.from_values(vals, spec, axis=1)
    return acc_mod.merge(state.acc, tail, spec)
