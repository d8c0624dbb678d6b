"""Deterministic, sharded, checkpointable synthetic data pipeline.

The reproducibility contract requires that the *content* of every
microbatch quantum be a pure function of its global index — never of the
process count.  Quantum q of step s is drawn from the key
``fold_in(fold_in(PRNGKey(seed), s), q)``; ranks then take the quanta
assigned to their data shard.  Re-sharding the data axis therefore
redistributes the *same* quanta, and the reproducible gradient
accumulation makes the resulting update bit-identical.

The tokens are the JAX package's: its threefry2x32 counter generator, key
derivation and uniform-bits-to-float step are rebuilt here in exact
integer arithmetic (int64 tensors holding uint32 words), which gives
``jax.random``'s bits on any device.  The Gumbel step ``-log(-log(u))``
and the argmax run in float32 on the target device; a ``log`` one ulp away
from XLA's could flip a near tie, which the tests check does not happen on
their shapes.  The pipeline state is a single integer (next step).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterator, Optional

import torch

from repro_torch.device import resolve_device

__all__ = ["DataConfig", "synth_quantum", "synth_batch", "PipelineState",
           "DataPipeline", "threefry2x32", "prng_key", "fold_in",
           "random_bits", "uniform"]

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(key, x0, x1):
    """Threefry-2x32, 20 rounds (Salmon et al.), as ``jax.random`` runs it.

    ``key`` is a pair of uint32 words (Python ints); ``x0``/``x1`` are the
    counter words, Python ints or int64 tensors holding values below 2^32.
    Returns the two output words in the same form."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def prng_key(seed: int) -> tuple:
    """``jax.random.PRNGKey(seed)`` for a seed in [0, 2^63)."""
    return ((seed >> 32) & _MASK, seed & _MASK)


def fold_in(key: tuple, data: int) -> tuple:
    """``jax.random.fold_in(key, data)``."""
    return threefry2x32(key, 0, data & _MASK)


def random_bits(key: tuple, n: int, device, offset: int = 0) -> torch.Tensor:
    """32 random bits for each of the linear indices ``offset .. offset +
    n`` of a draw (``jax.random``'s partitionable threefry: the index as
    the counter, the two output words xor-ed); int64 tensor of values below
    2^32."""
    i = torch.arange(offset, offset + n, dtype=torch.int64, device=device)
    y0, y1 = threefry2x32(key, i >> 32, i & _MASK)
    return y0 ^ y1


def uniform(bits: torch.Tensor, minval: float, maxval: float) -> torch.Tensor:
    """float32 uniforms from 32 random bits, as ``jax.random.uniform``:
    23 mantissa bits under the exponent of 1.0, minus 1, scaled, shifted
    and clamped below at ``minval``."""
    one = torch.tensor(1.0, dtype=torch.float32)
    fbits = (bits >> 9) | int(one.view(torch.int32))
    floats = fbits.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=bits.device)
    span = torch.tensor(maxval, dtype=torch.float32) - lo.cpu()
    return torch.maximum(lo, floats * span.to(bits.device) + lo)


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int
    global_batch: int          # sequences per step
    seq_len: int
    vocab: int
    embed_dim: int = 0         # stub frontends: emit embeddings too
    mrope: bool = False


def _quantum_key(dcfg: DataConfig, step: int, quantum: int) -> tuple:
    return fold_in(fold_in(prng_key(dcfg.seed), step), quantum)


def synth_quantum(dcfg: DataConfig, step: int, quantum: int,
                  device=None) -> torch.Tensor:
    """One sequence (the accumulation quantum): pure function of indices.

    Tokens are Zipf(1.2)-distributed over the vocab rather than uniform (a
    uniform stream has nothing to learn): ``jax.random.categorical`` over
    the logits ``-1.2 * log(rank)``, i.e. the argmax of the logits plus
    Gumbel noise.  Returns int32 (seq_len + 1,).
    """
    dev = resolve_device(device)
    key = _quantum_key(dcfg, step, quantum)
    ranks = torch.arange(dcfg.vocab, dtype=torch.float32, device=dev) + 1.0
    logits = -1.2 * torch.log(ranks)
    n = (dcfg.seq_len + 1) * dcfg.vocab
    tiny = torch.finfo(torch.float32).tiny
    u = uniform(random_bits(key, n, dev), tiny, 1.0)
    gumbel = -torch.log(-torch.log(u))
    noisy = gumbel.reshape(dcfg.seq_len + 1, dcfg.vocab) + logits
    return torch.argmax(noisy, dim=-1).to(torch.int32)


def _normal(key: tuple, shape: tuple, offset: int, device) -> torch.Tensor:
    """float32 standard normals (``jax.random.normal``'s inverse-erf
    method) at linear indices ``offset ..`` of a draw."""
    lo = torch.nextafter(torch.tensor(-1.0, dtype=torch.float32),
                         torch.tensor(0.0, dtype=torch.float32))
    bits = random_bits(key, math.prod(shape), device, offset)
    u = uniform(bits, float(lo), 1.0)
    return (math.sqrt(2) * torch.erfinv(u)).reshape(shape)


def synth_batch(dcfg: DataConfig, step: int, lo: int, hi: int, device=None):
    """Quanta [lo, hi) of a step, as a dict of tensors on ``device``.

    Stub frontends also get ``embeds``: normals from one key per step,
    indexed by the *global* quantum, so a slice equals the same rows of the
    whole step's draw (``synth_batch(.., 0, global_batch)``, as the
    trainer builds it).
    """
    dev = resolve_device(device)
    toks = torch.stack([synth_quantum(dcfg, step, q, dev)
                        for q in range(lo, hi)])
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    if dcfg.embed_dim:
        key = fold_in(prng_key(dcfg.seed ^ 0x5A5A), step)
        row = dcfg.seq_len * dcfg.embed_dim
        batch["embeds"] = _normal(key, (hi - lo, dcfg.seq_len,
                                        dcfg.embed_dim), lo * row, dev) \
            * 0.02
        del batch["tokens"]
    if dcfg.mrope:
        pos = torch.arange(dcfg.seq_len, dtype=torch.int32, device=dev)
        batch["positions"] = pos.expand(hi - lo, 3, dcfg.seq_len)
    return batch


@dataclasses.dataclass
class PipelineState:
    step: int = 0

    def to_dict(self):
        return {"step": int(self.step)}

    @classmethod
    def from_dict(cls, d):
        return cls(step=int(d["step"]))


class DataPipeline:
    """Iterator over per-step batches for one data shard.

    ``shard``/``num_shards`` describe this rank's slice of the data axis;
    changing num_shards (elastic re-scale) redistributes identical quanta.
    """

    def __init__(self, dcfg: DataConfig, shard: int = 0, num_shards: int = 1,
                 state: Optional[PipelineState] = None, device=None):
        if dcfg.global_batch % num_shards:
            raise ValueError(f"global batch {dcfg.global_batch} does not "
                             f"split over {num_shards} shards")
        self.dcfg = dcfg
        self.shard = shard
        self.num_shards = num_shards
        self.state = state or PipelineState()
        self.device = resolve_device(device)

    @property
    def per_shard(self) -> int:
        return self.dcfg.global_batch // self.num_shards

    def next_batch(self):
        s = self.state.step
        lo = self.shard * self.per_shard
        batch = synth_batch(self.dcfg, s, lo, lo + self.per_shard,
                            self.device)
        self.state.step += 1
        return batch

    def __iter__(self) -> Iterator[dict]:
        while True:
            yield self.next_batch()
