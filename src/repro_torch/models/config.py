"""Model configuration dataclasses for the architecture zoo.

Every assigned architecture is expressed as a :class:`ModelConfig`; reduced
smoke-test variants are produced by :meth:`ModelConfig.reduced`.  The same
fields and values as the JAX package's; ``cdtype``/``pdtype`` are
``torch.dtype``s.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    router_z_coef: float = 1e-3
    load_balance_coef: float = 1e-2


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 16
    conv_width: int = 4
    expand: int = 1           # inner dim = expand * d_model


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str               # dense | moe | hybrid | xlstm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None         # default d_model // n_heads
    act: str = "silu"                      # silu | gelu
    norm_eps: float = 1e-5
    rope_theta: float = 10_000.0
    rope_kind: str = "rope"                # rope | mrope | none
    mrope_sections: Tuple[int, ...] = (16, 24, 24)   # t/h/w head-dim split
    attn_kind: str = "full"                # full | sliding | alternating
    window: int = 4096                     # sliding-window size
    softcap_attn: float = 0.0              # gemma2: 50.0
    softcap_final: float = 0.0             # gemma2: 30.0
    post_block_norm: bool = False          # gemma2 sandwich norms
    qk_norm: bool = False
    tie_embeddings: bool = True
    embed_frontend: str = "tokens"         # tokens | stub (audio/vlm frames)
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None        # hybrid: parallel attn+ssm heads
    logit_scale: Optional[float] = None
    scale_embed: bool = False              # gemma: x *= sqrt(d_model)
    moe_group: int = 1024                  # MoE dispatch group size
    # attention tensor-parallel layout of the JAX package ('auto', 'heads'
    # or 'replicate'); the port has no model axis yet and ignores it
    attn_shard: str = "auto"
    # --- numerics / training ---
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # sub-quadratic decode? (drives long_500k applicability)
    subquadratic: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def cdtype(self):
        return getattr(torch, self.compute_dtype)

    @property
    def pdtype(self):
        return getattr(torch, self.param_dtype)

    def reduced(self) -> "ModelConfig":
        """A tiny same-family variant for CPU smoke tests."""
        changes = dict(
            param_dtype="float32",
            compute_dtype="float32",
            n_layers=max(2, min(4, self.n_layers)),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            head_dim=32,
            d_ff=256 if self.d_ff else 0,
            vocab=256,
            window=32,
        )
        if self.moe is not None:
            changes["moe"] = dataclasses.replace(
                self.moe, num_experts=min(8, self.moe.num_experts),
                top_k=min(2, self.moe.top_k), d_ff_expert=64)
        if self.ssm is not None:
            changes["ssm"] = dataclasses.replace(self.ssm, state_dim=8)
        if self.mrope_sections:
            changes["mrope_sections"] = (8, 12, 12)
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned (input-shape) cell."""
    name: str                 # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                 # train | prefill | decode

    @property
    def is_train(self) -> bool:
        return self.kind == "train"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}
