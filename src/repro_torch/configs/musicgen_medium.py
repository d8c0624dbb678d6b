"""musicgen-medium [audio]: 48L d=1536 24H (kv=24) ff=6144 vocab=2048.
Decoder-only over EnCodec tokens; the EnCodec frontend itself is a stub —
inputs are code tokens / precomputed frame embeddings.  [arXiv:2306.05284]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium", family="audio",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24, d_ff=6144,
    vocab=2048, act="gelu", rope_theta=10_000.0,
    attn_kind="full", tie_embeddings=False,
    embed_frontend="stub",
    param_dtype="bfloat16",
)
