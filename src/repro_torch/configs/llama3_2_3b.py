"""llama3.2-3b [dense]: 28L d=3072 24H (GQA kv=8) ff=8192 vocab=128256.
[hf:meta-llama/Llama-3.2-1B family; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b", family="dense",
    n_layers=28, d_model=3072, n_heads=24, n_kv_heads=8, d_ff=8192,
    vocab=128256, head_dim=128, act="silu", rope_theta=500_000.0,
    attn_kind="full", tie_embeddings=True,
    param_dtype="bfloat16",
)
