"""stablelm-3b [dense]: 32L d=2560 32H (GQA kv=32, i.e. MHA) ff=6912
vocab=50304.  [hf:stabilityai/stablelm-2-1_6b family; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b", family="dense",
    n_layers=32, d_model=2560, n_heads=32, n_kv_heads=32, d_ff=6912,
    vocab=50304, act="silu", rope_theta=10_000.0,
    attn_kind="full", tie_embeddings=False,
    param_dtype="bfloat16",
)
