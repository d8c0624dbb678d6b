"""hymba-1.5b [hybrid]: 32L d=1600 25H (GQA kv=5) ff=5504, parallel
attention + mamba heads, ssm_state=16, sliding-window attention.
[arXiv:2411.13676; hf]"""
from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, d_ff=5504,
    vocab=32001, act="silu", rope_theta=10_000.0,
    attn_kind="sliding", window=1024, tie_embeddings=True,
    ssm=SSMConfig(state_dim=16), subquadratic=True,
    param_dtype="bfloat16",
)
