"""xlstm-350m [ssm]: 24L d=1024 4H ff=0 vocab=50304 — alternating
sLSTM + mLSTM blocks (blocks carry their own projections; no separate FFN).
[arXiv:2405.04517; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m", family="xlstm",
    n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4, d_ff=0,
    vocab=50304, head_dim=256, act="gelu", rope_kind="none",
    attn_kind="full", tie_embeddings=True, subquadratic=True,
    param_dtype="bfloat16",
)
