"""gemma2-27b [dense]: 46L d=4608 32H (GQA kv=16) ff=36864 vocab=256000.
Local+global alternating attention, logit softcaps, sandwich norms.
[arXiv:2408.00118; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b", family="dense",
    n_layers=46, d_model=4608, n_heads=32, n_kv_heads=16, d_ff=36864,
    vocab=256_000, head_dim=128, act="gelu", rope_theta=10_000.0,
    attn_kind="alternating", window=4096,
    softcap_attn=50.0, softcap_final=30.0, post_block_norm=True,
    scale_embed=True, tie_embeddings=True,
    param_dtype="bfloat16",
)
