"""qwen2-vl-72b [vlm]: 80L d=8192 64H (GQA kv=8) ff=29568 vocab=152064.
M-RoPE (t/h/w sections), dynamic-resolution vision frontend is a stub —
inputs are precomputed patch embeddings + 3D position ids.
[arXiv:2409.12191; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=29568,
    vocab=152064, head_dim=128, act="silu", rope_theta=1_000_000.0,
    rope_kind="mrope", mrope_sections=(16, 24, 24),
    attn_kind="full", tie_embeddings=False,
    embed_frontend="stub",
    param_dtype="bfloat16",
)
