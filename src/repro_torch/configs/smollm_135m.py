"""smollm-135m [dense]: 30L d=576 9H (GQA kv=3) ff=1536 vocab=49152.
llama-arch small.  [hf:HuggingFaceTB/SmolLM-135M; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m", family="dense",
    n_layers=30, d_model=576, n_heads=9, n_kv_heads=3, d_ff=1536,
    vocab=49152, act="silu", rope_theta=10_000.0,
    attn_kind="full", tie_embeddings=True,
    param_dtype="bfloat16",
)
