"""granite-moe-3b-a800m [moe]: 32L d=1536 24H (GQA kv=8) expert ff=512
vocab=49155, MoE 40 experts top-8.  [hf:ibm-granite family; hf]"""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8, d_ff=512,
    vocab=49155, act="silu", rope_theta=10_000.0,
    attn_kind="full", tie_embeddings=True,
    moe=MoEConfig(num_experts=40, top_k=8, d_ff_expert=512),
    param_dtype="bfloat16",
)
