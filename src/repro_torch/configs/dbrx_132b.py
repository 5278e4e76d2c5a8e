"""dbrx-132b [moe] — 16 experts top-4, fine-grained
[hf:databricks/dbrx-base; unverified]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b", family="moe",
    n_layers=40, d_model=6144, n_heads=48, n_kv=8, d_ff=10752,
    vocab=100352, n_experts=16, top_k=4, moe_d_ff=10752,
    rope_theta=5e5, act="silu",
)
