"""smollm-135m [dense] — llama-arch small [hf:HuggingFaceTB/SmolLM-135M; hf]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m", family="dense",
    n_layers=30, d_model=576, n_heads=9, n_kv=3, d_ff=1536,
    vocab=49152, rope_theta=1e4, act="silu", tie_embeddings=True,
)
