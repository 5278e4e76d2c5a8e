"""granite-3-8b [dense] — GQA [hf:ibm-granite/granite-3.0-2b-base; hf]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-8b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv=8, d_ff=12800,
    vocab=49155, rope_theta=1e4, act="silu", tie_embeddings=True,
)
