"""recurrentgemma-2b [hybrid] — RG-LRU + local attention, pattern
(recurrent, recurrent, attention) [arXiv:2402.19427; hf]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv=1, d_ff=7680,
    vocab=256000, window=2048, lru_width=2560,
    block_pattern=("rglru", "rglru", "attn"),
    head_dim=256, act="gelu", tie_embeddings=True,
)
