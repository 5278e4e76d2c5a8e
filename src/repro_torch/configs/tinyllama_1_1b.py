"""tinyllama-1.1b [dense] — llama2-arch small [arXiv:2401.02385; hf]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b", family="dense",
    n_layers=22, d_model=2048, n_heads=32, n_kv=4, d_ff=5632,
    vocab=32000, rope_theta=1e4, act="silu",
)
