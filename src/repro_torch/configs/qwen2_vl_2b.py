"""qwen2-vl-2b [vlm] — M-RoPE, dynamic resolution; transformer BACKBONE only,
vision frontend is a stub providing precomputed patch embeddings
[arXiv:2409.12191; hf]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b", family="vlm",
    n_layers=28, d_model=1536, n_heads=12, n_kv=2, d_ff=8960,
    vocab=151936, qkv_bias=True, mrope=True, rope_theta=1e6,
    vision_patches=1024, act="silu",
)
