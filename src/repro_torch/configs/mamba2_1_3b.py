"""mamba2-1.3b [ssm] — SSD (state-space duality), attention-free
[arXiv:2405.21060; unverified]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=0, n_kv=0, d_ff=0,
    vocab=50280, ssm_state=128, ssm_expand=2, ssm_headdim=64,
    ssm_groups=1, conv_kernel=4, tie_embeddings=True,
)
