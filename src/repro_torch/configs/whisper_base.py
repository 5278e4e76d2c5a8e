"""whisper-base [audio] — enc-dec; conv frontend is a STUB (input_specs
provides precomputed 1500-frame embeddings) [arXiv:2212.04356; unverified]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", family="audio",
    n_layers=6, d_model=512, n_heads=8, n_kv=8, d_ff=2048,
    vocab=51865, encoder_layers=6, encoder_frames=1500,
    rope_theta=1e4, act="gelu", tie_embeddings=True,
)
