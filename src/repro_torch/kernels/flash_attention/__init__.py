"""Flash attention K7: CUDA kernel (``kernel.py`` launches
``csrc/flash_attention.cu``), wrapper (``ops.py``) and plain-torch version
(``ref.py``) — the same three layers as the JAX reference."""
from .ops import LAUNCHES, flash_attention
from .ref import attention_ref

__all__ = ["LAUNCHES", "attention_ref", "flash_attention"]
