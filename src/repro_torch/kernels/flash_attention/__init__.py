"""Flash attention K7: CUDA kernel (``kernel.py`` launches
``csrc/flash_attention.cu``), wrapper (``ops.py``) and plain-torch version
(``ref.py``) — the same three layers as the JAX reference — and its
backward, in the same three layers, which the reference does not have."""
from .ops import (LAUNCHES, flash_attention, flash_attention_bwd,
                  flash_attention_lse)
from .ref import attention_bwd_ref, attention_lse_ref, attention_ref

__all__ = ["LAUNCHES", "attention_bwd_ref", "attention_lse_ref",
           "attention_ref", "flash_attention", "flash_attention_bwd",
           "flash_attention_lse"]
