"""Dodoor decision kernels K1 and K2 (its masked form): CUDA kernel
(``kernel.py`` launches ``csrc/dodoor_fused_sparse.cu``), wrapper
(``ops.py``) and plain-torch version (``ref.py``) — the same three layers
as the JAX reference."""
from .ops import LAUNCHES, dodoor_fused_sparse
from .ref import dodoor_fused_sparse_ref

__all__ = ["LAUNCHES", "dodoor_fused_sparse", "dodoor_fused_sparse_ref"]
