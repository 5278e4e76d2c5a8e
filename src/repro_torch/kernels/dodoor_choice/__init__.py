"""Dodoor decision kernels: K1 (sparse-gather sample → score → select),
K2 (its masked form, down-window availability in the prefilter), K3 (the
locality form of either), K4 (the dense form, plain and masked by an
availability plane) and K5 (score and select for pre-sampled pairs).
Each has a CUDA kernel (``kernel.py`` launches
``csrc/dodoor_fused_sparse.cu``), a wrapper (``ops.py``) and a plain-torch
version (``ref.py``) — the same three layers as the JAX reference."""
from .ops import LAUNCHES, dodoor_choice, dodoor_fused, dodoor_fused_sparse
from .ref import dodoor_choice_ref, dodoor_fused_ref, dodoor_fused_sparse_ref

__all__ = ["LAUNCHES", "dodoor_choice", "dodoor_choice_ref", "dodoor_fused",
           "dodoor_fused_ref", "dodoor_fused_sparse",
           "dodoor_fused_sparse_ref"]
