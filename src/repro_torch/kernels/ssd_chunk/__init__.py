"""Mamba-2 SSD chunk kernel K8 and its backward: CUDA kernels
(``kernel.py`` launches ``csrc/ssd_chunk.cu``), wrappers (``ops.py``:
``ssd_chunk``, ``ssd_chunk_bwd``, and ``ssd`` and ``ssd_decode_step``
around them) and plain-torch versions (``ref.py``) — the three layers of
the JAX reference, plus a backward it does not have."""
from .ops import LAUNCHES, ssd, ssd_chunk, ssd_chunk_bwd, ssd_decode_step
from .ref import ssd_chunk_bwd_ref, ssd_chunk_ref, ssd_ref

__all__ = ["LAUNCHES", "ssd", "ssd_chunk", "ssd_chunk_bwd",
           "ssd_chunk_bwd_ref", "ssd_chunk_ref", "ssd_decode_step",
           "ssd_ref"]
