"""Mamba-2 SSD chunk kernel K8: CUDA kernel (``kernel.py`` launches
``csrc/ssd_chunk.cu``), wrappers (``ops.py``: ``ssd_chunk``, and ``ssd``
and ``ssd_decode_step`` around it) and plain-torch versions (``ref.py``) —
the same three layers as the JAX reference."""
from .ops import LAUNCHES, ssd, ssd_chunk, ssd_decode_step
from .ref import ssd_chunk_ref, ssd_ref

__all__ = ["LAUNCHES", "ssd", "ssd_chunk", "ssd_chunk_ref", "ssd_decode_step",
           "ssd_ref"]
