"""repro_torch.kernels — hand-written CUDA kernels for Hopper that replace
the JAX reference's Pallas TPU kernels.

Each kernel package has ``kernel.py`` (the ctypes launcher of a
``csrc/*.cu`` source built by :mod:`._build`), ``ops.py`` (the checked
public wrapper with a launch counter) and ``ref.py`` (the plain-torch
version the CPU runs and the card is held against).

* ``dodoor_choice`` — K1, the sparse-gather sample → score → select kernel
  of the batched driver's decision step, and K2, its masked form with
  down-window availability in the prefilter (one CUDA template).
"""
from . import dodoor_choice

__all__ = ["dodoor_choice"]
