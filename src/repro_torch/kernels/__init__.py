"""repro_torch.kernels — hand-written CUDA kernels for Hopper that replace
the JAX reference's Pallas TPU kernels.

Each kernel package has ``kernel.py`` (the ctypes launcher of a
``csrc/*.cu`` source built by :mod:`._build`), ``ops.py`` (the checked
public wrapper, counted in the shared ``LAUNCHES``) and ``ref.py`` (the
plain-torch version the CPU runs and the card is held against).

* ``dodoor_choice`` — the Dodoor decision kernels, one CUDA source: K1,
  the sparse-gather sample → score → select kernel of the batched
  driver's decision step; K2, its masked form with down-window
  availability in the prefilter; K3, the locality form of either; K4,
  the dense form with a [T, N] duration plane (``dodoor_fused``, plain
  and masked by an availability plane); K5, score and select for
  pre-sampled pairs (``dodoor_choice``, behind
  ``core.dodoor_choice_batch(use_kernel=True)``).
* ``rl_score`` — K6, the batched Eq.-1 score matrix
  (``rl_score_matrix``).
"""
from . import dodoor_choice, rl_score
from ._wrap import LAUNCHES

__all__ = ["LAUNCHES", "dodoor_choice", "rl_score"]
