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
* ``flash_attention`` — K7, online-softmax attention with causal and
  local-window masks and grouped-query heads (``flash_attention``), which
  every attention layer of the port's models launches on the card.
* ``ssd_chunk`` — K8, the Mamba-2 SSD intra-chunk block (``ssd_chunk``),
  with the chunked SSD around it (``ssd``) and the one-token update
  (``ssd_decode_step``).
"""
from . import dodoor_choice, flash_attention, rl_score, ssd_chunk
from ._wrap import LAUNCHES

__all__ = ["LAUNCHES", "dodoor_choice", "flash_attention", "rl_score",
           "ssd_chunk"]
