"""Plain-torch version of the RL score matrix K6, in the reference's
Pallas kernel's form: both K-long sums are fused multiply-add chains in k
order, scaled by ``1/ΣC²`` (bit for bit against the jitted
``repro.kernels.rl_score.rl_score_matrix``).  At K = 2, the width the
simulator uses, this is also the core form
(:func:`repro_torch.core.rl_score.rl_score_matrix`); at K = 4 and 8 the
core form follows XLA:CPU's own order instead.  The wrapper runs it for
tensors on the CPU; ``chip_smoke.py`` holds the CUDA kernel against it on
the card."""
from __future__ import annotations

from ..._arith import dot_fma


def rl_score_matrix_ref(r, L, C):
    """score[t, j] = (r_t · L_j) / ‖C_j‖² — Eq. 1 batched, [T, K] × [N, K]
    → [T, N] float32."""
    inv = 1.0 / dot_fma(C, C)                                   # [N]
    return dot_fma(r[:, None, :], L[None, :, :]) * inv[None, :]
