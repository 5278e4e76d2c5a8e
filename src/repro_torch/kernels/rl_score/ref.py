"""Plain-torch version of the RL score matrix K6: the port's core form
(:func:`repro_torch.core.rl_score.rl_score_matrix`), as the reference's
``ref.py`` delegates to its core.  The wrapper runs it for tensors on the
CPU; ``chip_smoke.py`` holds the CUDA kernel against it on the card."""
from __future__ import annotations

from ...core.rl_score import rl_score_matrix


def rl_score_matrix_ref(r, L, C):
    """score[t, j] = (r_t · L_j) / ‖C_j‖² — Eq. 1 batched, [T, K] × [N, K]
    → [T, N] float32."""
    return rl_score_matrix(r, L, C)
