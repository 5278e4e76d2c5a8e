"""Plain-torch version of the RL score matrix K6, in the form of the
reference's jitted wrapper (``repro.kernels.rl_score.rl_score_matrix``):
the dot ``r·L`` is a fused multiply-add chain in k order, scaled by
``1/ΣC²``, bit for bit.  ``ΣC²`` is reduced by the wrapper outside the
Pallas kernel, and at K ≥ 5 XLA:CPU picks its order by the number of
servers N (:func:`unfused_columns`).  At K = 2, the width the simulator
uses, this is also the core form
(:func:`repro_torch.core.rl_score.rl_score_matrix`).  The wrapper runs it
for tensors on the CPU; ``chip_smoke.py`` holds the CUDA kernel against it
on the card."""
from __future__ import annotations

import torch

from ..._arith import dot_fma


#: From this many servers on, the vectorised ``ΣC²`` at K = 5..8 runs an
#: 8-wide remainder loop after its main loop, below it a 4-wide one.
_WIDE_FROM = {5: 40, 6: 32, 7: 80, 8: 80}


def unfused_columns(N: int, K: int) -> int:
    """How many leading columns (servers) of ``ΣC²`` XLA:CPU sums as
    rounded squares added left to right; the rest, and every column at
    K ≤ 4, are a fused multiply-add chain.  At K ≥ 5 the reference's
    wrapper reduces ``ΣC²`` in a loop over the servers that XLA:CPU
    vectorises only at some widths (it pads the result to a multiple of
    128); its vector lanes neither contract nor reorder and its scalar
    remainder contracts.  Mapped column by column against the reference
    on the CPU (``tests/test_torch_f4.py``): N ∈ {2, 4, 8} every column;
    16 ≤ N ≤ 128 the first 4⌊N/4⌋, or 8⌊N/8⌋ from ``_WIDE_FROM[K]``
    servers on; N > 128 with N mod 128 ∈ {0, 127} the first 8⌊N/8⌋;
    otherwise none.  One column is not replayed: at N = 2, K = 5
    XLA:CPU contracts the last terms of column 1, which this rule sums
    unfused (ROADMAP §3, F4)."""
    if K < 5:
        return 0
    if N in (2, 4, 8):
        return N
    if 16 <= N <= 128:
        return 8 * (N // 8) if N >= _WIDE_FROM[K] else 4 * (N // 4)
    if N > 128 and N % 128 in (0, 127):
        return 8 * (N // 8)
    return 0


def inv_norms(C: torch.Tensor) -> torch.Tensor:
    """``1 / Σ_k C[j, k]²`` for every server j ([N, K] → [N]), the sum in
    the order :func:`unfused_columns` gives column j."""
    N, K = C.shape
    acc = dot_fma(C, C)
    nvec = unfused_columns(N, K)
    if nvec:
        sq = C * C
        unf = sq[:, 0]
        for k in range(1, K):
            unf = unf + sq[:, k]
        acc = torch.where(torch.arange(N, device=C.device) < nvec, unf, acc)
    return 1.0 / acc


def rl_score_matrix_ref(r, L, C):
    """score[t, j] = (r_t · L_j) / ‖C_j‖² — Eq. 1 batched, [T, K] × [N, K]
    → [T, N] float32."""
    return dot_fma(r[:, None, :], L[None, :, :]) * inv_norms(C)[None, :]
