"""The anti-affinity Resource-Load score and LOADSCORE (§3.2, Algorithm 1)
— counterpart of ``repro.core.rl_score``.

    RL(r, L_j, C_j) = (r · L_j) / Σ_k C_jk²
    loadScore_j = (1-α)·RL_j/(RL_j+RL_p) + α·(D_j+d_j)/(D_j+d_j+D_p+d_p)

Lower is better.  :func:`rl_score_matrix` is Eq. 1 for a block of tasks
against every server (the kernel K6 computes it on the card).  The
arithmetic follows the reference as XLA:CPU runs it
(see :mod:`repro_torch._arith`): the products ``r·L`` and ``Σ C²`` are
fused multiply-add chains, ``RL_j / (ΣRL + ε)`` is evaluated as
``(r·L_j) / (ΣC_j² · (ΣRL + ε))``, and the α-mix is one fused
multiply-add (on the duration term when the RL term falls back to 0.5).
"""
from __future__ import annotations

import torch

from .._arith import dot_fma, fma

_EPS = 1e-9  # guards 0/0 when both candidates are fully idle


def rl(r: torch.Tensor, L: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """Eq. 1 for one (task, server) pair: r, L, C are [K]."""
    return dot_fma(r, L) / dot_fma(C, C)


def rl_score_matrix(r: torch.Tensor, L: torch.Tensor,
                    C: torch.Tensor) -> torch.Tensor:
    """Batched Eq. 1: tasks r [T, K] × servers L, C [N, K] → scores
    [T, N], ``score[t, j] = (r_t · L_j) · (1 / Σ_k C_jk²)``.

    The reference's core form ``(r @ L.T) * inv`` as XLA:CPU runs it
    (ROADMAP hazard P4): ``r·L`` is a fused multiply-add chain in k order
    at K = 2; at K = 4 the four products are summed pairwise, ``(p0 + p1)
    + (p2 + p3)``; at K = 8 four accumulators ``p_i`` take ``p_{i+4}`` by
    a fused multiply-add and are summed the same way.  ``Σ C²`` is a chain
    of fused multiply-adds, except at 5 ≤ K ≤ 8 over N ≥ 16 servers,
    where the squares are summed left to right without contraction.
    XLA:CPU picks its dot's order by shape as well: at some (T, N) it
    runs the K = 4 and K = 8 dot as a chain (or as two interleaved
    accumulators), which this form does not replay (ROADMAP §3, F1).
    The kernel K6 and its plain version keep the chain at every K."""
    inv = 1.0 / _sum_squares(C)                                 # [N]
    return _core_dot(r[:, None, :], L[None, :, :]) * inv[None, :]


def _core_dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    K = x.shape[-1]
    if K == 4:
        p = x * y
        return (p[..., 0] + p[..., 1]) + (p[..., 2] + p[..., 3])
    if K == 8:
        acc = fma(x[..., 4:], y[..., 4:], x[..., :4] * y[..., :4])
        return (acc[..., 0] + acc[..., 1]) + (acc[..., 2] + acc[..., 3])
    return dot_fma(x, y)


def _sum_squares(C: torch.Tensor) -> torch.Tensor:
    N, K = C.shape
    if 5 <= K <= 8 and N >= 16:
        sq = C * C
        acc = sq[:, 0]
        for k in range(1, K):
            acc = acc + sq[:, k]
        return acc
    return dot_fma(C, C)


def _mix(rl_num, rl_den, rl_sum, D, d_sum, alpha, fold_fallback: bool):
    """One candidate's normalized score from its RL numerator/denominator.
    In the batched form (``fold_fallback``) the reference folds the
    constant ``0.5·(1-α)`` where the RL term falls back to 0.5 and
    contracts the duration term instead; the pair form does not."""
    half = torch.full_like(D, 0.5)
    rl_ok = rl_sum > _EPS
    rl_frac = torch.where(rl_ok, rl_num / (rl_den * (rl_sum + _EPS)), half)
    d_frac = torch.where(d_sum > _EPS, D / (d_sum + _EPS), half)
    one_m = 1.0 - alpha
    score = fma(rl_frac, one_m, d_frac * alpha)
    if fold_fallback:
        score = torch.where(rl_ok, score, fma(d_frac, alpha, half * one_m))
    return score


def _alpha(alpha, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(alpha, dtype=torch.float32, device=like.device)


def load_score_pair(r, L_a, L_b, D_a, D_b, C_a, C_b, alpha):
    """LOADSCORE for candidates A and B of one task.  ``D_a``/``D_b``
    already include the task's own duration on the candidate.  Returns
    (score_A, score_B); the lower one wins."""
    alpha = _alpha(alpha, r)
    num_a, den_a = dot_fma(r, L_a), dot_fma(C_a, C_a)
    num_b, den_b = dot_fma(r, L_b), dot_fma(C_b, C_b)
    rl_sum = num_a / den_a + num_b / den_b
    d_sum = D_a + D_b
    return (_mix(num_a, den_a, rl_sum, D_a, d_sum, alpha, False),
            _mix(num_b, den_b, rl_sum, D_b, d_sum, alpha, False))


def load_score_batched(r: torch.Tensor, L_ab: torch.Tensor,
                       D_ab: torch.Tensor, C_ab: torch.Tensor,
                       alpha) -> torch.Tensor:
    """r [T, K], L_ab [T, 2, K], D_ab [T, 2], C_ab [T, 2, K] → [T, 2]."""
    alpha = _alpha(alpha, r)
    num = dot_fma(r[:, None, :], L_ab)                          # [T, 2]
    den = dot_fma(C_ab, C_ab)                                   # [T, 2]
    rl_ab = num / den
    rl_sum = rl_ab[:, :1] + rl_ab[:, 1:]
    d_sum = D_ab[:, :1] + D_ab[:, 1:]
    return _mix(num, den, rl_sum, D_ab, d_sum, alpha, True)
