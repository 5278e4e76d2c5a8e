"""Plain-torch versions of the decision kernels K1–K5.

The fused kernels (K1, K2 and K3 with a per-type duration table; K4 and
its masked form with a dense [T, N] duration plane) compute exactly what
the JAX reference's two-stage path computes — ``feasible_mask`` (ANDed
with ``avail_rows`` of the down windows for K2, with an availability
plane for K4-masked) → ``sample_feasible_batch`` → the candidates'
durations → ``load_score_batched`` → (K3) the locality penalty →
Algorithm 1's pick — by reusing the port's :mod:`repro_torch.random`,
prefilter and RL score.  K5 (:func:`dodoor_choice_ref`) scores
pre-sampled pairs in the reciprocal form of the reference's Pallas
kernel.  The wrappers run these for tensors on the CPU; ``chip_smoke.py``
holds the CUDA kernels against them on the card.
"""
from __future__ import annotations

import numpy as np
import torch

from ..._arith import dot_fma, fma
from ...core.policies import remote_bytes
from ...core.prefilter import avail_rows, feasible_mask, sample_feasible_batch
from ...core.rl_score import load_score_batched

_EPS = np.float32(1e-9)   # the reference's guard of 0/0 (rl_score._EPS)


def dodoor_fused_sparse_ref(keys, r, d_types, node_type, L, D, C,
                            alpha: float = 0.5, down0=None, down1=None,
                            now=None, psrv=None, pbytes=None,
                            gamma_bw: float = 0.0):
    """keys [T, 2] int64, r [T, K], d_types [T, TT], node_type [N], L
    [N, K], D [N], C [N, K] → (choice [T] int32, cand [T, 2] int32,
    scores [T, 2] float32).  With the down-window planes ``down0``,
    ``down1`` [N, Wd] and the tasks' times ``now`` [T] (K2), a server in a
    down window at ``now`` is not admissible.  With the parents' servers
    ``psrv`` [T, P] int32 (−1 pads) and output sizes ``pbytes`` [T, P]
    float32 (K3), each candidate's score gains ``gamma_bw`` (rounded to
    float32) per remote parent MB, as one fused multiply-add."""
    mask = feasible_mask(r, C)
    if down0 is not None:
        mask = mask & avail_rows(down0, down1, now)
    cand = sample_feasible_batch(keys, mask, 2)                 # [T, 2]
    rows = torch.arange(r.shape[0], device=r.device)[:, None]
    d_cand = d_types[rows, node_type[cand.long()].long()]      # [T, 2]
    return _score_and_pick(r, cand, d_cand, L, D, C, alpha, psrv, pbytes,
                           gamma_bw)


def _score_and_pick(r, cand, d_cand, L, D, C, alpha, psrv=None, pbytes=None,
                    gamma_bw=0.0):
    """LOADSCORE of the sampled pairs in the two-stage form, (K3) the
    locality penalty, and Algorithm 1's pick: ties keep A."""
    c = cand.long()
    scores = load_score_batched(r, L[c], D[c] + d_cand, C[c], alpha)
    if psrv is not None:
        scores = fma(np.float32(gamma_bw), remote_bytes(psrv, pbytes, cand),
                     scores)
    choice = torch.where(scores[:, 0] > scores[:, 1], cand[:, 1],
                         cand[:, 0]).to(torch.int32)
    return choice, cand, scores


def dodoor_fused_ref(keys, r, d, L, D, C, alpha: float = 0.5, avail=None):
    """K4: keys [T, 2] int64, r [T, K], d [T, N] per-server durations, L
    [N, K], D [N], C [N, K] → (choice [T] int32, cand [T, 2] int32, scores
    [T, 2] float32).  With ``avail`` [T, N] (K4-masked) a server whose
    entry is not > 0 is not admissible.  The arithmetic is K1's: on
    ``d = d_types[:, node_type]`` (and ``avail = avail_rows(...)``) it is
    :func:`dodoor_fused_sparse_ref` bit for bit.  That is the form of the
    reference's dense Pallas kernel, which its tests hold to the sparse
    one bit for bit; the reference's jnp oracle of the same name scores
    in reciprocal form and differs by at most 3 ulp (candidates and
    choices equal) at the pins of ``tests/test_torch_kernel_family.py``."""
    mask = feasible_mask(r, C)
    if avail is not None:
        mask = mask & (avail > 0)
    cand = sample_feasible_batch(keys, mask, 2)                 # [T, 2]
    d_cand = torch.gather(d, 1, cand.long())                   # [T, 2]
    return _score_and_pick(r, cand, d_cand, L, D, C, alpha)



def dodoor_choice_ref(r, cand, d_cand, L, D, C, alpha: float = 0.5):
    """K5: r [T, 2], cand [T, 2] int (each in [0, N)), d_cand [T, 2], L
    [N, 2], D [N], C [N, 2] → (choice [T] int32, scores [T, 2] float32).

    The reference's Pallas kernel scores in reciprocal form, RL_j =
    (r·L_j)·(1/ΣC_j²), and as its interpret lowering runs on XLA:CPU (read
    from the compiled program and pinned bit for bit by
    ``tests/test_torch_kernel_family.py``): ``r·L`` and ``ΣC²`` are fused
    multiply-add chains; in candidate A's fraction the sum RL_A + RL_B is
    ``fma(r·L_B, inv_B, RL_A)`` (B's fraction symmetrically), while the
    fallback test uses the plain sum; the α-mix is two products and an
    add, with ``1 − α`` rounded once from the float ``alpha``."""
    c = cand.long()
    inv = 1.0 / dot_fma(C, C)                                   # [N]
    dot = dot_fma(r[:, None, :], L[c])                          # [T, 2]
    iv = inv[c]
    rl = dot * iv
    rl_a, rl_b = rl[:, 0], rl[:, 1]
    rl_ok = (rl_a + rl_b) > _EPS
    half = torch.full_like(rl_a, 0.5)
    rf_a = torch.where(rl_ok, rl_a / (fma(dot[:, 1], iv[:, 1], rl_a) + _EPS),
                       half)
    rf_b = torch.where(rl_ok, rl_b / (fma(dot[:, 0], iv[:, 0], rl_b) + _EPS),
                       half)
    Dab = D[c] + d_cand
    d_sum = Dab[:, 0] + Dab[:, 1]
    df = torch.where((d_sum > _EPS)[:, None], Dab / (d_sum + _EPS)[:, None],
                     torch.full_like(Dab, 0.5))
    one_m, a = np.float32(1.0 - alpha), np.float32(alpha)
    scores = torch.stack([rf_a, rf_b], dim=1) * one_m + df * a
    choice = torch.where(scores[:, 0] > scores[:, 1], cand[:, 1],
                         cand[:, 0]).to(torch.int32)
    return choice, scores
