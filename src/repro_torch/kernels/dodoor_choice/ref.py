"""Plain-torch version of the sparse-gather decision kernels K1, K2 and
K3.

It computes exactly what the JAX reference's two-stage path computes —
``feasible_mask`` (ANDed with ``avail_rows`` of the down windows for K2)
→ ``sample_feasible_batch`` → per-type duration gather →
``load_score_batched`` → (K3) the locality penalty → Algorithm 1's pick —
by reusing the port's :mod:`repro_torch.random`, prefilter and RL score.
The wrapper runs it for tensors on the CPU; ``chip_smoke.py`` holds the
CUDA kernels against it on the card.
"""
from __future__ import annotations

import numpy as np
import torch

from ..._arith import fma, row_sum
from ...core.prefilter import avail_rows, feasible_mask, sample_feasible_batch
from ...core.rl_score import load_score_batched


def remote_bytes(psrv, pbytes, cand):
    """Σ_p pbytes[t, p]·[psrv[t, p] ≠ cand[t, c]] for both candidates
    ([T, P], [T, P], [T, 2] → [T, 2] float32), summed in the reference's
    row order (:func:`repro_torch._arith.row_sum`)."""
    away = (psrv[:, None, :] != cand[:, :, None]).to(torch.float32)
    return row_sum(pbytes[:, None, :] * away)


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
    c = cand.long()
    rows = torch.arange(r.shape[0], device=r.device)[:, None]
    d_cand = d_types[rows, node_type[c].long()]                # [T, 2]
    scores = load_score_batched(r, L[c], D[c] + d_cand, C[c], alpha)
    if psrv is not None:
        scores = fma(np.float32(gamma_bw), remote_bytes(psrv, pbytes, cand),
                     scores)
    choice = torch.where(scores[:, 0] > scores[:, 1], cand[:, 1],
                         cand[:, 0]).to(torch.int32)
    return choice, cand, scores
