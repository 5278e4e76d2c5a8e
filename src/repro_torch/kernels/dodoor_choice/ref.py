"""Plain-torch version of the sparse-gather decision kernels K1 and K2.

It computes exactly what the JAX reference's two-stage path computes —
``feasible_mask`` (ANDed with ``avail_rows`` of the down windows for K2)
→ ``sample_feasible_batch`` → per-type duration gather →
``load_score_batched`` → Algorithm 1's pick — by reusing the port's
:mod:`repro_torch.random`, prefilter and RL score.  The wrapper runs it for
tensors on the CPU; ``chip_smoke.py`` holds the CUDA kernels against it on
the card.
"""
from __future__ import annotations

import torch

from ...core.prefilter import avail_rows, feasible_mask, sample_feasible_batch
from ...core.rl_score import load_score_batched


def dodoor_fused_sparse_ref(keys, r, d_types, node_type, L, D, C,
                            alpha: float = 0.5, down0=None, down1=None,
                            now=None):
    """keys [T, 2] int64, r [T, K], d_types [T, TT], node_type [N], L
    [N, K], D [N], C [N, K] → (choice [T] int32, cand [T, 2] int32,
    scores [T, 2] float32).  With the down-window planes ``down0``,
    ``down1`` [N, Wd] and the tasks' times ``now`` [T] (K2), a server in a
    down window at ``now`` is not admissible."""
    mask = feasible_mask(r, C)
    if down0 is not None:
        mask = mask & avail_rows(down0, down1, now)
    cand = sample_feasible_batch(keys, mask, 2)                 # [T, 2]
    c = cand.long()
    rows = torch.arange(r.shape[0], device=r.device)[:, None]
    d_cand = d_types[rows, node_type[c].long()]                # [T, 2]
    scores = load_score_batched(r, L[c], D[c] + d_cand, C[c], alpha)
    choice = torch.where(scores[:, 0] > scores[:, 1], cand[:, 1],
                         cand[:, 0]).to(torch.int32)
    return choice, cand, scores
