"""Public wrapper of the RL score matrix kernel K6.

``rl_score_matrix`` keeps the JAX wrapper's signature without its
``block_t``/``block_n``/``interpret`` knobs: the CUDA kernel has no tile
size to choose (each thread covers four servers of sixteen tasks).
Tensors on the CPU go to the plain version (``ref.py``); CUDA tensors are
checked and go to the CUDA kernel, or the call raises — there is no
fallback.  Each call that reaches the card counts one
``"rl_score_matrix"`` in ``LAUNCHES``.
"""
from __future__ import annotations

import torch

from .._wrap import LAUNCHES, check, device_of
from .kernel import launch_rl_score
from .ref import rl_score_matrix_ref

#: The widest demand vector the kernel is built for.
MAX_K = 8


def rl_score_matrix(r, L, C):
    """Batched Eq. 1: r [T, K] demands, L [N, K] loads, C [N, K]
    capacities (float32) → score [T, N] float32, ``score[t, j] =
    (r_t · L_j) / Σ_k C_jk²``.  The kernel takes K ≤ 8 (the reference's
    pins use 2, 4 and 8); ``1/ΣC²`` is computed once per call."""
    device = device_of("rl_score_matrix", (r, L, C))
    if device.type == "cpu":
        return rl_score_matrix_ref(r, L, C)
    T, K = r.shape
    N = L.shape[0]
    if not 1 <= K <= MAX_K:
        raise ValueError(f"rl_score_matrix: the kernel takes 1 ≤ K ≤ "
                         f"{MAX_K} resource dimensions, got {K}")
    check("r", r, torch.float32, (T, K))
    check("L", L, torch.float32, (N, K))
    check("C", C, torch.float32, (N, K))
    inv = torch.empty((N,), dtype=torch.float32, device=device)
    out = torch.empty((T, N), dtype=torch.float32, device=device)
    launch_rl_score(r, L, C, inv, out)
    LAUNCHES["rl_score_matrix"] += 1
    return out
