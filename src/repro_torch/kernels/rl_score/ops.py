"""Public wrapper of the RL score matrix kernel K6, and its grid plan.

``rl_score_matrix`` keeps the JAX wrapper's signature without its
``block_t``/``block_n``/``interpret`` knobs: the CUDA kernel's tiling is
planned from the shape and the card (:func:`plan_k6`).  Tensors on the CPU
go to the plain version (``ref.py``); CUDA tensors are checked and go to
the CUDA kernel, one launch, or the call raises — there is no fallback.
Each call that reaches the card counts one ``"rl_score_matrix"`` in
``LAUNCHES``.
"""
from __future__ import annotations

import math

import torch

from .._wrap import LAUNCHES, check, device_of, sm_count
from .kernel import launch_rl_score
from .ref import rl_score_matrix_ref

#: The widest demand vector the kernel is built for.
MAX_K = 8
#: A column tile holds at most this many groups of 4 servers (one
#: warp-width of 16-byte stores), and a block at most K6_THREADS threads.
K6_MAX_G = 32
K6_THREADS = 256
#: Rows a thread: K6_RPT where the grid still fills one wave of blocks
#: (K6_SM_THREADS // (R·G) blocks on each SM), else K6_RPT_SMALL.
K6_RPT = 4
K6_RPT_SMALL = 2
K6_SM_THREADS = 2048


def k6_groups(T: int, N: int) -> int:
    """Groups of 4 columns a row spans at most.  Row t's groups are its
    columns [4i − s, 4i − s + 4) with s = t·N mod 4 (each group 16-byte
    aligned), so a row with s > 0 spans ⌈(N + s)/4⌉; s is 0 on every row
    when N % 4 == 0 (or T == 1), at most 2 when N % 4 == 2, else 3."""
    max_s = 0 if N % 4 == 0 or T == 1 else (2 if N % 2 == 0 else 3)
    return -(-(N + max_s) // 4)


def k6_grid(T: int, N: int, plan) -> tuple:
    """(row tiles, column tiles) of K6's launch under ``plan`` = (G, R,
    rpt), as ``rl_score.cu``'s launcher computes them; the kernel's
    blocks take the column tile fastest."""
    G, R, rpt = plan
    return -(-T // (R * rpt)), -(-k6_groups(T, N) // G)


def plan_k6(T: int, N: int, sms: int) -> tuple:
    """K6's tiling (G, R, rpt): G groups of 4 servers a column tile (the
    row's groups split evenly into tiles of at most 32), R rows a block
    (as many as fit 256 threads with R·N % 4 == 0, so that a thread's rows
    share one alignment shift) and rpt rows a thread: 4 where that still
    launches one full wave of blocks on ``sms`` SMs, else 2.
    Measured on an H100 (``chip_smoke.py``'s ``K6_RPT_SWEEP``): at the
    10⁴-server shapes 4 rows a thread beat 1 and 2 by 2–16 µs (fewer
    prologues) and 8–16 gain nothing; the launch-sized shapes are within
    0.1 µs of their best at 2.  At (1024, 10⁴, 2) on 132 SMs: (32, 8, 4),
    2 528 blocks of 256 threads; (500, 10⁴, 2): (32, 8, 4), 1 264 blocks;
    (2048, 100, 2): (25, 10, 2), 103 blocks of 250 threads, every thread a
    row's float4."""
    groups = max(1, k6_groups(T, N))
    tiles = -(-groups // K6_MAX_G)
    G = -(-groups // tiles)
    step = 4 // math.gcd(N, 4)
    R = K6_THREADS // G // step * step
    per_wave = sms * (K6_SM_THREADS // (R * G))
    blocks = tiles * -(-max(T, 1) // (R * K6_RPT))
    if blocks >= per_wave:
        return G, R, K6_RPT
    return G, R, K6_RPT_SMALL


def rl_score_matrix(r, L, C):
    """Batched Eq. 1: r [T, K] demands, L [N, K] loads, C [N, K]
    capacities (float32) → score [T, N] float32, ``score[t, j] =
    (r_t · L_j) / Σ_k C_jk²``.  The kernel takes K ≤ 8 (the reference's
    pins use 2, 4 and 8); each block computes ``1/ΣC²`` for its own
    columns, in the same launch."""
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
    out = torch.empty((T, N), dtype=torch.float32, device=device)
    launch_rl_score(r, L, C, out, plan_k6(T, N, sm_count(device)))
    LAUNCHES["rl_score_matrix"] += 1
    return out
