"""Public wrapper of the sparse-gather decision kernel (K1).

``dodoor_fused_sparse`` keeps the JAX wrapper's signature.  Tensors on the
CPU go to the plain version (``ref.py``); CUDA tensors are checked and go
to the CUDA kernel, or the call raises — there is no fallback.
``LAUNCHES`` counts kernel launches, one per call that reaches the card.
"""
from __future__ import annotations

from collections import Counter

import torch

from .kernel import launch_dodoor_fused_sparse
from .ref import dodoor_fused_sparse_ref

#: Kernel launches by kernel name; reset it to read one run's launches.
LAUNCHES: Counter = Counter()


def _check(name, t, dtype, shape):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def dodoor_fused_sparse(keys, r, d_types, node_type, L, D, C,
                        alpha: float = 0.5):
    """Sample → score → select for one decision block.

    keys [T, 2] int64 per-task candidate keys (uint32 words, the first key
    of ``split(fold_in(base, task_id))``); r [T, K] demands; d_types
    [T, TT] per-node-type estimated durations; node_type [N] int32 server
    types (each in [0, TT)); L [N, K], D [N] the cached view; C [N, K]
    capacities.  K is 2 (cores, memory).

    Returns (choice [T] int32, cand [T, 2] int32, scores [T, 2] float32).
    """
    tensors = (keys, r, d_types, node_type, L, D, C)
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"dodoor_fused_sparse: tensors on several devices "
                         f"{sorted(map(str, devices))}")
    device = devices.pop()
    if device.type == "cpu":
        return dodoor_fused_sparse_ref(*tensors, alpha=alpha)
    if device.type != "cuda":
        raise ValueError(f"dodoor_fused_sparse: unsupported device {device}")
    T, K = r.shape
    N = C.shape[0]
    if K != 2:
        raise ValueError(f"dodoor_fused_sparse: the kernel takes K=2 "
                         f"resource dimensions, got {K}")
    _check("keys", keys, torch.int64, (T, 2))
    _check("r", r, torch.float32, (T, K))
    _check("d_types", d_types, torch.float32, (T, d_types.shape[1]))
    _check("node_type", node_type, torch.int32, (N,))
    _check("L", L, torch.float32, (N, K))
    _check("D", D, torch.float32, (N,))
    _check("C", C, torch.float32, (N, K))
    if N < 1 or d_types.shape[1] < 1:
        raise ValueError("dodoor_fused_sparse: needs N ≥ 1 and TT ≥ 1")
    choice = torch.empty((T,), dtype=torch.int32, device=device)
    cand = torch.empty((T, 2), dtype=torch.int32, device=device)
    scores = torch.empty((T, 2), dtype=torch.float32, device=device)
    launch_dodoor_fused_sparse(keys, r, d_types, node_type, L, D, C, alpha,
                               choice, cand, scores)
    LAUNCHES["dodoor_fused_sparse"] += 1
    return choice, cand, scores
