"""Public wrapper of the sparse-gather decision kernels K1, K2 and K3.

``dodoor_fused_sparse`` keeps the JAX wrapper's signature, with the
down-window planes in place of its ``avail`` plane.  Tensors on the CPU go
to the plain version (``ref.py``); CUDA tensors are checked and go to the
CUDA kernel, or the call raises — there is no fallback.  ``LAUNCHES``
counts kernel launches by kernel name, one per call that reaches the card.
"""
from __future__ import annotations

from collections import Counter

import numpy as np
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
                        alpha: float = 0.5, *, down0=None, down1=None,
                        now=None, psrv=None, pbytes=None,
                        gamma_bw: float = 0.0):
    """Sample → score → select for one decision block.

    keys [T, 2] int64 per-task candidate keys (uint32 words, the first key
    of ``split(fold_in(base, task_id))``); r [T, K] demands; d_types
    [T, TT] per-node-type estimated durations; node_type [N] int32 server
    types (each in [0, TT)); L [N, K], D [N] the cached view; C [N, K]
    capacities.  K is 2 (cores, memory).  With ``down0``, ``down1``
    [N, Wd] float32 down-window planes (``+inf`` pads) and ``now`` [T]
    float32 task times, a server inside a down window at its task's time
    is not admissible (the masked kernel K2, counted under
    ``"dodoor_fused_sparse_masked"``).  With ``psrv`` [T, P] int32 (the
    servers of each task's parents, −1 pads) and ``pbytes`` [T, P]
    float32 (their output MB, 0 pads), each candidate's score gains
    ``gamma_bw`` per MB held on another server (the locality kernel K3,
    counted under ``"dodoor_fused_sparse_locality"`` or, with the
    windows, ``"dodoor_fused_sparse_masked_locality"``).

    Returns (choice [T] int32, cand [T, 2] int32, scores [T, 2] float32).
    """
    windows = (down0, down1, now)
    masked = down0 is not None
    if masked != (down1 is not None) or masked != (now is not None):
        raise ValueError("dodoor_fused_sparse: pass down0, down1 and now "
                         "together")
    local = psrv is not None
    if local != (pbytes is not None):
        raise ValueError("dodoor_fused_sparse: pass psrv and pbytes "
                         "together")
    parents = (psrv, pbytes)
    tensors = (keys, r, d_types, node_type, L, D, C) + (
        windows if masked else ()) + (parents if local else ())
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"dodoor_fused_sparse: tensors on several devices "
                         f"{sorted(map(str, devices))}")
    device = devices.pop()
    if device.type == "cpu":
        return dodoor_fused_sparse_ref(keys, r, d_types, node_type, L, D, C,
                                       alpha, *windows, psrv, pbytes,
                                       gamma_bw)
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
    if masked:
        _check("down0", down0, torch.float32, (N, down0.shape[1]))
        _check("down1", down1, torch.float32, down0.shape)
        _check("now", now, torch.float32, (T,))
    if local:
        _check("psrv", psrv, torch.int32, (T, psrv.shape[-1]))
        _check("pbytes", pbytes, torch.float32, psrv.shape)
    choice = torch.empty((T,), dtype=torch.int32, device=device)
    cand = torch.empty((T, 2), dtype=torch.int32, device=device)
    scores = torch.empty((T, 2), dtype=torch.float32, device=device)
    name = launch_dodoor_fused_sparse(
        keys, r, d_types, node_type, L, D, C, alpha, choice, cand, scores,
        *windows, *parents, gamma_bw=float(np.float32(gamma_bw)))
    LAUNCHES[name] += 1
    return choice, cand, scores
