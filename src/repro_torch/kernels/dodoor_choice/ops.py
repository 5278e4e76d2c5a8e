"""Public wrappers of the decision kernels K1–K5.

They keep the JAX wrappers' signatures without ``block_t``/``interpret``:
the CUDA kernels have no tile size to choose (1–8 warps per task for the
fused kernels, sized by N; one thread per task for K5, its blocks
planned by :func:`plan_k5`) and pad nothing.
``dodoor_fused_sparse`` takes the down-window planes in place of its
``avail`` plane.  Tensors on the CPU go to the plain versions
(``ref.py``); CUDA tensors are checked and go to the CUDA kernel, or the
call raises — there is no fallback.  ``LAUNCHES`` counts kernel launches
by kernel name, one per call that reaches the card.  K1–K5 take K = 2
resource dimensions (cores, memory), as the simulator has; any other K
raises on the card.
"""
from __future__ import annotations

import numpy as np
import torch

from .._wrap import LAUNCHES, check, device_of, sm_count
from .kernel import (launch_dodoor_choice, launch_dodoor_fused,
                     launch_dodoor_fused_sparse)
from .ref import dodoor_choice_ref, dodoor_fused_ref, dodoor_fused_sparse_ref


def plan_k5(T: int, sms: int) -> int:
    """K5's tasks a block: up to 256 tasks one lean block of ⌈T/32⌉
    warps; beyond that ⌈T/sms⌉ tasks a block rounded up to whole warps,
    between 64 and 256, so that T = 2048 spreads over 32 blocks of 64
    tasks on 132 SMs."""
    warps = -(-max(T, 1) // 32)
    if warps <= 8:
        return 32 * warps
    return min(256, max(64, 32 * -(-T // (32 * sms))))


def _two_dims(fn: str, K: int) -> None:
    if K != 2:
        raise ValueError(f"{fn}: the kernel takes K=2 resource dimensions, "
                         f"got {K}")


def _server_view(L, D, C, N: int) -> None:
    check("L", L, torch.float32, (N, 2))
    check("D", D, torch.float32, (N,))
    check("C", C, torch.float32, (N, 2))
    if N < 1:
        raise ValueError("the kernel needs N ≥ 1 servers")


def dodoor_fused_sparse(keys, r, d_types, node_type, L, D, C,
                        alpha: float = 0.5, *, down0=None, down1=None,
                        now=None, down_t=None, psrv=None, pbytes=None,
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
    ``"dodoor_fused_sparse_masked"``).  K2 reads the planes window-major:
    ``down_t`` = (``down0.T``, ``down1.T``) as contiguous [Wd, N] tensors,
    made once by a caller that launches many blocks against the same
    windows (the engine does, once per run); without it a call on the
    card makes the pair itself.  The plain version reads ``down0`` and
    ``down1`` and ignores ``down_t``.  With ``psrv`` [T, P] int32 (the
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
        windows if masked else ()) + (parents if local else ()) + (
        tuple(down_t) if masked and down_t is not None else ())
    device = device_of("dodoor_fused_sparse", tensors)
    if device.type == "cpu":
        return dodoor_fused_sparse_ref(keys, r, d_types, node_type, L, D, C,
                                       alpha, *windows, psrv, pbytes,
                                       gamma_bw)
    T, K = r.shape
    N = C.shape[0]
    _two_dims("dodoor_fused_sparse", K)
    check("keys", keys, torch.int64, (T, 2))
    check("r", r, torch.float32, (T, K))
    check("d_types", d_types, torch.float32, (T, d_types.shape[1]))
    check("node_type", node_type, torch.int32, (N,))
    _server_view(L, D, C, N)
    if d_types.shape[1] < 1:
        raise ValueError("dodoor_fused_sparse: needs TT ≥ 1")
    if masked:
        check("down0", down0, torch.float32, (N, down0.shape[1]))
        check("down1", down1, torch.float32, down0.shape)
        check("now", now, torch.float32, (T,))
        if down0.shape[1] < 1:
            raise ValueError("dodoor_fused_sparse: needs Wd ≥ 1 windows")
        if down_t is None:
            down_t = (down0.t().contiguous(), down1.t().contiguous())
        Wd = down0.shape[1]
        for i, plane in enumerate(down_t):
            check(f"down_t[{i}]", plane, torch.float32, (Wd, N))
        windows = (*down_t, now)
    if local:
        check("psrv", psrv, torch.int32, (T, psrv.shape[-1]))
        check("pbytes", pbytes, torch.float32, psrv.shape)
    choice = torch.empty((T,), dtype=torch.int32, device=device)
    cand = torch.empty((T, 2), dtype=torch.int32, device=device)
    scores = torch.empty((T, 2), dtype=torch.float32, device=device)
    name = launch_dodoor_fused_sparse(
        keys, r, d_types, node_type, L, D, C, alpha, choice, cand, scores,
        *windows, *parents, gamma_bw=float(np.float32(gamma_bw)))
    LAUNCHES[name] += 1
    return choice, cand, scores


def dodoor_fused(keys, r, d, L, D, C, alpha: float = 0.5, *, avail=None):
    """K4, the dense megakernel: sample → score → select for one decision
    block, with the task's estimated duration on every server.

    keys [T, 2] int64 per-task candidate keys (uint32 words); r [T, K]
    demands; d [T, N] per-server durations; L [N, K], D [N] the cached
    view; C [N, K] capacities; K = 2.  With ``avail`` [T, N] (bool or
    float32; cast to float32 as the reference's wrapper does) a server
    whose entry is not > 0 is not admissible (K4-masked, counted under
    ``"dodoor_fused_masked"``).  Draws are ``sample_feasible_batch``'s
    and the arithmetic is K1's, so on ``d = d_types[:, node_type]`` this
    is :func:`dodoor_fused_sparse` bit for bit.

    Score form: K1's two-stage form, which is the reference *kernel's*
    form — the reference pins its dense and sparse Pallas kernels as one
    program, bit for bit (``tests/test_kernels.py``,
    ``test_matches_dense_megakernel_exactly``).  The reference's jnp
    oracle ``dodoor_fused_ref`` scores in reciprocal form instead, and its
    own docstring allows that 1 ulp.  Against that oracle the scores here
    are within 3 ulp, and the candidates and choices equal, at the pins of
    ``tests/test_torch_kernel_family.py`` (K4_CASES); a near-tie could
    still pick the other candidate.

    Returns (choice [T] int32, cand [T, 2] int32, scores [T, 2] float32).
    """
    tensors = (keys, r, d, L, D, C) + (() if avail is None else (avail,))
    device = device_of("dodoor_fused", tensors)
    if avail is not None:
        avail = avail.to(torch.float32)
    if device.type == "cpu":
        return dodoor_fused_ref(keys, r, d, L, D, C, alpha, avail)
    T, K = r.shape
    N = C.shape[0]
    _two_dims("dodoor_fused", K)
    check("keys", keys, torch.int64, (T, 2))
    check("r", r, torch.float32, (T, K))
    check("d", d, torch.float32, (T, N))
    _server_view(L, D, C, N)
    if avail is not None:
        check("avail", avail, torch.float32, (T, N))
    choice = torch.empty((T,), dtype=torch.int32, device=device)
    cand = torch.empty((T, 2), dtype=torch.int32, device=device)
    scores = torch.empty((T, 2), dtype=torch.float32, device=device)
    name = launch_dodoor_fused(keys, r, d, L, D, C, alpha, choice, cand,
                               scores, avail)
    LAUNCHES[name] += 1
    return choice, cand, scores


def dodoor_choice(r, cand, d_cand, L, D, C, alpha: float = 0.5):
    """K5, the two-stage selection: score a block's pre-sampled candidate
    pairs against one cache snapshot and pick.

    r [T, K] demands; cand [T, 2] int32 candidate ids, each in [0, N) (not
    checked on the card); d_cand [T, 2] the task's durations on them; L
    [N, K], D [N], C [N, K]; K = 2.  The score is the reference kernel's
    reciprocal form (:func:`dodoor_choice_ref`); ties keep A.  Counted
    under ``"dodoor_choice"``.

    Returns (choice [T] int32, scores [T, 2] float32).
    """
    device = device_of("dodoor_choice", (r, cand, d_cand, L, D, C))
    if device.type == "cpu":
        return dodoor_choice_ref(r, cand, d_cand, L, D, C, alpha)
    T, K = r.shape
    N = C.shape[0]
    _two_dims("dodoor_choice", K)
    check("r", r, torch.float32, (T, K))
    check("cand", cand, torch.int32, (T, 2))
    check("d_cand", d_cand, torch.float32, (T, 2))
    _server_view(L, D, C, N)
    choice = torch.empty((T,), dtype=torch.int32, device=device)
    scores = torch.empty((T, 2), dtype=torch.float32, device=device)
    name = launch_dodoor_choice(r, cand, d_cand, L, D, C,
                                np.float32(alpha), np.float32(1.0 - alpha),
                                choice, scores,
                                plan_k5(T, sm_count(device)))
    LAUNCHES[name] += 1
    return choice, scores
