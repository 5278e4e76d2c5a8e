"""Post-pass ground-truth reconstruction for decision telemetry — a copy
of ``repro.sim.decision_trace`` (numpy only, so both packages compute the
same bits).

Tracing a run (``EngineConfig.trace``) must answer, for every decision:
how wrong was the scheduler's cached view (view error), and would ground
truth have picked the other candidate (misplacement)?  Ground truth lives
in the engine's per-server in-flight ring buffers, and reading it *inside*
the scan costs two ``[b, 2, R]`` gather/reduce fences per block — measured
at 1.3–2× the whole untraced program, because a dodoor decision itself is
O(1) while a ring scan is O(R).

This module moves the reconstruction out of the scan entirely.  The scan
only records what it alone knows — the cached-view reads and the sampled
candidates — and the ground truth is rebuilt here from the commit history
in one vectorized O((m + q)·log) pass:

*   The ring buffer evicts the slot with the **minimum release time**
    (:func:`repro_torch.sim.engine._commit_one`), so as long as no server ever
    holds ``R`` live entries at a commit, every eviction removes an
    already-released entry and the live ring content at decision ``i`` for
    server ``c`` is exactly *all* commits to ``c`` before ``i`` that are
    still running::

        truth_x(i, c) = Σ_{t < i, j_t = c} x_t · [rel_t > now_i]
                      = P_x(i, c) − F_x(i, c)

    with ``P`` a prefix sum over commit order and ``F`` the commits already
    finished by ``now_i``.  ``P`` is a ``searchsorted`` on an integer
    ``(server, position)`` key; ``F`` falls out of one merged sort of
    commits and queries by ``(server, time)``.  Both are exact: rif counts
    are integers, and the engine's decision stream is time-ordered with
    ``rel > now`` at every commit, so no later commit can leak into ``F``.

*   If a server *does* reach ``R`` live entries, the engine's own ring
    forgets a live entry (its load caches under-count from then on — a
    modeling-fidelity limit of the seed engine, not of this pass).  The
    reconstruction keeps the un-evicted truth and emits a warning, since
    counting a still-running task is strictly closer to the paper's
    ground truth than forgetting it.

Both drivers feed the identical history through this one code path, so
sequential-vs-batched trace parity is bitwise by construction.
"""
from __future__ import annotations

import warnings

import numpy as np

#: Policies that schedule off a cached snapshot — the only ones with a
#: staleness/misplacement story to tell (probing policies read truth).
CACHED_POLICIES = ("dodoor", "one_plus_beta")

_EPS = np.float32(1e-9)   # mirrors repro_torch.core.rl_score._EPS


def _load_score_np(r, L_ab, D_ab, C_ab, alpha):
    """Numpy float32 mirror of :func:`repro_torch.core.rl_score.load_score_batched`
    (Algorithm 1's LOADSCORE) — same operations in the same f32 scale, so
    the truth-side scores live on the view-side scores' grid."""
    r = r.astype(np.float32)
    L_ab = L_ab.astype(np.float32)
    D_ab = D_ab.astype(np.float32)
    C_ab = C_ab.astype(np.float32)
    alpha = np.float32(alpha)
    rl_ab = (np.einsum("tk,tck->tc", r, L_ab)
             / np.sum(C_ab * C_ab, axis=-1)).astype(np.float32)
    rl_sum = np.sum(rl_ab, axis=-1, keepdims=True)
    d_sum = np.sum(D_ab, axis=-1, keepdims=True)
    rl_frac = np.where(rl_sum > _EPS, rl_ab / (rl_sum + _EPS),
                       np.float32(0.5))
    d_frac = np.where(d_sum > _EPS, D_ab / (d_sum + _EPS), np.float32(0.5))
    return rl_frac * (np.float32(1.0) - alpha) + d_frac * alpha


def _pf_sums(cj, crel, cx, cpos, qsrv, qnow, qpos):
    """For each query ``q``: ``Σ over commits with srv == qsrv[q] and
    pos < qpos[q] of cx · [rel > qnow[q]]`` — the live-entry sums.

    ``cx`` is ``[mc, Q]`` (one column per summed quantity); ``cpos`` must
    be nondecreasing (commit order — both callers pass it that way).
    Exactness rests on the engine's time-ordered stream: every commit
    releases strictly after its own decision, so a commit with ``rel ≤
    qnow`` necessarily has ``pos < qpos`` and the position condition can
    be dropped from the finished-sum ``F``.
    """
    mc, nq = cj.shape[0], qsrv.shape[0]
    Q = cx.shape[1]
    if mc == 0:
        return np.zeros((nq, Q))
    big = np.int64(max(int(cpos.max()), int(qpos.max())) + 1)
    # P: prefix sums in (server, position) order — a stable sort on the
    # server alone, since cpos is already nondecreasing.
    o1 = np.argsort(cj, kind="stable")
    key1 = (cj.astype(np.int64) * big + cpos)[o1]
    cs1 = np.vstack([np.zeros((1, Q)), np.cumsum(cx[o1], axis=0)])
    hi = np.searchsorted(key1, qsrv.astype(np.int64) * big + qpos,
                         side="left")
    # F: commits finished by qnow, via one merged (server, time) sort with
    # commits ordered before queries at equal time (rel ≤ now inclusive).
    srv_all = np.concatenate([cj, qsrv.astype(cj.dtype)])
    t_all = np.concatenate([crel, qnow])
    isq = np.concatenate([np.zeros(mc, np.int8), np.ones(nq, np.int8)])
    o2 = np.lexsort((isq, t_all, srv_all))
    x_all = np.vstack([cx, np.zeros((nq, Q))])
    cs2 = np.vstack([np.zeros((1, Q)), np.cumsum(x_all[o2], axis=0)])
    inv2 = np.empty(mc + nq, np.int64)
    inv2[o2] = np.arange(mc + nq)
    at = inv2[mc:]
    # cs2[at] = Σ_{srv < qsrv} + F  and  cs1[hi] = Σ_{srv < qsrv} + P,
    # so the earlier-server mass cancels without ever being gathered.
    return cs1[hi] - cs2[at]


def finish_trace(*, j, finish, cores, mem, now, v_rif, cand, use_two,
                 r_sub, d_est, node_type, C, alpha, policy, R,
                 gamma_bw=0.0, psrv=None, pbytes=None, rejected=None,
                 init_ring=None):
    """Resolve one engine invocation's raw trace captures into the
    ``(view_err, misplaced)`` planes.

    Parameters mirror one wave of the engine, in decision order (pads
    already stripped): ``j/finish/cores/mem`` the commit record (``finish``
    is the value written to the ring — the kill time for killed tasks),
    ``now`` the decision timestamps, ``v_rif``/``cand`` the in-scan
    ``([m], [m])`` pairs of cached-rif reads and candidate ids, ``use_two``
    the (1+β) coin (all-ones for dodoor).  ``rejected`` marks decisions
    whose task never committed; ``init_ring`` is the wave-entry
    ``(rb_release, rb_cpu, rb_mem, rb_dur)`` state for wave loops whose
    carry threads across engine calls.  Returns ``(view_err f32 [m],
    misplaced bool [m])`` — zeros for policies without a cached view.
    """
    mw = int(np.asarray(j).shape[0])
    zeros = (np.zeros(mw, np.float32), np.zeros(mw, bool))
    if policy not in CACHED_POLICIES or mw == 0:
        return zeros
    j = np.asarray(j).astype(np.int32)
    rel = np.asarray(finish, np.float64)
    now = np.asarray(now, np.float64)
    c0 = np.asarray(cand[0]).astype(np.int32)
    c1 = np.asarray(cand[1]).astype(np.int32)
    cand2 = np.stack([c0, c1], axis=1)                         # [m, 2]
    node_type = np.asarray(node_type)
    d_est = np.asarray(d_est)
    tt = np.arange(mw)
    dest = d_est[tt, node_type[j]].astype(np.float64)
    x = np.stack([np.ones(mw), np.asarray(cores, np.float64),
                  np.asarray(mem, np.float64), dest], axis=1)  # [m, 4]

    commit = np.ones(mw, bool) if rejected is None \
        else ~np.asarray(rejected, bool)
    cj, crel, cx = j[commit], rel[commit], x[commit]
    cpos = (tt.astype(np.int64) + 1)[commit]

    if init_ring is not None:
        # Wave-entry ring entries become position-0 pseudo-commits; the
        # ones already released before every query sum to zero in P − F
        # and are dropped up front.
        r0, cpu0, mem0, dur0 = (np.asarray(a, np.float64).ravel()
                                for a in init_ring)
        keep = r0 > now.min()
        if keep.any():
            n_srv, slots = np.asarray(init_ring[0]).shape
            srv0 = np.repeat(np.arange(n_srv, dtype=np.int32), slots)[keep]
            x0 = np.stack([np.ones(keep.sum()), cpu0[keep], mem0[keep],
                           dur0[keep]], axis=1)
            cj = np.concatenate([srv0, cj])
            crel = np.concatenate([r0[keep], crel])
            cx = np.vstack([x0, cx])
            cpos = np.concatenate([np.zeros(keep.sum(), np.int64), cpos])

    qsrv = cand2.reshape(-1)
    qnow = np.repeat(now, 2)
    qpos = np.repeat(tt.astype(np.int64) + 1, 2)
    truth = _pf_sums(cj, crel, cx, cpos, qsrv, qnow, qpos).reshape(mw, 2, 4)
    t_rif = truth[..., 0]
    tL = truth[..., 1:3]                                       # [m, 2, 2]
    t_dur = truth[..., 3]

    # Fidelity guard: a full-of-live-entries ring means the engine itself
    # evicted a running task (its caches under-count from there on).
    chosen_rif = np.where(c0 == j, t_rif[:, 0], t_rif[:, 1])
    if bool(np.any(commit & (chosen_rif >= R))):
        warnings.warn(
            f"decision trace: a server reached {R} (rbuf_slots) live "
            "tasks — the engine's ring evicted a running entry and its "
            "load caches under-count; trace truth keeps the un-evicted "
            "count. Raise EngineConfig.rbuf_slots for this load level.",
            RuntimeWarning, stacklevel=2)

    d_cand = d_est[tt[:, None], node_type[cand2]]
    scores = _load_score_np(np.asarray(r_sub), tL, t_dur + d_cand,
                            np.asarray(C)[cand2], alpha)
    if gamma_bw and psrv is not None:
        rem = np.sum(np.asarray(pbytes)[:, None, :]
                     * (np.asarray(psrv)[:, None, :]
                        != cand2[:, :, None]).astype(np.float32), axis=-1)
        scores = scores + np.float32(gamma_bw) * rem.astype(np.float32)
    t_two = np.where(scores[:, 0] > scores[:, 1], c1, c0)
    misp = (t_two != j) & (np.asarray(use_two) > 0.5)
    v = np.stack([np.asarray(v_rif[0], np.float32),
                  np.asarray(v_rif[1], np.float32)], axis=1)
    verr = np.mean(np.abs(v - t_rif.astype(np.float32)),
                   axis=1).astype(np.float32)
    return verr, misp
