"""Placement policies: Random, PoT, Dodoor (Algorithm 1, per task and
batched), Prequal and the (1+β) process — counterpart of
``repro.core.policies``.

Per-task policies are ``select(key, r, d, view, params) -> server``, with
``r`` [K] the demand, ``d`` [n] the per-server estimated durations and
``view`` the scheduler's :class:`SchedulerView`.  Randomness comes from the
task id folded into the base key (§5), with :mod:`repro_torch.random`.
Prequal keeps a per-scheduler probe pool; its functional update is here
too, for the simulator to loop over.
"""
from __future__ import annotations

import torch

from .._arith import fma, row_sum
from ..random import fold_in, randint, split, uniform
from .prefilter import feasible_mask, sample_feasible, sample_feasible_batch
from .rl_score import load_score_batched
from .types import (DodoorParams, PrequalParams, PrequalPool,
                    SchedulerView)


def random_select(key, r, d, view: SchedulerView,
                  params: DodoorParams) -> torch.Tensor:
    """Uniform placement over feasible servers (the Random baseline)."""
    return sample_feasible(key, feasible_mask(r, view.C), 1)[0]


def pot_select(key, r, d, view: SchedulerView,
               params: DodoorParams) -> torch.Tensor:
    """Power of two on requests in flight (the PoT baseline): two feasible
    candidates, the one with fewer in flight wins, ties keep the first.
    ``view`` must be the ground truth; the engine charges the two
    synchronous probe round-trips (§2.2)."""
    cand = sample_feasible(key, feasible_mask(r, view.C), 2)
    rif = view.rif[cand.long()]
    return torch.where(rif[1] < rif[0], cand[1], cand[0]).to(torch.int32)


def remote_bytes(psrv, pbytes, cand):
    """Σ_p pbytes[t, p]·[psrv[t, p] ≠ cand[t, c]] for both candidates
    ([T, P], [T, P], [T, 2] → [T, 2] float32), summed in the reference's
    row order (:func:`repro_torch._arith.row_sum`)."""
    away = (psrv[:, None, :] != cand[:, :, None]).to(torch.float32)
    return row_sum(pbytes[:, None, :] * away)


def dodoor_choice_batch(r, cand, d_cand, view: SchedulerView, alpha, *,
                        psrv=None, pbytes=None, gamma_bw=0.0, sched=None,
                        use_kernel: bool = False) -> torch.Tensor:
    """Score a block's pre-sampled candidate pairs against one cache
    snapshot and pick the winners: r [T, K], cand [T, 2] int, d_cand
    [T, 2] (the task's duration on each candidate) → int32 [T].
    Line 11 of Algorithm 1: B wins iff score_A > score_B; ties keep A.
    With the parents' servers ``psrv`` [T, P] (−1 pads) and output sizes
    ``pbytes`` [T, P] of a task graph, each score gains ``gamma_bw`` ×
    the candidate's remote bytes (one rounding; ``alpha`` and
    ``gamma_bw`` are floats or float32 tensors on the device).  With
    per-scheduler views (``view.L`` [S, n, K], ``view.D`` [S, n], the
    cache-fault engine's), ``sched`` [T] names each task's scheduler,
    whose row it reads.

    ``use_kernel`` routes the selection through the decision kernel K5
    (:func:`repro_torch.kernels.dodoor_choice.dodoor_choice`): on CUDA
    tensors its CUDA kernel, on the CPU its plain version.  It scores in
    the reference kernel's reciprocal form, so a score may differ from the
    default path's by a few ulp; choices differ only at such near-ties.
    The kernel takes ``cand`` as int32 and K = 2."""
    if use_kernel:
        if psrv is not None:
            raise ValueError("the decision kernel K5 takes no locality "
                             "operands")
        from ..kernels.dodoor_choice import dodoor_choice  # lazy: no cycle
        choice, _ = dodoor_choice(r, cand.to(torch.int32), d_cand, view.L,
                                  view.D, view.C, float(alpha))
        return choice
    c = cand.long()
    rows = (c,) if sched is None else (sched.long()[:, None], c)
    L_ab = view.L[rows]                                        # [T, 2, K]
    D_ab = view.D[rows] + d_cand                               # [T, 2]
    scores = load_score_batched(r, L_ab, D_ab, view.C[c], alpha)
    if psrv is not None:
        scores = fma(gamma_bw, remote_bytes(psrv, pbytes, cand), scores)
    take_b = scores[:, 0] > scores[:, 1]
    return torch.where(take_b, cand[:, 1], cand[:, 0]).to(torch.int32)


def dodoor_select(key, r, d, view: SchedulerView,
                  params: DodoorParams) -> torch.Tensor:
    """Algorithm 1 for one task: two cached-view candidates, loadScore."""
    cand = sample_feasible(key, feasible_mask(r, view.C), 2)
    return dodoor_choice_batch(r[None], cand[None], d[cand.long()][None],
                               view, params.alpha)[0]


def dodoor_select_batch(key, r, d, view: SchedulerView,
                        params: DodoorParams, *, keys=None,
                        use_kernel: bool = False) -> torch.Tensor:
    """Algorithm 1 over a block of tasks (r [T, K], d [T, n]) against one
    cache snapshot: the b-batched model's decision block.  Task ``i``
    draws its candidates from ``fold_in(key, i)``, unless ``keys`` [T, 2]
    gives each task's key (the engine passes task-id-seeded keys).
    ``use_kernel`` as in :func:`dodoor_choice_batch`."""
    if keys is None:
        keys = fold_in(key, torch.arange(r.shape[0], device=r.device))
    cand = sample_feasible_batch(keys, feasible_mask(r, view.C), 2)
    d_cand = torch.gather(d, 1, cand.long())                   # [T, 2]
    return dodoor_choice_batch(r, cand, d_cand, view, params.alpha,
                               use_kernel=use_kernel)


def one_plus_beta_select(key, r, d, view: SchedulerView,
                         params: DodoorParams, beta: float = 0.5):
    """The (1+β) process: Dodoor's two-choice with probability β, else one
    uniform feasible choice (the ablation of §3.2)."""
    k_choice, k_sel = split(key)
    two = dodoor_select(k_sel, r, d, view, params)
    one = random_select(k_sel, r, d, view, params)
    use_two = uniform(k_choice) < beta
    return torch.where(use_two, two, one).to(torch.int32)


def prequal_select(key, r, d, pool: PrequalPool, view: SchedulerView,
                   params: PrequalParams):
    """Prequal's hot-cold lexicographic rule: an entry is cold when its
    RIF is at most the ``q_rif`` quantile of the pooled RIFs; take the cold
    entry of lowest latency, else the lowest-RIF entry (first index on
    ties), else, with an empty pool, one uniform feasible server
    (:func:`random_select` on ``key``).  Returns ``(server, pool)`` with
    the used entry consumed (b_reuse = 1)."""
    inf = torch.full_like(pool.rif, float("inf"))
    rifs = torch.where(pool.valid, pool.rif, inf)
    lats = torch.where(pool.valid, pool.latency, inf)
    any_valid = pool.valid.any()
    n_valid = torch.clamp_min(pool.valid.sum(), 1).to(torch.float32)
    q = torch.tensor(params.q_rif, dtype=torch.float32,
                     device=pool.rif.device)
    q_idx = (q * n_valid).to(torch.int32).clamp(0, pool.rif.shape[0] - 1)
    threshold = torch.sort(rifs).values[q_idx.long()]
    cold = pool.valid & (pool.rif <= threshold)
    entry = torch.where(cold.any(),
                        torch.argmin(torch.where(cold, lats, inf)),
                        torch.argmin(rifs))
    rand_server = random_select(key, r, d, view, DodoorParams())
    server = torch.where(any_valid, pool.server[entry],
                         rand_server).to(torch.int32)
    valid = pool.valid.clone()
    valid[entry] = valid[entry] & ~any_valid
    return server, pool._replace(valid=valid)


def prequal_probe_update(key, pool: PrequalPool, truth: SchedulerView,
                         now, params: PrequalParams) -> PrequalPool:
    """Prequal's asynchronous probes after a decision: ``r_probe`` servers
    drawn with :func:`repro_torch.random.randint`, each written with its
    true (RIF, duration) at ``now`` into the first invalid slot, else the
    oldest; then, if the pool is full, the highest-RIF entry is evicted
    (r_remove = 1).  Returns a new pool."""
    n = truth.rif.shape[0]
    probes = randint(key, (params.r_probe,), 0, n).long()
    server, rif, lat, age, valid = (t.clone() for t in pool)
    now = torch.as_tensor(now, dtype=torch.float32, device=rif.device)
    for i in range(params.r_probe):
        slot = torch.argmin(torch.where(valid, age, float("-inf")))
        srv = probes[i]
        server[slot] = srv.to(torch.int32)
        rif[slot] = truth.rif[srv]
        lat[slot] = truth.D[srv]
        age[slot] = now
        valid[slot] = True
    worst = torch.argmax(torch.where(valid, rif, float("-inf")))
    valid[worst] = valid[worst] & ~valid.all()
    return PrequalPool(server, rif, lat, age, valid)


def task_key(base_key: torch.Tensor, task_id) -> torch.Tensor:
    """Task-id-seeded key (§5 reproducibility)."""
    return fold_in(base_key, task_id)


POLICIES = {
    "random": random_select,
    "pot": pot_select,
    "dodoor": dodoor_select,
    "one_plus_beta": one_plus_beta_select,
    # "prequal" is stateful: the engine runs it with its pool.
}

#: Which view each policy reads: "cached" (the data store's snapshot),
#: "truth" (synchronous probes at decision time) or "pool" (Prequal's).
POLICY_VIEW = {
    "random": "cached",
    "pot": "truth",
    "dodoor": "cached",
    "one_plus_beta": "cached",
    "prequal": "pool",
}
