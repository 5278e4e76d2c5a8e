"""Placement policies of the ported slice: Random, Dodoor (Algorithm 1,
per task and batched) and the (1+β) process — counterpart of
``repro.core.policies``.

Per-task policies are ``select(key, r, d, view, params) -> server``, with
``r`` [K] the demand, ``d`` [n] the per-server estimated durations and
``view`` the scheduler's :class:`SchedulerView`.  Randomness comes from the
task id folded into the base key (§5), with :mod:`repro_torch.random`.
"""
from __future__ import annotations

import torch

from ..random import fold_in, split, uniform
from .prefilter import feasible_mask, sample_feasible, sample_feasible_batch
from .rl_score import load_score_batched
from .types import DodoorParams, SchedulerView


def random_select(key, r, d, view: SchedulerView,
                  params: DodoorParams) -> torch.Tensor:
    """Uniform placement over feasible servers (the Random baseline)."""
    return sample_feasible(key, feasible_mask(r, view.C), 1)[0]


def dodoor_choice_batch(r, cand, d_cand, view: SchedulerView, alpha, *,
                        use_kernel: bool = False) -> torch.Tensor:
    """Score a block's pre-sampled candidate pairs against one cache
    snapshot and pick the winners: r [T, K], cand [T, 2] int, d_cand
    [T, 2] (the task's duration on each candidate) → int32 [T].
    Line 11 of Algorithm 1: B wins iff score_A > score_B; ties keep A.

    ``use_kernel`` routes the selection through the decision kernel K5
    (:func:`repro_torch.kernels.dodoor_choice.dodoor_choice`): on CUDA
    tensors its CUDA kernel, on the CPU its plain version.  It scores in
    the reference kernel's reciprocal form, so a score may differ from the
    default path's by a few ulp; choices differ only at such near-ties.
    The kernel takes ``cand`` as int32 and K = 2."""
    if use_kernel:
        from ..kernels.dodoor_choice import dodoor_choice  # lazy: no cycle
        choice, _ = dodoor_choice(r, cand.to(torch.int32), d_cand, view.L,
                                  view.D, view.C, float(alpha))
        return choice
    c = cand.long()
    L_ab = view.L[c]                                           # [T, 2, K]
    D_ab = view.D[c] + d_cand                                  # [T, 2]
    scores = load_score_batched(r, L_ab, D_ab, view.C[c], alpha)
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


def task_key(base_key: torch.Tensor, task_id) -> torch.Tensor:
    """Task-id-seeded key (§5 reproducibility)."""
    return fold_in(base_key, task_id)
