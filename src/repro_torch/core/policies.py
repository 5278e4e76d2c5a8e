"""Placement policies of the ported slice: Random, Dodoor (Algorithm 1)
and the (1+β) process — counterpart of ``repro.core.policies``.

Per-task policies are ``select(key, r, d, view, params) -> server``, with
``r`` [K] the demand, ``d`` [n] the per-server estimated durations and
``view`` the scheduler's :class:`SchedulerView`.  Randomness comes from the
task id folded into the base key (§5), with :mod:`repro_torch.random`.
"""
from __future__ import annotations

import torch

from ..random import fold_in, split, uniform
from .prefilter import feasible_mask, sample_feasible
from .rl_score import load_score_batched
from .types import DodoorParams, SchedulerView


def random_select(key, r, d, view: SchedulerView,
                  params: DodoorParams) -> torch.Tensor:
    """Uniform placement over feasible servers (the Random baseline)."""
    return sample_feasible(key, feasible_mask(r, view.C), 1)[0]


def dodoor_choice_batch(r, cand, d_cand, view: SchedulerView,
                        alpha) -> torch.Tensor:
    """Score a block's pre-sampled candidate pairs against one cache
    snapshot and pick the winners: r [T, K], cand [T, 2] int, d_cand
    [T, 2] (the task's duration on each candidate) → int32 [T].
    Line 11 of Algorithm 1: B wins iff score_A > score_B; ties keep A."""
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
