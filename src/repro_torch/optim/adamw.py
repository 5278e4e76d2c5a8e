"""AdamW with global-norm clipping — the port of the JAX package's
``optim/adamw.py``.

State (``step``, ``m``, ``v``) mirrors the parameter tree (dicts and
tuples of tensors), so a checkpoint flattens to the reference's keys
(``step``, ``m/...``, ``v/...``).

The update is the reference's as XLA:CPU compiles it, so that on the CPU
the port's numbers are the reference's (``tests/test_torch_optim.py``):

* ``b1·m + (1 − b1)·g`` is ``fma(b1, m, (1 − b1)·g)`` and ``b2·v +
  (1 − b2)·g·g`` is ``fma(b2, v, ((1 − b2)·g)·g)``;
* ``p − lr·(u + wd·p)`` is ``fma(−lr, fma(wd, p, u), p)``;
* square roots are correctly rounded (``_arith.sqrt``; the CPU build of
  torch's ``sqrt`` is not, on ≈ 0.7 % of arguments).

Two scalars may still differ from the reference's by an ulp: the global
norm, a sum whose order XLA:CPU picks per leaf shape (32-wide windows,
vectorised inside), which reaches the update only when the norm clips;
and ``b**t``, XLA's own float32 ``pow`` (for b = 0.95 it moves the bias
correction at one step in 3 000).  On the card each multiply-add is one
``torch.addcmul`` (``_arith.madd``).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from .._arith import madd, sqrt
from ..models.common import tree_leaves, tree_map, tree_unflatten


class AdamWState(NamedTuple):
    step: torch.Tensor
    m: Any
    v: Any


def adamw_init(params) -> AdamWState:
    zeros = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                     params)
    device = tree_leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      m=zeros, v=tree_map(torch.clone, zeros))


def global_norm(tree) -> torch.Tensor:
    total = torch.zeros((), dtype=torch.float32,
                        device=tree_leaves(tree)[0].device)
    for x in tree_leaves(tree):
        total = total + torch.sum(torch.square(x.float()))
    return sqrt(total)


def _f32(x: float) -> float:
    """A Python float as the float32 constant the reference traces."""
    return float(torch.tensor(x, dtype=torch.float32))


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, *, lr,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, clip_norm: float = 1.0):
    """Returns (new_params, new_state).  ``lr`` may be a scalar or a
    step-indexed callable (schedule)."""
    step = state.step + 1
    if callable(lr):
        lr = lr(step)
    lr = torch.as_tensor(lr, dtype=torch.float32, device=step.device)
    gnorm = global_norm(grads)
    scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    c1, c2 = _f32(1 - b1), _f32(1 - b2)
    t = step.to(torch.float32)
    one = torch.ones((), dtype=torch.float32, device=t.device)
    mhat_scale = 1.0 / (one - torch.pow(_f32(b1), t))
    vhat_scale = 1.0 / (one - torch.pow(_f32(b2), t))

    def upd(p, g, m_, v_):
        # One leaf at a time, so that a leaf's temporaries (its scaled
        # gradient, u) are freed before the next leaf's are made.
        g = g.float() * scale
        m_ = madd(_f32(b1), m_, c1 * g)
        v_ = madd(_f32(b2), v_, (c2 * g) * g)
        u = (m_ * mhat_scale) / (sqrt(v_ * vhat_scale) + _f32(eps))
        p32 = p.float()
        return (madd(-lr, madd(_f32(weight_decay), p32, u), p32).to(p.dtype),
                m_, v_)

    out = [upd(*leaves) for leaves in zip(
        tree_leaves(params), tree_leaves(grads), tree_leaves(state.m),
        tree_leaves(state.v))]
    new_params, m, v = (tree_unflatten(params, [o[i] for o in out])
                        for i in range(3))
    return new_params, AdamWState(step=step, m=m, v=v)
