"""Parameters of the JAX reference, as numpy arrays, to the port's.

The port keeps the reference's parameter tree: the same names, the layers
stacked along axis 0, and dense weights in the ``x @ W`` layout
``[d_in, d_out]`` — so no leaf is transposed or renamed, and a converted
tree computes what the reference computes with the same numbers.
"""
from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from ..configs.base import ModelConfig
from .registry import module


def params_from_numpy(cfg: ModelConfig, tree, *, device=None):
    """``tree``: the reference's ``init_params(cfg, key)`` pytree (dicts
    and tuples) with numpy (or array-like) leaves → the port's float32
    parameters on ``device`` (the card unless the caller asks for the
    CPU).  Raises ValueError naming the leaf if the tree's keys, tuple
    lengths or shapes differ from the port's for ``cfg``."""
    device = resolve_device(device)
    want = module(cfg).init_params(cfg, torch.Generator(), device="meta")

    def convert(path, got, spec):
        if isinstance(spec, dict):
            if not isinstance(got, dict) or set(got) != set(spec):
                have = sorted(got) if isinstance(got, dict) else type(got)
                raise ValueError(f"params_from_numpy: {path or 'the tree'} "
                                 f"has keys {have}, want {sorted(spec)}")
            return {k: convert(f"{path}/{k}", got[k], spec[k]) for k in spec}
        if isinstance(spec, tuple):
            if not isinstance(got, (tuple, list)) or len(got) != len(spec):
                have = (f"{len(got)} entries" if isinstance(got, (tuple, list))
                        else type(got))
                raise ValueError(f"params_from_numpy: {path or 'the tree'} "
                                 f"has {have}, want a tuple of {len(spec)}")
            return tuple(convert(f"{path}/{i}", g, sp)
                         for i, (g, sp) in enumerate(zip(got, spec)))
        arr = np.asarray(got)
        if arr.shape != tuple(spec.shape):
            raise ValueError(f"params_from_numpy: {path} has shape "
                             f"{arr.shape}, want {tuple(spec.shape)}")
        return torch.tensor(arr, dtype=torch.float32).to(device)

    return convert("", tree, want)


def train_state_from_numpy(cfg: ModelConfig, params_tree, opt_tree, *,
                           device=None):
    """A reference train state — ``(params, AdamWState(step, m, v))`` with
    numpy (or array-like) leaves, e.g. ``jax.tree.map(np.asarray, state)``
    — to the port's ``(params, optim.AdamWState)`` on ``device`` (the card
    unless the caller asks for the CPU), so that a state the JAX package
    trained resumes in the port.  ``opt_tree`` is any object with
    ``step``, ``m`` and ``v`` (or a (step, m, v) triple); m and v are
    checked against ``cfg``'s parameter tree as the parameters are."""
    from ..optim import AdamWState

    step, m, v = ((opt_tree.step, opt_tree.m, opt_tree.v)
                  if hasattr(opt_tree, "step") else tuple(opt_tree))
    device = resolve_device(device)
    params = params_from_numpy(cfg, params_tree, device=device)
    opt = AdamWState(
        step=torch.tensor(np.asarray(step), dtype=torch.int32).to(device),
        m=params_from_numpy(cfg, m, device=device),
        v=params_from_numpy(cfg, v, device=device))
    return params, opt
