"""Precision knobs threaded through the transformer — the port of the JAX
package's ``models/precision.py``.

* ``compute_dtype`` — cast a layer's float weights and the residual
  stream to it at use (bf16: the projections become cuBLAS bf16 products
  through ``torch.matmul``, and K7 takes bf16 q, k, v).  The float32
  parameters stay the master copy the optimizer updates.
* ``residual_spec`` — the reference's sequence-parallel sharding of the
  residual stream between sublayers.  One card has no mesh to shard
  over, so ``set_residual_spec`` stores its argument and changes nothing,
  and :func:`constrain` returns its input.

Both are module-level globals, as the reference's are: a caller sets
them for a run or a block (:func:`options`); the defaults (None) leave
the float32 path exactly as it is.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch

_DTYPE: Optional[torch.dtype] = None
_RESIDUAL_SPEC = None


def set_compute_dtype(dtype) -> None:
    global _DTYPE
    _DTYPE = dtype


def set_residual_spec(spec) -> None:
    """Store ``spec``; it has no effect on one card (see :func:`constrain`)."""
    global _RESIDUAL_SPEC
    _RESIDUAL_SPEC = spec


@contextlib.contextmanager
def options(dtype=None, residual_spec=None):
    """Set both knobs inside the block and restore the previous values on
    leaving it, also when the block raises."""
    global _DTYPE, _RESIDUAL_SPEC
    old = (_DTYPE, _RESIDUAL_SPEC)
    _DTYPE, _RESIDUAL_SPEC = dtype, residual_spec
    try:
        yield
    finally:
        _DTYPE, _RESIDUAL_SPEC = old


def _cast(t):
    if isinstance(t, dict):
        return {k: _cast(v) for k, v in t.items()}
    if isinstance(t, (tuple, list)):
        return type(t)(_cast(v) for v in t)
    if isinstance(t, torch.Tensor) and t.is_floating_point():
        return t.to(_DTYPE)
    return t


def cast_params(tree):
    """Cast the float leaves of a parameter tree to the compute dtype."""
    return tree if _DTYPE is None else _cast(tree)


def cast_act(x):
    return x if _DTYPE is None else x.to(_DTYPE)


def constrain(x):
    """The reference's ``with_sharding_constraint`` of the residual stream
    to ``residual_spec`` (sequence parallelism across a mesh).  One card
    holds the whole stream, so this returns ``x`` whatever the spec."""
    return x
