"""int8 gradient compression with error feedback — the port of the JAX
package's ``optim/compression.py``.

Per-tensor symmetric int8 quantisation, the quantisation residual carried
in an error-feedback buffer so that the accumulated update is unbiased.
On one card there is no gradient all-reduce for it to shrink; it is
ported so that a state compressed by either package continues in the
other.  As XLA:CPU compiles the reference, ``g / scale`` is a true
division (no reciprocal), ``round`` is half to even, and the residual
``g − q·scale`` is one fused multiply-add, ``fma(−q, scale, g)``
(``_arith.madd``); ``tests/test_torch_optim.py`` holds the port to it bit
for bit.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from .._arith import madd
from ..models.common import tree_leaves, tree_map, tree_unflatten


class CompressionState(NamedTuple):
    error: Any               # residual tree (same structure as grads)


def compression_init(grads_like) -> CompressionState:
    return CompressionState(error=tree_map(
        lambda g: torch.zeros_like(g, dtype=torch.float32), grads_like))


def _quantize(g: torch.Tensor):
    scale = torch.clamp(g.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


@torch.no_grad()
def compress_grads(grads, state: CompressionState):
    """grads (+carried error) → (int8 tree, scales tree, new state)."""
    def one(g, e):
        g32 = g.float() + e
        q, scale = _quantize(g32)
        return q, scale, madd(-q.float(), scale, g32)

    qs, scales, errs = zip(*[one(g, e) for g, e in zip(
        tree_leaves(grads), tree_leaves(state.error))])
    return (tree_unflatten(grads, qs), tree_unflatten(grads, scales),
            CompressionState(error=tree_unflatten(grads, errs)))


def decompress_grads(q_tree, scales):
    return tree_map(lambda q, s: q.float() * s, q_tree, scales)


__all__ = ["CompressionState", "compression_init", "compress_grads",
           "decompress_grads"]
