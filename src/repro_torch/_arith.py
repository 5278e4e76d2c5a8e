"""Float32 arithmetic spelled out the way XLA:CPU executes the reference.

The JAX reference is what it computes *as compiled*, and XLA:CPU rewrites
three patterns that PyTorch evaluates literally.  Each helper here states
one rewrite, so the port's CPU results match the reference bit for bit and
the CUDA kernel (which uses ``fmaf`` and is built with ``-fmad=false``)
matches both:

* ``a * b + c`` inside one fused loop is contracted to one fused
  multiply-add (a single rounding) — :func:`fma`;
* a K-term product sum (``einsum``/``sum(x * y)`` over a short axis) is a
  chain of such contractions starting from ``x0 * y0`` — :func:`dot_fma`;
* ``(a / b) / c`` is rewritten to ``a / (b * c)`` by the algebraic
  simplifier — callers write that form directly;
* a row sum over a long axis is evaluated as sequential sums of column
  chunks (32 wide for the ring buffer's 256 slots), then a sequential sum
  of the chunk totals — :func:`row_sum`.

These were measured against ``jax.jit`` on the CPU backend (JAX 0.9) and
are pinned by ``tests/test_torch_core.py``.
"""
from __future__ import annotations

import torch

_CHUNK = 32


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` with one rounding.  The product of two float32
    values is exact in float64, so only the final sum rounds twice (to
    float64, then float32); that differs from a true FMA only when the
    float64 sum lands exactly on a float32 rounding midpoint."""
    out = a.double() * b.double() + c.double()
    return out.float()


def dot_fma(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Σ_k x[..., k]·y[..., k] as XLA:CPU evaluates a short contraction:
    ``acc = x0*y0``, then ``acc = fma(x_k, y_k, acc)``."""
    acc = x[..., 0] * y[..., 0]
    for k in range(1, x.shape[-1]):
        acc = fma(x[..., k], y[..., k], acc)
    return acc


def row_sum(x: torch.Tensor) -> torch.Tensor:
    """float32 sum over the last axis in XLA:CPU's order: the row splits
    into ``ceil(W/32)`` contiguous chunks of ``ceil(W / ceil(W/32))``
    columns (the last one shorter), each summed left to right, then the
    chunk totals left to right.  That order was measured for widths up to
    64 and for multiples of 32; other widths raise."""
    W = x.shape[-1]
    if W > 64 and W % _CHUNK:
        raise ValueError(f"row_sum: width {W} has no measured XLA order "
                         "(use a multiple of 32, or at most 64)")
    n_chunks = -(-W // _CHUNK)
    width = -(-W // n_chunks)
    if W % width == 0:                 # equal chunks: sum them side by side
        cols = x.unflatten(-1, (n_chunks, width))
        acc = cols[..., 0]
        for i in range(1, width):
            acc = acc + cols[..., i]
        parts = acc.unbind(-1)
    else:
        parts = []
        for c0 in range(0, W, width):
            acc = x[..., c0]
            for i in range(c0 + 1, min(c0 + width, W)):
                acc = acc + x[..., i]
            parts.append(acc)
    total = parts[0]
    for part in parts[1:]:
        total = total + part
    return total
