"""JAX-compatible counter-based PRNG (threefry2x32) on torch tensors.

Bit-exact with ``jax.random`` under ``jax_threefry_partitionable=True``
(the JAX 0.9 default), so the port draws the reference's candidates from
the same seeds:

* ``PRNGKey(s)``          = (s >> 32, s & 0xFFFFFFFF)
* ``fold_in(key, d)``     = threefry2x32(key, (0, d))
* ``split(key, n)[i]``    = threefry2x32(key, (0, i))
* ``uniform(key, (n,))[i] = unit(y0 ^ y1)`` with
  ``(y0, y1) = threefry2x32(key, (0, i))`` and ``unit`` the f32 mantissa
  fill ``bitcast((bits >> 9) | 0x3F800000) - 1``; with bounds,
  ``max(lo, fma(unit, hi − lo, lo))``;
* ``gumbel(key, shape) = -log(-log(uniform(key, shape, tiny, 1)))`` with
  XLA:CPU's float32 ``log`` (:func:`repro_torch._arith.log`; JAX 0.9's
  default, low-range Gumbel), whose ``argmax(noise + logits)`` is
  ``jax.random.categorical``;
* ``exponential(key, shape) = -log1p(-uniform(key, shape))`` with
  XLA:CPU's float32 ``log1p`` (:func:`repro_torch._arith.log1p`);
* ``randint(key, shape, lo, hi)`` = ``lo + (w0 mod s · m + w1 mod s) mod
  s`` in wrapping uint32 arithmetic, with ``s = hi − lo``, ``m = (2¹⁶ mod
  s)² mod s`` and the words ``w0``, ``w1`` drawn from the two halves of
  ``split(key)``.

A key is an int64 tensor whose last axis holds the two 32-bit words; every
function broadcasts over leading axes (a ``[T, 2]`` block of keys gives
``[T, ...]`` results).  The uint32 arithmetic runs on int64 masked with
``0xFFFFFFFF`` because torch's uint32 operator coverage is thin.
"""
from __future__ import annotations

import torch

from ._arith import fma, log, log1p
from ._device import resolve_device

MASK32 = 0xFFFFFFFF
# threefry2x32 rotation schedule and key-parity constant (Salmon et al.,
# as in jax._src.prng).
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & MASK32


def threefry2x32(k0, k1, x0, x1):
    """20-round threefry2x32 on int64 tensors holding uint32 values."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    a = (x0 + ks[0]) & MASK32
    b = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & MASK32
            b = _rotl(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & MASK32
        b = (b + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return a, b


def PRNGKey(seed: int, *, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` as an int64 ``[2]`` tensor."""
    dev = resolve_device(device)
    seed = int(seed)
    hi = (seed >> 32) & MASK32 if seed >= 0 else 0
    return torch.tensor([hi, seed & MASK32], dtype=torch.int64, device=dev)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in`` broadcast over ``key[..., 2]`` and ``data``
    (an integer tensor, e.g. a block of task ids)."""
    data = torch.as_tensor(data, device=key.device).to(torch.int64) & MASK32
    k0, k1 = key[..., 0], key[..., 1]
    y0, y1 = threefry2x32(k0, k1, torch.zeros_like(data), data)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: ``key[..., 2]`` → ``[..., num, 2]``."""
    i = torch.arange(num, dtype=torch.int64, device=key.device)
    k0, k1 = key[..., 0, None], key[..., 1, None]
    y0, y1 = threefry2x32(k0, k1, torch.zeros_like(i), i)
    return torch.stack((y0, y1), dim=-1)


def random_bits(key: torch.Tensor, shape=()) -> torch.Tensor:
    """32-bit random words ``[..., *shape]`` (int64 holding uint32)."""
    shape = tuple(shape)
    count = 1
    for s in shape:
        count *= s
    i = torch.arange(count, dtype=torch.int64, device=key.device)
    k0, k1 = key[..., 0, None], key[..., 1, None]
    y0, y1 = threefry2x32(k0, k1, torch.zeros_like(i), i)
    return (y0 ^ y1).reshape(key.shape[:-1] + shape)


def uniform(key: torch.Tensor, shape=(), minval=0.0,
            maxval=1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, minval=, maxval=)`` as float32: in
    [0, 1) by default; with bounds ``max(minval, unit·(maxval − minval) +
    minval)``, the multiply-add rounded once as XLA:CPU contracts it (the
    bounds are float32 values; ``maxval − minval`` is rounded to float32
    first, as the reference's)."""
    bits = (random_bits(key, shape) >> 9) | 0x3F800000
    unit = bits.to(torch.int32).view(torch.float32) - 1.0
    if minval == 0.0 and maxval == 1.0:
        return unit
    lo = torch.tensor(minval, dtype=torch.float32, device=unit.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=unit.device)
    return torch.maximum(lo, fma(unit, hi - lo, lo))


def gumbel(key: torch.Tensor, shape=()) -> torch.Tensor:
    """``jax.random.gumbel(key, shape)`` (float32, the default low-range
    mode) bit for bit: ``-log(-log(u))`` with u uniform in [tiny, 1) and
    XLA:CPU's ``log`` (≈ 14 % of torch's ``log`` values differ from it by
    an ulp, which can flip a near-tie argmax)."""
    tiny = float(torch.finfo(torch.float32).tiny)
    return -log(-log(uniform(key, shape, minval=tiny, maxval=1.0)))


def exponential(key: torch.Tensor, shape=()) -> torch.Tensor:
    """``jax.random.exponential(key, shape)``: unit-rate exponential
    draws as float32, bit-exact with the compiled reference."""
    return -log1p(-uniform(key, shape))


def _mul32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a · b mod 2³²`` for int64 tensors holding uint32 values, without
    leaving int64: split ``a`` into 16-bit halves."""
    hi = ((a >> 16) * b) & 0xFFFF
    return ((hi << 16) + (a & 0xFFFF) * b) & MASK32


def randint(key: torch.Tensor, shape=(), minval=0, maxval=1,
            dtype=torch.int32) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` for 32-bit
    integers: uniform-ish integers in ``[minval, maxval)``, broadcast over
    ``key[..., 2]`` like the other draws.  JAX's form: two words per value
    from the two halves of ``split(key)``, reduced modulo the span ``s =
    maxval − minval`` (uint32, wrapping) as ``(hi mod s · m + lo mod s) mod
    s`` with ``m = (2¹⁶ mod s)² mod s``, every product and sum wrapped
    to 32 bits as JAX's are; ``s`` is 1 when ``maxval ≤
    minval``, so ``minval`` comes back.  Bounds outside int32 are clipped
    to it, and a ``maxval`` above its maximum widens the span by one."""
    if dtype != torch.int32:
        raise TypeError(f"randint draws int32 values, got {dtype}")
    shape = tuple(shape)
    lo_i, hi_i = -(1 << 31), (1 << 31) - 1
    dev = key.device
    minval = torch.as_tensor(minval, dtype=torch.int64, device=dev)
    maxval = torch.as_tensor(maxval, dtype=torch.int64, device=dev)
    out_of_range = maxval > hi_i
    minval = minval.clamp(lo_i, hi_i)
    maxval = maxval.clamp(lo_i, hi_i)
    kk = split(key)
    higher = random_bits(kk[..., 0, :], shape)
    lower = random_bits(kk[..., 1, :], shape)
    span = (maxval - minval) & MASK32
    span = torch.where(maxval <= minval, torch.ones_like(span), span)
    span = torch.where(out_of_range & (maxval > minval),
                       (span + 1) & MASK32, span)
    # A span that wrapped to 0 (2³²) leaves the words as they are.
    wrap = span == 0
    s = torch.where(wrap, torch.ones_like(span), span)
    mult = (1 << 16) % s
    mult = ((mult * mult) & MASK32) % s
    off = (_mul32(higher % s, mult) + lower % s) & MASK32
    off = torch.where(wrap, off, off % s)
    val = (minval + off) & MASK32
    return torch.where(val > hi_i, val - (1 << 32), val).to(torch.int32)
