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
* a row sum over more than 32 columns is rewritten into a 32-wide,
  32-stride window sum over the row padded evenly on both sides, then a
  sum of the window totals (again windowed while there are more than 32
  of them); each sum runs left to right — :func:`row_sum`;
* float32 ``log1p`` is XLA:CPU's own expansion, neither correctly rounded
  nor torch's: a rational function for small arguments and a polynomial
  ``log`` after a mantissa/exponent split otherwise — :func:`log1p`; and
  float32 ``log`` is that polynomial (:func:`log`; ≈ 14 % of uniform
  draws differ from ``torch.log`` by an ulp);
* ``sqrt`` is correctly rounded, which the CPU build of ``torch.sqrt``
  is not on ≈ 0.7 % of arguments — :func:`sqrt`.

These were measured against ``jax.jit`` on the CPU backend (JAX 0.9) and
are pinned by ``tests/test_torch_core.py``.
"""
from __future__ import annotations

import numpy as np
import torch

_CHUNK = 32
# float64 bits below a float32 mantissa (29), and their midpoint pattern.
_MID_MASK = (1 << 29) - 1
_MID_BIT = 1 << 28


def fma(a, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` with one rounding.  The product of two float32
    values is exact in float64; the float64 sum rounds once, and where it
    lands exactly on a float32 rounding midpoint it is moved one float64
    step towards its rounding error (Two-Sum), so that the float32
    rounding sees which side of the midpoint the exact sum lies on.  Under
    autograd the step is added as a constant (``nextafter`` has no
    derivative), so the gradient is that of a·b + c."""
    dev = next(x.device for x in (a, b, c) if isinstance(x, torch.Tensor))
    a, b, c = (torch.as_tensor(x, dtype=torch.float32, device=dev)
               for x in (a, b, c))
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    mid = (s.view(torch.int64) & _MID_MASK) == _MID_BIT
    if torch.is_grad_enabled() and s.requires_grad:
        sd = s.detach()
        step = torch.nextafter(sd, sd + err.detach()) - sd   # exact
        return (s + torch.where(mid & (err != 0), step,
                                torch.zeros_like(sd))).float()
    s = torch.where(mid & (err != 0), torch.nextafter(s, s + err), s)
    return s.float()


def madd(a, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` where the reference contracts it: on the CPU
    :func:`fma` (bit for bit, in float64); on the card one
    ``torch.addcmul``, the card's own multiply-add (the float64 replay
    costs several passes over each tensor there)."""
    dev = next(x.device for x in (a, b, c) if isinstance(x, torch.Tensor))
    if dev.type == "cpu":
        return fma(a, b, c)
    a, b, c = (torch.as_tensor(x, dtype=torch.float32, device=dev)
               for x in (a, b, c))
    return torch.addcmul(c, a, b)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root: on the CPU through float64
    (exact after one rounding, since 53 ≥ 2·24 + 2 bits), on the card
    ``torch.sqrt`` (IEEE there)."""
    if x.device.type == "cpu":
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def dot_fma(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Σ_k x[..., k]·y[..., k] as XLA:CPU evaluates a short contraction:
    ``acc = x0*y0``, then ``acc = fma(x_k, y_k, acc)``."""
    acc = x[..., 0] * y[..., 0]
    for k in range(1, x.shape[-1]):
        acc = fma(x[..., k], y[..., k], acc)
    return acc


def _seq_sum(x: torch.Tensor) -> torch.Tensor:
    acc = x[..., 0]
    for i in range(1, x.shape[-1]):
        acc = acc + x[..., i]
    return acc


def row_windows(W: int) -> list:
    """The column bounds ``[(a, b), ...]`` of XLA:CPU's 32-wide windows
    over a row of ``W`` > 32 columns: ``ceil(W/32)`` windows over the row
    padded with ``pad // 2`` zeros in front and the rest behind (``pad``
    rounds W up to a multiple of 32), so the first and last windows hold
    fewer real columns."""
    n = -(-W // _CHUNK)
    lo = (n * _CHUNK - W) // 2
    edges = [max(0, k * _CHUNK - lo) for k in range(n)] + [W]
    return list(zip(edges[:-1], edges[1:]))


def row_sum(x: torch.Tensor) -> torch.Tensor:
    """float32 sum over the last axis in XLA:CPU's order.  Up to 32
    columns it is a left-to-right sum.  A wider row is first reduced to
    its :func:`row_windows` totals, each summed left to right (XLA's tree
    reduction rewrite: a reduce-window of size and stride 32), and those
    totals are summed the same way — read from the optimized HLO and
    pinned by ``tests/test_torch_core.py`` for widths up to 5000."""
    while x.shape[-1] > _CHUNK:
        W = x.shape[-1]
        if W % _CHUNK == 0:          # no padding: sum the windows side by side
            x = _seq_sum(x.unflatten(-1, (W // _CHUNK, _CHUNK)))
        else:
            x = torch.stack([_seq_sum(x[..., a:b])
                             for a, b in row_windows(W)], dim=-1)
    return _seq_sum(x)


def _f32(bits: int) -> float:
    return float(np.uint32(bits).view(np.float32))


# XLA:CPU's float32 log1p: a Cephes rational function for |x| below
# sqrt(2)-1 (coefficients highest power first), and otherwise log(1 + x)
# by Eigen's float log polynomial.
_SMALL_MAX = _f32(0x3ED413CD)
_DEN = tuple(map(_f32, (0x3F800000, 0x417101AD, 0x42A6185B, 0x435DC32D,
                        0x439A8CA3, 0x43586D8A, 0x42707982)))
_NUM = tuple(map(_f32, (0x383DE04B, 0x3EFF40C5, 0x40D284FA, 0x41EF4B9C,
                        0x4273CC76, 0x426473AD, 0x41A05101)))
_SQRTHF = _f32(0x3F3504F3)
_LOG_P = tuple(map(_f32, (0x3D9021BB, 0xBDEBD1B8, 0x3DEF251A,   # a-chain
                          0xBDFE5D4F, 0x3E11E9BF, 0xBE2AAE50,   # b-chain
                          0x3E4CCEAC, 0xBE7FFFFC, 0x3EAAAAAA)))  # c-chain
_LN2_LO, _LN2_HI = _f32(0xB95E8083), _f32(0x3F318000)
_FLT_MIN = _f32(0x00800000)


def log(y: torch.Tensor) -> torch.Tensor:
    """float32 ``log(y)`` for y in [FLT_MIN, +inf) as XLA:CPU evaluates it:
    :func:`log1p`'s large branch, and ``jnp.log`` itself (the reference's
    ``jax.random.gumbel`` is ``-log(-log(u))``); pinned against
    ``jax.jit(jnp.log)`` by ``tests/test_torch_data.py``."""
    y = torch.clamp_min(y, _FLT_MIN)
    bits = y.view(torch.int32)
    e = ((bits >> 23) - 127).float() + 1.0
    m = ((bits & 0x7FFFFF) | 0x3F000000).view(torch.float32)   # [0.5, 1)
    lo = m < _SQRTHF
    x = (m - 1.0) + torch.where(lo, m, torch.zeros_like(m))
    e = torch.where(lo, e - 1.0, e)
    z = x * x
    x3 = z * x
    a0, a1, a2, b0, b1, b2, c0, c1, c2 = _LOG_P
    a = fma(fma(a0, x, a1), x, a2)
    b = fma(fma(b0, x, b1), x, b2)
    c = fma(fma(c0, x, c1), x, c2)
    t = fma(x3, fma(x3, a, b), c)
    t = fma(x3, t, e * _LN2_LO)
    r = fma(-0.5, z, x) + t
    return fma(e, _LN2_HI, r)


def log1p(x: torch.Tensor) -> torch.Tensor:
    """float32 ``log1p`` for x in (-1, +inf) as XLA:CPU computes it (the
    reference's ``jax.random.exponential`` is ``-log1p(-u)``).  Its
    contractions into fused multiply-adds were read from the compiled
    kernel; pinned against ``jax.random.exponential`` by
    ``tests/test_torch_random.py``."""
    z2 = x * x
    den = torch.full_like(x, _DEN[0])
    for coef in _DEN[1:]:
        den = fma(den, x, coef)
    num = torch.full_like(x, _NUM[0])
    for coef in _NUM[1:]:
        num = fma(num, x, coef)
    small = fma(z2, -0.5, (x * z2) * (num / den)) + x
    return torch.where(x.abs() < _SMALL_MAX, small, log(1.0 + x))
