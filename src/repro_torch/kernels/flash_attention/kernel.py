"""ctypes launcher of the CUDA flash-attention kernel K7
(``kernels/csrc/flash_attention.cu``)."""
from __future__ import annotations

import ctypes

import torch

from .._build import load

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_ARGTYPES = ((_P,) * 6 + (_I,) * 6 + (_L,) * 13
             + (_I, _I, ctypes.c_float, _I, _I, _P, _I, _P, _P, _P))


def launch_flash_attention(q, k, v, out, *, causal: bool, window,
                           scale: float, kv_last=None, splits: int = 1,
                           part=None, lse=None, o32=None) -> None:
    """Enqueue K7 on the current stream of the tensors' device: q [B, H,
    Lq, D] float32 or bfloat16; k, v [B, Hkv, Lk, D] of one of those
    dtypes, read in q's; each with unit stride along D (any strides
    elsewhere: a slice of a cache goes as it lies); out [B, H, Lq, D]
    contiguous of q's dtype; ``kv_last``: None, or (k_last, v_last)
    [B, Hkv, 1, D] of q's dtype with unit stride along D, which take the
    place of key and value Lk − 1.  ``splits``: the runs of keys a group
    of at most 16 rows (H / Hkv · Lq) is cut into (``ops.plan_k7``; 1 for
    larger groups); with ``splits`` > 1, ``part`` is float32 scratch of
    B·Hkv·splits·rows·(D + 2) values and a second kernel merges the runs.
    ``lse``: None, or float32 [B, H, Lq] contiguous, which receives each
    row's log2-sum-exp of its logits scaled by scale·log2 e (the
    backward's input); such a call takes the tensor-core kernel at any
    group size, q, k, v of one dtype (float32, or bfloat16 at D ≤ 128),
    and ``splits`` = 1.  ``o32``: None, or float32 [B, H, Lq, D]
    contiguous, which such a call fills with the output unrounded (a
    bfloat16 q's ``out`` is it rounded once).  The wrapper in ``ops.py``
    checks; raises if the launch is refused."""
    fn = load("flash_attention").flash_attention_launch
    if fn.argtypes is None:          # first use of this library handle
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    B, H, Lq, D = q.shape
    Hkv, Lk = k.shape[1], k.shape[2]
    if kv_last is None:
        last, last_strides = (None, None), (0,) * 4
    else:
        kl, vl = kv_last
        last = (kl.data_ptr(), vl.data_ptr())
        last_strides = (*kl.stride()[:2], *vl.stride()[:2])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *last,
             B, H, Hkv, Lq, Lk, D, *q.stride()[:3], *k.stride()[:3],
             *v.stride()[:3], *last_strides, int(causal),
             0 if window is None else window, float(scale),
             int(q.dtype == torch.bfloat16), int(k.dtype == torch.bfloat16),
             None if part is None else part.data_ptr(), splits,
             None if lse is None else lse.data_ptr(),
             None if o32 is None else o32.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")


_BWD_ARGTYPES = ((_P,) * 11 + (_I,) * 7 + (_L,) * 15
                 + (_I, _I, ctypes.c_float, _I, _P))


def launch_flash_attention_bwd(q, k, v, o, do, lse, dq, dk, dv, stats, *,
                               causal: bool, window, scale: float,
                               runs: int = 1, part=None) -> None:
    """Enqueue K7's backward on the current stream: q, do [B, H, Lq, D]
    and k, v [B, Hkv, Lk, D] of one dtype, float32 or (at D ≤ 128)
    bfloat16, and o [B, H, Lq, D] float32, each with unit stride along D,
    16-byte aligned rows and other strides multiples of 16 bytes; ``o``
    and ``lse`` the forward's float32 output (a bfloat16 call's
    unrounded ``o32``) and its [B, H, Lq] float32 log2-sum-exp
    (``launch_flash_attention(lse=...)``); dq [B, H, Lq, D] and dk, dv [B,
    Hkv, Lk, D] contiguous outputs of the operands' dtype; ``stats``
    float32 scratch of
    2·B·Hkv·rows_pad values (rows_pad = H / Hkv · Lq rounded up to a
    multiple of 64: each row's lse and Δ = rowsum(do ∘ o)); ``runs`` the
    dk/dv pass's runs of rows (``ops.plan_k7_bwd``) and, with more than
    one, ``part`` float32 scratch of 2·runs·B·Hkv·Lk·D values for their
    partial sums.  The wrapper in ``ops.py`` checks; raises if the launch
    is refused."""
    fn = load("flash_attention").flash_attention_bwd_launch
    if fn.argtypes is None:          # first use of this library handle
        fn.argtypes = _BWD_ARGTYPES
        fn.restype = ctypes.c_int
    B, H, Lq, D = q.shape
    Hkv, Lk = k.shape[1], k.shape[2]
    strides = [s for t in (q, k, v, o, do) for s in t.stride()[:3]]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(*(t.data_ptr() for t in (q, k, v, o, do, lse, dq, dk, dv,
                                      stats)),
             None if part is None else part.data_ptr(), runs,
             B, H, Hkv, Lq, Lk, D, *strides, int(causal),
             0 if window is None else window, float(scale),
             int(q.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention backward launch failed: CUDA "
                           f"error {err}")


def bwd_bf16_attrs(D: int) -> dict:
    """What the bf16 backward's two passes take on the current card at
    head width D (32, 64 or 128), from ``cudaFuncGetAttributes`` and the
    occupancy calculator: ``{"dkdv": {...}, "dq": {...}}``, each with
    ``registers``, ``local_bytes`` (spills land in local memory),
    ``smem_bytes`` (dynamic) and ``blocks_per_sm``."""
    fn = load("flash_attention").flash_attention_bwd_bf16_attrs
    if fn.argtypes is None:          # first use of this library handle
        fn.argtypes = (_I, ctypes.POINTER(ctypes.c_int))
        fn.restype = ctypes.c_int
    out = (ctypes.c_int * 8)()
    err = fn(D, out)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd_bf16_attrs({D}): CUDA "
                           f"error {err}")
    keys = ("registers", "local_bytes", "smem_bytes", "blocks_per_sm")
    return {name: dict(zip(keys, out[4 * i:4 * i + 4]))
            for i, name in enumerate(("dkdv", "dq"))}
