"""ctypes launchers of the CUDA SSD chunk kernel K8 and its backward
(``kernels/csrc/ssd_chunk.cu``)."""
from __future__ import annotations

import ctypes

import torch

from .._build import load

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = (_P,) * 8 + (_I,) * 9 + (_P,)


def launch_ssd_chunk(x, delta, dtv, Bm, Cm, y, Hs, exp_s, *,
                     heads_per_group: int, nh: int) -> None:
    """Enqueue K8 on the current stream of the tensors' device, ``nh``
    heads of a group a block (``ops.plan_k8``).  All tensors must be
    contiguous float32 CUDA tensors of the shapes ``ops.ssd_chunk``
    documents (it checks); raises if the launch is refused, for instance
    for more shared memory than the card grants."""
    fn = load("ssd_chunk").ssd_chunk_launch
    if fn.argtypes is None:          # first use of this library handle
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    BH, NC, Q, P = x.shape
    Bb, G = Bm.shape[0], Bm.shape[1]
    S = Bm.shape[4]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), delta.data_ptr(), dtv.data_ptr(), Bm.data_ptr(),
             Cm.data_ptr(), y.data_ptr(), Hs.data_ptr(), exp_s.data_ptr(),
             BH, NC, Q, P, S, Bb, G, heads_per_group, nh, stream)
    if err != 0:
        raise RuntimeError(f"ssd_chunk launch failed: CUDA error {err}")



_BWD_ARGTYPES = (_P,) * 14 + (_I,) * 9 + (_P,)


def launch_ssd_chunk_bwd(x, delta, dtv, Bm, Cm, dy, dH, des, dx, ddelta,
                         ddt, dB, dC, part, *, heads_per_group: int,
                         nh: int) -> None:
    """Enqueue K8's backward on the current stream of the tensors' device,
    ``nh`` heads of a group a block (``ops.plan_k8_bwd``): the forward's
    inputs, the output gradients dy [BH, NC, Q, P], dH [BH, NC, S, P], des
    [BH, NC, Q], and the outputs dx, ddelta, ddt (x's and delta's shapes)
    and dB, dC [B, G, NC, Q, S], all contiguous float32 CUDA tensors;
    ``part``: None when nh = heads_per_group, else float32 scratch of
    2·⌈hpg / nh⌉·B·G·NC·Q·S values for the runs' partial sums.  The wrapper
    in ``ops.py`` checks; raises if the launch is refused."""
    fn = load("ssd_chunk").ssd_chunk_bwd_launch
    if fn.argtypes is None:          # first use of this library handle
        fn.argtypes = _BWD_ARGTYPES
        fn.restype = ctypes.c_int
    BH, NC, Q, P = x.shape
    Bb, G = Bm.shape[0], Bm.shape[1]
    S = Bm.shape[4]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(*(t.data_ptr() for t in (x, delta, dtv, Bm, Cm, dy, dH, des, dx,
                                      ddelta, ddt, dB, dC)),
             None if part is None else part.data_ptr(),
             BH, NC, Q, P, S, Bb, G, heads_per_group, nh, stream)
    if err != 0:
        raise RuntimeError(f"ssd_chunk backward launch failed: CUDA error "
                           f"{err}")
