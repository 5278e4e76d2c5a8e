"""ctypes launcher of the CUDA RL score kernel K6
(``kernels/csrc/rl_score.cu``)."""
from __future__ import annotations

import ctypes

import torch

from .._build import load

_P = ctypes.c_void_p
_I = ctypes.c_int


def launch_rl_score(r, L, C, inv, out) -> None:
    """Enqueue the reciprocal norms (into the scratch ``inv`` [N]) and the
    scores (into ``out`` [T, N]) on the current stream of the tensors'
    device.  All tensors must be contiguous float32 CUDA tensors (the
    wrapper in ``ops.py`` checks); raises if the launch is refused."""
    fn = load("rl_score").rl_score_launch
    if fn.argtypes is None:          # first use of this library handle
        fn.argtypes = (_P,) * 5 + (_I, _I, _I, _P)
        fn.restype = ctypes.c_int
    T, K = r.shape
    stream = torch.cuda.current_stream(r.device).cuda_stream
    err = fn(r.data_ptr(), L.data_ptr(), C.data_ptr(), inv.data_ptr(),
             out.data_ptr(), T, L.shape[0], K, stream)
    if err != 0:
        raise RuntimeError(f"rl_score_matrix launch failed: CUDA error {err}")
