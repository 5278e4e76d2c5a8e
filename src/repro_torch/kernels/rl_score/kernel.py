"""ctypes launcher of the CUDA RL score kernel K6
(``kernels/csrc/rl_score.cu``)."""
from __future__ import annotations

import ctypes

import torch

from .._build import load
from .ref import unfused_columns

_P = ctypes.c_void_p
_I = ctypes.c_int


def launch_rl_score(r, L, C, out, plan) -> None:
    """Enqueue the scores (into ``out`` [T, N], 16-byte aligned) on the
    current stream of the tensors' device, one launch: ``plan`` = (G, R,
    rpt) from :func:`..ops.plan_k6`; the kernel sums ``ΣC²`` of the first
    :func:`..ref.unfused_columns` servers unfused, as the plain version.
    All tensors must be contiguous float32 CUDA tensors (the wrapper in
    ``ops.py`` checks); raises if the launch is refused."""
    fn = load("rl_score").rl_score_launch
    if fn.argtypes is None:          # first use of this library handle
        fn.argtypes = (_P,) * 4 + (_I,) * 7 + (_P,)
        fn.restype = ctypes.c_int
    T, K = r.shape
    G, R, rpt = plan
    stream = torch.cuda.current_stream(r.device).cuda_stream
    N = L.shape[0]
    err = fn(r.data_ptr(), L.data_ptr(), C.data_ptr(), out.data_ptr(), T, N,
             K, G, R, rpt, unfused_columns(N, K), stream)
    if err != 0:
        raise RuntimeError(f"rl_score_matrix launch failed: CUDA error {err}")
