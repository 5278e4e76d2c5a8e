"""ctypes launcher of the CUDA decision kernel
(``kernels/csrc/dodoor_fused_sparse.cu``)."""
from __future__ import annotations

import ctypes

import torch

from .._build import load

_P = ctypes.c_void_p
_ARGTYPES = (_P, _P, _P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_float, _P, _P, _P, _P)


def _launcher():
    fn = load("dodoor_fused_sparse").dodoor_fused_sparse_launch
    if fn.argtypes is None:          # first use of this library handle
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def launch_dodoor_fused_sparse(keys, r, d_types, node_type, L, D, C,
                               alpha: float, choice, cand, scores) -> None:
    """Enqueue the kernel on the current stream of the tensors' device.
    All tensors must be contiguous CUDA tensors of the documented dtypes
    (the wrapper in ``ops.py`` checks); raises if the launch is refused."""
    T, N, TT = r.shape[0], C.shape[0], d_types.shape[1]
    stream = torch.cuda.current_stream(keys.device).cuda_stream
    err = _launcher()(
        keys.data_ptr(), r.data_ptr(), d_types.data_ptr(),
        node_type.data_ptr(), L.data_ptr(), D.data_ptr(), C.data_ptr(),
        T, N, TT, float(alpha), choice.data_ptr(), cand.data_ptr(),
        scores.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"dodoor_fused_sparse launch failed: CUDA error "
                           f"{err}")
