"""ctypes launchers of the CUDA decision kernels K1 and K2
(``kernels/csrc/dodoor_fused_sparse.cu``)."""
from __future__ import annotations

import ctypes

import torch

from .._build import load

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = {
    "dodoor_fused_sparse_launch":
        (_P,) * 7 + (_I, _I, _I, ctypes.c_float) + (_P,) * 4,
    "dodoor_fused_sparse_masked_launch":
        (_P,) * 10 + (_I, _I, _I, _I, ctypes.c_float) + (_P,) * 4,
}


def _launcher(symbol: str):
    fn = getattr(load("dodoor_fused_sparse"), symbol)
    if fn.argtypes is None:          # first use of this library handle
        fn.argtypes = _ARGTYPES[symbol]
        fn.restype = ctypes.c_int
    return fn


def launch_dodoor_fused_sparse(keys, r, d_types, node_type, L, D, C,
                               alpha: float, choice, cand, scores,
                               down0=None, down1=None, now=None) -> None:
    """Enqueue K1 (or K2, given the down-window planes ``down0``, ``down1``
    [N, Wd] and the tasks' times ``now`` [T]) on the current stream of the
    tensors' device.  All tensors must be contiguous CUDA tensors of the
    documented dtypes (the wrapper in ``ops.py`` checks); raises if the
    launch is refused."""
    T, N, TT = r.shape[0], C.shape[0], d_types.shape[1]
    stream = torch.cuda.current_stream(keys.device).cuda_stream
    ins = [t.data_ptr() for t in (keys, r, d_types, node_type, L, D, C)]
    outs = [choice.data_ptr(), cand.data_ptr(), scores.data_ptr(), stream]
    if down0 is None:
        name = "dodoor_fused_sparse"
        err = _launcher("dodoor_fused_sparse_launch")(
            *ins, T, N, TT, float(alpha), *outs)
    else:
        name = "dodoor_fused_sparse_masked"
        err = _launcher("dodoor_fused_sparse_masked_launch")(
            *ins, down0.data_ptr(), down1.data_ptr(), now.data_ptr(),
            T, N, TT, down0.shape[1], float(alpha), *outs)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
