"""ctypes launchers of the CUDA decision kernels K1, K2 and K3
(``kernels/csrc/dodoor_fused_sparse.cu``)."""
from __future__ import annotations

import ctypes

import torch

from .._build import load

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_ARGTYPES = {
    "dodoor_fused_sparse_launch":
        (_P,) * 7 + (_I, _I, _I, _F) + (_P,) * 4,
    "dodoor_fused_sparse_masked_launch":
        (_P,) * 10 + (_I, _I, _I, _I, _F) + (_P,) * 4,
    "dodoor_fused_sparse_locality_launch":
        (_P,) * 9 + (_I, _I, _I, _I, _F, _F) + (_P,) * 4,
    "dodoor_fused_sparse_masked_locality_launch":
        (_P,) * 12 + (_I, _I, _I, _I, _I, _F, _F) + (_P,) * 4,
}


def _launcher(symbol: str):
    fn = getattr(load("dodoor_fused_sparse"), symbol)
    if fn.argtypes is None:          # first use of this library handle
        fn.argtypes = _ARGTYPES[symbol]
        fn.restype = ctypes.c_int
    return fn


def launch_dodoor_fused_sparse(keys, r, d_types, node_type, L, D, C,
                               alpha: float, choice, cand, scores,
                               down0=None, down1=None, now=None, psrv=None,
                               pbytes=None, gamma_bw: float = 0.0) -> str:
    """Enqueue K1 (or K2, given the down-window planes ``down0``, ``down1``
    [N, Wd] and the tasks' times ``now`` [T]; or K3 in either form, given
    the parent planes ``psrv``, ``pbytes`` [T, P] and ``gamma_bw``) on the
    current stream of the tensors' device, and return the kernel's name.
    All tensors must be contiguous CUDA tensors of the documented dtypes
    (the wrapper in ``ops.py`` checks); raises if the launch is
    refused."""
    T, N, TT = r.shape[0], C.shape[0], d_types.shape[1]
    stream = torch.cuda.current_stream(keys.device).cuda_stream
    ins = [t.data_ptr() for t in (keys, r, d_types, node_type, L, D, C)]
    outs = [choice.data_ptr(), cand.data_ptr(), scores.data_ptr(), stream]
    name = "dodoor_fused_sparse"
    args = []
    dims = [T, N, TT]
    if down0 is not None:
        name += "_masked"
        args += [down0.data_ptr(), down1.data_ptr(), now.data_ptr()]
        dims.append(down0.shape[1])
    scalars = [float(alpha)]
    if psrv is not None:
        name += "_locality"
        args += [psrv.data_ptr(), pbytes.data_ptr()]
        dims.append(psrv.shape[1])
        scalars.append(float(gamma_bw))
    err = _launcher(name + "_launch")(*ins, *args, *dims, *scalars, *outs)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    return name
