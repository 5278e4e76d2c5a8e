"""ctypes launchers of the CUDA decision kernels K1–K5
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
    "dodoor_fused_launch": (_P,) * 6 + (_I, _I, _F) + (_P,) * 4,
    "dodoor_fused_masked_launch": (_P,) * 7 + (_I, _I, _F) + (_P,) * 4,
    "dodoor_choice_launch": (_P,) * 6 + (_I, _F, _F, _I) + (_P,) * 3,
}


def _launcher(symbol: str):
    fn = getattr(load("dodoor_fused_sparse"), symbol)
    if fn.argtypes is None:          # first use of this library handle
        fn.argtypes = _ARGTYPES[symbol]
        fn.restype = ctypes.c_int
    return fn


def _raise_on(err: int, name: str) -> str:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    return name


def launch_dodoor_fused_sparse(keys, r, d_types, node_type, L, D, C,
                               alpha: float, choice, cand, scores,
                               down0=None, down1=None, now=None, psrv=None,
                               pbytes=None, gamma_bw: float = 0.0) -> str:
    """Enqueue K1 (or K2, given the window-major down-window planes
    ``down0``, ``down1`` [Wd, N] and the tasks' times ``now`` [T]; or K3 in
    either form, given
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
        dims.append(down0.shape[0])
    scalars = [float(alpha)]
    if psrv is not None:
        name += "_locality"
        args += [psrv.data_ptr(), pbytes.data_ptr()]
        dims.append(psrv.shape[1])
        scalars.append(float(gamma_bw))
    err = _launcher(name + "_launch")(*ins, *args, *dims, *scalars, *outs)
    return _raise_on(err, name)


def launch_dodoor_fused(keys, r, d, L, D, C, alpha: float, choice, cand,
                        scores, avail=None) -> str:
    """Enqueue K4 (or K4-masked, given the float32 plane ``avail`` [T, N])
    on the current stream of the tensors' device, and return the kernel's
    name; the tensors as :func:`launch_dodoor_fused_sparse` takes them,
    with the dense durations ``d`` [T, N] in place of the per-type
    table."""
    T, N = d.shape
    stream = torch.cuda.current_stream(keys.device).cuda_stream
    plane = [] if avail is None else [avail.data_ptr()]
    name = "dodoor_fused" if avail is None else "dodoor_fused_masked"
    ins = [keys.data_ptr(), r.data_ptr(), d.data_ptr(), *plane,
           L.data_ptr(), D.data_ptr(), C.data_ptr()]
    err = _launcher(name + "_launch")(
        *ins, T, N, float(alpha), choice.data_ptr(), cand.data_ptr(),
        scores.data_ptr(), stream)
    return _raise_on(err, name)


def launch_dodoor_choice(r, cand, d_cand, L, D, C, alpha: float,
                         one_m_alpha: float, choice, scores, tpb: int) -> str:
    """Enqueue K5 on the current stream of the tensors' device, ``tpb``
    tasks a block (:func:`.ops.plan_k5`), and return the kernel's name;
    ``alpha`` and ``one_m_alpha`` are the float32 weights of the duration
    and RL terms."""
    stream = torch.cuda.current_stream(r.device).cuda_stream
    err = _launcher("dodoor_choice_launch")(
        r.data_ptr(), cand.data_ptr(), d_cand.data_ptr(), L.data_ptr(),
        D.data_ptr(), C.data_ptr(), r.shape[0], float(alpha),
        float(one_m_alpha), tpb, choice.data_ptr(), scores.data_ptr(),
        stream)
    return _raise_on(err, "dodoor_choice")
