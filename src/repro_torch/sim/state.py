"""Carry the simulator's state across between the JAX reference and the
port.

A scheduler has no weights: its state is the batched driver's carry (the
per-server unit clocks, ring buffers, cached views, unflushed deltas and
the message ledger).  :func:`carry_from_numpy` turns the reference's
``_Carry`` leaves, as numpy arrays keyed by field name, into the port's
:class:`~repro_torch.sim.engine._Carry`; :func:`carry_to_numpy` does the
reverse.  With them both packages can continue one run from the same
state.

Shapes pass through as they are: under cache faults the views are per
scheduler (``view_L`` [S, n, 2], ``view_D`` and ``view_rif`` [S, n])
instead of one shared ``[n, ...]`` view, and a traced carry holds
``push_at`` [S]; the run that continues the carry must be configured
alike (the same ``Dynamics.cache_faults`` and ``trace``).
"""
from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from .engine import _Carry


def carry_from_numpy(leaves: dict, device=None) -> _Carry:
    """``{field: ndarray}`` → :class:`_Carry` on ``device`` (default: the
    GPU, as for every entry point of the port; pass ``device="cpu"`` to
    keep it on the host).  Every field of ``_Carry`` except the optional
    ``push_at`` must be present; dtypes are kept (float32, int32, bool).
    The rows of ``core_free`` and ``mem_free`` are sorted ascending, the
    port's layout in both modes (the reference's sequential carry holds
    the same values unsorted; a commit reads only their multiset)."""
    missing = [f for f in _Carry._fields
               if f != "push_at" and f not in leaves]
    if missing:
        raise KeyError(f"carry leaves missing: {missing}")
    device = resolve_device(device)
    vals = {}
    for f in _Carry._fields:
        a = leaves.get(f)
        if a is not None and f in ("core_free", "mem_free"):
            a = np.sort(a, axis=-1)
        vals[f] = (None if a is None else
                   torch.from_numpy(np.array(a, copy=True)).to(device))
    return _Carry(**vals)


def carry_to_numpy(carry: _Carry) -> dict:
    """:class:`_Carry` → ``{field: ndarray}`` (``push_at`` omitted when
    absent), the form :func:`carry_from_numpy` takes."""
    return {f: v.detach().cpu().numpy()
            for f, v in carry._asdict().items() if v is not None}
