"""What every kernel wrapper of the port shares: the launch counter, the
device dispatch and the operand checks."""
from __future__ import annotations

import functools
from collections import Counter

import torch

#: Kernel launches by kernel name, one per wrapper call that reaches the
#: card; reset it (``LAUNCHES.clear()``) to read one run's launches.
LAUNCHES: Counter = Counter()


def device_of(fn: str, tensors) -> torch.device:
    """The one device of ``tensors``: ``cpu`` (the wrapper then runs the
    plain version) or ``cuda`` (the kernel); raises for anything else and
    for tensors on several devices."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{fn}: tensors on several devices "
                         f"{sorted(map(str, devices))}")
    device = devices.pop()
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn}: unsupported device {device}")
    return device


def check(name, t, dtype, shape) -> None:
    """Raise unless ``t`` has ``dtype``, ``shape`` and is contiguous."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """The number of SMs of CUDA ``device`` (the current device when it
    names no index), which the kernels' planners size their grids by."""
    return _sm_count(device.index if device.index is not None
                     else torch.cuda.current_device())
