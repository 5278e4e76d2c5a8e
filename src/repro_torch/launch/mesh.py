"""Meshes and the H100's peak rates — the port of the JAX package's
``launch/mesh.py``.

A mesh comes in two forms.  :class:`Mesh` is a named shape (``.shape``,
a dict from axis name to size, in order): what the sharding rules
(``repro_torch.sharding``) and the dry-run read, with no device and no
process group, so that a 256-card mesh is described on any host.
:meth:`Mesh.device_mesh` makes the ``torch.distributed`` ``DeviceMesh`` of
that shape when a process group of that size exists.

The constants are the roofline's targets: one NVIDIA H100 SXM 80GB HBM3
at its 700 W limit, dense rates from NVIDIA's H100 Tensor Core GPU data
sheet (SXM column; the sparse figures are twice these).
"""
from __future__ import annotations

from math import prod

from .._device import resolve_device

#: HBM3 bandwidth, bytes/s (data sheet: 3.35 TB/s).
HBM_BW = 3.35e12
#: Dense peaks, op/s: FP32 on the CUDA cores, TF32 and BF16 on the tensor
#: cores (data sheet: 67, 495 and 989 TFLOPS without sparsity).
PEAK_FLOPS_FP32 = 67e12
PEAK_FLOPS_TF32 = 495e12
PEAK_FLOPS_BF16 = 989e12
#: One card's inter-node link, bytes/s a direction: one 400 Gb/s NDR
#: InfiniBand port a GPU (ConnectX-7, as in a DGX H100).  The production
#: mesh's every axis (16 cards) spans more than the 8 cards of one NVLink
#: domain (NVLink 4: 450 GB/s a direction), so a ring collective over
#: either axis crosses nodes and runs at this rate.
LINK_BW = 50e9


class Mesh:
    """A named mesh shape: ``shape`` ({axis: size}, in axis order),
    ``axis_names``, ``size``."""

    def __init__(self, shape, axes):
        shape, axes = tuple(int(s) for s in shape), tuple(axes)
        if len(shape) != len(axes) or len(set(axes)) != len(axes):
            raise ValueError(f"mesh: shape {shape} and axes {axes} do not "
                             f"pair up")
        self.axis_names = axes
        self.shape = dict(zip(axes, shape))

    @property
    def size(self) -> int:
        return prod(self.shape.values())

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"

    def device_mesh(self, device_type=None):
        """The ``DeviceMesh`` of this shape over the default process group,
        on ``device_type`` (the card unless the caller asks for the CPU).
        Raises RuntimeError unless a process group of ``size`` ranks is
        initialised."""
        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh

        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError(f"{self!r}: no process group is initialised")
        if dist.get_world_size() != self.size:
            raise RuntimeError(f"{self!r}: the process group has "
                               f"{dist.get_world_size()} ranks, the mesh "
                               f"{self.size}")
        return init_device_mesh(resolve_device(device_type).type,
                                tuple(self.shape.values()),
                                mesh_dim_names=self.axis_names)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16×16 = 256 cards; 2 pods = 512 cards multi-pod."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes)


def make_mesh(shape, axes) -> Mesh:
    """Arbitrary meshes for elastic re-sharding (fault tolerance)."""
    return Mesh(shape, axes)
