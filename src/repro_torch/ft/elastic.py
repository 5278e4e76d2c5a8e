"""Elastic re-meshing: rebuild a smaller mesh after host failures and
reshard the training state onto it — the port of the JAX package's
``ft/elastic.py``.

Policy: failures remove whole data-parallel slices (a host owns a
contiguous block of one DP slice). The survivor mesh keeps the model axis
intact and shrinks the data axis to the largest power-of-two ≤ survivors;
the global batch either shrinks with it (throughput degrades, semantics
identical) or per-device batch grows (configurable). Resharding lays each
tensor onto the survivor mesh's DTensor placements (``distribute_tensor``,
or ``redistribute`` for a DTensor already on that mesh); the checkpoint
stores logical shapes, so a cold restore onto the survivor mesh works the
same way (``repro_torch.checkpoint``).
"""
from __future__ import annotations

from .. import sharding as shd
from ..launch.mesh import make_mesh


def survivor_mesh(failed_data_slices: int, *, data: int = 16,
                  model: int = 16, pods: int = 0):
    """(mesh, new data size) after losing ``failed_data_slices`` of the data
    axis; the mesh is a ``launch.mesh.Mesh`` (its ``device_mesh()`` is the
    ``DeviceMesh`` once a process group of its size exists).  Raises
    RuntimeError when no slice is left."""
    alive = data - failed_data_slices
    if alive < 1:
        raise RuntimeError("no data-parallel slices left")
    # largest power of two ≤ alive keeps collectives ring-friendly
    new_data = 1 << (alive.bit_length() - 1)
    if pods:
        return make_mesh((pods, new_data, model),
                         ("pod", "data", "model")), new_data
    return make_mesh((new_data, model), ("data", "model")), new_data


def reshard(tree, new_mesh, spec_fn=None):
    """Reshard a tree of tensors or DTensors (params, opt state or cache)
    onto ``new_mesh`` — a ``DeviceMesh``, or a ``launch.mesh.Mesh`` whose
    ``DeviceMesh`` is made on the device type of the tree's tensors — by
    ``spec_fn(tree, mesh)``'s specs (``sharding.param_specs`` by
    default).  Returns the tree of DTensors."""
    import torch
    from torch.distributed.tensor import DTensor, distribute_tensor

    spec_fn = spec_fn or shd.param_specs
    specs = spec_fn(tree, new_mesh)
    if not hasattr(new_mesh, "mesh_dim_names"):
        dev = next((x.device for _, x in shd.leaves_with_paths(tree)
                    if isinstance(x, torch.Tensor)), None)
        new_mesh = new_mesh.device_mesh(None if dev is None else dev.type)
    shardings = shd.to_shardings(specs, new_mesh)

    def move(parts, x):
        s = shd._lookup(shardings, parts)
        if isinstance(x, DTensor):
            if x.device_mesh == s.mesh:
                return x.redistribute(s.mesh, s.placements)
            x = x.full_tensor()
        return distribute_tensor(x, s.mesh, s.placements)

    return shd._path_tree_map(move, tree)
