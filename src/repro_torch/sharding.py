"""Sharding policy: FSDP (data) × TP (model) × EP (experts) × pod-DP — the
port of the JAX package's ``sharding.py``.

The mesh is (pod, data, model) multi-pod or (data, model) single-pod. Rules:

* **Named rules** for the tensors whose parallelism we care about:
  column-parallel in-projections ([d, X] → X on 'model', d on 'data'),
  row-parallel out-projections ([X, d] → X on 'model', d on 'data'),
  expert-parallel MoE banks ([E, ...] → E on 'model', d on 'data'),
  vocab-parallel embeddings when the vocab divides the axis.
* **Generic fallback** for everything else: shard the largest divisible dim
  on 'model', then the largest remaining divisible dim on 'data'. Division
  must be exact — otherwise the dim is replicated (heterogeneous head/vocab
  counts across the 10 archs make a greedy-but-safe default essential).

Optimizer state (Adam m/v) mirrors parameter specs; activations shard batch
on ('pod', 'data'); batch-1 decode shards the longest divisible dim of each
cache tensor on 'data' instead (sequence/state sharding).

The rules read only the mesh's named shape: a ``launch.mesh.Mesh``, a
``DeviceMesh`` with dim names, or anything with a ``shape`` dict.  A spec
is a :class:`PartitionSpec`, a tuple with one entry a tensor dim — None,
an axis name, or a tuple of axis names that shard that dim together —
normalised as JAX's is (a one-name tuple is the name).  ``to_shardings``
turns specs into DTensor placements on a ``DeviceMesh``.  The port's
parameter trees keep the reference's keys and stacked leading axes
(``models/convert.py``), so the rules, which read paths, apply as they
are.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np

# ---------------------------------------------------------------------------
# specs and meshes
# ---------------------------------------------------------------------------


class PartitionSpec(tuple):
    """One entry a tensor dim: None, an axis name, or a tuple of axis names
    (a one-name tuple is stored as the name, as JAX stores it)."""

    def __new__(cls, *parts):
        return super().__new__(cls, tuple(
            p[0] if isinstance(p, tuple) and len(p) == 1 else p
            for p in parts))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def mesh_shape(mesh) -> dict:
    """{axis: size} of a ``launch.mesh.Mesh`` (or anything with a ``shape``
    dict) or of a ``DeviceMesh`` with dim names."""
    shape = getattr(mesh, "shape", None)
    if isinstance(shape, dict):
        return shape
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        raise ValueError(f"{mesh!r}: a mesh needs named axes")
    return dict(zip(names, mesh.mesh.shape))


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def axis_size(mesh, name: str) -> int:
    return mesh_shape(mesh).get(name, 1)


def _divides(dim: int, size: int) -> bool:
    return size > 1 and dim % size == 0 and dim >= size


def _data_axes(mesh):
    """The data-parallel axes, largest composite first: ('pod','data') when a
    pod axis exists."""
    return ("pod", "data") if "pod" in mesh_shape(mesh) else ("data",)


def _data_size(mesh) -> int:
    return int(np.prod([axis_size(mesh, a) for a in _data_axes(mesh)]))


# ---------------------------------------------------------------------------
# parameter rules
# ---------------------------------------------------------------------------

_COL_PAR = ("wq", "wk", "wv", "gate", "up", "w_y", "w_in", "in_proj")
_ROW_PAR = ("wo", "down", "w_out", "out_proj")

#: Layouts (the §Perf levers):
#: * "fsdp"      — baseline: TP on model + FSDP on data (training default).
#: * "inference" — no contracting-dim sharding: weights shard on 'model'
#:                 (+ the non-contracting ff dim of expert banks on 'data'),
#:                 so decode never all-gathers weights; tiny activation
#:                 partial-sum all-reduces instead.
#: * "dp"        — pure data parallel: no model-axis sharding; batch spreads
#:                 over BOTH axes (small models where TP=16 is pure loss).
LAYOUTS = ("fsdp", "inference", "dp")


def _param_spec(path: str, shape, mesh, layout: str = "fsdp") -> P:
    model = axis_size(mesh, "model")
    dsize = _data_size(mesh)
    daxes = _data_axes(mesh)
    leaf = path.split("/")[-1]
    nd = len(shape)
    spec = [None] * nd

    def try_set(dim, axis, size):
        if spec[dim] is None and _divides(shape[dim], size):
            spec[dim] = axis
            return True
        return False

    if nd == 0:
        return P()
    if layout == "dp":
        return P(*spec)                    # replicate everything
    # Expert banks: [E, d, ff] / [E, ff, d] → EP on model.
    if leaf in ("w_gate", "w_up", "w_down") and nd == 3:
        try_set(0, "model", model)
        if layout == "inference":
            # shard the NON-contracting ff dim on data: no weight gather.
            ff_dim = 2 if leaf in ("w_gate", "w_up") else 1
            try_set(ff_dim, daxes, dsize)
        else:
            try_set(1, daxes, dsize)
        return P(*spec)
    if leaf == "embed" and nd == 2:
        try_set(0, "model", model)         # vocab-parallel when divisible
        if layout != "inference":
            try_set(1, daxes, dsize)
        return P(*spec)
    if (leaf in _COL_PAR or leaf == "lm_head") and nd == 2:
        try_set(1, "model", model)
        if layout != "inference":
            try_set(0, daxes, dsize)
        return P(*spec)
    if leaf in _ROW_PAR and nd == 2:
        try_set(0, "model", model)
        if layout != "inference":
            try_set(1, daxes, dsize)
        return P(*spec)
    # Generic fallback: biggest divisible dim → model; next → data.
    order = sorted(range(nd), key=lambda i: -shape[i])
    for i in order:
        if try_set(i, "model", model):
            break
    if layout != "inference":
        for i in order:
            if spec[i] is None and try_set(i, daxes, dsize):
                break
    return P(*spec)


def param_specs(params: Any, mesh, layout: str = "fsdp") -> Any:
    """PartitionSpec tree for a parameter (or Adam-state) tree.

    Stacked-layer leading axes are detected by path ('layers' / 'blocks'
    / ..., a substring of the '/'-joined path, as the reference tests it)
    and kept unsharded (the layer dim)."""

    def one(path_parts, leaf):
        path = "/".join(str(p) for p in path_parts)
        shape = tuple(leaf.shape)
        stacked = any(k in path for k in ("layers", "blocks", "enc_layers",
                                          "dec_layers", "rem"))
        if stacked and len(shape) >= 1:
            inner = _param_spec(path, shape[1:], mesh, layout)
            return P(None, *inner)
        return _param_spec(path, shape, mesh, layout)

    return _path_tree_map(one, params)


def _path_tree_map(fn, tree):
    """``fn(path parts, leaf)`` at every leaf of a tree of dicts, tuples,
    lists and NamedTuples (by field), keeping its structure."""

    def rec(node, parts):
        if isinstance(node, dict):
            return {k: rec(v, parts + (k,)) for k, v in node.items()}
        if hasattr(node, "_fields"):      # NamedTuple
            return type(node)(*[rec(getattr(node, f), parts + (f,))
                                for f in node._fields])
        if isinstance(node, (tuple, list)) and not isinstance(
                node, PartitionSpec):
            seq = [rec(v, parts + (str(i),)) for i, v in enumerate(node)]
            return type(node)(seq)
        return fn(parts, node)

    return rec(tree, ())


# ---------------------------------------------------------------------------
# activation / batch rules
# ---------------------------------------------------------------------------

def batch_specs(batch: Any, mesh, layout: str = "fsdp") -> Any:
    """Training/prefill inputs: batch dim on ('pod','data'); under the "dp"
    layout the batch spreads over BOTH axes (model becomes extra DP)."""
    daxes = _data_axes(mesh)
    dsize = _data_size(mesh)
    model = axis_size(mesh, "model")
    if layout == "dp":
        daxes = tuple(daxes) + ("model",)
        dsize = dsize * model

    def one(parts, leaf):
        shape = tuple(leaf.shape)
        spec = [None] * len(shape)
        if len(shape) >= 1 and _divides(shape[0], dsize):
            spec[0] = daxes
        return P(*spec)

    return _path_tree_map(one, batch)


def cache_specs(cache: Any, mesh, batch_dim: int = 1) -> Any:
    """Decode caches [layers, B, ...]: B on ('pod','data') when divisible;
    otherwise the longest divisible trailing dim goes on 'data' (sequence /
    state sharding for batch-1 long-context). One more dim → 'model'."""
    daxes = _data_axes(mesh)
    dsize = _data_size(mesh)
    model = axis_size(mesh, "model")

    def one(parts, leaf):
        shape = tuple(leaf.shape)
        nd = len(shape)
        spec = [None] * nd
        if nd == 0:
            return P()
        used_data = False
        if nd > batch_dim and _divides(shape[batch_dim], dsize):
            spec[batch_dim] = daxes
            used_data = True
        rest = sorted(range(batch_dim + 1 if used_data else batch_dim, nd),
                      key=lambda i: -shape[i])
        rest = [i for i in rest if spec[i] is None]
        if not used_data:
            for i in rest:
                if _divides(shape[i], dsize):
                    spec[i] = daxes
                    rest = [j for j in rest if j != i]
                    used_data = True
                    break
        for i in rest:
            if spec[i] is None and _divides(shape[i], model):
                spec[i] = "model"
                break
        return P(*spec)

    return _path_tree_map(one, cache)


# ---------------------------------------------------------------------------
# specs → DTensor placements
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class NamedSharding:
    """A spec laid onto a ``DeviceMesh``: one DTensor placement a mesh dim
    (``Shard(dim)`` for the tensor dim whose spec names that axis,
    ``Replicate()`` where none does)."""
    mesh: Any
    placements: tuple


def placements(spec, device_mesh) -> tuple:
    """The DTensor placements of ``spec`` on ``device_mesh``: a composite
    entry ('pod', 'data') shards its tensor dim over both mesh dims (the
    first axis major, as JAX lays it out).  Raises ValueError if the spec
    names an axis the mesh lacks."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(device_mesh.mesh_dim_names or ())
    on = {}
    for dim, entry in enumerate(spec):
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            if axis is None:
                continue
            if axis not in names:
                raise ValueError(f"spec {spec} names axis {axis!r}; the "
                                 f"mesh has {names}")
            on[axis] = dim
    return tuple(Shard(on[a]) if a in on else Replicate() for a in names)


def to_shardings(specs: Any, device_mesh) -> Any:
    """A :class:`NamedSharding` for every spec of ``specs``, on
    ``device_mesh`` (a ``DeviceMesh``, or a ``launch.mesh.Mesh`` whose
    ``device_mesh()`` is taken on the card)."""
    if not hasattr(device_mesh, "mesh_dim_names"):
        device_mesh = device_mesh.device_mesh()
    return _path_tree_map(lambda parts, s: NamedSharding(
        device_mesh, placements(s, device_mesh)), specs)


def leaves_with_paths(tree: Any) -> list:
    """[(path, leaf)] of a tree of dicts, tuples and NamedTuples, the path
    its keys, indices and fields joined by '/'."""
    out = []
    _path_tree_map(lambda parts, x: out.append(
        ("/".join(str(p) for p in parts), x)), tree)
    return out


def bytes_per_device(tree: Any, specs: Any, mesh) -> int:
    """The bytes a device holds of ``tree``'s tensors (meta ones
    included) laid out by ``specs`` on ``mesh``: each tensor's bytes over
    the product of the axis sizes its spec names.  The rules shard only
    dims that divide, so each share is exact."""
    shape = mesh_shape(mesh)
    total = []

    def one(parts, leaf):
        spec = _lookup(specs, parts)
        ways = 1
        for entry in spec:
            for axis in (entry if isinstance(entry, tuple) else (entry,)):
                if axis is not None:
                    ways *= shape[axis]
        total.append(leaf.numel() * leaf.element_size() // ways)
        return None

    _path_tree_map(one, tree)
    return int(sum(total))


def _lookup(tree, parts):
    for p in parts:
        tree = (getattr(tree, p) if hasattr(tree, "_fields")
                else tree[int(p)] if isinstance(tree, (tuple, list))
                else tree[p])
    return tree
