"""The port's sharding rules (``repro_torch.sharding``), meshes
(``launch.mesh``) and elastic re-meshing (``ft.elastic``) against the JAX
package's on the CPU, and the specs laid onto a ``DeviceMesh`` of a
world-1 gloo process group.

Tolerance: exact everywhere.  ``param_specs``, ``batch_specs`` and
``cache_specs`` equal the reference's PartitionSpecs, as tuples, for
every arch, layout and mesh shape; tensors resharded onto the survivor
mesh come back bit for bit.

The reference's ``survivor_mesh`` builds a ``jax.make_mesh`` and JAX has
one CPU device here, so only its one-slice cases and its raise are held
against it; the power-of-two arithmetic is held to a table.  Every test
that needs a process group takes the module's ``world1`` fixture, which
destroys the group when the module ends, so no other test sees it."""
import functools
import os

import numpy as np
import pytest

from _reference_cache import no_persistent_compile_cache  # noqa: F401

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro import sharding as jshd  # noqa: E402
from repro.ft import elastic as jelastic  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro_torch import sharding as shd  # noqa: E402
from repro_torch.ft import reshard, survivor_mesh  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.train import abstract_train_state  # noqa: E402

ARCHS = sorted(tconfigs.ARCHS)
#: The mesh shapes: one card, the production pod, two pods, and a shape
#: that divides few dims (12 × 6).
MESHES = {"1x1": {"data": 1, "model": 1},
          "16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "12x6": {"data": 12, "model": 6}}
#: survivor_mesh's new data size after losing ``failed`` of 16 slices:
#: the largest power of two ≤ 16 − failed.
SURVIVORS = {0: 16, 1: 8, 2: 8, 3: 8, 4: 8, 5: 8, 6: 8, 7: 8, 8: 8,
             9: 4, 10: 4, 11: 4, 12: 4, 13: 2, 14: 2, 15: 1}


class FakeMesh:
    """A named shape, as the reference's own tests pass its rules."""

    def __init__(self, shape):
        self.shape = dict(shape)


def _ref_mesh(name):
    return FakeMesh(MESHES[name])


def _port_mesh(name):
    shape = MESHES[name]
    return tmesh.make_mesh(tuple(shape.values()), tuple(shape))


def _jspecs(tree) -> list:
    """(path, spec as a tuple) of a reference spec tree."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return sorted((jax.tree_util.keystr(p), tuple(s)) for p, s in flat)


def _tspecs(tree, prefix="") -> list:
    """(path, spec) of a port spec tree, in the reference's key notation;
    every spec a PartitionSpec."""
    if isinstance(tree, dict):
        return sorted(x for k in tree
                      for x in _tspecs(tree[k], f"{prefix}[{k!r}]"))
    if hasattr(tree, "_fields"):
        return sorted(x for f in tree._fields
                      for x in _tspecs(getattr(tree, f), f"{prefix}.{f}"))
    if isinstance(tree, tuple) and not isinstance(tree, shd.PartitionSpec):
        return sorted(x for i, v in enumerate(tree)
                      for x in _tspecs(v, f"{prefix}[{i}]"))
    assert isinstance(tree, shd.PartitionSpec), (prefix, type(tree))
    return [(prefix, tuple(tree))]


@functools.lru_cache(maxsize=None)
def _trees(name):
    """(port, reference) abstract params of an arch."""
    return (registry.abstract_params(tconfigs.ARCHS[name]),
            jregistry.abstract_params(jconfigs.ARCHS[name]))


def test_partition_spec_normalises_as_jax():
    for parts in [(), (None,), (("data",), None, "model"),
                  (("pod", "data"), ("model",)), ("data", ("pod", "data"))]:
        assert tuple(shd.P(*parts)) == tuple(jax.sharding.PartitionSpec(
            *parts))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("layout", shd.LAYOUTS)
@pytest.mark.parametrize("name", ARCHS)
def test_param_specs(name, layout, mesh):
    tp, jp = _trees(name)
    got = shd.param_specs(tp, _port_mesh(mesh), layout)
    want = jshd.param_specs(jp, _ref_mesh(mesh), layout)
    assert _tspecs(got) == _jspecs(want)


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
@pytest.mark.parametrize("name", ["dbrx-132b", "recurrentgemma-2b"])
def test_opt_state_specs(name, mesh):
    """The AdamW state mirrors the parameters (m and v), the step
    replicated — and ``param_specs`` walks the port's NamedTuple state
    whole."""
    params, opt = abstract_train_state(tconfigs.ARCHS[name])
    _, jopt = jsteps.abstract_train_state(jconfigs.ARCHS[name])
    got = shd.param_specs(opt, _port_mesh(mesh))
    for field in ("m", "v"):
        want = jshd.param_specs(getattr(jopt, field), _ref_mesh(mesh))
        assert _tspecs(getattr(got, field)) == _jspecs(want)
    assert tuple(got.step) == ()


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("layout", shd.LAYOUTS)
@pytest.mark.parametrize("name", ARCHS)
def test_batch_specs(name, layout, mesh):
    """Every cell's batch (train and prefill inputs, the decode token)."""
    tcfg, jcfg = tconfigs.ARCHS[name], jconfigs.ARCHS[name]
    got, want = {}, {}
    for sname, shape in tconfigs.SHAPES.items():
        if shape.kind == "decode":
            tb = {"t": registry.decode_specs(tcfg, shape.global_batch,
                                             16)[1]}
            jb = {"t": jregistry.decode_specs(jcfg, shape.global_batch,
                                              16)[1]}
        else:
            tb = registry.make_inputs(tcfg, shape)
            jb = jregistry.make_inputs(jcfg, jconfigs.SHAPES[sname])
        got[sname] = shd.batch_specs(tb, _port_mesh(mesh), layout)
        want[sname] = jshd.batch_specs(jb, _ref_mesh(mesh), layout)
    assert _tspecs(got) == _jspecs(want)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("name", ARCHS)
def test_cache_specs(name, mesh):
    """Every decode cell's cache (bf16 and int8), at its full shape."""
    tcfg, jcfg = tconfigs.ARCHS[name], jconfigs.ARCHS[name]
    got, want = {}, {}
    for sname, shape in tconfigs.SHAPES.items():
        if shape.kind != "decode":
            continue
        for dt in ("bfloat16", "int8"):
            tc = registry.abstract_cache(tcfg, shape.global_batch,
                                         shape.seq_len,
                                         dtype=getattr(torch, dt))
            jc = jregistry.abstract_cache(jcfg, shape.global_batch,
                                          shape.seq_len,
                                          dtype=getattr(jax.numpy, dt))
            got[f"{sname}_{dt}"] = shd.cache_specs(tc, _port_mesh(mesh))
            want[f"{sname}_{dt}"] = jshd.cache_specs(jc, _ref_mesh(mesh))
    assert _tspecs(got) == _jspecs(want)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh(multi_pod):
    m = tmesh.make_production_mesh(multi_pod=multi_pod)
    want = ({"pod": 2, "data": 16, "model": 16} if multi_pod
            else {"data": 16, "model": 16})
    assert list(m.shape.items()) == list(want.items())
    assert m.size == (512 if multi_pod else 256)
    assert m.axis_names == tuple(want)


def test_h100_constants():
    """The H100 SXM's data-sheet peaks, not the reference's TPU v5e ones."""
    assert (tmesh.HBM_BW, tmesh.PEAK_FLOPS_FP32, tmesh.PEAK_FLOPS_TF32,
            tmesh.PEAK_FLOPS_BF16) == (3.35e12, 67e12, 495e12, 989e12)
    assert tmesh.LINK_BW == 50e9


def test_bytes_per_device_against_reference_specs():
    """Bytes a device holds of dbrx-132b's train state on the pod: the
    port's sum against one over the reference's specs."""
    mesh = "16x16"
    params, opt = abstract_train_state(tconfigs.ARCHS["dbrx-132b"])
    jp = _trees("dbrx-132b")[1]
    jspecs = dict(_jspecs(jshd.param_specs(jp, _ref_mesh(mesh))))
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    want = 0
    for path, leaf in flat:
        ways = 1
        for entry in jspecs[jax.tree_util.keystr(path)]:
            for ax in (entry if isinstance(entry, tuple) else (entry,)):
                ways *= MESHES[mesh].get(ax, 1) if ax else 1
        want += int(np.prod(leaf.shape)) * 4 // ways
    got = shd.bytes_per_device(params, shd.param_specs(params,
                                                       _port_mesh(mesh)),
                               _port_mesh(mesh))
    assert got == want
    opt_bytes = shd.bytes_per_device(
        opt, shd.param_specs(opt, _port_mesh(mesh)), _port_mesh(mesh))
    assert opt_bytes == 2 * want + 4


@pytest.mark.parametrize("failed", sorted(SURVIVORS))
def test_survivor_arithmetic(failed):
    m, new_data = survivor_mesh(failed, data=16, model=16)
    assert new_data == SURVIVORS[failed]
    assert list(m.shape.items()) == [("data", new_data), ("model", 16)]
    m, _ = survivor_mesh(failed, data=16, model=16, pods=2)
    assert list(m.shape.items()) == [("pod", 2), ("data", new_data),
                                     ("model", 16)]


@pytest.mark.parametrize("pods", [0, 1])
def test_survivor_mesh_against_reference(pods):
    m, n = survivor_mesh(0, data=1, model=1, pods=pods)
    jm, jn = jelastic.survivor_mesh(0, data=1, model=1, pods=pods)
    assert n == jn == 1
    assert list(m.shape.items()) == list(dict(jm.shape).items())
    for fn in (survivor_mesh, jelastic.survivor_mesh):
        with pytest.raises(RuntimeError, match="no data-parallel slices"):
            fn(1, data=1, model=1, pods=pods)
    with pytest.raises(RuntimeError, match="no data-parallel slices"):
        survivor_mesh(16, data=16, model=16)


def test_device_mesh_needs_a_group(monkeypatch):
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    with pytest.raises(RuntimeError, match="no process group"):
        tmesh.make_mesh((1, 1), ("data", "model")).device_mesh("cpu")


@pytest.fixture(scope="module")
def world1():
    """A world-1 gloo process group on an in-process store (no address,
    no port), bound to the loopback device; destroyed after the module's
    tests."""
    prev = os.environ.get("GLOO_SOCKET_IFNAME")
    os.environ["GLOO_SOCKET_IFNAME"] = "lo"
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()
        if prev is None:
            os.environ.pop("GLOO_SOCKET_IFNAME", None)
        else:
            os.environ["GLOO_SOCKET_IFNAME"] = prev


def test_placements_on_a_device_mesh(world1):
    """Each spec entry becomes Shard(dim) on the mesh dims it names and
    Replicate() elsewhere; a composite ('pod', 'data') shards one tensor
    dim over both; an axis the mesh lacks raises."""
    from torch.distributed.tensor import Replicate, Shard

    dm = tmesh.make_mesh((1, 1, 1), ("pod", "data", "model")).device_mesh(
        "cpu")
    assert shd.placements(shd.P(("pod", "data"), None, "model"), dm) == (
        Shard(0), Shard(0), Shard(2))
    assert shd.placements(shd.P(None, "data"), dm) == (
        Replicate(), Shard(1), Replicate())
    assert shd.placements(shd.P(), dm) == (Replicate(),) * 3
    dm2 = tmesh.make_mesh((1, 1), ("data", "model")).device_mesh("cpu")
    with pytest.raises(ValueError, match="pod"):
        shd.placements(shd.P(("pod", "data")), dm2)
    # The rules read a DeviceMesh's named shape as they read the Mesh's.
    tp, _ = _trees("dbrx-132b")
    assert _tspecs(shd.param_specs(tp, dm)) == _tspecs(shd.param_specs(
        tp, tmesh.make_mesh((1, 1, 1), ("pod", "data", "model"))))
    assert shd.mesh_shape(dm) == {"pod": 1, "data": 1, "model": 1}
    with pytest.raises(RuntimeError, match="ranks"):
        tmesh.make_mesh((2, 1), ("data", "model")).device_mesh("cpu")


def test_to_shardings_and_reshard(world1):
    """A smoke model's parameters and AdamW state laid onto a (1, 1)
    DeviceMesh by ``to_shardings``, then resharded through
    ``survivor_mesh(0, data=1, model=1)``: the values bit for bit, every
    leaf a DTensor on the survivor mesh."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    from repro_torch.models.common import tree_leaves
    from repro_torch.optim import adamw_init

    cfg = tconfigs.ARCHS["recurrentgemma-2b"].smoke()
    params = registry.init_params(cfg, 0, device="cpu")
    state = {"params": params, "opt": adamw_init(params)}
    mesh = tmesh.make_mesh((1, 1), ("data", "model"))
    dm = mesh.device_mesh("cpu")
    specs = shd.param_specs(state, mesh)
    shardings = shd.to_shardings(specs, dm)
    placed = shd._path_tree_map(
        lambda parts, x: distribute_tensor(
            x, dm, shd._lookup(shardings, parts).placements), state)
    new_mesh, new_data = survivor_mesh(0, data=1, model=1)
    assert new_data == 1
    out = reshard(placed, new_mesh)
    flat_in, flat_out = [], []
    shd._path_tree_map(lambda p, x: flat_in.append(x), state)
    shd._path_tree_map(lambda p, x: flat_out.append(x), out)
    assert len(flat_in) == len(flat_out) == len(tree_leaves(state))
    for a, b in zip(flat_in, flat_out):
        assert isinstance(b, DTensor)
        assert b.device_mesh.mesh_dim_names == ("data", "model")
        full = b.full_tensor()
        assert full.dtype == a.dtype and torch.equal(full, a)
    # Plain tensors reshard too, onto the description's DeviceMesh.
    again = reshard(params, new_mesh)
    assert all(torch.equal(x.full_tensor(), y) for x, y in zip(
        tree_leaves(again), tree_leaves(params)))
