"""The port's meta-device sizing (``registry.abstract_params``,
``abstract_cache``, ``train_batch_specs``, ``decode_specs``,
``make_inputs``, ``train.abstract_train_state``) against the JAX
package's ``ShapeDtypeStruct``s on the CPU.

Tolerance: exact everywhere.  Every abstract tree has the reference's
paths, and every leaf its shape and dtype, and lies on the ``meta``
device; ``make_inputs(concrete=True, seed=)`` draws the reference's arrays
value for value (the same ``np.random.RandomState`` draws in the same
order, rounded to the same dtypes)."""
import functools
import resource

import numpy as np
import pytest

from _reference_cache import no_persistent_compile_cache  # noqa: F401

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.configs.shapes import ShapeSpec as JShapeSpec  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro_torch.configs.shapes import ShapeSpec  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.train import abstract_train_state  # noqa: E402

ARCHS = sorted(tconfigs.ARCHS)
#: One arch a family.
FAMILIES = {"dense": "smollm-135m", "moe": "qwen3-moe-235b-a22b",
            "vlm": "qwen2-vl-2b", "ssm": "mamba2-1.3b",
            "hybrid": "recurrentgemma-2b", "audio": "whisper-base"}
#: (B, L) of the cache cases: a short cache, and one past the hybrid's
#: 2 048-token window.
CACHE_SHAPES = [(1, 64), (3, 4100)]
CACHE_DTYPES = [None, "bfloat16", "int8"]
#: The concrete cells, on the smoke configs: (kind, B, L, cache dtype):
#: two shapes a kind, and an int8 cache.
CONCRETE = [("train", 2, 16, None), ("train", 1, 40, None),
            ("prefill", 1, 24, None), ("decode", 2, 8, None),
            ("decode", 1, 20, None), ("decode", 2, 8, "int8")]


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


def _jflat(tree) -> dict:
    """{path: (shape, dtype)} of a reference tree of ShapeDtypeStructs or
    arrays."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        parts = []
        for k in path:
            if isinstance(k, jax.tree_util.DictKey):
                parts.append(str(k.key))
            elif isinstance(k, jax.tree_util.SequenceKey):
                parts.append(str(k.idx))
            else:
                parts.append(str(k.name))
        out["/".join(parts)] = (tuple(leaf.shape), str(leaf.dtype))
    return out


def _tflat(tree, prefix="", out=None) -> dict:
    """{path: (shape, dtype)} of a port tree, and every leaf on meta."""
    out = {} if out is None else out
    if isinstance(tree, dict):
        for k in tree:
            _tflat(tree[k], f"{prefix}{k}/", out)
    elif hasattr(tree, "_fields"):
        for f in tree._fields:
            _tflat(getattr(tree, f), f"{prefix}{f}/", out)
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            _tflat(v, f"{prefix}{i}/", out)
    else:
        assert isinstance(tree, torch.Tensor), (prefix, type(tree))
        out[prefix[:-1]] = (tuple(tree.shape), _dtype_name(tree.dtype),
                            tree.device.type)
    return out


def _same_abstract(got, want) -> None:
    g = _tflat(got)
    assert {k: v[2] for k, v in g.items()} == {k: "meta" for k in g}
    assert {k: v[:2] for k, v in g.items()} == _jflat(want)


@functools.lru_cache(maxsize=None)
def _ref_params(name):
    return jregistry.abstract_params(jconfigs.ARCHS[name])


@pytest.mark.parametrize("name", ARCHS)
def test_abstract_params(name):
    _same_abstract(registry.abstract_params(tconfigs.ARCHS[name]),
                   _ref_params(name))


@pytest.mark.parametrize("name", ARCHS)
def test_abstract_train_state(name):
    params, opt = abstract_train_state(tconfigs.ARCHS[name])
    jparams, jopt = jsteps.abstract_train_state(jconfigs.ARCHS[name])
    _same_abstract(params, jparams)
    _same_abstract({"step": opt.step, "m": opt.m, "v": opt.v},
                   {"step": jopt.step, "m": jopt.m, "v": jopt.v})


@pytest.mark.parametrize("dtype", CACHE_DTYPES)
@pytest.mark.parametrize("B,L", CACHE_SHAPES)
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_abstract_cache(family, B, L, dtype):
    name = FAMILIES[family]
    got = registry.abstract_cache(
        tconfigs.ARCHS[name], B, L,
        dtype=None if dtype is None else getattr(torch, dtype))
    want = jregistry.abstract_cache(
        jconfigs.ARCHS[name], B, L,
        dtype=None if dtype is None else getattr(jnp, dtype))
    _same_abstract(got, want)


@pytest.mark.parametrize("shape", sorted(tconfigs.SHAPES))
@pytest.mark.parametrize("name", ARCHS)
def test_abstract_inputs(name, shape):
    """Every cell's abstract inputs, the decode cells' cache and token
    (``decode_specs``) among them, at the full shapes."""
    got = registry.make_inputs(tconfigs.ARCHS[name], tconfigs.SHAPES[shape])
    want = jregistry.make_inputs(jconfigs.ARCHS[name],
                                 jconfigs.SHAPES[shape])
    _same_abstract(got, want)


def test_int8_decode_specs():
    cfg = tconfigs.ARCHS["tinyllama-1.1b"]
    cache, token = registry.decode_specs(cfg, 4, 128, cache_dtype=torch.int8)
    jcache, jtoken = jregistry.decode_specs(jconfigs.ARCHS["tinyllama-1.1b"],
                                            4, 128, cache_dtype=jnp.int8)
    _same_abstract({"cache": cache, "token": token},
                   {"cache": jcache, "token": jtoken})


def test_full_size_state_allocates_nothing():
    """qwen3-moe-235b-a22b's full train state (≈ 2.8 TB in float32) and a
    32k decode cache, built on meta, move the process's peak resident
    memory by less than 512 MB."""
    before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    cfg = tconfigs.ARCHS["qwen3-moe-235b-a22b"]
    params, opt = abstract_train_state(cfg)
    cache = registry.make_inputs(cfg, tconfigs.SHAPES["decode_32k"])
    leaves = (list(_tflat(params).values()) + list(_tflat(opt).values())
              + list(_tflat(cache).values()))
    assert {dev for _, _, dev in leaves} == {"meta"}
    n = sum(int(np.prod(s)) for s, _, _ in _tflat(params).values())
    assert n > 2.3e11                          # the full model, on meta
    grown = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss - before
    assert grown < 512 * 1024                 # ru_maxrss is in KiB


def _host(x) -> np.ndarray:
    """A port tensor or a reference array as numpy, bf16 widened to
    float32 (exactly)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype == jnp.bfloat16 else x


def _tensors(tree, prefix="", out=None) -> dict:
    """{path: tensor} of a port tree of dicts."""
    out = {} if out is None else out
    if isinstance(tree, dict):
        for k in tree:
            _tensors(tree[k], f"{prefix}{k}/", out)
    else:
        out[prefix[:-1]] = tree
    return out


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("kind,B,L,cache_dtype", CONCRETE)
def test_make_inputs_concrete(family, kind, B, L, cache_dtype):
    name = FAMILIES[family]
    tcfg = tconfigs.ARCHS[name].smoke()
    jcfg = jconfigs.ARCHS[name].smoke()
    seed = 3 + B
    got = _tensors(registry.make_inputs(
        tcfg, ShapeSpec("t", L, B, kind), concrete=True, seed=seed,
        cache_dtype=cache_dtype and getattr(torch, cache_dtype),
        device="cpu"))
    want_tree = jregistry.make_inputs(
        jcfg, JShapeSpec("t", L, B, kind), concrete=True, seed=seed,
        cache_dtype=cache_dtype and getattr(jnp, cache_dtype))
    want = dict(zip(_jflat(want_tree), jax.tree.leaves(want_tree)))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        assert g.device.type == "cpu"
        assert _dtype_name(g.dtype) == str(w.dtype), k
        a, b = _host(g), _host(w)
        assert a.shape == b.shape and np.array_equal(a, b), k


def test_make_inputs_on_the_card_by_default():
    """Without ``device`` the concrete inputs go to the card, and without
    one the call raises rather than fall back to the CPU."""
    cfg = tconfigs.ARCHS["smollm-135m"].smoke()
    shape = ShapeSpec("t", 8, 1, "train")
    if torch.cuda.is_available():
        got = registry.make_inputs(cfg, shape, concrete=True)
        assert got["tokens"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            registry.make_inputs(cfg, shape, concrete=True)
