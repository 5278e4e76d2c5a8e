"""The port's optimizer (``repro_torch.optim``) against the JAX package's
on identical numpy inputs, the reference run as its trainer runs it
(``adamw_update`` under ``jax.jit``).

Bit for bit: AdamW's moments and parameters whenever the global norm does
not clip, int8 compression (q, scales, error feedback) and
decompression.  Two scalars are XLA:CPU's own and are not replayed, so
they are held to a few ulp with the reason:

* the global norm when it clips: ``jnp.sum`` of a multi-dimensional leaf
  runs in 32-wide windows vectorised inside, an order that depends on the
  leaf's shape; one ulp of the norm is one ulp of the clip scale, which
  moves m, v and the parameters by an ulp or two;
* the cosine schedule: XLA:CPU's float32 ``cos`` differs from torch's by
  one ulp on ≈ 5 % of arguments, and near the end of the decay ``1 + cos``
  cancels, so one ulp of ``cos`` becomes up to 6 ulp of the rate."""
import numpy as np
import pytest

from _reference_cache import no_persistent_compile_cache  # noqa: F401

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro import optim as J  # noqa: E402
from repro_torch import optim as T  # noqa: E402
from repro_torch.models.common import (  # noqa: E402
    tree_leaves, tree_map, tree_unflatten)

#: A parameter tree with a stacked matrix, a vector, a 3-d leaf and a
#: tuple, as the models' trees have.
SHAPES = {"w": (64, 128), "b": (37,), "z": {"c": (3, 5, 7)},
          "t": ((4, 40), (9,))}


def _tree(rng, scale, shapes=SHAPES):
    if isinstance(shapes, dict):
        return {k: _tree(rng, scale, v) for k, v in shapes.items()}
    if isinstance(shapes, tuple) and isinstance(shapes[0], tuple):
        return tuple(_tree(rng, scale, s) for s in shapes)
    return (rng.randn(*shapes) * scale).astype(np.float32)


def _jax(t):
    return jax.tree.map(jnp.asarray, t)


def _torch(t):
    if isinstance(t, dict):
        return {k: _torch(v) for k, v in t.items()}
    if isinstance(t, tuple):
        return tuple(_torch(v) for v in t)
    return torch.from_numpy(np.array(t))


def _ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert np.all(np.sign(a) * np.sign(b) >= 0)
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


def _pairs(jtree, ttree):
    jl = [np.asarray(x) for x in jax.tree.leaves(jtree)]
    tl = [x.numpy() for x in tree_leaves(ttree)]
    assert len(jl) == len(tl)
    return list(zip(jl, tl))


def _state(rng):
    p = _tree(rng, 1.0)
    m = _tree(rng, 1e-3)
    v = jax.tree.map(np.abs, _tree(rng, 1e-3))
    return p, m, v


def test_tree_order_is_the_references():
    """``tree_leaves`` walks a tree as ``jax.tree.leaves`` does (dict keys
    sorted), and ``tree_unflatten`` inverts it."""
    t = _tree(np.random.RandomState(0), 1.0)
    for j, tt in _pairs(t, _torch(t)):
        np.testing.assert_array_equal(j, tt)
    back = tree_unflatten(t, tree_leaves(_torch(t)))
    assert list(back) == list(t) and isinstance(back["t"], tuple)


@pytest.mark.parametrize("step", [0, 1, 7, 99])
def test_adamw_matches_reference_bit_for_bit(step):
    """No clipping (global norm < 1): m, v and the parameters bit for
    bit, with the step counter."""
    rng = np.random.RandomState(step)
    p, m, v = _state(rng)
    g = _tree(rng, 1e-3)
    jp, js = jax.jit(lambda g, s, p: J.adamw_update(g, s, p, lr=1e-3))(
        _jax(g), J.AdamWState(jnp.int32(step), _jax(m), _jax(v)), _jax(p))
    tp, ts = T.adamw_update(
        _torch(g), T.AdamWState(torch.tensor(step, dtype=torch.int32),
                                _torch(m), _torch(v)), _torch(p), lr=1e-3)
    assert float(J.adamw.global_norm(_jax(g))) < 1.0
    assert int(ts.step) == int(js.step) == step + 1
    assert ts.step.dtype == torch.int32
    for name, jt, tt in (("m", js.m, ts.m), ("v", js.v, ts.v),
                         ("p", jp, tp)):
        for a, b in _pairs(jt, tt):
            np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("step", [0, 5])
def test_adamw_with_clipping_within_ulps(step):
    """The clip binds (global norm ≫ 1): the norm within 2 ulp (its
    summation order, module docstring), and every value of m, v and the
    parameters within 4 ulp of its leaf's largest magnitude (one ulp of
    the clip scale moves each gradient by an ulp, and ``b1·m + (1−b1)·g``
    may cancel, so an elementwise ulp count means nothing there); most
    values bit for bit."""
    rng = np.random.RandomState(10 + step)
    p, m, v = _state(rng)
    g = _tree(rng, 1.0)
    jp, js = jax.jit(lambda g, s, p: J.adamw_update(g, s, p, lr=1e-3))(
        _jax(g), J.AdamWState(jnp.int32(step), _jax(m), _jax(v)), _jax(p))
    tp, ts = T.adamw_update(
        _torch(g), T.AdamWState(torch.tensor(step, dtype=torch.int32),
                                _torch(m), _torch(v)), _torch(p), lr=1e-3)
    assert float(J.adamw.global_norm(_jax(g))) > 10.0
    gn_j = np.asarray(jax.jit(J.adamw.global_norm)(_jax(g)))
    assert _ulps(gn_j, T.adamw.global_norm(_torch(g)).numpy()) <= 2
    same = total = 0
    for jt, tt in ((js.m, ts.m), (js.v, ts.v), (jp, tp)):
        for a, b in _pairs(jt, tt):
            np.testing.assert_allclose(b, a, rtol=0, atol=2 ** -21 *
                                       float(np.abs(a).max()))
            same += int((a == b).sum())
            total += a.size
    assert same / total > 0.5


def test_adamw_under_the_schedule_matches_reference():
    """A schedule callable as ``lr``, evaluated at the new step inside the
    update: bit for bit at a warmup step (no ``cos``)."""
    rng = np.random.RandomState(3)
    p, m, v = _state(rng)
    g = _tree(rng, 1e-3)
    jl, tl = J.cosine_schedule(1e-3, 5, 100), T.cosine_schedule(1e-3, 5, 100)
    jp, _ = jax.jit(lambda g, s, p: J.adamw_update(g, s, p, lr=jl))(
        _jax(g), J.AdamWState(jnp.int32(2), _jax(m), _jax(v)), _jax(p))
    tp, _ = T.adamw_update(
        _torch(g), T.AdamWState(torch.tensor(2, dtype=torch.int32),
                                _torch(m), _torch(v)), _torch(p), lr=tl)
    for a, b in _pairs(jp, tp):
        np.testing.assert_array_equal(a, b)


def test_adamw_init_matches_reference():
    p = _tree(np.random.RandomState(1), 1.0)
    js, ts = J.adamw_init(_jax(p)), T.adamw_init(_torch(p))
    assert ts.step.dtype == torch.int32 and int(ts.step) == 0
    for jt, tt in ((js.m, ts.m), (js.v, ts.v)):
        for a, b in _pairs(jt, tt):
            np.testing.assert_array_equal(a, b)
    assert ts.m["w"] is not ts.v["w"]


@pytest.mark.parametrize("peak,warmup,total", [(1e-3, 5, 100),
                                               (3e-4, 10, 1000),
                                               (1e-2, 1, 30)])
def test_cosine_schedule_matches_reference(peak, warmup, total):
    """Warmup bit for bit; the decay within 8 ulp (XLA's ``cos``, module
    docstring), past ``total`` at the floor."""
    steps = np.arange(0, total + 20, dtype=np.int32)
    want = np.asarray(jax.jit(jax.vmap(J.cosine_schedule(
        peak, warmup, total)))(steps))
    lr = T.cosine_schedule(peak, warmup, total)
    got = np.array([lr(torch.tensor(s)).item() for s in steps], np.float32)
    got_all = lr(torch.from_numpy(steps)).numpy()
    np.testing.assert_array_equal(got, got_all)
    np.testing.assert_array_equal(got[steps < warmup], want[steps < warmup])
    assert _ulps(got, want).max() <= 8
    assert (got == want).mean() > 0.6


def test_compression_matches_reference_bit_for_bit():
    """q, scales and the error-feedback residual (one fused multiply-add,
    as XLA:CPU contracts it), over two rounds with the error carried; then
    decompression."""
    rng = np.random.RandomState(4)
    e = jax.tree.map(np.zeros_like, _tree(rng, 1.0))
    js, ts = J.CompressionState(_jax(e)), T.CompressionState(_torch(e))
    for rnd in range(2):
        g = _tree(rng, 0.3 * (rnd + 1))
        jq, jsc, js = jax.jit(J.compress_grads)(_jax(g), js)
        tq, tsc, ts = T.compress_grads(_torch(g), ts)
        for jt, tt in ((jq, tq), (jsc, tsc), (js.error, ts.error)):
            for a, b in _pairs(jt, tt):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
        jd = jax.jit(J.decompress_grads)(jq, jsc)
        for a, b in _pairs(jd, T.decompress_grads(tq, tsc)):
            np.testing.assert_array_equal(a, b)


def test_compression_init_and_tree_map():
    g = _torch(_tree(np.random.RandomState(5), 1.0))
    st = T.compression.compression_init(g)
    assert all(float(x.abs().max()) == 0 for x in tree_leaves(st.error))
    doubled = tree_map(lambda a, b: a + b, g, g)
    assert torch.equal(doubled["t"][1], 2 * g["t"][1])
