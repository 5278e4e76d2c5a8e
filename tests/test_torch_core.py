"""The port's inputs and Algorithm-1 core against the JAX reference on the
CPU: clusters and traces array-equal, prefilter/sampling/scoring bit-exact,
the cache helpers, message accounting and metrics equal, and the port's
package free of JAX."""
import os
import subprocess
import sys

import numpy as np
import pytest

from _reference_cache import no_persistent_compile_cache  # noqa: F401

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402
import repro.core.cache as jcache  # noqa: E402
import repro.sim as jsim  # noqa: E402
from repro.workloads import azure as jaz  # noqa: E402
from repro.workloads import functionbench as jfb  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.core.cache as tcache  # noqa: E402
import repro_torch.sim as tsim  # noqa: E402
from repro_torch import _arith  # noqa: E402
from repro_torch import random as trand  # noqa: E402
from repro_torch.workloads import azure as taz  # noqa: E402
from repro_torch.workloads import functionbench as tfb  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(a):
    return torch.from_numpy(np.array(a))          # a writable copy


def _same(a, b):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    return a.shape == b.shape and np.array_equal(a, b)


# ---------------------------------------------------------------- inputs

CLUSTERS = [
    ("make_testbed", dict()), ("make_testbed", dict(scale=0.2)),
    ("make_testbed", dict(scale=2.0, interleave=False)),
    ("make_scaled", dict(n=1000)), ("make_scaled", dict(n=257, het=0.3)),
    ("make_scaled", dict(n=64, capacity_skew=0.5, seed=3)),
    ("make_homogeneous", dict(n=12)),
]


@pytest.mark.parametrize("fn,kw", CLUSTERS)
def test_clusters_array_equal(fn, kw):
    a, b = getattr(jsim, fn)(**kw), getattr(tsim, fn)(**kw)
    assert _same(a.C, b.C) and a.C.dtype == b.C.dtype
    assert _same(a.node_type, b.node_type)
    assert a.type_names == b.type_names
    assert _same(a.type_capacity(), b.type_capacity())
    assert tsim.CMAX == jsim.engine.CMAX


@pytest.mark.parametrize("mod,kw", [
    ("fb", dict(m=600, qps=60.0, seed=0)), ("fb", dict(m=97, qps=5.0, seed=3)),
    ("az", dict(m=400, qps=4.0, seed=0)), ("az", dict(m=53, qps=9.0, seed=2)),
])
def test_workloads_array_equal(mod, kw):
    j, t = ((jfb, tfb) if mod == "fb" else (jaz, taz))
    a, b = j.synthesize(**kw), t.synthesize(**kw)
    for f in ("r_submit", "r_exec", "d_est", "d_act", "task_type",
              "submit_ms"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f


# ------------------------------------------- XLA:CPU arithmetic the port pins

def test_fma_matches_contracted_multiply_add():
    rng = np.random.RandomState(0)
    a, b, c = (rng.rand(4096).astype(np.float32) * s for s in (1, 1e3, 3))
    ref = jax.jit(lambda a, b, c: a + b * c)(a, b, c)
    assert _same(ref, _arith.fma(_t(b), _t(c), _t(a)))


def test_dot_fma_matches_short_contraction():
    rng = np.random.RandomState(1)
    r = rng.rand(2048, 2).astype(np.float32) * 100
    L = rng.rand(2048, 2, 2).astype(np.float32) * 1e5
    ref = jax.jit(lambda r, L: jnp.einsum("tk,tck->tc", r, L))(r, L)
    assert _same(ref, _arith.dot_fma(_t(r)[:, None, :], _t(L)))


@pytest.mark.parametrize("n,w", [(20, 256), (1000, 256), (7, 64), (5, 40),
                                 (9, 33), (4, 96), (3, 512), (6, 65),
                                 (6, 70), (5, 100), (4, 200), (3, 1100),
                                 (2, 5000)])
def test_row_sum_matches_xla_order(n, w):
    rng = np.random.RandomState(n)
    x = (rng.rand(n, w) * 6e5).astype(np.float32)
    x[rng.rand(n, w) < 0.5] = 0.0
    ref = jax.jit(lambda x: jnp.sum(x, axis=-1))(x)
    assert _same(ref, _arith.row_sum(_t(x)))


# ------------------------------------------------------------------ core

def _block(T, N, seed, all_down_rows=()):
    rng = np.random.RandomState(seed)
    C = np.stack([rng.choice([8, 10, 16, 28], N),
                  rng.choice([64e3, 128e3], N)], 1).astype(np.float32)
    r = np.stack([rng.choice([1, 2, 4, 8, 14, 20], T),
                  rng.uniform(1e3, 9e4, T)], 1).astype(np.float32)
    for i in all_down_rows:
        r[i] = (64.0, 1e9)
    L = (rng.rand(N, 2) * C).astype(np.float32)
    D = (rng.rand(N) * 1e5).astype(np.float32)
    keys = rng.randint(0, 2 ** 32, size=(T, 2), dtype=np.uint64)
    return keys.astype(np.uint32), r, C, L, D


def test_feasible_mask_equal():
    _, r, C, _, _ = _block(33, 40, 0)
    assert _same(jcore.feasible_mask(r, C), tcore.feasible_mask(_t(r), _t(C)))
    assert _same(jcore.feasible_mask(r[3], C),
                 tcore.feasible_mask(_t(r[3]), _t(C)))


@pytest.mark.parametrize("T,N,num", [(1, 5, 2), (9, 40, 2), (137, 100, 1),
                                     (64, 300, 3)])
def test_sample_feasible_batch_bit_exact(T, N, num):
    keys, r, C, _, _ = _block(T, N, T + N, all_down_rows=(0,))
    mask = jcore.feasible_mask(r, C)
    ref = jcore.sample_feasible_batch(jnp.asarray(keys), mask, num)
    got = tcore.sample_feasible_batch(_t(keys.astype(np.int64)),
                                      _t(np.asarray(mask)), num)
    assert got.dtype == torch.int32 and _same(ref, got)
    one = tcore.sample_feasible(_t(keys[0].astype(np.int64)),
                                _t(np.asarray(mask[0])), num)
    assert _same(jcore.sample_feasible(jnp.asarray(keys[0]), mask[0], num),
                 one)


@pytest.mark.parametrize("alpha", [0.5, 0.3, 0.85])
def test_load_score_batched_bit_exact(alpha):
    rng = np.random.RandomState(int(alpha * 100))
    T = 4096
    r = (rng.rand(T, 2) * 100).astype(np.float32)
    L = (rng.rand(T, 2, 2) * 1e5).astype(np.float32)
    D = (rng.rand(T, 2) * 1e5).astype(np.float32)
    C = (rng.rand(T, 2, 2) * 100 + 1).astype(np.float32)
    L[:64] = 0.0                                   # idle pairs: 0.5 fallback
    D[:32] = 0.0
    D[64:96] = 0.0
    ref = jax.jit(jcore.load_score_batched)(r, L, D, C, jnp.float32(alpha))
    got = tcore.load_score_batched(_t(r), _t(L), _t(D), _t(C), alpha)
    assert _same(ref, got)


def test_load_score_pair_and_rl_bit_exact():
    """Over a batch of pairs (the reference vmapped)."""
    rng = np.random.RandomState(5)
    T = 4096
    r = (rng.rand(T, 2) * 10).astype(np.float32)
    La, Lb = ((rng.rand(T, 2) * 1e4).astype(np.float32) for _ in range(2))
    Da, Db = ((rng.rand(T) * 3e4).astype(np.float32) for _ in range(2))
    Ca, Cb = ((rng.rand(T, 2) * 30 + 1).astype(np.float32) for _ in range(2))
    La[:50] = 0.0
    Lb[:50] = 0.0
    args = (r, La, Lb, Da, Db, Ca, Cb)
    pair = jax.vmap(jcore.load_score_pair, in_axes=(0,) * 7 + (None,))
    ref = jax.jit(pair)(*args, jnp.float32(0.3))
    got = tcore.load_score_pair(*(_t(a) for a in args), 0.3)
    assert _same(ref[0], got[0]) and _same(ref[1], got[1])
    assert _same(jax.jit(jax.vmap(jcore.rl))(r, La, Ca),
                 tcore.rl(_t(r), _t(La), _t(Ca)))


def _views(L, D, C):
    jv = jcore.SchedulerView(L=jnp.asarray(L), D=jnp.asarray(D),
                             rif=jnp.zeros(D.shape), C=jnp.asarray(C))
    tv = tcore.SchedulerView(L=_t(L), D=_t(D), rif=torch.zeros(D.shape),
                             C=_t(C))
    return jv, tv


def test_dodoor_choice_batch_bit_exact():
    keys, r, C, L, D = _block(137, 60, 11, all_down_rows=(3,))
    cand = np.asarray(jcore.sample_feasible_batch(
        jnp.asarray(keys), jcore.feasible_mask(r, C), 2))
    d_cand = (np.random.RandomState(2).rand(137, 2) * 1e4).astype(np.float32)
    jv, tv = _views(L, D, C)
    ref = jax.jit(lambda *a: jcore.dodoor_choice_batch(*a, jv, jnp.float32(
        0.5)))(r, cand, d_cand)
    got = tcore.dodoor_choice_batch(_t(r), _t(cand), _t(d_cand), tv, 0.5)
    assert got.dtype == torch.int32 and _same(ref, got)


@pytest.mark.parametrize("task", [0, 17, 4242])
def test_per_task_policies_bit_exact(task):
    _, r, C, L, D = _block(4, 50, task)
    d = (np.random.RandomState(task).rand(50) * 1e4).astype(np.float32)
    jv, tv = _views(L, D, C)
    jkey = jcore.task_key(jax.random.PRNGKey(3), task)
    tkey = tcore.task_key(trand.PRNGKey(3, device="cpu"), task)
    assert np.array_equal(np.asarray(jkey).astype(np.int64), tkey.numpy())
    params = jcore.DodoorParams()
    tparams = tcore.DodoorParams()
    for name in ("random_select", "dodoor_select", "one_plus_beta_select"):
        ref = getattr(jcore, name)(jkey, r[1], d, jv, params)
        got = getattr(tcore, name)(tkey, _t(r[1]), _t(d), tv, tparams)
        assert int(ref) == int(got), name


def test_cache_helpers_match():
    n = 6
    st_j = jcore.make_datastore(jnp.ones((n, 2)))
    st_t = tcore.DataStoreState(L=torch.zeros(n, 2), D=torch.zeros(n),
                                rif=torch.zeros(n),
                                p=torch.zeros((), dtype=torch.int32))
    r = np.array([2.0, 300.0], np.float32)
    st_j = jcache.add_new_load(st_j, 3, r, 40.0)
    st_t = tcache.add_new_load(st_t, 3, _t(r), 40.0)
    st_j = jcache.override_node_state(st_j, 1, r * 2, 7.0, 2.0)
    st_t = tcache.override_node_state(st_t, 1, _t(r * 2), 7.0, 2.0)
    for f in ("L", "D", "rif"):
        assert _same(getattr(st_j, f), getattr(st_t, f)), f
    pushes_j, pushes_t = [], []
    for _ in range(7):
        st_j, pj = jcache.tick(st_j, 3)
        st_t, pt = tcache.tick(st_t, 3)
        pushes_j.append(bool(pj))
        pushes_t.append(bool(pt))
    assert pushes_j == pushes_t and int(st_j.p) == int(st_t.p)
    C = torch.ones(n, 2)
    view = tcache.push_if(torch.tensor(True), st_t,
                          tcore.SchedulerView(L=torch.zeros(n, 2),
                                              D=torch.zeros(n),
                                              rif=torch.zeros(n), C=C))
    assert torch.equal(view.L, tcache.snapshot(st_t, C).L)
    for b, s in ((100, 5), (1, 5), (7, 2), (50, 0)):
        assert tcache.scheduler_minibatch(b, s) == jcache.scheduler_minibatch(
            b, s)
    for n_srv in (1, 2, 100, 10_001):
        assert (tcache.default_batch_size(n_srv)
                == jcache.default_batch_size(n_srv))


@pytest.mark.parametrize("policy", ["random", "pot", "prequal", "dodoor",
                                    "one_plus_beta"])
def test_message_accounting_equal(policy):
    for kw in (dict(), dict(b=7, num_schedulers=3, flush_every=1),
               dict(b=500, attempts=1.5)):
        assert (tsim.expected_messages_per_task(policy, **kw)
                == jsim.expected_messages_per_task(policy, **kw))
    assert (tsim.per_decision_messages(policy)
            == jsim.per_decision_messages(policy))
    assert (tsim.cache_messages_per_decision(50, 5, 2)
            == jsim.cache_messages_per_decision(50, 5, 2))


def test_summary_and_violations_equal(fb_small, small_testbed, sim_cache):
    """The port's metrics on the reference's own result arrays."""
    cfg = jsim.EngineConfig(policy="dodoor", b=10)
    res = sim_cache(fb_small, small_testbed, cfg, mode="batched",
                    key="fb_small")
    tres = tsim.SimResult(**{f: getattr(res, f)
                             for f in tsim.SimResult._fields})
    assert jsim.summarize(res) == tsim.summarize(tres)
    tcl = tsim.make_testbed(scale=0.2)
    assert (jsim.resource_violations(res, small_testbed)
            == tsim.resource_violations(tres, tcl) == 0)


def test_port_imports_no_jax():
    """``repro_torch`` and all its modules load without JAX or ``repro``."""
    code = (
        "import sys, pkgutil, importlib, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib',"
        " 'repro')]\n"
        "print(len(bad), bad[:5])\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
