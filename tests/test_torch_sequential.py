"""The port's sequential oracle (``simulate(mode="sequential")``) and the
policies and state containers it rides, against the reference's
``mode="sequential"`` on the CPU: placements, the four-field message
ledger and every timestamp plane bit for bit, for all five policies —
under outages, churn, stragglers and store outages, on task graphs with
locality, with retries (kills and hard-capacity rejection), at ring widths
off 32 and at two (b, flush_every) pairs — and the port's own sequential
oracle against its batched driver.  The smoke size of the message-
reduction point of ``benchmarks/bench_faults.py`` gives the reference's
ledgers."""
import numpy as np
import pytest

from _reference_cache import no_persistent_compile_cache  # noqa: F401

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import repro.core as jcore  # noqa: E402
import repro.sim as jsim  # noqa: E402
from repro.core import cache as jcache  # noqa: E402
from repro.sim import scenarios as jsc  # noqa: E402
from repro.workloads import dags as jdags  # noqa: E402
from repro.workloads import functionbench as jfb  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.sim as tsim  # noqa: E402
from repro_torch.core import cache as tcache  # noqa: E402
from repro_torch.random import PRNGKey  # noqa: E402
from repro_torch.sim import scenarios as tsc  # noqa: E402
from repro_torch.workloads import dags as tdags  # noqa: E402
from repro_torch.workloads import functionbench as tfb  # noqa: E402
from test_engine_batched import assert_parity  # noqa: E402

POLICIES = ("random", "pot", "dodoor", "one_plus_beta", "prequal")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def twl():
    """The port's copies of ``fb_small`` and ``small_testbed``."""
    return tfb.synthesize(m=600, qps=60.0, seed=0), tsim.make_testbed(
        scale=0.2)


def _pair(name, *args, **kw):
    """The same builder from both packages: (reference, port)."""
    return getattr(jsim, name)(*args, **kw), getattr(tsim, name)(*args, **kw)


def _dynamics(kind, n, H):
    if kind == "outages":
        return _pair("random_outages", n, 5, 0.6 * H,
                     mean_down_ms=0.15 * H, seed=7)
    if kind == "churn":
        return _pair("random_churn", n, 0.2, 0.2, H, seed=3)
    if kind == "stragglers":
        return _pair("random_stragglers", n, 5, H, seed=2)
    return (jsim.Dynamics(store_outages=((1000.0, 5000.0),)),
            tsim.Dynamics(store_outages=((1000.0, 5000.0),)))


def _check(ref, got):
    assert got.server.dtype == np.int32
    assert_parity(ref, got, timestamps_exact=True)
    assert np.array_equal(ref.submit_ms, got.submit_ms)
    for f in ("attempts", "failed", "wasted_ms"):
        a, b = getattr(ref, f), getattr(got, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert np.array_equal(a, b), f


def _run(jwl, twl_, jcl, tcl, policy, *, seed=0, jdyn=None, tdyn=None,
         jdag=None, tdag=None, **kw):
    def cfg(pkg):
        k = dict(kw)
        for name in ("retry", "locality"):
            if callable(k.get(name)):
                k[name] = k[name](pkg)
        return pkg.EngineConfig(policy=policy, **k)

    ref = jsim.simulate(jwl, jcl, cfg(jsim), seed, mode="sequential",
                        dynamics=jdyn, dag=jdag)
    got = tsim.simulate(twl_, tcl, cfg(tsim), seed, mode="sequential",
                        device="cpu", dynamics=tdyn, dag=tdag)
    _check(ref, got)
    return got


# --------------------------------------------------- core (Part B 2–4)

def _t(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


# The reference's policies jitted once (as its engine runs them), with the
# parameter tuples static: eager calls would dispatch op by op.
_j_pot_select = jax.jit(jcore.pot_select, static_argnums=4)
_j_prequal_select = jax.jit(jcore.prequal_select, static_argnums=5)
_j_probe_update = jax.jit(jcore.prequal_probe_update, static_argnums=4)


def test_types_and_store_match_reference():
    C = np.random.RandomState(0).rand(7, 2).astype(np.float32) * 64
    js, ts = jcore.make_server_state(C), tcore.make_server_state(
        torch.from_numpy(C))
    for a, b in zip(js, ts):
        assert np.array_equal(np.asarray(a), b.numpy())
        assert np.asarray(a).dtype == b.numpy().dtype
    assert ts.num_servers == js.num_servers == 7
    for a, b in zip(jcore.make_datastore(C),
                    tcore.make_datastore(torch.from_numpy(C))):
        assert np.array_equal(np.asarray(a), b.numpy())
        assert np.asarray(a).dtype == b.numpy().dtype
    for a, b in zip(jcore.make_view(js), tcore.make_view(ts)):
        assert np.array_equal(np.asarray(a), b.numpy())
    for a, b in zip(jcache.store_from_truth(js), tcache.store_from_truth(ts)):
        assert np.array_equal(np.asarray(a), b.numpy())
        assert np.asarray(a).dtype == b.numpy().dtype
    for a, b in zip(jcore.make_prequal_pool(16),
                    tcore.make_prequal_pool(16, device="cpu")):
        assert np.array_equal(np.asarray(a), b.numpy())
        assert np.asarray(a).dtype == b.numpy().dtype
    task = tcore.TaskSpec(*_t(C[:3], C[:3, :1], C[:3, 0], np.arange(3)))
    assert task.num_tasks == 3
    assert tcore.TaskSpec._fields == jcore.TaskSpec._fields
    assert tcore.PrequalPool._fields == jcore.PrequalPool._fields
    assert tcore.ServerState._fields == jcore.ServerState._fields
    assert set(tcore.__all__) == set(jcore.__all__)
    assert set(tcore.POLICIES) == set(jcore.POLICIES)
    assert tcore.POLICY_VIEW == jcore.POLICY_VIEW


def _view(seed, n):
    rng = np.random.RandomState(seed)
    C = (8.0 + rng.rand(n, 2) * 64).astype(np.float32)
    L = (rng.rand(n, 2) * 16).astype(np.float32)
    D = (rng.rand(n) * 900).astype(np.float32)
    rif = rng.randint(0, 4, n).astype(np.float32)   # ties are real
    return (jcore.SchedulerView(*(jax.numpy.asarray(a)
                                  for a in (L, D, rif, C))),
            tcore.SchedulerView(*_t(L, D, rif, C)))


@pytest.mark.parametrize("seed", range(4))
def test_pot_select_matches_reference(seed):
    jv, tv = _view(seed, 23)
    r = np.array([2.0, 900.0], np.float32)
    d = np.random.RandomState(seed).rand(23).astype(np.float32)
    for t in range(30):
        jk = jax.random.fold_in(jax.random.PRNGKey(seed), t)
        tk = tcore.task_key(PRNGKey(seed, device="cpu"), t)
        want = _j_pot_select(jk, r, d, jv, jcore.DodoorParams())
        got = tcore.pot_select(tk, torch.from_numpy(r), torch.from_numpy(d),
                               tv, tcore.DodoorParams())
        assert int(got) == int(want) and got.dtype == torch.int32


def _pools(P=16):
    """An empty pool, a full one with tied RIFs and latencies (first index
    wins), a full one all at +inf latency, and a half-full one."""
    rng = np.random.RandomState(1)
    full = (rng.randint(0, 23, P).astype(np.int32),
            np.repeat(np.float32([3.0, 1.0, 1.0, 5.0]), P // 4),
            np.repeat(np.float32([7.0, 2.0, 2.0, 9.0]), P // 4),
            np.arange(P, dtype=np.float32) % 5, np.ones(P, bool))
    inf_lat = full[:2] + (np.full(P, np.inf, np.float32),) + full[3:]
    half = full[:4] + (np.arange(P) % 2 == 0,)
    empty = tuple(np.asarray(a) for a in jcore.make_prequal_pool(P))
    return {"empty": empty, "full_tied": full, "full_inf_latency": inf_lat,
            "half": half}


@pytest.mark.parametrize("kind", ["empty", "full_tied", "full_inf_latency",
                                  "half"])
def test_prequal_select_and_probe_update_match_reference(kind):
    pool = _pools()[kind]
    jpool = jcore.PrequalPool(*(jax.numpy.asarray(a) for a in pool))
    tpool = tcore.PrequalPool(*_t(*pool))
    jv, tv = _view(5, 23)
    r, d = np.array([1.0, 100.0], np.float32), np.ones(23, np.float32)
    params = jcore.PrequalParams()
    for t in range(6):
        jk = jax.random.fold_in(jax.random.PRNGKey(3), t)
        tk = tcore.task_key(PRNGKey(3, device="cpu"), t)
        js, jpool = _j_prequal_select(jk, r, d, jpool, jv, params)
        ts, tpool = tcore.prequal_select(tk, torch.from_numpy(r),
                                         torch.from_numpy(d), tpool, tv,
                                         tcore.PrequalParams())
        assert int(ts) == int(js)
        now = np.float32(10.0 * t)
        jpool = _j_probe_update(jk, jpool, jv, now, params)
        tpool = tcore.prequal_probe_update(tk, tpool, tv, now,
                                           tcore.PrequalParams())
        for a, b in zip(jpool, tpool):
            assert np.array_equal(np.asarray(a), b.numpy())


# -------------------------------------------------- the sequential oracle

@pytest.mark.parametrize("policy", POLICIES)
def test_matches_reference_sequential(policy, fb_small, small_testbed, twl):
    _run(fb_small, twl[0], small_testbed, twl[1], policy, b=10)


@pytest.mark.parametrize("policy", POLICIES)
def test_matches_reference_under_dynamics(policy, fb_small, small_testbed,
                                          twl):
    """Outages, churn, stragglers and a store outage at once: masked
    draws (and Prequal's pool and probes skipping down servers), gated
    starts, stretched durations and suppressed pushes."""
    H = float(fb_small.submit_ms[-1])
    pairs = [_dynamics(k, 20, H) for k in ("outages", "churn", "stragglers",
                                           "store_outages")]
    jd = pairs[0][0].merge(*(p[0] for p in pairs[1:]))
    td = pairs[0][1].merge(*(p[1] for p in pairs[1:]))
    _run(fb_small, twl[0], small_testbed, twl[1], policy, b=10, jdyn=jd,
         tdyn=td)


@pytest.fixture(scope="module")
def chain_inputs():
    """An 80-task FunctionBench trace, for task graphs' many small
    waves."""
    return (jfb.synthesize(m=80, qps=60.0, seed=1),
            tfb.synthesize(m=80, qps=60.0, seed=1))


def test_chain_dag_with_locality(chain_inputs, small_testbed, twl):
    """Prequal on a chain (dodoor's locality score is held on the
    map-reduce graph below)."""
    spec = dict(edge_delay_ms=2.0, edge_bytes_mb=16.0)
    got = _run(chain_inputs[0], chain_inputs[1], small_testbed, twl[1],
               "prequal", b=10,
               locality=lambda p: p.LocalityModel(gamma=2.0),
               jdag=jdags.ChainDAG(**spec), tdag=tdags.ChainDAG(**spec))
    assert (got.submit_ms[1:] >= got.finish_ms[:-1]).all()


def test_map_reduce_dag_with_locality(chain_inputs, small_testbed, twl):
    """Eight parents a reducer: the locality sum over P = 8 slots."""
    spec = dict(mappers=8, reducers=2, edge_bytes_mb=4.0)
    _run(chain_inputs[0], chain_inputs[1], small_testbed, twl[1], "dodoor",
         b=10, locality=lambda p: p.LocalityModel(gamma=2.0),
         jdag=jdags.MapReduceDAG(**spec), tdag=tdags.MapReduceDAG(**spec))


@pytest.fixture(scope="module")
def smoke_point():
    """``bench_faults.main(smoke=True)``'s message point: m = 600 at 30
    qps on the 20-server testbed, 5 outages (25 %), the default
    RetryPolicy, b = 10, seed 0."""
    jwl = jfb.synthesize(m=600, qps=30.0, seed=0)
    twl_ = tfb.synthesize(m=600, qps=30.0, seed=0)
    H = float(jwl.submit_ms[-1])
    jd, td = _pair("random_outages", 20, 5, 0.6 * H, mean_down_ms=0.15 * H,
                   seed=7)
    return jwl, twl_, jd, td


def test_retries_with_rejection_and_kills(smoke_point, small_testbed, twl):
    """Prequal in two waves on the message point's workload and outages,
    so that the first wave shares the reference's compile with the
    message point below (each further wave length is one more); the
    other policies' retries are held by the message point and by the
    port's own batched driver."""
    jwl, twl_, jd, td = smoke_point
    got = _run(jwl, twl_, small_testbed, twl[1], "prequal", b=10,
               jdyn=jd, tdyn=td,
               retry=lambda p: p.RetryPolicy(max_attempts=2, backoff_ms=50.0,
                                             reject_queue_factor=1.0))
    assert got.attempts.max() > 1 and got.wasted_ms.sum() > 0


@pytest.mark.parametrize("slots", [40, 100])
def test_ring_widths_off_32(slots, fb_small, small_testbed, twl):
    """Prequal's probes sum a ring whose width is no multiple of 32 in the
    reference's padded-window order (the push's sum is the batched
    driver's, held at these widths by test_torch_engine.py)."""
    _run(fb_small, twl[0], small_testbed, twl[1], "prequal", b=10,
         rbuf_slots=slots)


@pytest.mark.parametrize("b,fe", [(7, 1), (50, 3)])
@pytest.mark.parametrize("policy", ["dodoor", "one_plus_beta"])
def test_block_and_flush_pairs(policy, b, fe, fb_small, small_testbed, twl):
    _run(fb_small, twl[0], small_testbed, twl[1], policy, b=b,
         flush_every=fe, alpha=0.3, seed=1)


def test_run_scenario_sequential(small_testbed, twl):
    from repro.workloads import arrivals as jarr
    from repro_torch.workloads import arrivals as tarr

    jwl = jfb.synthesize(m=600, qps=12.0, seed=0)
    twl_ = tfb.synthesize(m=600, qps=12.0, seed=0)
    H = float(jwl.submit_ms[-1])
    js = jsc.Scenario("outage_storm", arrivals=jarr.PoissonArrivals(12.0),
                      dynamics=jsc.random_outages(20, 4, 0.6 * H,
                                                  mean_down_ms=0.2 * H,
                                                  seed=7))
    ts = tsc.Scenario("outage_storm", arrivals=tarr.PoissonArrivals(12.0),
                      dynamics=tsc.random_outages(20, 4, 0.6 * H,
                                                  mean_down_ms=0.2 * H,
                                                  seed=7))
    cfg = dict(policy="prequal", b=10)
    ref = jsc.run_scenario(jwl, small_testbed, js, jsim.EngineConfig(**cfg),
                           seed=2, mode="sequential")
    got = tsc.run_scenario(twl_, twl[1], ts, tsim.EngineConfig(**cfg),
                           seed=2, mode="sequential", device="cpu")
    _check(ref, got)


@pytest.mark.parametrize("policy", POLICIES)
def test_port_sequential_equals_port_batched(policy, twl):
    """The port's two drivers hold each other, as the reference's do,
    under outages with retries."""
    wl, cl = twl
    dyn = tsim.random_outages(20, 5, 0.6 * float(wl.submit_ms[-1]),
                              mean_down_ms=3000.0, seed=7)
    cfg = tsim.EngineConfig(policy=policy, b=10, retry=tsim.RetryPolicy())
    seq = tsim.simulate(wl, cl, cfg, mode="sequential", device="cpu",
                        dynamics=dyn)
    bat = tsim.simulate(wl, cl, cfg, mode="batched", device="cpu",
                        dynamics=dyn)
    _check(bat, seq)


def _ref_seq_wave(wl, cluster, cfg, sl, carry0=None):
    """The reference's sequential scan over the tasks ``sl`` as one wave
    (wave-local index, global task ids), from ``carry0`` (None: the t=0
    carry, passed in so that both waves share one compile)."""
    from repro.sim import engine as jeng

    n = cluster.num_servers
    C, nt, cores_per, mem_unit = jeng._cluster_arrays(cluster, cfg.mem_units)
    if carry0 is None:
        carry0 = jeng._init_carry(jeng._static_cfg(cfg), n, cores_per, False)
    ids = np.arange(sl.start, sl.stop, dtype=np.int32)
    xs = (np.arange(ids.shape[0], dtype=np.int32),
          *(np.asarray(getattr(wl, f))[sl] for f in
            ("r_submit", "r_exec", "d_est", "d_act", "submit_ms")), ids)
    return jeng._simulate_jax(
        tuple(jax.numpy.asarray(x) for x in xs), C, nt, mem_unit, cores_per,
        jeng._make_dyn(cfg), jeng._make_dyn_ints(cfg),
        jeng._lower_dynamics(None, n), jeng._static_cfg(cfg), n,
        cluster.num_types, 0, carry0=carry0, return_carry=True)


def _port_seq_wave(wl, cluster, cfg, sl, carry0=None):
    from repro_torch.sim import engine as teng

    ctx = teng._make_ctx(cluster, cfg, 0, "cpu")
    host = {f: np.asarray(getattr(wl, f))[sl] for f in teng._TASK_FIELDS}
    host.update(submit=np.asarray(wl.submit_ms, np.float32)[sl],
                task_id=np.arange(sl.start, sl.stop, dtype=np.int32))
    return teng._seq_wave(ctx, carry0, host, "cpu")


@pytest.mark.parametrize("policy", ["dodoor", "prequal"])
def test_carry_handed_across_mid_run(policy, fb_small, small_testbed, twl):
    """A run split into two sequential waves of 300 tasks.  After the
    first, the port's carry equals the reference's leaf for leaf, the
    unit rows as the reference's sorted ascending (the port's layout in
    both modes, see ``_Carry``).  The second wave, from the port's own
    carry and from the reference's carry through ``carry_from_numpy``,
    gives the reference's second wave; for dodoor the port's batched
    driver continues the port's sequential carry to the same result."""
    from repro_torch.sim import engine as teng

    jcfg = jsim.EngineConfig(policy=policy, b=10)
    tcfg = tsim.EngineConfig(policy=policy, b=10)
    first, second = slice(0, 300), slice(300, 600)
    j_carry, _ = _ref_seq_wave(fb_small, small_testbed, jcfg, first)
    _, j_outs = _ref_seq_wave(fb_small, small_testbed, jcfg, second, j_carry)
    leaves = {f: np.asarray(v) for f, v in j_carry._asdict().items()
              if v is not None}
    t_carry, _, _ = _port_seq_wave(twl[0], twl[1], tcfg, first)
    mine = tsim.carry_to_numpy(t_carry)
    assert set(mine) == set(leaves)
    for f, v in leaves.items():
        if f in ("core_free", "mem_free"):
            assert np.array_equal(mine[f], np.sort(mine[f], axis=-1)), f
            v = np.sort(v, axis=-1)
        assert mine[f].dtype == v.dtype and np.array_equal(mine[f], v), f

    want = [np.asarray(o) for o in j_outs[:7]]
    # A sequential wave updates its carry's planes in place: each
    # continuation starts from a copy.
    starts = [t_carry, tsim.carry_from_numpy(leaves, device="cpu")]
    for carry0 in starts:
        carry0 = type(carry0)(*(None if v is None else v.clone()
                                for v in carry0))
        _, j, outs = _port_seq_wave(twl[0], twl[1], tcfg, second, carry0)
        assert np.array_equal(j, want[0])
        for row in range(6):
            assert np.array_equal(outs[row], want[row + 1]), row
    if policy == "dodoor":
        ctx = teng._make_ctx(twl[1], tcfg, 0, "cpu")
        planes = teng._task_planes(twl[0], "cpu")
        idx = np.arange(300, 600)
        xs = teng._wave_inputs(planes, idx,
                               np.asarray(twl[0].submit_ms, np.float32)[idx],
                               idx.astype(np.int32), 10, "cpu")
        _, j, outs = teng._run_wave(xs, ctx, t_carry, 300)
        assert np.array_equal(j, want[0])
        for row in range(6):
            assert np.array_equal(outs[row], want[row + 1]), row


@pytest.mark.parametrize("policy", ["dodoor", "pot", "prequal"])
def test_message_point_smoke(policy, smoke_point, small_testbed, twl):
    jwl, twl_, jd, td = smoke_point
    _run(jwl, twl_, small_testbed, twl[1], policy, b=10, jdyn=jd, tdyn=td,
         retry=lambda p: p.RetryPolicy())


def test_unknown_mode_and_policy_rejected(twl):
    wl, cl = twl
    with pytest.raises(ValueError, match="mode"):
        tsim.simulate(wl, cl, tsim.EngineConfig(), mode="warp", device="cpu")
    with pytest.raises(ValueError, match="policy"):
        tsim.simulate(wl, cl, tsim.EngineConfig(policy="nope"),
                      mode="sequential", device="cpu")


@pytest.mark.gpu
@pytest.mark.parametrize("policy", ["pot", "prequal"])
def test_cuda_sequential_matches_cpu(policy, twl):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    wl, cl = twl
    cfg = tsim.EngineConfig(policy=policy, b=10)
    gpu = tsim.simulate(wl, cl, cfg, mode="sequential", device="cuda")
    cpu = tsim.simulate(wl, cl, cfg, mode="sequential", device="cpu")
    _check(cpu, gpu)
