"""The port's scenario engine against the JAX reference on the CPU: the
dynamics lowering and its validation, the timeline generators, the arrival
processes, the windowed metrics, and ``simulate(..., dynamics=...)`` /
``run_scenario`` bit-exact against the reference's two-stage batched
driver (``use_kernel=False``) for random, dodoor and (1+β)."""
import warnings

import numpy as np
import pytest

from _reference_cache import no_persistent_compile_cache  # noqa: F401

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import repro.sim as jsim  # noqa: E402
from repro.sim import engine as jeng  # noqa: E402
from repro.sim import metrics as jmet  # noqa: E402
from repro.sim import scenarios as jsc  # noqa: E402
from repro.workloads import arrivals as jarr  # noqa: E402
from repro.workloads import functionbench as jfb  # noqa: E402
import repro_torch.sim as tsim  # noqa: E402
from repro_torch.sim import engine as teng  # noqa: E402
from repro_torch.sim import scenarios as tsc  # noqa: E402
from repro_torch.workloads import arrivals as tarr  # noqa: E402
from repro_torch.workloads import functionbench as tfb  # noqa: E402
from test_engine_batched import assert_parity  # noqa: E402

POLICIES = ("random", "dodoor", "one_plus_beta")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU runs are many tiny ops; a thread pool only adds
    overhead to them (and contends with the other test workers)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def inputs():
    jwl = jfb.synthesize(m=600, qps=60.0, seed=0)
    return dict(jwl=jwl, twl=tfb.synthesize(m=600, qps=60.0, seed=0),
                jtb=jsim.make_testbed(scale=0.2),
                ttb=tsim.make_testbed(scale=0.2),
                H=float(jwl.submit_ms[-1]))


def _to_torch(d: jeng.Dynamics) -> teng.Dynamics:
    cf = d.cache_faults
    return teng.Dynamics(**{**d._asdict(), "cache_faults": (
        None if cf is None else teng.CacheFaults(*cf))})


def _maintenance(pkg, n: int, H: float):
    """Rolling restart of every 10th server, 20 stragglers and a store
    outage: the start gate, the stretch and push suppression at once."""
    return pkg.rolling_restart(n, 0.05 * H, 0.08 * H, stride=10).merge(
        pkg.random_stragglers(n, max(2, n // 5), H, mean_slow_ms=0.1 * H,
                              mult=4.0),
        pkg.Dynamics(store_outages=((0.3 * H, 0.4 * H),)))


def _scenario(name: str, n: int, H: float):
    """A reference Dynamics spec by name (the port's is ``_to_torch``)."""
    if name == "outages":
        return jsc.random_outages(n, 6, 0.6 * H, mean_down_ms=0.2 * H, seed=7)
    if name == "churn":
        return jsc.random_churn(n, 0.15, 0.15, H, seed=11)
    if name == "stragglers":
        return jsc.random_stragglers(n, 6, H, mean_slow_ms=0.3 * H, mult=4.0,
                                     seed=3)
    if name == "store_outage":
        return jeng.Dynamics(store_outages=((0.3 * H, 0.5 * H),))
    if name == "all_down":
        # Every server down for a fifth of the run: those decisions fall
        # back to uniform over the whole fleet and queue until recovery.
        return jeng.Dynamics(outages=tuple((s, 0.2 * H, 0.4 * H)
                                           for s in range(n)))
    if name == "join_at_zero":
        return jeng.Dynamics(joins=((3, 0.0), (5, -1.0)))
    if name == "maintenance":
        return _maintenance(jsc, n, H)
    raise KeyError(name)


SCENARIOS = ("outages", "churn", "stragglers", "store_outage", "all_down",
             "join_at_zero", "maintenance")


@pytest.mark.parametrize("b", (10, 25))
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("name", SCENARIOS)
def test_simulate_with_dynamics_matches_jax(name, policy, b, inputs):
    jd = _scenario(name, inputs["jtb"].num_servers, inputs["H"])
    ref = jsim.simulate(inputs["jwl"], inputs["jtb"],
                        jsim.EngineConfig(policy=policy, b=b),
                        mode="batched", use_kernel=False, dynamics=jd)
    got = tsim.simulate(inputs["twl"], inputs["ttb"],
                        tsim.EngineConfig(policy=policy, b=b), device="cpu",
                        dynamics=_to_torch(jd))
    assert_parity(ref, got, timestamps_exact=True)


@pytest.mark.parametrize("policy", POLICIES)
def test_outage_ms_routes_to_store_outages(policy, inputs):
    window = (0.3 * inputs["H"], 0.5 * inputs["H"])
    with pytest.warns(DeprecationWarning):
        ref = jsim.simulate(inputs["jwl"], inputs["jtb"],
                            jsim.EngineConfig(policy=policy, b=10,
                                              outage_ms=window),
                            mode="batched", use_kernel=False)
    with pytest.warns(DeprecationWarning, match="store_outages"):
        got = tsim.simulate(inputs["twl"], inputs["ttb"],
                            tsim.EngineConfig(policy=policy, b=10,
                                              outage_ms=window),
                            device="cpu")
    assert_parity(ref, got, timestamps_exact=True)
    if policy != "random":
        assert got.msgs_push < 5 * (600 // 10)        # some pushes suppressed


@pytest.mark.parametrize("policy", POLICIES)
def test_padded_window_widths_are_inert(policy, inputs):
    """Planes padded past their minimal widths give the reference's
    minimal-width result."""
    jd = _scenario("maintenance", inputs["jtb"].num_servers, inputs["H"])
    ref = jsim.simulate(inputs["jwl"], inputs["jtb"],
                        jsim.EngineConfig(policy=policy, b=10),
                        mode="batched", use_kernel=False, dynamics=jd)
    cfg = tsim.EngineConfig(policy=policy, b=10)
    td = _to_torch(jd)
    ctx = teng._make_ctx(inputs["ttb"], cfg, 0, "cpu", td)
    win = teng._lower_dynamics(td, inputs["ttb"].num_servers,
                               widths=tuple(w + 2 for w in ctx.win.widths))
    xs = teng._blocked_inputs(inputs["twl"], 10, "cpu")
    msgs, outs = teng._simulate_batched(xs, ctx._replace(win=win))
    server, start, finish = (o.reshape(-1)[:600].numpy() for o in outs[:3])
    assert np.array_equal(server, ref.server)
    assert np.array_equal(start, ref.start_ms)
    assert np.array_equal(finish, ref.finish_ms)
    assert msgs.tolist() == [ref.msgs_base, ref.msgs_probe, ref.msgs_push,
                             ref.msgs_flush]


def test_dynamics_semantics_hold(inputs):
    """What the windows promise: no placement on a down server unless all
    its feasible servers were down, no start inside a gate window."""
    n, H = inputs["ttb"].num_servers, inputs["H"]
    td = _to_torch(_scenario("outages", n, H).merge(
        _scenario("churn", n, H)))
    res = tsim.simulate(inputs["twl"], inputs["ttb"],
                        tsim.EngineConfig(policy="dodoor", b=10),
                        device="cpu", dynamics=td)
    win = teng._lower_dynamics(td, n)
    d0, d1, g0, g1 = (p.numpy() for p in win[:4])
    now = res.submit_ms[:, None, None]
    down = ((d0[None] <= now) & (now < d1[None])).any(-1)     # [m, n]
    feasible = (inputs["twl"].r_submit[:, None, :]
                <= inputs["ttb"].C[None]).all(-1)
    on_down = down[np.arange(600), res.server]
    assert not (on_down & (feasible & ~down).any(1)).any()
    s = res.start_ms[:, None]
    in_gate = ((g0[res.server] <= s) & (s < g1[res.server])).any(1)
    assert not in_gate.any()
    assert tsim.resource_violations(res, inputs["ttb"]) == 0


# ---------------------------------------------------------------- lowering

LOWERINGS = [
    (lambda n, H: jeng.Dynamics(), None),
    (lambda n, H: _scenario("maintenance", n, H), None),
    (lambda n, H: _scenario("outages", n, H).merge(_scenario("churn", n, H)),
     (5, 4, 2, 3, 2)),
    (lambda n, H: jeng.Dynamics(
        joins=((1, 0.0), (2, 5.0)), leaves=((3, 7.0),),
        cache_faults=jeng.CacheFaults(0.2, ((1.0, 2.0),), 3.0, 4)), None),
]


@pytest.mark.parametrize("make,widths", LOWERINGS)
def test_lowered_planes_match_reference(make, widths, inputs):
    n, H = inputs["jtb"].num_servers, inputs["H"]
    jd = make(n, H)
    ref = jeng._lower_dynamics(jd, n, widths)
    got = teng._lower_dynamics(_to_torch(jd), n, widths)
    assert got.widths == ref.widths
    for f in jeng._Win._fields:
        a, b = np.asarray(getattr(ref, f)), getattr(got, f).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), f


BAD = [
    (dict(outages=((99, 0.0, 1.0),)), ValueError, "outside fleet"),
    (dict(outages=((0, 2.0, 1.0),)), ValueError, "t1 > t0"),
    (dict(slowdowns=((0, 0.0, 1.0, 0.0),)), ValueError, "mult > 0"),
    (dict(store_outages=((3.0, 3.0),)), ValueError, "store outage"),
    (dict(cache_faults="x"), TypeError, "CacheFaults"),
]


@pytest.mark.parametrize("kw,exc,match", BAD)
def test_lowering_refuses_what_the_reference_refuses(kw, exc, match):
    with pytest.raises(exc, match=match):
        jeng._lower_dynamics(jeng.Dynamics(**kw), 20)
    with pytest.raises(exc, match=match):
        teng._lower_dynamics(teng.Dynamics(**kw), 20)
    with pytest.raises(ValueError, match="required"):
        teng._lower_dynamics(teng.Dynamics(outages=((0, 0.0, 1.0),
                                                    (0, 2.0, 3.0))),
                             20, widths=(1, 1, 1, 1, 1))
    with pytest.raises(TypeError, match="Dynamics spec"):
        teng._lower_dynamics(object(), 20)


def test_merge_matches_reference():
    a = jeng.Dynamics(outages=((0, 1.0, 2.0),), store_outages=((1.0, 2.0),))
    b = jeng.Dynamics(leaves=((1, 3.0),), cache_faults=jeng.CacheFaults(0.1))
    got = _to_torch(a).merge(_to_torch(b))
    assert tuple(got[:5]) == tuple(a.merge(b)[:5])
    assert tuple(got.cache_faults) == tuple(a.merge(b).cache_faults)
    assert got.has_down_windows and not teng.Dynamics().has_down_windows
    with pytest.raises(ValueError, match="cache_faults"):
        teng.Dynamics(cache_faults=teng.CacheFaults(0.1)).merge(
            teng.Dynamics(cache_faults=teng.CacheFaults(0.2)))


# ---------------------------------------------------------------- timelines

@pytest.mark.parametrize("n,seed", [(20, 0), (100, 7), (1000, 3)])
def test_timeline_generators_match_reference(n, seed):
    H = 5e4
    pairs = [
        (jsc.random_outages(n, n // 5, 0.6 * H, 0.2 * H, seed),
         tsc.random_outages(n, n // 5, 0.6 * H, 0.2 * H, seed)),
        (jsc.rolling_restart(n, 500.0, 800.0, 10.0, stride=3),
         tsc.rolling_restart(n, 500.0, 800.0, 10.0, stride=3)),
        (jsc.random_churn(n, 0.15, 0.1, H, seed),
         tsc.random_churn(n, 0.15, 0.1, H, seed)),
        (jsc.random_stragglers(n, n // 4, H, 0.1 * H, 3.0, seed),
         tsc.random_stragglers(n, n // 4, H, 0.1 * H, 3.0, seed)),
    ]
    for ref, got in pairs:
        assert isinstance(got, teng.Dynamics)
        assert tuple(got) == tuple(ref)
    draws = [(1, 0.0, 2.0), (1, 1.0, 3.0), (0, 5.0, 6.0), (1, 4.0, 5.0)]
    assert tsc._union_per_server(draws) == jsc._union_per_server(draws)


# ---------------------------------------------------------------- arrivals

def _arrival_specs(mod):
    return (mod.PoissonArrivals(60.0),
            mod.OnOffArrivals(240.0, 10.0, mean_on_s=1.0, mean_off_s=3.0),
            mod.DiurnalArrivals(60.0, amplitude=0.85, period_s=20.0),
            mod.BatchArrivals(10.0, pareto_alpha=1.4, max_batch=64))


@pytest.mark.parametrize("i", range(4))
@pytest.mark.parametrize("m,seed", [(600, 0), (50_000, 5)])
def test_arrival_times_bit_exact(i, m, seed):
    js, ts = _arrival_specs(jarr)[i], _arrival_specs(tarr)[i]
    ref = jarr.arrival_times(js, m, seed)
    got = tarr.arrival_times(ts, m, seed)
    assert got.dtype == np.float32 and not got.flags.writeable
    assert np.array_equal(ref, got)
    assert tarr.mean_qps(ts) == jarr.mean_qps(js)
    assert np.array_equal(tarr.arrival_times_grid(ts, m, (seed, seed + 1)),
                          jarr.arrival_times_grid(js, m, (seed, seed + 1)))


def test_arrival_helpers_match_reference():
    assert np.array_equal(tarr.poisson_arrivals(500, 30.0, 2),
                          jarr.poisson_arrivals(500, 30.0, 2))
    assert np.array_equal(tarr.round_robin_scheduler(17, 5),
                          jarr.round_robin_scheduler(17, 5))
    with pytest.raises(ValueError, match="amplitude"):
        tarr.arrival_times(tarr.DiurnalArrivals(amplitude=1.0), 10)
    with pytest.raises(TypeError, match="unknown arrival spec"):
        tarr.arrival_times(object(), 10)


# ---------------------------------------------------------------- scenarios

def _bench_scenarios(sc, arr, n, horizon, qps):
    """``benchmarks/bench_scenarios.py:make_scenarios``, built from the
    package ``sc``/``arr`` given."""
    on, off = 4.0 * qps, qps / 6.0
    return (
        sc.Scenario("steady", arrivals=arr.PoissonArrivals(qps)),
        sc.Scenario("bursty_mmpp",
                    arrivals=arr.OnOffArrivals(on, off, mean_on_s=1.0,
                                               mean_off_s=3.0)),
        sc.Scenario("diurnal",
                    arrivals=arr.DiurnalArrivals(qps, amplitude=0.85,
                                                 period_s=horizon / 4e3)),
        sc.Scenario("batch_heavy",
                    arrivals=arr.BatchArrivals(qps / 6.0, pareto_alpha=1.4,
                                               max_batch=64)),
        sc.Scenario("outage_storm", arrivals=arr.PoissonArrivals(qps),
                    dynamics=sc.random_outages(
                        n, max(2, n // 5), 0.6 * horizon,
                        mean_down_ms=0.2 * horizon, seed=7)),
        sc.Scenario("churn", arrivals=arr.PoissonArrivals(qps),
                    dynamics=sc.random_churn(n, leave_frac=0.15,
                                             join_frac=0.15,
                                             horizon_ms=horizon, seed=11)),
    )


@pytest.mark.parametrize("k", range(6))
def test_run_scenario_matches_reference_on_bench_scenarios(k, inputs):
    """The six scenarios of the scenario benchmark at its smoke size
    (m=600, qps=12, the 20-server testbed, b=n/2)."""
    jwl = jfb.synthesize(m=600, qps=12.0, seed=0)
    twl = tfb.synthesize(m=600, qps=12.0, seed=0)
    n, H = 20, float(jwl.submit_ms[-1])
    js = _bench_scenarios(jsc, jarr, n, H, 12.0)[k]
    ts = _bench_scenarios(tsc, tarr, n, H, 12.0)[k]
    assert tuple(ts.dynamics) == tuple(js.dynamics)
    ref = jsc.run_scenario(jwl, inputs["jtb"], js,
                           jsim.EngineConfig(policy="dodoor", b=10), seed=k,
                           use_kernel=False)
    got = tsc.run_scenario(twl, inputs["ttb"], ts,
                           tsim.EngineConfig(policy="dodoor", b=10), seed=k,
                           device="cpu")
    assert np.array_equal(ref.submit_ms, got.submit_ms)
    assert_parity(ref, got, timestamps_exact=True)
    assert tsc.scenario_workload(twl, ts, k) is tsc.scenario_workload(
        twl, ts, k)


@pytest.mark.parametrize("name", ["outage_storm", "churn", "maintenance"])
def test_matches_jax_at_smoke_testbed_size(name, testbed):
    """The down-window scenarios ``chip_smoke.py`` runs on the card and
    compares with the port's CPU run: the paper's 100-server testbed,
    FunctionBench m=4000 at 60 qps, b=50.  Equal to the reference here,
    the CPU run stands in for it on the card, which has no JAX."""
    jwl = jfb.synthesize(m=4000, qps=60.0)
    twl = tfb.synthesize(m=4000, qps=60.0)
    H = float(jwl.submit_ms[-1])
    if name == "maintenance":
        js, ts = (jsc.Scenario(name, dynamics=_maintenance(jsc, 100, H)),
                  tsc.Scenario(name, dynamics=_maintenance(tsc, 100, H)))
    else:
        k = 4 if name == "outage_storm" else 5
        js = _bench_scenarios(jsc, jarr, 100, H, 60.0)[k]
        ts = _bench_scenarios(tsc, tarr, 100, H, 60.0)[k]
    ref = jsc.run_scenario(jwl, testbed, js,
                           jsim.EngineConfig(policy="dodoor", b=50),
                           use_kernel=False)
    got = tsc.run_scenario(twl, tsim.make_testbed(), ts,
                           tsim.EngineConfig(policy="dodoor", b=50),
                           device="cpu")
    assert_parity(ref, got, timestamps_exact=True)


# ---------------------------------------------------------------- metrics

def test_windowed_metrics_match_reference(inputs):
    n, H = inputs["jtb"].num_servers, inputs["H"]
    jd = _scenario("outages", n, H)
    ref = jsim.simulate(inputs["jwl"], inputs["jtb"],
                        jsim.EngineConfig(policy="dodoor", b=10),
                        mode="batched", use_kernel=False, dynamics=jd)
    got = tsim.simulate(inputs["twl"], inputs["ttb"],
                        tsim.EngineConfig(policy="dodoor", b=10),
                        device="cpu", dynamics=_to_torch(jd))
    edges = [0.0, 0.25 * H, 0.5 * H, H, 2 * H]
    assert ([tuple(p) for p in tsim.phase_summaries(got, edges)]
            == [tuple(p) for p in jmet.phase_summaries(ref, edges)])
    assert (tuple(tsim.summarize_window(got, 3 * H, 4 * H))
            == tuple(jmet.summarize_window(ref, 3 * H, 4 * H)))
    assert (tsim.mean_in_system(got, 0.1 * H, 0.9 * H)
            == jmet.mean_in_system(ref, 0.1 * H, 0.9 * H))
    assert (tsim.utilization_stats(got, inputs["ttb"], 2_000.0)
            == jmet.utilization_stats(ref, inputs["jtb"], 2_000.0))
    with pytest.raises(ValueError, match="increasing"):
        tsim.phase_summaries(got, [1.0, 1.0])


def test_dynamics_must_be_a_spec(inputs):
    cfg = tsim.EngineConfig(policy="dodoor", b=10)
    with pytest.raises(TypeError, match="Dynamics spec"):
        tsim.simulate(inputs["twl"], inputs["ttb"], cfg, device="cpu",
                      dynamics=object())
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tsim.simulate(inputs["twl"], inputs["ttb"], cfg, device="cpu",
                      dynamics=teng.Dynamics())


@pytest.mark.gpu
@pytest.mark.parametrize("policy", POLICIES)
def test_cuda_run_with_down_windows_matches_cpu_run(policy, inputs):
    """On the card: one masked-kernel launch per block under down windows,
    and the CPU run's placements and ledger."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU form)")
    from repro_torch.kernels.dodoor_choice import LAUNCHES

    td = _to_torch(_scenario("maintenance", inputs["ttb"].num_servers,
                             inputs["H"]))
    cfg = tsim.EngineConfig(policy=policy, b=10)
    LAUNCHES.clear()
    gpu = tsim.simulate(inputs["twl"], inputs["ttb"], cfg, device="cuda",
                        dynamics=td)
    blocks = 60 if policy != "random" else 0
    assert LAUNCHES["dodoor_fused_sparse_masked"] == blocks
    assert LAUNCHES["dodoor_fused_sparse"] == 0
    cpu = tsim.simulate(inputs["twl"], inputs["ttb"], cfg, device="cpu",
                        dynamics=td)
    assert_parity(cpu, gpu, timestamps_exact=False)
