"""The port's grid planners against the JAX reference on the CPU:
``run_study`` on a seeds × α × scenarios grid (a scenario with outages and
bursty arrivals, a cache-faulted one) point for point against the
reference's ``run_study(use_kernel=False, point_chunk=1)`` and the port's
``run_scenario`` loop; the DAG and retry studies; ``server_shards``
against ``simulate_hierarchical`` of both packages; ``simulate_many`` with
``trace=True``; ``run_scenario_grid``; the cross-seed summaries; the
knob-rule and validation errors with the reference's messages; the
mean-field predictor; ``simulate_hierarchical`` in both modes."""
import dataclasses

import numpy as np
import pytest

from _reference_cache import no_persistent_compile_cache  # noqa: F401

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import repro.sim as jsim  # noqa: E402
from repro.workloads import arrivals as jarr  # noqa: E402
from repro.workloads import dags as jdags  # noqa: E402
from repro.workloads import functionbench as jfb  # noqa: E402
import repro_torch.sim as tsim  # noqa: E402
from repro_torch.workloads import arrivals as tarr  # noqa: E402
from repro_torch.workloads import dags as tdags  # noqa: E402
from repro_torch.workloads import functionbench as tfb  # noqa: E402

PLANES = ("server", "enqueue_ms", "start_ms", "finish_ms", "sched_ms",
          "cores", "mem_mb", "submit_ms", "msgs")
TRACE = ("view_age_ms", "view_err", "misplaced", "cache_push", "sched_id",
         "decision_ms")
RECOVERY = ("attempts", "failed", "wasted_ms")
POINT = ("server", "submit_ms", "enqueue_ms", "start_ms", "finish_ms",
         "sched_ms", "cores", "mem_mb")
M, N = 240, 20


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def inputs():
    jwl = jfb.synthesize(m=M, qps=60.0, seed=0)
    return {"jwl": jwl, "twl": tfb.synthesize(m=M, qps=60.0, seed=0),
            "jtb": jsim.make_testbed(scale=0.2),
            "ttb": tsim.make_testbed(scale=0.2),
            "H": float(jwl.submit_ms[-1])}


def _scenarios(sim, arr, H):
    """Steady; bursty MMPP arrivals under an outage storm; cache faults."""
    return (sim.Scenario("steady"),
            sim.Scenario("bursty_storm",
                         arrivals=arr.OnOffArrivals(240.0, 10.0, 1.0, 3.0),
                         dynamics=sim.random_outages(
                             N, 4, 0.6 * H, mean_down_ms=0.2 * H, seed=7)),
            sim.Scenario("lossy", dynamics=sim.Dynamics(
                cache_faults=sim.CacheFaults(loss_rate=0.5, delay_ms=50.0,
                                             seed=5))))


def _same(a, b, fields):
    for f in fields:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype, f
        if not np.array_equal(x, y):
            bad = np.argwhere(x != y)
            i = tuple(bad[0])
            raise AssertionError(
                f"{f}: {len(bad)} of {x.size} values differ, first at {i}: "
                f"expected {x[i]!r}, got {y[i]!r}")


def _ledger(r):
    return (r.msgs_base, r.msgs_probe, r.msgs_push, r.msgs_flush)


def _same_point(want, got, fields=POINT):
    _same(want, got, fields)
    assert _ledger(want) == _ledger(got)


@pytest.fixture(scope="module")
def grid(inputs):
    """The acceptance grid, run once: seeds (0, 1) × α (0.3, 0.7) × the
    three scenarios, dodoor at b = 10, traced."""
    H = inputs["H"]
    kw = [dict(policy="dodoor", b=10, alpha=a, trace=True)
          for a in (0.3, 0.7)]
    js = jsim.Study(seeds=(0, 1), configs=[jsim.EngineConfig(**k)
                                           for k in kw],
                    scenarios=_scenarios(jsim, jarr, H))
    ts = tsim.Study(seeds=(0, 1), configs=[tsim.EngineConfig(**k)
                                           for k in kw],
                    scenarios=_scenarios(tsim, tarr, H))
    ref = jsim.run_study(inputs["jwl"], inputs["jtb"], js, use_kernel=False,
                         point_chunk=1)
    got = tsim.run_study(inputs["twl"], inputs["ttb"], ts, device="cpu")
    return ts, ref, got


def test_study_grid_matches_reference(grid):
    _, ref, got = grid
    _same(ref, got, PLANES + TRACE)
    assert got.policy == ref.policy == "dodoor"
    assert (got.num_seeds, got.num_configs, got.num_scenarios) == (2, 2, 3)
    # The mixed scenario axis is padded with an inert CacheFaults().
    assert [sc.dynamics.cache_faults is not None
            for sc in got.scenarios] == [True] * 3
    assert got.attempts is None and ref.attempts is None


def test_study_points_equal_the_run_scenario_loop(inputs, grid):
    ts, _, got = grid
    for si, sd in enumerate(ts.seeds):
        for gi, cfg in enumerate(ts.configs):
            for ki, sc in enumerate(ts.scenarios):
                want = tsim.run_scenario(inputs["twl"], inputs["ttb"], sc,
                                         cfg, sd, device="cpu")
                _same_point(want, got.point(si, gi, ki), POINT + TRACE)


def test_summarize_study_matches_reference(grid):
    _, ref, got = grid
    a, b = jsim.summarize_study(ref), tsim.summarize_study(got)
    assert len(a) == len(b) == 2 and len(a[0]) == len(b[0]) == 3
    for ra, rb in zip(a, b):
        for x, y in zip(ra, rb):
            assert x._asdict() == y._asdict()
            assert x.row() == y.row()


def _head(wl, k):
    return dataclasses.replace(wl, **{
        f.name: getattr(wl, f.name)[:k] for f in dataclasses.fields(wl)})


def test_dag_study_matches_reference(inputs):
    """A γ sweep over a map-reduce DAG: the locality model varies per
    column; submit planes are per-config effective submit times."""
    m = 120
    jwl, twl = _head(inputs["jwl"], m), _head(inputs["twl"], m)

    def study(sim, dags):
        return sim.Study(
            seeds=(0, 3),
            configs=[sim.EngineConfig(
                policy="dodoor", b=10, trace=True,
                locality=sim.LocalityModel(gamma=g)) for g in (0.0, 2.0)],
            scenarios=(sim.Scenario("mr", dag=dags.MapReduceDAG(
                mappers=6, reducers=2, edge_bytes_mb=40.0)),))
    ref = jsim.run_study(jwl, inputs["jtb"], study(jsim, jdags),
                         use_kernel=False)
    ts = study(tsim, tdags)
    got = tsim.run_study(twl, inputs["ttb"], ts, device="cpu")
    _same(ref, got, PLANES + TRACE)
    assert got.submit_ms.shape == (2, 2, 1, m)
    want = tsim.simulate(twl, inputs["ttb"], ts.configs[1], 3,
                         device="cpu", dag=ts.scenarios[0].dag)
    _same_point(want, got.point(1, 1, 0), POINT + TRACE)


def test_retry_study_matches_reference(inputs):
    """A retry-policy column beside a no-retry one, under outages."""
    H = inputs["H"]

    def study(sim):
        return sim.Study(
            seeds=(0,),
            configs=[sim.EngineConfig(policy="dodoor", b=10),
                     sim.EngineConfig(policy="dodoor", b=10,
                                      retry=sim.RetryPolicy())],
            scenarios=(sim.Scenario("storm", dynamics=sim.random_outages(
                N, 6, H, mean_down_ms=0.1 * H, seed=3)),))
    ref = jsim.run_study(inputs["jwl"], inputs["jtb"], study(jsim),
                         use_kernel=False)
    got = tsim.run_study(inputs["twl"], inputs["ttb"], study(tsim),
                         device="cpu")
    _same(ref, got, PLANES + RECOVERY)
    assert (got.attempts[0, 1, 0] > 1).any()
    assert (got.attempts[0, 0, 0] == 1).all()


def test_server_shards_match_simulate_hierarchical(inputs):
    H = inputs["H"]
    dyn = (jsim.Dynamics(outages=((3, 0.2 * H, 0.5 * H),)),
           tsim.Dynamics(outages=((3, 0.2 * H, 0.5 * H),)))
    cfgs = (jsim.EngineConfig(policy="dodoor", b=8, trace=True),
            tsim.EngineConfig(policy="dodoor", b=8, trace=True))
    got = tsim.run_study(
        inputs["twl"], inputs["ttb"],
        tsim.Study(seeds=(4,), configs=cfgs[1],
                   scenarios=tsim.Scenario("o", dynamics=dyn[1])),
        server_shards=2, device="cpu").point(0, 0, 0)
    want = tsim.simulate_hierarchical(inputs["twl"], inputs["ttb"], cfgs[1],
                                      2, 4, mode="batched", b=8,
                                      dynamics=dyn[1], device="cpu")
    _same_point(want, got, POINT + TRACE)
    ref = jsim.simulate_hierarchical(inputs["jwl"], inputs["jtb"], cfgs[0],
                                     2, 4, mode="batched", b=8,
                                     dynamics=dyn[0], use_kernel=False)
    _same_point(ref, got, POINT + TRACE)


@pytest.mark.parametrize("mode", ("batched", "sequential"))
def test_simulate_hierarchical_matches_reference(inputs, mode):
    """b=None: each mini-cluster's own n/2 batch; windows restricted to
    each part, a store outage on every part."""
    H = inputs["H"]

    def dyn(sim):
        return sim.Dynamics(outages=((2, 0.1 * H, 0.4 * H),
                                     (5, 0.3 * H, 0.8 * H)),
                            store_outages=((0.5 * H, 0.6 * H),))
    ref = jsim.simulate_hierarchical(
        inputs["jwl"], inputs["jtb"], jsim.EngineConfig(policy="dodoor"), 2,
        1, mode=mode, dynamics=dyn(jsim), use_kernel=False)
    got = tsim.simulate_hierarchical(
        inputs["twl"], inputs["ttb"], tsim.EngineConfig(policy="dodoor"), 2,
        1, mode=mode, dynamics=dyn(tsim), device="cpu")
    _same_point(ref, got)
    for (ja, a), (tb, b) in zip(jsim.split_cluster(inputs["jtb"], 4),
                                tsim.split_cluster(inputs["ttb"], 4)):
        assert np.array_equal(a, b) and np.array_equal(ja.C, tb.C)


@pytest.fixture(scope="module")
def sweep(inputs):
    cfgs = [dict(policy="dodoor", b=10, alpha=a, trace=True)
            for a in (0.5, 1.0)]
    ref = jsim.simulate_many(inputs["jwl"], inputs["jtb"],
                             [jsim.EngineConfig(**k) for k in cfgs],
                             seeds=(0, 2), use_kernel=False)
    tcfgs = [tsim.EngineConfig(**k) for k in cfgs]
    got = tsim.simulate_many(inputs["twl"], inputs["ttb"], tcfgs,
                             seeds=(0, 2), device="cpu")
    return tcfgs, ref, got


def test_simulate_many_traced_matches_reference(inputs, sweep):
    tcfgs, ref, got = sweep
    _same(ref, got, PLANES + TRACE)
    want = tsim.simulate(inputs["twl"], inputs["ttb"], tcfgs[1], 2,
                         device="cpu")
    _same_point(want, got.point(1, 1), POINT + TRACE)


def test_summarize_sweep_matches_reference(sweep):
    _, ref, got = sweep
    for x, y in zip(jsim.summarize_sweep(ref), tsim.summarize_sweep(got)):
        assert x._asdict() == y._asdict()
    per = [jsim.summarize(ref.point(si, 0)) for si in range(2)]
    tper = [tsim.summarize(got.point(si, 0)) for si in range(2)]
    assert (jsim.aggregate_summaries(per)._asdict()
            == tsim.aggregate_summaries(tper)._asdict())


def test_run_scenario_grid_matches_reference(inputs):
    H = inputs["H"]
    js = _scenarios(jsim, jarr, H)[:2]
    ts = _scenarios(tsim, tarr, H)[:2]
    cfg = dict(policy="pot", b=10)
    ref = jsim.run_scenario_grid(inputs["jwl"], inputs["jtb"], js,
                                 jsim.EngineConfig(**cfg), seeds=(0, 1),
                                 use_kernel=False)
    got = tsim.run_scenario_grid(inputs["twl"], inputs["ttb"], ts,
                                 tsim.EngineConfig(**cfg), seeds=(0, 1),
                                 device="cpu")
    _same(ref, got, PLANES)
    assert got.submit_ms.flags.writeable
    for si in range(2):
        for ki, sc in enumerate(ts):
            want = tsim.run_scenario(inputs["twl"], inputs["ttb"], sc,
                                     tsim.EngineConfig(**cfg), si,
                                     device="cpu")
            _same_point(want, got.point(si, ki))


def _bad_inputs(sim, dags, H):
    """(label, call) pairs that both packages must refuse alike."""
    E, Sc = sim.EngineConfig, sim.Scenario
    dag = Sc("g", dag=dags.MapReduceDAG())
    out = sim.Scenario("o", dynamics=sim.Dynamics(
        outages=((25, 0.0, H),)))
    return [
        ("no seeds", dict(study=sim.Study(seeds=()))),
        ("not a config", dict(study=sim.Study(configs=("x",)))),
        ("not a scenario", dict(study=sim.Study(scenarios=("x",)))),
        ("flush bound", dict(study=sim.Study(
            configs=E(b=10, flush_every=9)))),
        ("b differs", dict(study=sim.Study(configs=(E(b=10), E(b=20))))),
        ("policy differs", dict(study=sim.Study(
            configs=(E(b=10), E(b=10, policy="pot"))))),
        ("trace differs", dict(study=sim.Study(
            configs=(E(b=10), E(b=10, trace=True))))),
        ("locality, no dag", dict(study=sim.Study(
            configs=E(b=10, locality=sim.LocalityModel())))),
        ("dag with shards", dict(study=sim.Study(scenarios=dag),
                                 server_shards=2)),
        ("dag with retry", dict(study=sim.Study(
            configs=E(b=10, retry=sim.RetryPolicy()), scenarios=dag))),
        ("shards do not divide", dict(study=sim.Study(configs=E(b=10)),
                                      server_shards=3)),
        ("server outside fleet", dict(study=sim.Study(
            configs=E(b=10), scenarios=out), server_shards=2)),
    ]


def test_validation_errors_match_reference(inputs):
    H = inputs["H"]
    for (label, jkw), (_, tkw) in zip(_bad_inputs(jsim, jdags, H),
                                      _bad_inputs(tsim, tdags, H)):
        with pytest.raises(Exception) as je:
            jsim.run_study(inputs["jwl"], inputs["jtb"], jkw.pop("study"),
                           use_kernel=False, **jkw)
        with pytest.raises(Exception) as te:
            tsim.run_study(inputs["twl"], inputs["ttb"], tkw.pop("study"),
                           device="cpu", **tkw)
        assert te.type is je.type, label
        assert str(te.value) == str(je.value), label
    for mod, kw in ((jsim, dict(use_kernel=False)), (tsim, {})):
        wl = inputs["jwl" if mod is jsim else "twl"]
        tb = inputs["jtb" if mod is jsim else "ttb"]
        with pytest.raises(ValueError, match="≥ 1 config and ≥ 1 seed"):
            mod.simulate_many(wl, tb, (), **kw)
        with pytest.raises(ValueError, match="≥ 1 scenario and ≥ 1 seed"):
            mod.run_scenario_grid(wl, tb, (), mod.EngineConfig(), **kw)


# -------------------------------------------------------------- meanfield

def test_meanfield_functions_match_reference():
    for lam in (0.5, 0.9):
        for d in (1, 2, 3):
            assert np.array_equal(jsim.pod_tail(lam, d, 40),
                                  tsim.pod_tail(lam, d, 40))
            assert jsim.pod_mean_queue(lam, d) == tsim.pod_mean_queue(lam, d)
        for beta in (0.0, 0.5, 1.0):
            assert np.array_equal(jsim.one_plus_beta_tail(lam, beta, 64),
                                  tsim.one_plus_beta_tail(lam, beta, 64))
            assert (jsim.one_plus_beta_mean_queue(lam, beta)
                    == tsim.one_plus_beta_mean_queue(lam, beta))
    args = ([0.3, 0.7], [0.5, 1.5], 0.6)
    assert np.array_equal(jsim.het_pod_equilibrium(*args, kmax=16),
                          tsim.het_pod_equilibrium(*args, kmax=16))
    a, b = jsim.predict_pod(*args, kmax=16), tsim.predict_pod(*args, kmax=16)
    for f in a._fields:
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    for kw in ({}, {"b": 50}, {"rel": 0.1}):
        assert (jsim.tolerance_band(1.3, 1000, **kw)
                == tsim.tolerance_band(1.3, 1000, **kw))
    for mod in (jsim, tsim):
        with pytest.raises(ValueError, match="unstable"):
            mod.het_pod_equilibrium([1.0], [1.0], 1.1)
        with pytest.raises(ValueError, match="beta"):
            mod.one_plus_beta_tail(0.5, 1.5)


def test_service_workload_and_measured_queue_match_reference():
    jcl, tcl = jsim.make_scaled(40, het=0.0), tsim.make_scaled(40, het=0.0)
    jwl = jsim.make_service_workload(jcl, 0.7, 400, seed=1,
                                     service_scale_by_type=(1, 2, 1, 2))
    twl = tsim.make_service_workload(tcl, 0.7, 400, seed=1,
                                     service_scale_by_type=(1, 2, 1, 2))
    for f in dataclasses.fields(twl):
        assert np.array_equal(getattr(jwl, f.name), getattr(twl, f.name)), \
            f.name
    cfg = dict(policy="pot", b=20, interference=0.0, rbuf_slots=64,
               mem_units=8)
    ref = jsim.simulate(jwl, jcl, jsim.EngineConfig(**cfg), mode="batched",
                        use_kernel=False)
    got = tsim.simulate(twl, tcl, tsim.EngineConfig(**cfg), device="cpu")
    _same_point(ref, got)
    H = float(twl.submit_ms[-1])
    assert (jsim.measured_mean_queue(ref, 40, 0.25 * H, 0.95 * H)
            == tsim.measured_mean_queue(got, 40, 0.25 * H, 0.95 * H))
