"""Decision-trace telemetry and per-scheduler cache faults in the port
(``EngineConfig(trace=True)``, ``Dynamics(cache_faults=...)``) against the
JAX reference on the CPU: the six trace planes bit for bit against the
reference's ``simulate(trace=True, use_kernel=False)`` for all five
policies in both modes, under down windows, on a map-reduce DAG with a
LocalityModel and with a RetryPolicy; a traced run's placements,
timestamps and ledger equal to the untraced run's; the full-ring warning;
``repro_torch.obs`` on the port's result against ``repro.obs`` on the
reference's; cache faults (loss rate, loss windows, delay) at 1 and 3
schedulers in both modes, ledger included; ``loss_rate=0`` bit-identical
to no spec; the service under faults against ``simulate``; a faulted
checkpoint of the JAX service continued in the port."""
import dataclasses
import json

import numpy as np
import pytest

from _reference_cache import no_persistent_compile_cache  # noqa: F401

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import repro.obs as jobs  # noqa: E402
import repro.serve as jserve  # noqa: E402
import repro.sim as jsim  # noqa: E402
from repro.workloads import dags as jdags  # noqa: E402
from repro.workloads import functionbench as jfb  # noqa: E402
import repro_torch.obs as tobs  # noqa: E402
import repro_torch.sim as tsim  # noqa: E402
from repro_torch.serve import DecisionService, serve_workload  # noqa: E402
from repro_torch.sim import engine as teng  # noqa: E402
from repro_torch.workloads import dags as tdags  # noqa: E402
from repro_torch.workloads import functionbench as tfb  # noqa: E402

POLICIES = ("dodoor", "one_plus_beta", "random", "pot", "prequal")
MODES = ("batched", "sequential")
CORE = ("server", "submit_ms", "enqueue_ms", "start_ms", "finish_ms",
        "sched_ms", "cores", "mem_mb")
TRACE = ("view_age_ms", "view_err", "misplaced", "cache_push", "sched_id",
         "decision_ms")
M = 300


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


def _ledger(r):
    return (r.msgs_base, r.msgs_probe, r.msgs_push, r.msgs_flush)


def _first_difference(f, a, b):
    """The first task where plane ``f`` differs, with both values and
    their bits, for the assertion message."""
    bad = np.flatnonzero(~((a == b) | (np.isnan(a) & np.isnan(b)))
                         if a.dtype.kind == "f" else a != b)
    i = int(bad[0])
    bits = "" if a.dtype.kind != "f" else (
        f" (bits {a.view(np.uint32)[i]:#010x} / {b.view(np.uint32)[i]:#010x})"
        if a.dtype == np.float32 else "")
    return (f"{f}: {bad.size} of {a.size} tasks differ, first task {i}: "
            f"reference {a[i]!r}, port {b[i]!r}{bits}")


def _same(ref, got, fields=CORE + TRACE, ledger=True):
    for f in fields:
        a, b = getattr(ref, f), getattr(got, f)
        assert a is not None and b is not None, f
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype, f
        assert np.array_equal(a, b), _first_difference(f, a, b)
    if ledger:
        assert _ledger(ref) == _ledger(got)


def _head(wl, k):
    return dataclasses.replace(wl, **{
        f.name: getattr(wl, f.name)[:k] for f in dataclasses.fields(wl)})


def _pair(inputs, cfg_kw, dyn=None, mode="batched", dag=None):
    """(reference run, port run) of one configuration; ``dyn`` and
    ``dag`` are ``f(module) -> spec`` so each package builds its own.  A
    task graph runs on the first 120 tasks: the reference compiles its
    sequential scan once per wave length."""
    jd = None if dyn is None else dyn(jsim)
    td = None if dyn is None else dyn(tsim)
    if dag is not None:
        inputs = dict(inputs, jwl=_head(inputs["jwl"], 120),
                      twl=_head(inputs["twl"], 120))
    ref = jsim.simulate(inputs["jwl"], inputs["jtb"],
                        jsim.EngineConfig(**_cfg_kw(cfg_kw, jsim)),
                        mode=mode, use_kernel=False, dynamics=jd,
                        dag=None if dag is None else dag(jdags))
    got = tsim.simulate(inputs["twl"], inputs["ttb"],
                        tsim.EngineConfig(**_cfg_kw(cfg_kw, tsim)),
                        mode=mode, device="cpu", dynamics=td,
                        dag=None if dag is None else dag(tdags))
    return ref, got


def _cfg_kw(kw, mod):
    """Config kwargs with the named-tuple knobs built from ``mod``."""
    out = dict(kw)
    if out.get("retry") == "default":
        out["retry"] = mod.RetryPolicy()
    if isinstance(out.get("locality"), float):
        out["locality"] = mod.LocalityModel(gamma=out["locality"])
    return out


def _outages(H):
    def build(mod):
        return mod.random_outages(20, 6, H, mean_down_ms=0.1 * H, seed=3) \
            .merge(mod.Dynamics(store_outages=((0.3 * H, 0.5 * H),)))
    return build


# ------------------------------------------------------------------ trace

@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("policy", POLICIES)
def test_trace_planes_match_reference(inputs, policy, mode):
    ref, got = _pair(inputs, dict(policy=policy, b=10, trace=True),
                     mode=mode)
    _same(ref, got)
    if policy in ("random", "pot", "prequal"):
        for f in ("view_age_ms", "view_err", "misplaced", "cache_push"):
            assert not np.asarray(getattr(got, f)).any(), f
    else:
        assert got.cache_push.sum() == M // 10
        assert (got.view_age_ms > 0).any()
    # Trace consumes no draw: the untraced run is the same run.
    plain = tsim.simulate(inputs["twl"], inputs["ttb"],
                          tsim.EngineConfig(policy=policy, b=10),
                          mode=mode, device="cpu")
    _same(plain, got, CORE)
    assert all(getattr(plain, f) is None for f in TRACE)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("policy", ("dodoor", "one_plus_beta"))
def test_trace_under_down_windows(inputs, policy, mode):
    ref, got = _pair(inputs, dict(policy=policy, b=10, trace=True),
                     dyn=_outages(inputs["H"]), mode=mode)
    _same(ref, got)
    # The store outage suppressed some pushes: fewer than one a block.
    assert 0 < got.cache_push.sum() < M // 10


@pytest.mark.parametrize("mode", MODES)
def test_trace_on_a_dag_with_locality(inputs, mode):
    ref, got = _pair(inputs, dict(policy="dodoor", b=10, trace=True,
                                  locality=2.0), mode=mode,
                     dag=lambda d: d.MapReduceDAG(mappers=6, reducers=2,
                                                  edge_bytes_mb=40.0))
    _same(ref, got)
    assert got.view_err.max() > 0


@pytest.mark.parametrize("mode", MODES)
def test_trace_with_retries(inputs, mode):
    ref, got = _pair(inputs, dict(policy="dodoor", b=10, trace=True,
                                  retry="default"),
                     dyn=_outages(inputs["H"]), mode=mode)
    _same(ref, got, CORE + TRACE + ("attempts", "failed", "wasted_ms"))
    assert (got.attempts > 1).any()


def test_full_ring_warns_as_the_reference(inputs):
    """A ring of 2 slots fills at this load: both packages warn, and the
    planes still agree."""
    kw = dict(policy="dodoor", b=10, trace=True, rbuf_slots=2)
    with pytest.warns(RuntimeWarning, match="rbuf_slots"):
        got = tsim.simulate(inputs["twl"], inputs["ttb"],
                            tsim.EngineConfig(**kw), device="cpu")
    with pytest.warns(RuntimeWarning, match="rbuf_slots"):
        ref = jsim.simulate(inputs["jwl"], inputs["jtb"],
                            jsim.EngineConfig(**kw), mode="batched",
                            use_kernel=False)
    _same(ref, got)


@pytest.mark.parametrize("policy", ("dodoor", "pot"))
def test_obs_rollups_match_reference(inputs, policy):
    ref, got = _pair(inputs, dict(policy=policy, b=10, trace=True))
    assert tobs.TRACE_STAT_FIELDS == jobs.TRACE_STAT_FIELDS
    for fn in ("decision_stats", "latency_stats"):
        a, b = getattr(jobs, fn)(ref), getattr(tobs, fn)(got)
        assert json.dumps(a) == json.dumps(b), fn
    a = jobs.to_chrome_trace(ref, inputs["jtb"])
    b = tobs.to_chrome_trace(got, inputs["ttb"])
    assert json.dumps(a) == json.dumps(b)
    with pytest.raises(ValueError, match="traced run"):
        tobs.decision_stats(got._replace(view_age_ms=None))


def test_traced_carry_round_trips(inputs):
    """``push_at`` and the per-scheduler views pass through the carry's
    numpy form."""
    ctx = teng._make_ctx(inputs["ttb"], tsim.EngineConfig(trace=True,
                                                          num_schedulers=3),
                         0, torch.device("cpu"),
                         tsim.Dynamics(cache_faults=tsim.CacheFaults(0.5)))
    carry = teng._init_carry(ctx.cfg, 20, ctx.cores_per, faulted=True)
    leaves = tsim.carry_to_numpy(carry)
    assert leaves["push_at"].shape == (3,)
    assert leaves["view_L"].shape == (3, 20, 2)
    back = tsim.carry_from_numpy(leaves, device="cpu")
    for f, v in back._asdict().items():
        assert np.array_equal(v.numpy(), leaves[f]), f


def test_module_writes_no_compile_cache_entries():
    """F5 and F6 (ROADMAP §3): while a port test module runs, JAX neither
    reads nor writes the persistent compilation cache
    (``_reference_cache``), so every reference executable it runs is
    compiled in this process, on this host."""
    from jax._src import compilation_cache

    assert not jax.config.jax_enable_compilation_cache
    assert not compilation_cache.is_cache_used(jax.devices()[0].client)


# ----------------------------------------------------------- cache faults

def _faults(H, rate=0.5, delay=0.02):
    def build(mod):
        return mod.Dynamics(cache_faults=mod.CacheFaults(
            loss_rate=rate, loss_windows=((0.6 * H, 0.7 * H),),
            delay_ms=delay * H, seed=5))
    return build


@pytest.mark.parametrize("S", (1, 3))
@pytest.mark.parametrize("mode", MODES)
def test_cache_faults_match_reference(inputs, mode, S):
    kw = dict(policy="dodoor", b=10, num_schedulers=S, trace=True)
    ref, got = _pair(inputs, kw, dyn=_faults(inputs["H"]), mode=mode)
    _same(ref, got)
    # The faults matter: the views go staler than the unfaulted run's.
    clean = tsim.simulate(inputs["twl"], inputs["ttb"],
                          tsim.EngineConfig(**kw), mode=mode, device="cpu")
    assert got.view_age_ms.mean() > clean.view_age_ms.mean()
    assert not np.array_equal(got.server, clean.server)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("policy", ("one_plus_beta", "prequal"))
def test_cache_faults_other_policies(inputs, policy, mode):
    ref, got = _pair(inputs, dict(policy=policy, b=10, num_schedulers=3),
                     dyn=_faults(inputs["H"]), mode=mode)
    _same(ref, got, CORE)


@pytest.mark.parametrize("mode", MODES)
def test_cache_faults_on_a_dag_under_down_windows(inputs, mode):
    """The faulted two-stage score with the locality term, and the masked
    draws, against the reference."""
    H = inputs["H"]

    def dyn(mod):
        return _outages(H)(mod)._replace(
            cache_faults=mod.CacheFaults(loss_rate=0.3, seed=1))
    ref, got = _pair(inputs, dict(policy="dodoor", b=10, num_schedulers=3,
                                  locality=2.0, trace=True), dyn=dyn,
                     mode=mode,
                     dag=lambda d: d.MapReduceDAG(mappers=6, reducers=2,
                                                  edge_bytes_mb=40.0))
    _same(ref, got)


@pytest.mark.parametrize("mode", MODES)
def test_zero_loss_is_bit_identical_to_no_faults(inputs, mode):
    for policy in ("dodoor", "one_plus_beta"):
        cfg = tsim.EngineConfig(policy=policy, b=10, num_schedulers=3,
                                trace=True)
        plain = tsim.simulate(inputs["twl"], inputs["ttb"], cfg, mode=mode,
                              device="cpu")
        inert = tsim.simulate(
            inputs["twl"], inputs["ttb"], cfg, mode=mode, device="cpu",
            dynamics=tsim.Dynamics(cache_faults=tsim.CacheFaults()))
        _same(plain, inert)


@pytest.mark.parametrize("policy", ("dodoor", "pot"))
def test_service_under_faults_equals_simulate(inputs, policy):
    cfg = tsim.EngineConfig(policy=policy, b=25, num_schedulers=3)
    dyn = _faults(inputs["H"])(tsim)
    want = tsim.simulate(inputs["twl"], inputs["ttb"], cfg, device="cpu",
                         dynamics=dyn)
    svc, got = serve_workload(inputs["twl"], inputs["ttb"], cfg, chunk=13,
                              dynamics=dyn, device="cpu")
    _same(want, got, CORE)
    assert svc.export_checkpoint()["faulted"]
    assert svc.snapshot()["view_rif"].shape == (3, 20)


def test_jax_faulted_checkpoint_continues_in_the_port(inputs):
    """The JAX service checkpoints a faulted stream mid-way; the port
    restores its per-scheduler views and continues to the reference's
    uninterrupted result, bit for bit."""
    m, cut = M, 150
    jcfg = jsim.EngineConfig(policy="dodoor", b=25, num_schedulers=3)
    tcfg = tsim.EngineConfig(policy="dodoor", b=25, num_schedulers=3)
    jd, td = _faults(inputs["H"])(jsim), _faults(inputs["H"])(tsim)
    ref = jserve.DecisionService(inputs["jtb"], jcfg, seed=2, dynamics=jd,
                                 capacity=m)
    ref.submit_workload(inputs["jwl"], 0, cut)
    ref.drain()
    ck = ref.export_checkpoint()
    assert ck["faulted"] and ck["carry"]["view_L"].shape == (3, 20, 2)
    ref.submit_workload(inputs["jwl"], cut, m)
    ref.flush()
    want = ref.result()

    svc = DecisionService.from_checkpoint(inputs["ttb"], tcfg, ck,
                                          dynamics=td, capacity=m,
                                          device="cpu")
    svc.submit_workload(inputs["twl"], cut, m)
    svc.flush()
    got = svc.result()
    assert (got.server == want.server[cut:]).all()
    for f in CORE[1:]:
        assert np.array_equal(getattr(got, f), getattr(want, f)[cut:]), f
    assert _ledger(got) == _ledger(want)
    with pytest.raises(ValueError, match="faulted"):
        DecisionService.from_checkpoint(inputs["ttb"], tcfg, ck,
                                        capacity=m, device="cpu")
