"""The port's task graphs against the JAX reference on the CPU: the DAG
specs and their lowered plans, the frontier loop with and without a
LocalityModel (``simulate(..., dag=...)``) bit-exact against the
reference's two-stage batched driver (``use_kernel=False``) for random,
dodoor and (1+β), the DAG metrics, and the locality form K3 of the
decision kernel: its plain version against the reference's two-stage
arithmetic, and on a machine with a card the CUDA kernel against it.

Every comparison is exact (tolerance 0)."""
import numpy as np
import pytest

from _reference_cache import no_persistent_compile_cache  # noqa: F401

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402
import repro.sim as jsim  # noqa: E402
from repro.sim import engine as jeng  # noqa: E402
from repro.sim import scenarios as jsc  # noqa: E402
from repro.workloads import dags as jdags  # noqa: E402
from repro.workloads import functionbench as jfb  # noqa: E402
import repro_torch.sim as tsim  # noqa: E402
from repro_torch.kernels.dodoor_choice import (LAUNCHES,  # noqa: E402
                                               dodoor_fused_sparse,
                                               dodoor_fused_sparse_ref)
from repro_torch.workloads import dags as tdags  # noqa: E402
from repro_torch.workloads import functionbench as tfb  # noqa: E402
from test_torch_kernels import _inputs, _windows  # noqa: E402

POLICIES = ("random", "dodoor", "one_plus_beta")
M = 240


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
    jwl = jfb.synthesize(m=M, qps=30.0, seed=0)
    return dict(jwl=jwl, twl=tfb.synthesize(m=M, qps=30.0, seed=0),
                jtb=jsim.make_testbed(scale=0.2),
                ttb=tsim.make_testbed(scale=0.2),
                H=float(jwl.submit_ms[-1]))


#: Edges with non-integer delays and payloads, and a 40-parent fan-in
#: (P = 40: two 20-column chunks in the reference's row-sum order).
EXPLICIT_EDGES = (
    tuple((u, u + 10 + u % 7, 0.3 * (u % 3), 1.1 + 0.37 * (u % 5))
          for u in range(0, 200, 3))
    + tuple((p, 230, 0.05 * (p % 4), 0.5 + 0.13 * (p - 180))
            for p in range(180, 220)))


def _spec(pkg, name: str):
    """A DAG spec by name, from the reference's or the port's module."""
    if name == "chain":
        return pkg.ChainDAG(edge_delay_ms=0.5, edge_bytes_mb=4.0)
    if name == "fanout":
        return pkg.FanOutDAG(width=6, edge_delay_ms=1.0, edge_bytes_mb=8.0)
    if name == "mapreduce":
        return pkg.MapReduceDAG(mappers=8, reducers=2, edge_delay_ms=0.5,
                                edge_bytes_mb=4.0)
    if name == "layered":
        return pkg.LayeredDAG(width=24, density=0.3, edge_delay_ms=1.0,
                              edge_bytes_mb=3.3, seed=2)
    if name == "explicit":
        return pkg.ExplicitDAG(edges=EXPLICIT_EDGES)
    raise KeyError(name)


SPECS = ("chain", "fanout", "mapreduce", "layered", "explicit")
#: LocalityModel settings: none, γ = 0, γ = 2, and γ/bandwidth = 0.7/1.3
#: (not a power of two, so the penalty's rounding shows).
LOCALITY = {"none": None, "gamma0": (0.0, 1.0), "gamma2": (2.0, 1.0),
            "gamma0.7bw1.3": (0.7, 1.3)}


def _locality(pkg, name: str):
    g = LOCALITY[name]
    return None if g is None else pkg.LocalityModel(
        gamma=g[0], bandwidth_mb_per_ms=g[1])


def _outages(inputs):
    return jsc.random_outages(inputs["jtb"].num_servers, 6, 0.6 * inputs["H"],
                              mean_down_ms=0.2 * inputs["H"], seed=7)


def _to_torch(d):
    return None if d is None else tsim.Dynamics(**d._asdict())


def assert_same(ref, got):
    """Placements, all five time planes (effective submit included), the
    consumed resources and the four-field ledger, bit for bit."""
    assert np.array_equal(ref.server, got.server), "placements diverge"
    for f in ("submit_ms", "enqueue_ms", "start_ms", "finish_ms",
              "sched_ms", "cores", "mem_mb"):
        assert np.array_equal(getattr(ref, f), getattr(got, f)), f
    ledger = lambda r: (r.msgs_base, r.msgs_probe, r.msgs_push,
                        r.msgs_flush)
    assert ledger(ref) == ledger(got), "message ledger diverges"


def _run_pair(inputs, policy, spec, loc, dyn=None, b=16):
    ref = jsim.simulate(inputs["jwl"], inputs["jtb"],
                        jsim.EngineConfig(policy=policy, b=b,
                                          locality=_locality(jsim, loc)),
                        mode="batched", use_kernel=False,
                        dag=_spec(jdags, spec), dynamics=dyn)
    got = tsim.simulate(inputs["twl"], inputs["ttb"],
                        tsim.EngineConfig(policy=policy, b=b,
                                          locality=_locality(tsim, loc)),
                        device="cpu", dag=_spec(tdags, spec),
                        dynamics=_to_torch(dyn))
    return ref, got


# ------------------------------------------------------------- the specs

PLAN_CASES = [(name, m) for name in SPECS for m in (1, 37, M)
              if name != "explicit" or m == M]      # its edges reach 230


@pytest.mark.parametrize("name,m", PLAN_CASES)
def test_dag_plan_matches_reference(name, m):
    ref = jdags.dag_plan(_spec(jdags, name), m)
    got = tdags.dag_plan(_spec(tdags, name), m)
    assert type(got).__name__ == "DagPlan"
    for f, a in ref._asdict().items():
        b = getattr(got, f)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f
            assert not b.flags.writeable, f
        else:
            assert a == b, f
    assert np.array_equal(jdags.dag_edges(_spec(jdags, name), m),
                          tdags.dag_edges(_spec(tdags, name), m))


def test_dag_plan_memoized_and_passthrough():
    spec = tdags.FanOutDAG(width=4)
    p1 = tdags.dag_plan(spec, 60)
    assert tdags.dag_plan(spec, 60) is p1
    assert tdags.dag_plan(p1, 60) is p1
    with pytest.raises(ValueError, match="m=60"):
        tdags.dag_plan(p1, 61)


@pytest.mark.parametrize("pkg", (jdags, tdags), ids=("jax", "torch"))
def test_dag_spec_errors(pkg):
    """Cycle, self-edge, bounds and bad-spec errors, as the reference."""
    with pytest.raises(ValueError, match="cycle"):
        pkg.dag_plan(pkg.ExplicitDAG(edges=((0, 1), (1, 2), (2, 0))), 4)
    with pytest.raises(ValueError, match="self-edge"):
        pkg.dag_edges(pkg.ExplicitDAG(edges=((3, 3),)), 8)
    with pytest.raises(ValueError, match="outside"):
        pkg.dag_edges(pkg.ExplicitDAG(edges=((0, 9),)), 8)
    with pytest.raises(ValueError, match="width"):
        pkg.dag_edges(pkg.FanOutDAG(width=0), 8)
    with pytest.raises(ValueError, match="≥ 0"):
        pkg.dag_edges(pkg.ExplicitDAG(edges=((0, 1, -1.0),)), 8)
    with pytest.raises(TypeError, match="unknown DAG spec"):
        pkg.dag_edges(object(), 8)


# ----------------------------------------------------- the frontier loop

@pytest.mark.parametrize("dyn", ("none", "outages"))
@pytest.mark.parametrize("loc", tuple(LOCALITY))
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("spec", SPECS)
def test_simulate_dag_matches_jax(spec, policy, loc, dyn, inputs):
    ref, got = _run_pair(inputs, policy, spec, loc,
                         _outages(inputs) if dyn == "outages" else None)
    assert_same(ref, got)


@pytest.mark.parametrize("spec", SPECS)
def test_gamma_zero_is_no_model(spec, inputs):
    """γ = 0 adds +0.0 to every score: bit-identical to no model."""
    cfg = tsim.EngineConfig(policy="dodoor", b=16)
    plain = tsim.simulate(inputs["twl"], inputs["ttb"], cfg, device="cpu",
                          dag=_spec(tdags, spec))
    zero = tsim.simulate(inputs["twl"], inputs["ttb"],
                         cfg._replace(locality=tsim.LocalityModel(0.0)),
                         device="cpu", dag=_spec(tdags, spec))
    assert_same(plain, zero)


def test_locality_moves_placements_and_bytes(inputs):
    """γ > 0 changes placements and moves fewer parent bytes."""
    spec = _spec(tdags, "fanout")
    cfg = tsim.EngineConfig(policy="dodoor", b=16)
    base = tsim.simulate(inputs["twl"], inputs["ttb"], cfg, device="cpu",
                         dag=spec)
    loc = tsim.simulate(inputs["twl"], inputs["ttb"],
                        cfg._replace(locality=tsim.LocalityModel(5.0)),
                        device="cpu", dag=spec)
    plan = tdags.dag_plan(spec, M)
    assert (loc.server != base.server).any()
    assert (tsim.dag_stats(loc, plan)["bytes_moved_mb"]
            < tsim.dag_stats(base, plan)["bytes_moved_mb"])


@pytest.mark.parametrize("policy", POLICIES)
def test_edgeless_dag_is_the_plain_run(policy, inputs):
    cfg = tsim.EngineConfig(policy=policy, b=16)
    plain = tsim.simulate(inputs["twl"], inputs["ttb"], cfg, device="cpu")
    edgeless = tsim.simulate(inputs["twl"], inputs["ttb"], cfg,
                             device="cpu", dag=tdags.ExplicitDAG())
    assert_same(plain, edgeless)


@pytest.mark.parametrize("spec", ("fanout", "mapreduce", "layered",
                                  "explicit"))
def test_ready_set_rule(spec, inputs):
    """No task starts before a parent's finish plus the edge delay, and
    ``submit_ms`` is the ready-set rule's value, computed in float64."""
    res = tsim.simulate(inputs["twl"], inputs["ttb"],
                        tsim.EngineConfig(policy="dodoor", b=16),
                        device="cpu", dag=_spec(tdags, spec))
    plan = tdags.dag_plan(_spec(tdags, spec), M)
    for t in range(M):
        lo, hi = plan.par_indptr[t], plan.par_indptr[t + 1]
        gate = max((np.float64(res.finish_ms[p]) + np.float64(d)
                    for p, d in zip(plan.par_idx[lo:hi],
                                    plan.par_delay[lo:hi])),
                   default=-np.inf)
        assert res.submit_ms[t] == np.float32(
            max(np.float64(inputs["twl"].submit_ms[t]), gate))
        assert res.start_ms[t] >= res.submit_ms[t]


def test_run_scenario_with_a_dag(inputs):
    spec = _spec(tdags, "mapreduce")
    cfg = tsim.EngineConfig(policy="dodoor", b=16,
                            locality=tsim.LocalityModel(2.0))
    direct = tsim.simulate(inputs["twl"], inputs["ttb"], cfg, device="cpu",
                           dag=spec)
    via = tsim.run_scenario(inputs["twl"], inputs["ttb"],
                            tsim.Scenario("mr", dag=spec), cfg,
                            device="cpu")
    assert_same(direct, via)


def test_routing_errors_match_the_reference(inputs):
    """locality without a dag, dag with retries, bad LocalityModels."""
    twl, ttb = inputs["twl"], inputs["ttb"]
    with pytest.raises(ValueError, match="needs a dag"):
        tsim.simulate(twl, ttb, tsim.EngineConfig(
            locality=tsim.LocalityModel()), device="cpu")
    with pytest.raises(NotImplementedError,
                       match="dag together with a RetryPolicy"):
        tsim.simulate(twl, ttb, tsim.EngineConfig(retry=tsim.RetryPolicy()),
                      device="cpu", dag=tdags.ChainDAG())
    with pytest.raises(ValueError, match="gamma"):
        tsim.simulate(twl, ttb, tsim.EngineConfig(
            locality=tsim.LocalityModel(gamma=-1.0)), device="cpu",
            dag=tdags.ExplicitDAG())
    with pytest.raises(ValueError, match="bandwidth"):
        tsim.simulate(twl, ttb, tsim.EngineConfig(locality=tsim.LocalityModel(
            bandwidth_mb_per_ms=0.0)), device="cpu", dag=tdags.ExplicitDAG())
    with pytest.raises(TypeError, match="LocalityModel"):
        tsim.simulate(twl, ttb, tsim.EngineConfig(locality=1.0),
                      device="cpu", dag=tdags.ExplicitDAG())
    assert tsim.LocalityModel(3.0, 2.0).gamma_bw == 1.5


# ---------------------------------------------------------- DAG metrics

@pytest.mark.parametrize("spec", SPECS)
def test_dag_metrics_match_reference(spec, inputs):
    ref, got = _run_pair(inputs, "dodoor", spec, "gamma2")
    jplan = jdags.dag_plan(_spec(jdags, spec), M)
    tplan = tdags.dag_plan(_spec(tdags, spec), M)
    assert tsim.dag_stats(got, tplan) == jsim.dag_stats(ref, jplan)
    assert tsim.summarize_dag(got, tplan) == jsim.summarize_dag(ref, jplan)
    with pytest.raises(ValueError, match="plan built for"):
        tsim.dag_stats(got, tdags.dag_plan(tdags.ChainDAG(), 100))


# --------------------------------------------------- K3: the plain version

def _parents(T, N, P, seed):
    """psrv in [−1, N) with about a quarter −1 pads, and non-integer MB
    (0 at the pads)."""
    rng = np.random.RandomState(seed)
    psrv = rng.randint(0, N, (T, P)).astype(np.int32)
    psrv[rng.rand(T, P) < 0.25] = -1
    pbytes = rng.uniform(0.1, 9.0, (T, P)).astype(np.float32)
    pbytes[psrv < 0] = 0.0
    # A few parents on the candidates' likely servers (the first ones of
    # the fleet): some penalties are partial.
    psrv[:, 0] = rng.randint(0, min(N, 4), T)
    return psrv, pbytes


GAMMA_BW = float(np.float32(0.7 / 1.3))


@jax.jit
def _two_stage_locality(keys, r, d_types, node_type, L, D, C, alpha,
                        psrv, pbytes, gamma_bw, avail):
    """The engine's two-stage locality branch (engine.py, ``elif
    locality:``), compiled."""
    mask = jcore.feasible_mask(r, C) & avail
    cand2 = jcore.sample_feasible_batch(keys, mask, 2)
    tt = jnp.arange(r.shape[0])
    d_cand = d_types[tt[:, None], node_type[cand2]]
    scores = jcore.load_score_batched(r, L[cand2], D[cand2] + d_cand,
                                      C[cand2], alpha)
    rem = jnp.sum(pbytes[:, None, :]
                  * (psrv[:, None, :] != cand2[:, :, None]
                     ).astype(jnp.float32), axis=-1)
    scores = scores + gamma_bw * rem
    two = jnp.where(scores[:, 0] > scores[:, 1], cand2[:, 1], cand2[:, 0])
    return two, cand2, scores


@pytest.mark.parametrize("masked", (False, True), ids=("K1", "K2"))
@pytest.mark.parametrize("P", (1, 8, 33, 64, 65, 100))
def test_locality_plain_version_matches_jax_two_stage(P, masked):
    """Hazard P3: the P-wide sum in the reference's row order (padded
    32-wide windows past 32 parents), and the penalty one fused
    multiply-add after the α-mix — scores exact."""
    T, N = 137, 100
    host = _inputs(T, N, seed=P, infeasible=(2,))
    psrv, pbytes = _parents(T, N, P, seed=P + 1)
    win, now = _windows(T, N, seed=P + 2, all_down_rows=(5,))
    avail = (np.asarray(jeng._avail_rows(win, now)) if masked
             else np.ones((T, N), bool))
    ref = _two_stage_locality(host[0].astype(np.uint32), *host[1:],
                              jnp.float32(0.5), psrv, pbytes,
                              jnp.float32(GAMMA_BW), avail)
    kw = (dict(down0=torch.from_numpy(np.array(win.down0)),
               down1=torch.from_numpy(np.array(win.down1)),
               now=torch.from_numpy(now)) if masked else {})
    got = dodoor_fused_sparse(*(torch.from_numpy(a) for a in host),
                              alpha=0.5, psrv=torch.from_numpy(psrv),
                              pbytes=torch.from_numpy(pbytes),
                              gamma_bw=0.7 / 1.3, **kw)
    for a, b in zip(ref, got):
        assert np.array_equal(np.asarray(a), b.numpy())
    # The penalty is not vacuous: it moved scores and some choices.
    base = dodoor_fused_sparse(*(torch.from_numpy(a) for a in host),
                               alpha=0.5, **kw)
    assert not torch.equal(got[2], base[2])


@pytest.mark.parametrize("masked", (False, True), ids=("K1", "K2"))
def test_locality_gamma_zero_equals_the_kernel_without_it(masked):
    T, N, P = 64, 100, 8
    host = tuple(torch.from_numpy(a) for a in _inputs(T, N, seed=4,
                                                      infeasible=(0,)))
    psrv, pbytes = (torch.from_numpy(a) for a in _parents(T, N, P, seed=5))
    kw = {}
    if masked:
        win, now = _windows(T, N, seed=6)
        kw = dict(down0=torch.from_numpy(np.array(win.down0)),
                  down1=torch.from_numpy(np.array(win.down1)),
                  now=torch.from_numpy(now))
    got = dodoor_fused_sparse(*host, psrv=psrv, pbytes=pbytes, gamma_bw=0.0,
                              **kw)
    want = dodoor_fused_sparse(*host, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_locality_wrapper_checks_its_operands():
    host = tuple(torch.from_numpy(a) for a in _inputs(4, 100, seed=2))
    psrv, pbytes = (torch.from_numpy(a) for a in _parents(4, 100, 8, 3))
    with pytest.raises(ValueError, match="together"):
        dodoor_fused_sparse(*host, psrv=psrv)
    with pytest.raises(ValueError, match="several devices"):
        dodoor_fused_sparse(*host, psrv=psrv, pbytes=pbytes.to("meta"))
    LAUNCHES.clear()
    dodoor_fused_sparse(*host, psrv=psrv, pbytes=pbytes, gamma_bw=1.0)
    assert sum(LAUNCHES.values()) == 0               # the CPU launches none


# ------------------------------------------------------- K3 on the card

@pytest.mark.gpu
@pytest.mark.parametrize("masked", (False, True), ids=("K1", "K2"))
@pytest.mark.parametrize("T,N,P", [(50, 100, 8), (50, 100, 40),
                                   (50, 100, 100), (500, 10_000, 8)])
def test_cuda_locality_kernel_matches_plain_version(T, N, P, masked):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU form)")
    host = [torch.from_numpy(a) for a in _inputs(T, N, seed=T + N,
                                                 infeasible=(0,))]
    extra = dict(zip(("psrv", "pbytes"),
                     (torch.from_numpy(a) for a in _parents(T, N, P, 7))))
    if masked:
        win, now = _windows(T, N, seed=N, all_down_rows=(1, 2))
        extra.update(down0=torch.from_numpy(np.array(win.down0)),
                     down1=torch.from_numpy(np.array(win.down1)),
                     now=torch.from_numpy(now))
    LAUNCHES.clear()
    got = dodoor_fused_sparse(*(t.cuda() for t in host), alpha=0.5,
                              gamma_bw=GAMMA_BW,
                              **{k: v.cuda() for k, v in extra.items()})
    torch.cuda.synchronize()
    name = ("dodoor_fused_sparse_masked_locality" if masked
            else "dodoor_fused_sparse_locality")
    assert LAUNCHES[name] == 1
    want = dodoor_fused_sparse_ref(*host, alpha=0.5, gamma_bw=GAMMA_BW,
                                   **extra)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
