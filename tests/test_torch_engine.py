"""The port's batched Dodoor driver against the JAX reference's two-stage
batched driver (``use_kernel=False``) on the CPU: placements, the
four-field message ledger and every timestamp bit-exact; the carry handed
across mid-run; bad inputs refused with the reference's errors."""
import numpy as np
import pytest

from _reference_cache import no_persistent_compile_cache  # noqa: F401

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import repro.sim as jsim  # noqa: E402
from repro.sim import engine as jeng  # noqa: E402
import repro_torch.sim as tsim  # noqa: E402
from repro_torch.sim import engine as teng  # noqa: E402
from repro_torch.workloads import azure as taz  # noqa: E402
from repro_torch.workloads import functionbench as tfb  # noqa: E402
from test_engine_batched import assert_parity  # noqa: E402

POLICIES = ("dodoor", "random", "one_plus_beta")
BLOCKS = (10, 1, 7, 160, 1000)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU runs are many tiny ops; a thread pool only adds
    overhead to them (and contends with the other test workers)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="session")
def torch_inputs():
    """The port's own copies of the session workloads and the 20-node
    testbed (array-equal to the reference's, see test_torch_core)."""
    return {"fb": tfb.synthesize(m=600, qps=60.0, seed=0),
            "azure": taz.synthesize(m=400, qps=4.0, seed=0),
            "testbed": tsim.make_testbed(scale=0.2)}


def _cfgs(policy, b):
    fe = 1 if b == 1 else 2
    return (jsim.EngineConfig(policy=policy, b=b, flush_every=fe),
            tsim.EngineConfig(policy=policy, b=b, flush_every=fe))


@pytest.mark.parametrize("b", BLOCKS)
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("trace", ["fb", "azure"])
def test_matches_jax_batched_driver(trace, policy, b, fb_small, azure_small,
                                    small_testbed, sim_cache, torch_inputs):
    jwl = fb_small if trace == "fb" else azure_small
    jcfg, tcfg = _cfgs(policy, b)
    ref = sim_cache(jwl, small_testbed, jcfg, mode="batched",
                    use_kernel=False, key=trace)
    got = tsim.simulate(torch_inputs[trace], torch_inputs["testbed"], tcfg,
                        device="cpu")
    assert got.server.dtype == np.int32
    assert_parity(ref, got, timestamps_exact=True)
    if b == 1000:
        assert got.msgs_push == 0          # never reaches the b-th decision


@pytest.mark.parametrize("alpha", [0.3, 0.9])
def test_matches_jax_off_default_alpha(alpha, fb_small, small_testbed,
                                       torch_inputs):
    """α ≠ 0.5 exercises the score's fused multiply-add rounding."""
    jcfg = jsim.EngineConfig(policy="dodoor", b=10, alpha=alpha)
    tcfg = tsim.EngineConfig(policy="dodoor", b=10, alpha=alpha)
    ref = jsim.simulate(fb_small, small_testbed, jcfg, mode="batched",
                        use_kernel=False)
    got = tsim.simulate(torch_inputs["fb"], torch_inputs["testbed"], tcfg,
                        device="cpu")
    assert_parity(ref, got, timestamps_exact=True)


@pytest.mark.parametrize("trace", ["azure", "functionbench"])
def test_matches_jax_at_smoke_testbed_size(trace, testbed):
    """The configuration ``chip_smoke.py`` runs on the card and compares
    with the port's CPU run: the paper's 100-server testbed, m=4000,
    b=50.  Equal to the reference here, the CPU run is a valid stand-in
    for it on the card, which has no JAX."""
    from repro.workloads import azure as jaz
    from repro.workloads import functionbench as jfb

    if trace == "azure":
        jwl, twl = (jaz.synthesize(m=4000, qps=10.0),
                    taz.synthesize(m=4000, qps=10.0))
    else:
        jwl, twl = (jfb.synthesize(m=4000, qps=300.0),
                    tfb.synthesize(m=4000, qps=300.0))
    ref = jsim.simulate(jwl, testbed, jsim.EngineConfig(policy="dodoor",
                                                         b=50),
                        mode="batched", use_kernel=False)
    got = tsim.simulate(twl, tsim.make_testbed(),
                        tsim.EngineConfig(policy="dodoor", b=50),
                        device="cpu")
    assert_parity(ref, got, timestamps_exact=True)


def _jax_run(wl, cluster, cfg, xs, seed=0, carry0=None):
    n = cluster.num_servers
    C, nt, cores_per, mem_unit = jeng._cluster_arrays(cluster, cfg.mem_units)
    return jeng._simulate_batched_jax(
        xs, C, nt, mem_unit, cores_per, jeng._make_dyn(cfg),
        jeng._make_dyn_ints(cfg), jeng._lower_dynamics(None, n),
        jeng._static_cfg(cfg, keep_b=True), n, cluster.num_types, seed,
        False, carry0=carry0, return_carry=True)


@pytest.mark.parametrize("trace,policy,b,k", [
    ("fb", "dodoor", 10, 23), ("azure", "one_plus_beta", 7, 19),
    ("fb", "random", 7, 40)])
def test_carry_handed_across_mid_run(trace, policy, b, k, fb_small,
                                     azure_small, small_testbed,
                                     torch_inputs):
    """JAX runs the first k blocks; its carry goes through
    ``carry_from_numpy``; the port runs the rest.  The port's carry after
    k blocks equals JAX's leaf for leaf, and the continued outputs and
    ledger equal the JAX full run's."""
    jwl = fb_small if trace == "fb" else azure_small
    jcfg, tcfg = _cfgs(policy, b)
    xs = jeng._blocked_inputs(jwl, b)
    j_full_carry, j_full = _jax_run(jwl, small_testbed, jcfg, xs)
    j_carry, _ = _jax_run(jwl, small_testbed, jcfg,
                          tuple(x[:k] for x in xs))
    leaves = {f: np.asarray(v) for f, v in j_carry._asdict().items()
              if v is not None}

    ctx = teng._make_ctx(torch_inputs["testbed"], tcfg, 0, "cpu")
    t_xs = teng._blocked_inputs(torch_inputs[trace], b, "cpu")
    t_carry, _ = teng._simulate_batched(tuple(x[:k] for x in t_xs), ctx,
                                        return_carry=True)
    mine = tsim.carry_to_numpy(t_carry)
    assert set(mine) == set(leaves)
    for f, v in leaves.items():
        assert mine[f].dtype == v.dtype and np.array_equal(mine[f], v), f

    carry0 = tsim.carry_from_numpy(leaves, device="cpu")
    t_end, t_rest = teng._simulate_batched(tuple(x[k:] for x in t_xs), ctx,
                                           carry0=carry0, return_carry=True)
    for ref, got in zip(j_full, t_rest):
        assert np.array_equal(np.asarray(ref)[k:], got.numpy())
    assert np.array_equal(np.asarray(j_full_carry.msgs), t_end.msgs.numpy())


def test_carry_numpy_round_trip(torch_inputs):
    cfg = tsim.EngineConfig(policy="dodoor", b=10)
    ctx = teng._make_ctx(torch_inputs["testbed"], cfg, 0, "cpu")
    xs = teng._blocked_inputs(torch_inputs["fb"], 10, "cpu")
    carry, _ = teng._simulate_batched(tuple(x[:5] for x in xs), ctx,
                                      return_carry=True)
    leaves = tsim.carry_to_numpy(carry)
    back = tsim.carry_from_numpy(leaves, device="cpu")
    for f, v in leaves.items():
        assert np.array_equal(getattr(back, f).numpy(), v)
    with pytest.raises(KeyError, match="msgs"):
        tsim.carry_from_numpy({k: v for k, v in leaves.items()
                               if k != "msgs"})


def test_summary_matches_reference(fb_small, small_testbed, sim_cache,
                                   torch_inputs):
    jcfg, tcfg = _cfgs("dodoor", 10)
    ref = sim_cache(fb_small, small_testbed, jcfg, mode="batched",
                    use_kernel=False, key="fb")
    got = tsim.simulate(torch_inputs["fb"], torch_inputs["testbed"], tcfg,
                        device="cpu")
    assert tsim.summarize(got) == jsim.summarize(ref)
    assert tsim.resource_violations(got, torch_inputs["testbed"]) == 0


@pytest.mark.parametrize("slots", (40, 100))
def test_matches_jax_at_ring_widths_off_32(slots, fb_small, small_testbed,
                                           torch_inputs):
    """A ring buffer whose width is no multiple of 32 is summed in the
    reference's padded-window order."""
    ref = jsim.simulate(fb_small, small_testbed,
                        jsim.EngineConfig(policy="dodoor", b=10,
                                          rbuf_slots=slots),
                        mode="batched", use_kernel=False)
    got = tsim.simulate(torch_inputs["fb"], torch_inputs["testbed"],
                        tsim.EngineConfig(policy="dodoor", b=10,
                                          rbuf_slots=slots), device="cpu")
    assert_parity(ref, got, timestamps_exact=True)


#: Inputs of the retry, dag and locality paths (ported) that the
#: reference refuses: (config kwargs, call kwargs, error, message).
BAD_INPUTS = [
    (dict(retry=object()), dict(), TypeError, "RetryPolicy"),
    (dict(), dict(dag=object()), TypeError, "unknown DAG spec"),
    (dict(locality="LocalityModel"), dict(), ValueError, "needs a dag"),
]


@pytest.mark.parametrize("cfg_kw,call_kw,error,match", BAD_INPUTS,
                         ids=("retry", "dag", "locality"))
def test_bad_inputs_raise_the_reference_error(cfg_kw, call_kw, error, match,
                                              fb_small, small_testbed,
                                              torch_inputs):
    """A retry policy that is not one, a dag that is no spec, and a
    LocalityModel without a dag raise the reference's error."""
    def config(pkg):
        kw = {k: (pkg.LocalityModel() if v == "LocalityModel" else v)
              for k, v in cfg_kw.items()}
        return pkg.EngineConfig(**kw)

    with pytest.raises(error, match=match):
        jsim.simulate(fb_small, small_testbed, config(jsim), mode="batched",
                      use_kernel=False, **call_kw)
    with pytest.raises(error, match=match):
        tsim.simulate(torch_inputs["fb"], torch_inputs["testbed"],
                      config(tsim), device="cpu", **call_kw)


def test_bad_config_rejected(torch_inputs):
    for kw in (dict(b=0), dict(flush_every=9, b=10), dict(rbuf_slots=0),
               dict(policy="nope")):
        with pytest.raises(ValueError):
            tsim.simulate(torch_inputs["fb"], torch_inputs["testbed"],
                          tsim.EngineConfig(**kw), device="cpu")


def test_default_device_is_the_gpu(torch_inputs):
    cfg = tsim.EngineConfig(policy="dodoor", b=10)
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsim.simulate(torch_inputs["fb"], torch_inputs["testbed"], cfg)


@pytest.mark.gpu
@pytest.mark.parametrize("policy", POLICIES)
def test_cuda_run_matches_cpu_run(policy, torch_inputs):
    """On the card: one kernel launch per block, and the CPU run's
    placements and ledger (a near-tie flip aside)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU form)")
    from repro_torch.kernels.dodoor_choice import LAUNCHES

    cfg = tsim.EngineConfig(policy=policy, b=10)
    LAUNCHES.clear()
    gpu = tsim.simulate(torch_inputs["fb"], torch_inputs["testbed"], cfg,
                        device="cuda")
    blocks = 60 if policy != "random" else 0
    assert LAUNCHES["dodoor_fused_sparse"] == blocks
    cpu = tsim.simulate(torch_inputs["fb"], torch_inputs["testbed"], cfg,
                        device="cpu")
    assert (gpu.msgs_base, gpu.msgs_push, gpu.msgs_flush) == (
        cpu.msgs_base, cpu.msgs_push, cpu.msgs_flush)
    assert np.array_equal(gpu.server, cpu.server)
