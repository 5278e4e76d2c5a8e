"""The port's batched driver for the probing baselines — PoT's speculative
commit and Prequal's segment scan — against the reference's batched
driver (``mode="batched", use_kernel=False``) on the CPU: placements, the
four-field message ledger and all six planes bit for bit, at every
PoT/Prequal configuration of ``tests/test_engine_batched.py`` (ragged
tails, the high- and low-conflict PoT fleets, Prequal's colliding
5-server fleet, ``b > m`` and chunks that straddle scheduler rounds),
under outages, churn, stragglers and store outages, at the fault
benchmark's smoke message point with retries, and on a chain and a
map-reduce graph under a LocalityModel; and a committed PoT prefix never
places two tasks on one server."""
import numpy as np
import pytest

from _reference_cache import no_persistent_compile_cache  # noqa: F401

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import repro.sim as jsim  # noqa: E402
from repro.workloads import dags as jdags  # noqa: E402
from repro.workloads import functionbench as jfb  # noqa: E402
import repro_torch.sim as tsim  # noqa: E402
from repro_torch.sim import engine as teng  # noqa: E402
from repro_torch.workloads import dags as tdags  # noqa: E402
from repro_torch.workloads import functionbench as tfb  # noqa: E402
from test_torch_sequential import _check, _dynamics, _pair  # noqa: E402

PROBING = ("pot", "prequal")


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


def _run(jwl, twl_, jcl, tcl, policy, *, seed=0, jdyn=None, tdyn=None,
         jdag=None, tdag=None, **kw):
    """Both batched drivers on one input; the port's result."""
    def cfg(pkg):
        k = dict(kw)
        for name in ("retry", "locality"):
            if callable(k.get(name)):
                k[name] = k[name](pkg)
        return pkg.EngineConfig(policy=policy, **k)

    ref = jsim.simulate(jwl, jcl, cfg(jsim), seed, mode="batched",
                        use_kernel=False, dynamics=jdyn, dag=jdag)
    got = tsim.simulate(twl_, tcl, cfg(tsim), seed, mode="batched",
                        device="cpu", dynamics=tdyn, dag=tdag)
    _check(ref, got)
    return got


def _homogeneous(n, m, qps, seed):
    """(reference workload, port workload, reference fleet, port fleet)."""
    return (jfb.synthesize(m=m, qps=qps, seed=seed),
            tfb.synthesize(m=m, qps=qps, seed=seed),
            jsim.make_homogeneous(n, cores=28, mem_mb=128_000),
            tsim.make_homogeneous(n, cores=28, mem_mb=128_000))


@pytest.mark.parametrize("b", [7, 160])
@pytest.mark.parametrize("policy", PROBING)
def test_ragged_tail(policy, b, fb_small, small_testbed, twl):
    """b ∤ m: the padded tail is inert in the speculative loop and in the
    segment scan."""
    got = _run(fb_small, twl[0], small_testbed, twl[1], policy, b=b)
    assert got.msgs_push == got.msgs_flush == 0


@pytest.mark.parametrize("policy,case,b", [
    ("pot", (4, 288, 120.0, 3), 48),     # nearly every task conflicts
    ("pot", (100, 400, 100.0, 5), 20),   # conflicts are rare
    ("prequal", (5, 300, 100.0, 7), 30),  # same-chunk commits hit probes
], ids=["pot-4-servers", "pot-100-servers", "prequal-5-servers"])
def test_conflict_spectrum(policy, case, b):
    jwl, twl_, jcl, tcl = _homogeneous(*case)
    _run(jwl, twl_, jcl, tcl, policy, b=b)


@pytest.mark.parametrize("policy,b", [("pot", 1), ("prequal", 1000),
                                      ("prequal", 8)])
def test_block_edges(policy, b, fb_small, small_testbed, twl):
    """b = 1 (a block of one: never a conflict), b > m (one partial
    block), b = 8 with S = 5 (chunks straddle scheduler rounds, so pool
    state carries across blocks)."""
    _run(fb_small, twl[0], small_testbed, twl[1], policy, b=b)


def test_prequal_ring_width_off_32(fb_small, small_testbed, twl):
    """The probes' duration sum over a ring of 40 slots, in the
    reference's padded-window order."""
    _run(fb_small, twl[0], small_testbed, twl[1], "prequal", b=10,
         rbuf_slots=40)


@pytest.mark.parametrize("kind", ["outages", "churn", "stragglers",
                                  "store_outages", "all"])
@pytest.mark.parametrize("policy", PROBING)
def test_under_dynamics(policy, kind, fb_small, small_testbed, twl):
    """Masked candidates, Prequal's pool and probes skipping down servers,
    gated starts, stretched durations; a store outage changes nothing for
    policies without a data store."""
    H = float(fb_small.submit_ms[-1])
    kinds = (("outages", "churn", "stragglers", "store_outages")
             if kind == "all" else (kind,))
    pairs = [_dynamics(k, 20, H) for k in kinds]
    jd = pairs[0][0].merge(*(p[0] for p in pairs[1:]))
    td = pairs[0][1].merge(*(p[1] for p in pairs[1:]))
    _run(fb_small, twl[0], small_testbed, twl[1], policy, b=10, jdyn=jd,
         tdyn=td)


@pytest.mark.parametrize("policy", PROBING)
def test_message_point_smoke(policy, small_testbed, twl):
    """``bench_faults.main(smoke=True)``'s message point (m = 600 at 30
    qps, 5 outages, the default RetryPolicy, b = 10) in the batched
    driver, as the benchmark runs it: kills and resubmission waves."""
    jwl = jfb.synthesize(m=600, qps=30.0, seed=0)
    twl_ = tfb.synthesize(m=600, qps=30.0, seed=0)
    H = float(jwl.submit_ms[-1])
    jd, td = _pair("random_outages", 20, 5, 0.6 * H, mean_down_ms=0.15 * H,
                   seed=7)
    got = _run(jwl, twl_, small_testbed, twl[1], policy, b=10, jdyn=jd,
               tdyn=td, retry=lambda p: p.RetryPolicy())
    assert got.attempts.max() > 1


@pytest.fixture(scope="module")
def dag_inputs():
    return (jfb.synthesize(m=80, qps=60.0, seed=1),
            tfb.synthesize(m=80, qps=60.0, seed=1))


@pytest.mark.parametrize("shape", ["chain", "map_reduce"])
@pytest.mark.parametrize("policy", PROBING)
def test_dag_with_locality(policy, shape, dag_inputs, small_testbed, twl):
    """The frontier loop's waves (each restarting the round robin) with
    the locality planes riding along, which PoT and Prequal ignore."""
    if shape == "chain":
        spec = dict(edge_delay_ms=2.0, edge_bytes_mb=16.0)
        jdag, tdag = jdags.ChainDAG(**spec), tdags.ChainDAG(**spec)
    else:
        spec = dict(mappers=8, reducers=2, edge_bytes_mb=4.0)
        jdag, tdag = jdags.MapReduceDAG(**spec), tdags.MapReduceDAG(**spec)
    _run(dag_inputs[0], dag_inputs[1], small_testbed, twl[1], policy, b=10,
         locality=lambda p: p.LocalityModel(gamma=2.0), jdag=jdag,
         tdag=tdag)


def test_pot_prefixes_place_on_distinct_servers(monkeypatch):
    """Every prefix PoT commits in one round has pairwise distinct
    servers, and the high-conflict fleet needs many prefixes a block."""
    _, wl, _, cl = _homogeneous(4, 288, 120.0, 3)
    commit = teng._commit_servers
    prefixes = []

    def recording(carry, valid, now, j, *args):
        jv = j[valid].tolist()
        assert len(set(jv)) == len(jv), jv
        prefixes.append(len(jv))
        return commit(carry, valid, now, j, *args)

    monkeypatch.setattr(teng, "_commit_servers", recording)
    tsim.simulate(wl, cl, tsim.EngineConfig(policy="pot", b=48),
                  device="cpu")
    assert sum(prefixes) == 288
    assert len(prefixes) > 3 * 288 // 48


@pytest.mark.gpu
@pytest.mark.parametrize("policy", PROBING)
def test_cuda_batched_matches_cpu(policy, twl):
    """On the card: PoT and Prequal launch no kernel, and equal the CPU
    run bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.dodoor_choice import LAUNCHES

    wl, cl = twl
    cfg = tsim.EngineConfig(policy=policy, b=10)
    LAUNCHES.clear()
    gpu = tsim.simulate(wl, cl, cfg, device="cuda")
    assert not dict(LAUNCHES)
    _check(tsim.simulate(wl, cl, cfg, device="cpu"), gpu)
