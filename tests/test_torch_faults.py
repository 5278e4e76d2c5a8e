"""The port's failure layer against the JAX reference on the CPU: the
retry re-entry wave loop (kill at a gate window's open, hard-capacity
rejection, backoff, permanent failure) bit-exact against the reference's
two-stage batched driver (``use_kernel=False``) for random, dodoor and
(1+β), including ``attempts``, ``failed`` and ``wasted_ms``; the recovery
metrics; and the reference's validation errors.

Every comparison is exact (tolerance 0)."""
import numpy as np
import pytest

from _reference_cache import no_persistent_compile_cache  # noqa: F401

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import repro.sim as jsim  # noqa: E402
from repro.sim import scenarios as jsc  # noqa: E402
from repro.workloads import functionbench as jfb  # noqa: E402
import repro_torch.sim as tsim  # noqa: E402
from repro_torch.workloads import functionbench as tfb  # noqa: E402

POLICIES = ("random", "dodoor", "one_plus_beta")
#: The retry policies of ``benchmarks/bench_faults.py:39-41`` and a
#: hard-capacity one.
RETRIES = {"default": {},
           "aggressive": dict(max_attempts=5, backoff_ms=50.0,
                              backoff_mult=1.5),
           "reject2": dict(reject_queue_factor=2.0)}


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
    jwl = jfb.synthesize(m=240, qps=30.0, seed=0)
    return dict(jwl=jwl, twl=tfb.synthesize(m=240, qps=30.0, seed=0),
                jburst=jfb.synthesize(m=300, qps=200.0, seed=0),
                tburst=tfb.synthesize(m=300, qps=200.0, seed=0),
                jtb=jsim.make_testbed(scale=0.2),
                ttb=tsim.make_testbed(scale=0.2),
                H=float(jwl.submit_ms[-1]))


def _dynamics(name: str, n: int, H: float):
    """A reference Dynamics spec by name: outages that kill running
    tasks, churn with joins (start gates opening at t = 0) and leaves,
    and stragglers (no kills: retries must then change nothing)."""
    if name == "outages":
        return jsc.random_outages(n, 6, 0.6 * H, mean_down_ms=0.2 * H,
                                  seed=7)
    if name == "churn":
        return jsc.random_churn(n, 0.15, 0.3, H, seed=11).merge(
            jsim.Dynamics(joins=((1, 0.3 * H), (4, 0.5 * H))))
    if name == "stragglers":
        return jsc.random_stragglers(n, 6, H, mean_slow_ms=0.3 * H,
                                     mult=4.0, seed=3)
    raise KeyError(name)


def _to_torch(d):
    return None if d is None else tsim.Dynamics(**d._asdict())


def assert_fault_parity(ref, got):
    assert np.array_equal(ref.server, got.server), "placements diverge"
    for f in ("submit_ms", "enqueue_ms", "start_ms", "finish_ms",
              "sched_ms", "cores", "mem_mb", "attempts", "failed",
              "wasted_ms"):
        a, b = getattr(ref, f), getattr(got, f)
        if a is None:
            assert b is None, f
        else:
            assert a.dtype == b.dtype and np.array_equal(a, b), f
    ledger = lambda r: (r.msgs_base, r.msgs_probe, r.msgs_push,
                        r.msgs_flush)
    assert ledger(ref) == ledger(got), "message ledger diverges"


def _run_pair(inputs, policy, retry, dyn, *, burst=False, b=16):
    jwl, twl = ((inputs["jburst"], inputs["tburst"]) if burst
                else (inputs["jwl"], inputs["twl"]))
    jr = None if retry is None else jsim.RetryPolicy(**retry)
    tr = None if retry is None else tsim.RetryPolicy(**retry)
    ref = jsim.simulate(jwl, inputs["jtb"],
                        jsim.EngineConfig(policy=policy, b=b, retry=jr),
                        mode="batched", use_kernel=False, dynamics=dyn)
    got = tsim.simulate(twl, inputs["ttb"],
                        tsim.EngineConfig(policy=policy, b=b, retry=tr),
                        device="cpu", dynamics=_to_torch(dyn))
    return ref, got


@pytest.mark.parametrize("dyn", ("outages", "churn", "stragglers"))
@pytest.mark.parametrize("retry", tuple(RETRIES))
@pytest.mark.parametrize("policy", POLICIES)
def test_retry_matches_jax(policy, retry, dyn, inputs):
    d = _dynamics(dyn, inputs["jtb"].num_servers, inputs["H"])
    ref, got = _run_pair(inputs, policy, RETRIES[retry], d)
    assert_fault_parity(ref, got)
    if dyn == "outages":
        assert (got.attempts > 1).any() and got.wasted_ms.sum() > 0.0


@pytest.mark.parametrize("policy", POLICIES)
def test_rejection_matches_jax(policy, inputs):
    """A 200 qps burst against a queue cap of 1.5 × cores: rejections,
    re-entries and their backoff, with no kill."""
    ref, got = _run_pair(inputs, policy,
                         dict(max_attempts=4, backoff_ms=50.0,
                              reject_queue_factor=1.5), None, burst=True)
    assert_fault_parity(ref, got)
    assert (got.attempts > 1).any() and (got.wasted_ms == 0.0).all()


@pytest.mark.parametrize("policy", POLICIES)
def test_permanent_failures_match_jax(policy, inputs):
    """Two attempts at a queue cap of 1 × cores under the 200 qps burst:
    tasks rejected twice fail for good, their finish the last reject
    time."""
    ref, got = _run_pair(inputs, policy,
                         dict(max_attempts=2, backoff_ms=5.0,
                              reject_queue_factor=1.0), None, burst=True)
    assert_fault_parity(ref, got)
    assert got.failed.any()


@pytest.mark.parametrize("policy", POLICIES)
def test_no_retry_is_unchanged(policy, inputs):
    """``retry=None`` keeps the recovery fields None; a policy that never
    fires changes no placement, time or message."""
    d = _dynamics("stragglers", inputs["jtb"].num_servers, inputs["H"])
    base = tsim.simulate(inputs["twl"], inputs["ttb"],
                         tsim.EngineConfig(policy=policy, b=16),
                         device="cpu", dynamics=_to_torch(d))
    assert base.attempts is None and base.failed is None \
        and base.wasted_ms is None
    inert = tsim.simulate(inputs["twl"], inputs["ttb"],
                          tsim.EngineConfig(policy=policy, b=16,
                                            retry=tsim.RetryPolicy()),
                          device="cpu", dynamics=_to_torch(d))
    assert (inert.attempts == 1).all() and not inert.failed.any()
    assert (inert.wasted_ms == 0.0).all()
    assert_fault_parity(base, inert._replace(attempts=None, failed=None,
                                             wasted_ms=None))


@pytest.mark.parametrize("retry", tuple(RETRIES))
def test_recovery_metrics_match_reference(retry, inputs):
    """``summarize`` (goodput, retries per task, wasted ms, failure rate),
    ``fault_stats``, ``time_to_recover_ms`` and a windowed summary."""
    d = _dynamics("outages", inputs["jtb"].num_servers, inputs["H"])
    ref, got = _run_pair(inputs, "dodoor", RETRIES[retry], d)
    assert tsim.summarize(got) == jsim.summarize(ref)
    assert tsim.fault_stats(got) == jsim.fault_stats(ref)
    assert tsim.time_to_recover_ms(got, _to_torch(d)) == \
        jsim.time_to_recover_ms(ref, d)
    H = inputs["H"]
    assert tsim.summarize_window(got, 0.2 * H, 0.6 * H) == \
        jsim.summarize_window(ref, 0.2 * H, 0.6 * H)
    s = tsim.summarize(got)
    assert s.goodput_tps < s.throughput_tps and s.retries_per_task > 0


def test_recovery_metrics_without_retries(inputs):
    ref, got = _run_pair(inputs, "dodoor", None, None)
    assert tsim.fault_stats(got) == jsim.fault_stats(ref)
    assert tsim.summarize(got).goodput_tps == \
        tsim.summarize(got).throughput_tps
    assert tsim.time_to_recover_ms(got, None) == 0.0


@pytest.mark.parametrize("bad,error", [
    (dict(max_attempts=0), ValueError),
    (dict(backoff_ms=-1.0), ValueError),
    (dict(backoff_mult=0.0), ValueError),
    ("aggressive", TypeError),
])
def test_bad_retry_policies_raise_as_the_reference(bad, error, inputs):
    for pkg, wl, tb, kw in ((jsim, inputs["jwl"], inputs["jtb"],
                             dict(mode="batched", use_kernel=False)),
                            (tsim, inputs["twl"], inputs["ttb"],
                             dict(device="cpu"))):
        retry = bad if isinstance(bad, str) else pkg.RetryPolicy(**bad)
        with pytest.raises(error):
            pkg.simulate(wl, tb, pkg.EngineConfig(policy="random", b=10,
                                                  retry=retry), **kw)
