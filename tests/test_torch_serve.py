"""The port's streaming decision service (``repro_torch.serve``) on the CPU:
bit-exact against the port's ``simulate(mode="batched")`` for all five
policies, in the closed and the open loop and under any chunking, with
dynamics; its streaming semantics (full blocks, the flush and result
gates, ring overflow, unsupported knobs, latency recorders, the
double-buffered snapshot); checkpoint and resume as a bit-exact
continuation, from its own checkpoint and from the JAX reference
service's; and the ring and latency classes against the reference's."""
import numpy as np
import pytest

from _reference_cache import no_persistent_compile_cache  # noqa: F401

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from hypothesis_compat import given, settings, st  # noqa: E402
import repro.serve as jserve  # noqa: E402
import repro.sim as jsim  # noqa: E402
from repro.workloads import functionbench as jfb  # noqa: E402
import repro_torch.sim as tsim  # noqa: E402
from repro_torch.serve import (ArrivalRing, DecisionService,  # noqa: E402
                               LatencyRecorder, serve_workload)
from repro_torch.workloads import functionbench as tfb  # noqa: E402

POLICIES = ("random", "pot", "dodoor", "prequal", "one_plus_beta")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


_CLUSTER = tsim.make_testbed(scale=0.2)
# 317 tasks: a ragged tail at every tested b, so flush() padding is always
# exercised.
_WL = tfb.synthesize(m=317, qps=60.0, seed=0)


@pytest.fixture(scope="module")
def cluster():
    return _CLUSTER


@pytest.fixture(scope="module")
def wl():
    return _WL


_OFFLINE: dict = {}


def _offline(wl, cluster, cfg, dynamics=None):
    """The port's batched driver on the CPU, once per configuration."""
    key = (id(wl), cfg, dynamics)
    if key not in _OFFLINE:
        _OFFLINE[key] = (wl, tsim.simulate(wl, cluster, cfg, device="cpu",
                                           dynamics=dynamics))
    return _OFFLINE[key][1]


def _cpu(cluster, cfg, **kw):
    return DecisionService(cluster, cfg, device="cpu", **kw)


def _assert_same(off, res, label=""):
    assert res.server.dtype == np.int32, label
    assert (off.server == res.server).all(), label
    for f in ("enqueue_ms", "start_ms", "finish_ms", "sched_ms",
              "cores", "mem_mb", "submit_ms"):
        assert np.array_equal(getattr(off, f), getattr(res, f)), (label, f)
    for f in ("msgs_base", "msgs_probe", "msgs_push", "msgs_flush"):
        assert getattr(off, f) == getattr(res, f), (label, f)


class TestOfflineParity:
    """The offline batched driver is the service's oracle."""

    @pytest.mark.parametrize("policy", POLICIES)
    @pytest.mark.parametrize("open_loop", [False, True])
    def test_all_policies_bit_exact(self, cluster, wl, policy, open_loop):
        cfg = tsim.EngineConfig(policy=policy, b=25)
        _, res = serve_workload(wl, cluster, cfg, seed=0, chunk=13,
                                open_loop=open_loop, device="cpu")
        _assert_same(_offline(wl, cluster, cfg), res, policy)

    @pytest.mark.parametrize("policy", ["dodoor", "pot", "prequal"])
    def test_dynamics_parity(self, cluster, wl, policy):
        """Down windows (masked draws, K2's path; Prequal's pools and
        probes skipping down servers), a straggler and a store outage."""
        H = float(wl.submit_ms[-1])
        dyn = tsim.Dynamics(outages=((3, 0.1 * H, 0.6 * H),
                                     (7, 0.2 * H, 0.9 * H)),
                            joins=((11, 0.3 * H),),
                            slowdowns=((4, 0.0, 0.5 * H, 2.0),),
                            store_outages=((0.4 * H, 0.7 * H),))
        cfg = tsim.EngineConfig(policy=policy, b=25)
        _, res = serve_workload(wl, cluster, cfg, seed=0, dynamics=dyn,
                                device="cpu")
        _assert_same(_offline(wl, cluster, cfg, dyn), res, policy)


class TestStreamingSemantics:
    def test_step_needs_full_block(self, cluster, wl):
        svc = _cpu(cluster, tsim.EngineConfig(policy="dodoor", b=25))
        svc.submit_workload(wl, 0, 10)
        with pytest.raises(ValueError, match="full block"):
            svc.step()
        assert svc.available == 10

    def test_flush_handles_ragged_tail_and_result_gate(self, cluster, wl):
        svc = _cpu(cluster, tsim.EngineConfig(policy="dodoor", b=25))
        with pytest.raises(ValueError, match="no decisions"):
            svc.result()
        svc.submit_workload(wl, 0, 60)
        assert svc.drain() == 50
        with pytest.raises(ValueError, match="flush"):
            svc.result()
        assert svc.flush() == 10
        assert svc.scheduled == 60
        assert svc.result().server.shape == (60,)

    def test_ring_overflow_raises(self, cluster, wl):
        svc = _cpu(cluster, tsim.EngineConfig(policy="dodoor", b=25),
                   capacity=30)
        with pytest.raises(RuntimeError, match="ring full"):
            svc.submit_workload(wl, 0, 31)

    @pytest.mark.parametrize("cfg_kw,dyn,error,match", [
        (dict(retry="RetryPolicy"), None, NotImplementedError,
         "RetryPolicy"),
        (dict(trace=True), None, NotImplementedError, "offline post-pass"),
        (dict(locality="LocalityModel"), None, NotImplementedError,
         "LocalityModel"),
        (dict(outage_ms=(1.0, 2.0)), None, ValueError, "deprecated"),
        (dict(), "not a spec", TypeError, "Dynamics spec"),
        (dict(policy="nope"), None, ValueError, "policy"),
    ], ids=["retry", "trace", "locality", "outage_ms", "dynamics",
            "policy"])
    def test_unsupported_knobs_raise(self, cluster, cfg_kw, dyn, error,
                                     match):
        kw = {k: ({"RetryPolicy": tsim.RetryPolicy(),
                   "LocalityModel": tsim.LocalityModel()}.get(v, v)
                  if isinstance(v, str) else v) for k, v in cfg_kw.items()}
        with pytest.raises(error, match=match):
            _cpu(cluster, tsim.EngineConfig(b=25, **kw), dynamics=dyn)

    def test_default_device_is_the_gpu(self, cluster):
        if torch.cuda.is_available():
            pytest.skip("a GPU is present: the default device is usable")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            DecisionService(cluster, tsim.EngineConfig(b=25))

    def test_latency_recorders_populate(self, cluster, wl):
        svc, _ = serve_workload(wl, cluster,
                                tsim.EngineConfig(policy="dodoor", b=25),
                                seed=0, device="cpu")
        m = wl.r_submit.shape[0]
        assert svc.decision_latency.count == m
        assert svc.step_wall.count == -(-m // 25)
        summ = svc.latency_summary()
        assert summ["decision"]["count"] == m
        assert summ["decision"]["p99_ms"] >= summ["decision"]["p50_ms"]
        hist = summ["step"]["histogram"]
        assert sum(hist["counts"]) == svc.step_wall.count
        assert len(hist["edges_ms"]) == len(hist["counts"]) + 1

    def test_snapshot_double_buffered(self, cluster, wl):
        svc = _cpu(cluster, tsim.EngineConfig(policy="dodoor", b=25))
        assert svc.snapshot() is None
        svc.submit_workload(wl, 0, 75)
        svc.step()
        s1 = svc.snapshot()
        view1 = s1["view_L"].copy()
        assert s1["step"] == 1
        svc.step()
        s2 = svc.snapshot()
        # the first snapshot buffer was not overwritten in place
        assert s2["step"] == 2 and s1["step"] == 1
        assert s1["view_L"].shape == (cluster.num_servers, 2)
        svc.step()
        assert s2["step"] == 2 and np.array_equal(s1["view_L"], view1)
        assert not np.array_equal(s1["view_L"], svc.snapshot()["view_L"])


class TestCheckpointResume:
    @pytest.mark.parametrize("policy", ["dodoor", "prequal"])
    def test_resume_is_bit_exact_continuation(self, cluster, wl, policy):
        cfg = tsim.EngineConfig(policy=policy, b=25)
        m = wl.r_submit.shape[0]
        cut = 150
        a = _cpu(cluster, cfg, capacity=m)
        a.submit_workload(wl, 0, cut)
        a.drain()
        ck = a.export_checkpoint()
        a.submit_workload(wl, cut, m)
        a.flush()
        uninterrupted = a.result()
        _assert_same(_offline(wl, cluster, cfg), uninterrupted, policy)

        b = DecisionService.from_checkpoint(cluster, cfg, ck, capacity=m,
                                            device="cpu")
        b.submit_workload(wl, cut, m)
        b.flush()
        resumed = b.result()
        done = ck["next_idx"]
        assert done == 150 and b.scheduled == a.scheduled == m
        assert (resumed.server == uninterrupted.server[done:]).all()
        for f in ("start_ms", "finish_ms", "enqueue_ms", "sched_ms"):
            assert np.array_equal(getattr(resumed, f),
                                  getattr(uninterrupted, f)[done:]), f
        # the ledger continues, not restarts
        assert resumed.msgs_total == uninterrupted.msgs_total

    def test_checkpoint_requires_empty_ring(self, cluster, wl):
        svc = _cpu(cluster, tsim.EngineConfig(policy="dodoor", b=25))
        svc.submit_workload(wl, 0, 10)
        with pytest.raises(ValueError, match="buffered"):
            svc.export_checkpoint()

    def test_mismatched_restore_raises(self, cluster, wl):
        cfg = tsim.EngineConfig(policy="dodoor", b=25)
        svc = _cpu(cluster, cfg, capacity=400)
        svc.submit_workload(wl, 0, 50)
        svc.drain()
        ck = svc.export_checkpoint()
        with pytest.raises(ValueError, match="does not match"):
            DecisionService.from_checkpoint(cluster, cfg._replace(b=50), ck,
                                            device="cpu")
        with pytest.raises(ValueError, match="does not match"):
            DecisionService.from_checkpoint(
                cluster, cfg._replace(policy="pot"), ck, device="cpu")

    @pytest.mark.parametrize("policy", ["dodoor", "pot", "prequal"])
    def test_reference_checkpoint_continues_in_the_port(self, policy):
        """The JAX reference service checkpoints mid-stream; the port
        restores its dict and continues to the reference's uninterrupted
        result, bit for bit."""
        jwl = jfb.synthesize(m=317, qps=60.0, seed=0)
        twl = tfb.synthesize(m=317, qps=60.0, seed=0)
        jcl = jsim.make_testbed(scale=0.2)
        tcl = tsim.make_testbed(scale=0.2)
        m, cut = 317, 175
        ref = jserve.DecisionService(jcl, jsim.EngineConfig(policy=policy,
                                                            b=25),
                                     seed=3, capacity=m)
        ref.submit_workload(jwl, 0, cut)
        ref.drain()
        ck = ref.export_checkpoint()
        # Batched carries keep the unit rows ascending in both packages:
        # nothing is reordered on the way in.
        for f in ("core_free", "mem_free"):
            a = ck["carry"][f]
            assert (a[:, 1:] >= a[:, :-1]).all(), f
        ref.submit_workload(jwl, cut, m)
        ref.flush()
        want = ref.result()

        svc = DecisionService.from_checkpoint(
            tcl, tsim.EngineConfig(policy=policy, b=25), ck, capacity=m,
            device="cpu")
        for f in ("core_free", "mem_free"):
            assert np.array_equal(svc._carry._asdict()[f].numpy(),
                                  ck["carry"][f])
        svc.submit_workload(twl, cut, m)
        svc.flush()
        got = svc.result()
        assert (got.server == want.server[cut:]).all()
        for f in ("enqueue_ms", "start_ms", "finish_ms", "sched_ms",
                  "cores", "mem_mb", "submit_ms"):
            assert np.array_equal(getattr(got, f),
                                  getattr(want, f)[cut:]), f
        for f in ("msgs_base", "msgs_probe", "msgs_push", "msgs_flush"):
            assert getattr(got, f) == getattr(want, f), f


class TestRechunkingProperty:
    @given(st.lists(st.integers(min_value=1, max_value=97),
                    min_size=1, max_size=8),
           st.sampled_from(POLICIES), st.sampled_from([25, 40, 64]))
    @settings(max_examples=10, deadline=None)
    def test_any_chunking_yields_identical_results(self, cuts, policy, b):
        """Re-chunking the same arrival stream — any split sizes, any
        policy, any b (317 tasks leave a ragged tail at each) — never
        changes placements, timestamps or the ledger: blocks are formed
        by the service, not the submitter."""
        cluster, wl = _CLUSTER, _WL
        m = wl.r_submit.shape[0]
        cfg = tsim.EngineConfig(policy=policy, b=b)
        svc = _cpu(cluster, cfg, capacity=m)
        lo = 0
        for c in cuts:
            if lo >= m:
                break
            svc.submit_workload(wl, lo, min(lo + c, m))
            svc.drain()
            lo = min(lo + c, m)
        if lo < m:
            svc.submit_workload(wl, lo, m)
        svc.flush()
        _assert_same(_offline(wl, cluster, cfg), svc.result(),
                     (cuts, policy, b))


class TestRingAndLatencyUnits:
    """The port's numpy copies against the reference's classes."""

    def test_ring_fifo_wraparound_matches_reference(self):
        rings = (ArrivalRing(capacity=7, num_types=2),
                 jserve.ArrivalRing(capacity=7, num_types=2))

        def chunk(lo, hi):
            k = hi - lo
            for ring in rings:
                ring.push(np.full((k, 2), lo, np.float32),
                          np.full((k, 2, 2), hi, np.float32),
                          np.zeros((k, 2), np.float32),
                          np.ones((k, 2), np.float32),
                          np.arange(lo, hi, dtype=np.float32), t_enq=lo)

        chunk(0, 5)
        got = [r.pop(3) for r in rings]
        assert got[0].submit_ms.tolist() == [0.0, 1.0, 2.0]
        chunk(5, 10)                      # wraps the 7-slot buffer
        assert [r.count for r in rings] == [7, 7]
        got += [r.pop(7) for r in rings]
        for a, b in ((got[0], got[1]), (got[2], got[3])):
            for x, y in zip(a, b):
                assert x.dtype == y.dtype and np.array_equal(x, y)
        assert got[2].submit_ms.tolist() == [3.0, 4.0, 5.0, 6.0,
                                             7.0, 8.0, 9.0]
        for ring in rings:
            with pytest.raises(ValueError, match="pop"):
                ring.pop(1)

    def test_latency_recorder_matches_reference(self):
        samples = np.random.RandomState(0).lognormal(0.0, 1.0, 500)
        recs = (LatencyRecorder(), jserve.LatencyRecorder())
        for rec in recs:
            assert rec.summary() == {"count": 0}
            rec.record(samples[:200])
            rec.record(samples[200:])
        assert recs[0].summary() == recs[1].summary()
        assert recs[0].histogram(10) == recs[1].histogram(10)
        assert recs[0].percentile(99) == recs[1].percentile(99)
        s = recs[0].summary()
        assert s["count"] == 500 and s["p99_ms"] <= s["max_ms"]


@pytest.mark.gpu
def test_cuda_service_matches_cuda_simulate(wl):
    """On the card: the service equals ``simulate(device="cuda")`` bit for
    bit, with one K1 launch a block for dodoor and none for PoT."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.dodoor_choice import LAUNCHES

    cl = tsim.make_testbed(scale=0.2)
    for policy, blocks in (("dodoor", -(-317 // 25)), ("pot", 0)):
        cfg = tsim.EngineConfig(policy=policy, b=25)
        off = tsim.simulate(wl, cl, cfg, device="cuda")
        LAUNCHES.clear()
        _, res = serve_workload(wl, cl, cfg, chunk=13)
        assert sum(LAUNCHES.values()) == blocks
        _assert_same(off, res, policy)
