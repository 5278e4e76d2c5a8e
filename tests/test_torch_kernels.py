"""The port's sparse-gather decision kernels (K1, and K2 with down-window
availability): their plain version against the JAX reference's two-stage
path on the CPU, the wrapper's device dispatch and launch counter, and —
on a machine with a card — the CUDA kernels against the plain version."""
import numpy as np
import pytest

from _reference_cache import no_persistent_compile_cache  # noqa: F401

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402
from repro.sim import engine as jeng  # noqa: E402
from repro.sim import make_scaled, make_testbed  # noqa: E402
from repro.sim import scenarios as jsc  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.dodoor_choice import (LAUNCHES,  # noqa: E402
                                               dodoor_fused_sparse,
                                               dodoor_fused_sparse_ref)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU runs are many tiny ops; a thread pool only adds
    overhead to them (and contends with the other test workers)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _inputs(T, N, seed, infeasible=(), feasible_frac=None):
    """A decision block: the testbed (N=100) or a scaled fleet, demands
    from the traces' range, ``infeasible`` rows that fit nowhere (the
    uniform fallback), random cached loads and per-type durations."""
    cl = make_testbed() if N == 100 else make_scaled(N)
    rng = np.random.RandomState(seed)
    keys = rng.randint(0, 2 ** 32, size=(T, 2), dtype=np.uint64)
    r = np.stack([rng.choice([1, 2, 4, 8, 14, 16, 28], T),
                  rng.uniform(1e3, 1.3e5, T)], 1).astype(np.float32)
    for i in infeasible:
        r[i] = (64.0, 1e9)
    L = (rng.uniform(0, 2, (N, 2)) * cl.C).astype(np.float32)
    D = rng.uniform(0, 5e5, N).astype(np.float32)
    D[:3] = 0.0
    L[:3] = 0.0
    d_types = rng.uniform(100, 2e4, (T, 4)).astype(np.float32)
    return (keys.astype(np.int64), r, d_types,
            np.asarray(cl.node_type, np.int32), L, D,
            np.asarray(cl.C, np.float32))


@jax.jit
def _two_stage(keys, r, d_types, node_type, L, D, C, alpha):
    mask = jcore.feasible_mask(r, C)
    cand = jcore.sample_feasible_batch(keys, mask, 2)
    tt = jnp.arange(r.shape[0])
    d_cand = d_types[tt[:, None], node_type[cand]]
    view = jcore.SchedulerView(L=L, D=D, rif=jnp.zeros_like(D), C=C)
    scores = jcore.load_score_batched(r, L[cand], D[cand] + d_cand, C[cand],
                                      alpha)
    choice = jcore.dodoor_choice_batch(r, cand, d_cand, view, alpha)
    return choice, cand, scores


def _jax_two_stage(keys, r, d_types, node_type, L, D, C, alpha):
    """The reference's use_kernel=False path (engine.py's dodoor branch),
    compiled as the engine compiles it."""
    out = _two_stage(keys.astype(np.uint32), r, d_types, node_type, L, D, C,
                     jnp.float32(alpha))
    return tuple(np.asarray(o) for o in out)


CASES = [
    (1, 100, ()), (9, 100, (0, 4)), (137, 100, (5,)),
    (137, 1000, tuple(range(0, 137, 3))),        # mixed feasibility block
    (16, 100, tuple(range(16))),                 # every row falls back
]


@pytest.mark.parametrize("T,N,infeasible", CASES)
@pytest.mark.parametrize("alpha", [0.5, 0.3])
def test_plain_version_matches_jax_two_stage(T, N, infeasible, alpha):
    host = _inputs(T, N, seed=T * N, infeasible=infeasible)
    ref_choice, ref_cand, ref_scores = _jax_two_stage(*host, alpha)
    choice, cand, scores = dodoor_fused_sparse_ref(
        *(torch.from_numpy(a) for a in host), alpha=alpha)
    assert cand.dtype == torch.int32 and choice.dtype == torch.int32
    assert np.array_equal(cand.numpy(), ref_cand)
    assert np.array_equal(choice.numpy(), ref_choice)
    assert np.array_equal(scores.numpy(), ref_scores)


def test_fallback_rows_draw_over_all_servers():
    host = _inputs(64, 100, seed=3, infeasible=tuple(range(64)))
    _, cand, _ = dodoor_fused_sparse_ref(*(torch.from_numpy(a)
                                           for a in host))
    assert int(cand.min()) >= 0 and int(cand.max()) < 100
    assert len(set(cand.flatten().tolist())) > 20


def test_wrapper_on_cpu_runs_the_plain_version_without_counting():
    host = tuple(torch.from_numpy(a) for a in _inputs(9, 100, seed=1))
    LAUNCHES.clear()
    got = dodoor_fused_sparse(*host, alpha=0.5)
    want = dodoor_fused_sparse_ref(*host, alpha=0.5)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert LAUNCHES["dodoor_fused_sparse"] == 0


def test_wrapper_rejects_other_devices():
    host = [torch.from_numpy(a) for a in _inputs(4, 100, seed=2)]
    meta = [t.to("meta") for t in host]
    with pytest.raises(ValueError, match="unsupported device"):
        dodoor_fused_sparse(*meta)
    with pytest.raises(ValueError, match="several devices"):
        dodoor_fused_sparse(*host[:-1], meta[-1])


def test_build_library_name_tracks_source_and_flags():
    path = _build.library_path("dodoor_fused_sparse")
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("dodoor_fused_sparse-")
    assert "-fmad=false" in _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


# ------------------------------------------------------------- K2 (masked)

def _windows(T, N, seed, Wd=None, all_down_rows=()):
    """Down-window planes from ``random_outages(N, N//5)`` merged with
    ``random_churn(N, 0.15, 0.15)`` over a horizon H, plus one window that
    takes every server down on [1.1H, 1.2H); task times spread over
    [0, H), the ``all_down_rows`` at 1.15H (the all-down fallback)."""
    H = 1e5
    dyn = jsc.random_outages(N, N // 5, 0.6 * H, mean_down_ms=0.2 * H,
                             seed=seed).merge(
        jsc.random_churn(N, 0.15, 0.15, H, seed=seed + 1),
        jeng.Dynamics(outages=tuple((s, 1.1 * H, 1.2 * H)
                                    for s in range(N))))
    win = jeng._lower_dynamics(dyn, N)
    if Wd is not None:
        win = jeng._lower_dynamics(dyn, N, (Wd,) + win.widths[1:])
    now = np.random.RandomState(seed).uniform(0, H, T).astype(np.float32)
    now[list(all_down_rows)] = np.float32(1.15 * H)
    return win, now


@jax.jit
def _two_stage_masked(keys, r, d_types, node_type, L, D, C, alpha, win,
                      now):
    mask = jcore.feasible_mask(r, C) & jeng._avail_rows(win, now)
    cand = jcore.sample_feasible_batch(keys, mask, 2)
    tt = jnp.arange(r.shape[0])
    d_cand = d_types[tt[:, None], node_type[cand]]
    view = jcore.SchedulerView(L=L, D=D, rif=jnp.zeros_like(D), C=C)
    scores = jcore.load_score_batched(r, L[cand], D[cand] + d_cand, C[cand],
                                      alpha)
    choice = jcore.dodoor_choice_batch(r, cand, d_cand, view, alpha)
    return choice, cand, scores


MASKED_CASES = [
    (9, 100, None, (0,)), (137, 100, None, (3, 4, 70)),
    (137, 1000, None, tuple(range(0, 137, 9))), (64, 100, 5, (1,)),
]


@pytest.mark.parametrize("T,N,Wd,all_down", MASKED_CASES)
def test_masked_plain_version_matches_jax_two_stage(T, N, Wd, all_down):
    """K2's plain version is the reference's two-stage masked path:
    ``sample_feasible_batch(keys, feasible_mask & _avail_rows(win, now))``
    then ``dodoor_choice_batch``, compiled as the engine compiles it."""
    host = _inputs(T, N, seed=T * N + 1, infeasible=(2,))
    win, now = _windows(T, N, seed=T + N, Wd=Wd, all_down_rows=all_down)
    ref = _two_stage_masked(host[0].astype(np.uint32), *host[1:],
                            jnp.float32(0.5), win, now)
    ref_choice, ref_cand, ref_scores = (np.asarray(o) for o in ref)
    d0, d1 = (torch.from_numpy(np.array(p)) for p in (win.down0,
                                                        win.down1))
    choice, cand, scores = dodoor_fused_sparse_ref(
        *(torch.from_numpy(a) for a in host), alpha=0.5, down0=d0,
        down1=d1, now=torch.from_numpy(now))
    assert np.array_equal(cand.numpy(), ref_cand)
    assert np.array_equal(choice.numpy(), ref_choice)
    assert np.array_equal(scores.numpy(), ref_scores)
    # The masked draw differs from the unmasked one somewhere.
    _, cand1, _ = dodoor_fused_sparse_ref(*(torch.from_numpy(a)
                                            for a in host))
    assert not torch.equal(cand, cand1)


def test_masked_all_down_rows_fall_back_to_the_whole_fleet():
    T, N = 64, 100
    host = _inputs(T, N, seed=5)
    win, now = _windows(T, N, seed=5, all_down_rows=range(T))
    _, cand, _ = dodoor_fused_sparse_ref(
        *(torch.from_numpy(a) for a in host), alpha=0.5,
        down0=torch.from_numpy(np.array(win.down0)),
        down1=torch.from_numpy(np.array(win.down1)),
        now=torch.from_numpy(now))
    assert int(cand.min()) >= 0 and int(cand.max()) < N
    assert len(set(cand.flatten().tolist())) > 20


@pytest.mark.parametrize("Wd", [1, 3])
def test_infinite_windows_equal_the_unmasked_kernel(Wd):
    """All windows at +inf: K2's plain version equals K1's bit for bit."""
    T, N = 137, 100
    host = tuple(torch.from_numpy(a) for a in _inputs(T, N, seed=11,
                                                      infeasible=(0, 5)))
    inf = torch.full((N, Wd), float("inf"))
    now = torch.linspace(0.0, 1e9, T)
    got = dodoor_fused_sparse(*host, alpha=0.5, down0=inf, down1=inf,
                              now=now)
    want = dodoor_fused_sparse(*host, alpha=0.5)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_masked_wrapper_checks_its_windows():
    host = tuple(torch.from_numpy(a) for a in _inputs(4, 100, seed=2))
    inf = torch.full((100, 1), float("inf"))
    with pytest.raises(ValueError, match="together"):
        dodoor_fused_sparse(*host, down0=inf, down1=inf)
    LAUNCHES.clear()
    dodoor_fused_sparse(*host, down0=inf, down1=inf, now=torch.zeros(4))
    assert sum(LAUNCHES.values()) == 0               # the CPU launches none


@pytest.mark.gpu
@pytest.mark.parametrize("T,N", [(50, 100), (500, 10_000)])
def test_cuda_masked_kernel_matches_plain_version(T, N):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU form)")
    host = _inputs(T, N, seed=T + N, infeasible=(0,))
    win, now = _windows(T, N, seed=N, all_down_rows=(1, 2))
    planes = [np.array(win.down0), np.array(win.down1), now]
    dev = [torch.from_numpy(a).cuda() for a in host]
    wdev = [torch.from_numpy(a).cuda() for a in planes]
    LAUNCHES.clear()
    choice, cand, scores = dodoor_fused_sparse(
        *dev, alpha=0.5, down0=wdev[0], down1=wdev[1], now=wdev[2])
    torch.cuda.synchronize()
    assert LAUNCHES["dodoor_fused_sparse_masked"] == 1
    p_choice, p_cand, p_scores = dodoor_fused_sparse_ref(
        *(torch.from_numpy(a) for a in host), alpha=0.5,
        down0=torch.from_numpy(planes[0]), down1=torch.from_numpy(planes[1]),
        now=torch.from_numpy(planes[2]))
    assert torch.equal(cand.cpu(), p_cand)
    np.testing.assert_allclose(scores.cpu().numpy(), p_scores.numpy(),
                               rtol=1e-6, atol=0.0)
    tie = (p_scores[:, 0] - p_scores[:, 1]).abs() <= 1e-6
    assert torch.equal(choice.cpu()[~tie], p_choice[~tie])


@pytest.mark.gpu
@pytest.mark.parametrize("T,N", [(50, 100), (137, 1000), (500, 10_000)])
def test_cuda_kernel_matches_plain_version(T, N):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU form)")
    host = _inputs(T, N, seed=T + N, infeasible=(0,))
    dev = [torch.from_numpy(a).cuda() for a in host]
    LAUNCHES.clear()
    choice, cand, scores = dodoor_fused_sparse(*dev, alpha=0.5)
    torch.cuda.synchronize()
    assert LAUNCHES["dodoor_fused_sparse"] == 1
    p_choice, p_cand, p_scores = dodoor_fused_sparse_ref(
        *(torch.from_numpy(a) for a in host), alpha=0.5)
    assert torch.equal(cand.cpu(), p_cand)
    np.testing.assert_allclose(scores.cpu().numpy(), p_scores.numpy(),
                               rtol=1e-6, atol=0.0)
    tie = (p_scores[:, 0] - p_scores[:, 1]).abs() <= 1e-6
    assert torch.equal(choice.cpu()[~tie], p_choice[~tie])
