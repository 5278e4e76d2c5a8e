"""The rest of the port's decision-kernel family — K5 (score and select
for pre-sampled pairs), K4 (the dense megakernel, plain and masked by an
availability plane) and K6 (the RL score matrix) — and the library entry
points that reach them: their plain versions against the JAX reference on
the CPU, the wrappers' device dispatch and launch counter, and — on a
machine with a card — the CUDA kernels against the plain versions.

Every JAX reference is jitted: eager JAX rounds differently from the
compiled program.  Where the reference is a Pallas kernel it runs in
interpret mode, as the JAX package's own tests run it on the CPU; the
dense megakernel's own draws are not a reference (its in-kernel threefry
is the legacy layout, fault R1), so K4 is held against the oracle
``dodoor_fused_ref`` and ``sample_feasible_batch``."""
import functools

import numpy as np
import pytest

from _reference_cache import no_persistent_compile_cache  # noqa: F401

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402
from repro.core import rl_score as jrl  # noqa: E402
from repro.kernels import dodoor_choice as jdc  # noqa: E402
from repro.kernels import rl_score as jrs  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro_torch.core.prefilter import avail_rows  # noqa: E402
from repro_torch.kernels import LAUNCHES, _build  # noqa: E402
from repro_torch.kernels.dodoor_choice import (  # noqa: E402
    dodoor_choice, dodoor_choice_ref, dodoor_fused, dodoor_fused_ref,
    dodoor_fused_sparse_ref)
from repro_torch.kernels.rl_score import (rl_score_matrix,  # noqa: E402
                                          rl_score_matrix_ref)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU runs are many tiny ops; a thread pool only adds
    overhead to them (and contends with the other test workers)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def _ulps(a, b) -> int:
    """The largest distance in float32 steps between ``a`` and ``b``."""
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(ia - ib).max()) if ia.size else 0


# ------------------------------------------------------- K5 dodoor_choice

def _pair_inputs(T, N, seed):
    """``TestDodoorChoiceKernel._inputs`` of the reference's pins."""
    rng = np.random.RandomState(seed)
    r = rng.rand(T, 2).astype(np.float32) * 8
    cand = rng.randint(0, N, size=(T, 2)).astype(np.int32)
    d_cand = rng.rand(T, 2).astype(np.float32) * 1000
    L = rng.rand(N, 2).astype(np.float32) * 50
    D = rng.rand(N).astype(np.float32) * 5000
    C = 8.0 + rng.rand(N, 2).astype(np.float32) * 100
    return r, cand, d_cand, L, D, C


@functools.lru_cache(maxsize=None)
def _jax_choice(alpha):
    return jax.jit(functools.partial(jdc.dodoor_choice, alpha=alpha,
                                     interpret=True))


def _assert_k5_matches_reference(args, alpha):
    want_choice, want_scores = (np.asarray(o)
                                for o in _jax_choice(alpha)(*args))
    choice, scores = dodoor_choice_ref(*_t(*args), alpha=alpha)
    assert choice.dtype == torch.int32 and scores.dtype == torch.float32
    assert np.array_equal(scores.numpy(), want_scores)
    assert np.array_equal(choice.numpy(), want_choice)
    return choice, scores


K5_CASES = [(16, 20, 0.5, 16), (300, 100, 0.5, 300), (257, 64, 0.0, 257),
            (64, 500, 1.0, 64), (2048, 100, 0.3, 7), (512, 100, 0.7, 8)]


@pytest.mark.parametrize("T,N,alpha,seed", K5_CASES)
def test_k5_plain_version_equals_the_pallas_kernel(T, N, alpha, seed):
    """Scores and choices bit for bit against the reference's K5 in
    interpret mode (``test_kernels.py:43-44`` and two other α), whose
    reciprocal-form score differs from its own jnp oracle by up to 3 ulp."""
    _assert_k5_matches_reference(_pair_inputs(T, N, seed), alpha)


@pytest.mark.parametrize("T", (1, 9, 12, 137))
def test_k5_partial_tails(T):
    _assert_k5_matches_reference(_pair_inputs(T, 20, T), 0.5)


def test_k5_ties_keep_candidate_a():
    """Servers 1 and 4 hold identical rows (``test_kernels.py:466``): the
    scores tie exactly and A wins."""
    N, T = 6, 16
    rng = np.random.RandomState(2)
    r = rng.rand(T, 2).astype(np.float32)
    L = rng.rand(N, 2).astype(np.float32) * 20
    L[4] = L[1]
    D = rng.rand(N).astype(np.float32) * 100
    D[4] = D[1]
    C = np.full((N, 2), 30.0, np.float32)
    cand = np.tile(np.array([[1, 4]], np.int32), (T, 1))
    d_cand = np.full((T, 2), 7.0, np.float32)
    choice, scores = _assert_k5_matches_reference(
        (r, cand, d_cand, L, D, C), 0.5)
    assert torch.equal(scores[:, 0], scores[:, 1])
    assert (choice == 1).all()


def test_k5_identical_candidates():
    N = 10
    rng = np.random.RandomState(1)
    cand = np.full((8, 2), 3, np.int32)
    r = rng.rand(8, 2).astype(np.float32)
    L = rng.rand(N, 2).astype(np.float32)
    args = (r, cand, np.ones((8, 2), np.float32), L,
            np.ones(N, np.float32), np.full((N, 2), 10.0, np.float32))
    choice, scores = _assert_k5_matches_reference(args, 0.5)
    assert (choice == 3).all()
    assert torch.equal(scores[:, 0], scores[:, 1])


def test_k5_idle_candidates_fall_back_to_even_terms():
    """Zero loads and zero durations: both fractions fall back to 0.5."""
    r, cand, d_cand, L, D, C = _pair_inputs(32, 20, 3)
    L[:] = 0.0
    D[:] = 0.0
    d_cand[:16] = 0.0
    _, scores = _assert_k5_matches_reference((r, cand, 0 * d_cand, L, D, C),
                                             0.3)
    assert torch.all(scores == np.float32(0.5))


# -------------------------------------------- the policy layer around K5

def _view(L, D, C, mod):
    return mod.SchedulerView(L=L, D=D, rif=0 * D, C=C)


@functools.lru_cache(maxsize=None)
def _jax_choice_batch(use_kernel):
    return jax.jit(lambda r, c, d, L, D, C: jcore.dodoor_choice_batch(
        r, c, d, _view(L, D, C, jcore), 0.5, use_kernel=use_kernel,
        interpret=True))


@pytest.mark.parametrize("T,N,seed", [(50, 20, 5), (300, 100, 6),
                                      (137, 64, 7)])
def test_choice_batch_kernel_route_agrees(T, N, seed):
    """``dodoor_choice_batch(use_kernel=True)`` gives the choices of
    ``use_kernel=False`` at ``test_kernels.py:507-517``'s inputs (and two
    more blocks), and each route equals the reference's."""
    r, cand, d_cand, L, D, C = _pair_inputs(T, N, seed)
    view = _view(*_t(L, D, C), tcore)
    tr, tc, td = _t(r, cand, d_cand)
    plain = tcore.dodoor_choice_batch(tr, tc, td, view, 0.5)
    kern = tcore.dodoor_choice_batch(tr, tc, td, view, 0.5, use_kernel=True)
    assert torch.equal(plain, kern)
    for use_kernel, got in ((False, plain), (True, kern)):
        want = _jax_choice_batch(use_kernel)(r, cand, d_cand, L, D, C)
        assert np.array_equal(got.numpy(), np.asarray(want))


@functools.lru_cache(maxsize=None)
def _jax_select_batch(use_kernel, with_keys):
    def f(key, r, d, L, D, C, keys):
        return jcore.dodoor_select_batch(
            key, r, d, _view(L, D, C, jcore), jcore.DodoorParams(),
            keys=keys if with_keys else None, use_kernel=use_kernel,
            interpret=True)
    return jax.jit(f)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("with_keys", [False, True])
def test_select_batch_matches_reference(use_kernel, with_keys):
    """Keys folded from the block index, or given per task; demands that
    leave some rows feasible nowhere (the uniform fallback)."""
    T, N = 137, 100
    rng = np.random.RandomState(11)
    r = np.stack([rng.choice([1, 2, 4, 8, 64], T),
                  rng.uniform(1e3, 1.3e5, T)], 1).astype(np.float32)
    d = rng.uniform(100, 2e4, (T, N)).astype(np.float32)
    L = rng.uniform(0, 50, (N, 2)).astype(np.float32)
    D = rng.uniform(0, 5e5, N).astype(np.float32)
    C = np.stack([rng.choice([8, 16, 32], N),
                  rng.uniform(1e4, 1.2e5, N)], 1).astype(np.float32)
    keys = rng.randint(0, 2 ** 32, (T, 2), dtype=np.uint64)
    key = np.array([0, 42], np.uint32)
    want = _jax_select_batch(use_kernel, with_keys)(
        key, r, d, L, D, C, keys.astype(np.uint32))
    got = tcore.dodoor_select_batch(
        torch.tensor([0, 42]), *_t(r, d), _view(*_t(L, D, C), tcore),
        tcore.DodoorParams(),
        keys=torch.from_numpy(keys.astype(np.int64)) if with_keys else None,
        use_kernel=use_kernel)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------- K4 dodoor_fused

def _fused_inputs(T, N, seed, avail_frac=0.4):
    """``TestDodoorFusedMegakernel._inputs`` (and the masked class's
    plane), with the keys as the port takes them."""
    rng = np.random.RandomState(seed)
    base = jax.random.PRNGKey(seed)
    keys = np.asarray(jax.vmap(lambda i: jax.random.fold_in(base, i))(
        jnp.arange(T)))
    r = rng.rand(T, 2).astype(np.float32) * 8
    d = rng.rand(T, N).astype(np.float32) * 1000
    L = rng.rand(N, 2).astype(np.float32) * 50
    D = rng.rand(N).astype(np.float32) * 5000
    C = 8.0 + rng.rand(N, 2).astype(np.float32) * 100
    avail = rng.rand(T, N) > avail_frac
    return keys, r, d, L, D, C, avail


@functools.lru_cache(maxsize=None)
def _jax_fused_ref(alpha, masked):
    if masked:
        return jax.jit(lambda k, r, d, L, D, C, a: jdc.dodoor_fused_ref(
            k, r, d, L, D, C, alpha, avail=a))
    return jax.jit(lambda k, r, d, L, D, C: jdc.dodoor_fused_ref(
        k, r, d, L, D, C, alpha))


@jax.jit
def _jax_draws(keys, r, C, avail):
    return jcore.sample_feasible_batch(
        keys, jcore.feasible_mask(r, C) & avail, 2)


def _assert_k4_matches_reference(host, alpha, masked):
    """Candidates and choices bit for bit against the reference's oracle
    and its two-stage sampler; scores within the reference's own K4
    tolerance.  The oracle scores in the Pallas kernel's reciprocal form
    and the port's K4 in K1's two-stage form (so that K4 equals K1): at
    these inputs the two differ by at most 3 ulp."""
    keys, r, d, L, D, C, avail = host
    jargs = (keys, r, d, L, D, C) + ((avail,) if masked else ())
    want = [np.asarray(o) for o in _jax_fused_ref(alpha, masked)(*jargs)]
    got = dodoor_fused_ref(*_t(keys.astype(np.int64), r, d, L, D, C),
                           alpha, _t(avail)[0] if masked else None)
    choice, cand, scores = (o.numpy() for o in got)
    assert np.array_equal(cand, want[1])
    assert np.array_equal(cand, np.asarray(_jax_draws(
        keys, r, C, avail if masked else np.ones_like(avail))))
    assert np.array_equal(choice, want[0])
    np.testing.assert_allclose(scores, want[2], rtol=2e-5, atol=1e-6)
    assert _ulps(scores, want[2]) <= 3
    return got


K4_CASES = [(16, 20, 0.5), (300, 100, 0.5), (257, 64, 0.0), (64, 500, 1.0)]


@pytest.mark.parametrize("T,N,alpha", K4_CASES)
def test_k4_plain_version_matches_the_oracle(T, N, alpha):
    """``test_kernels.py:95-96``'s shapes."""
    _assert_k4_matches_reference(_fused_inputs(T, N, T), alpha, False)


@pytest.mark.parametrize("T", (1, 9, 12, 137))
def test_k4_partial_tails(T):
    _assert_k4_matches_reference(_fused_inputs(T, 20, T), 0.5, False)


def test_k4_mixed_and_infeasible_rows():
    """Rows that fit nowhere draw uniformly over all servers; the rest
    of the block keeps its feasible draws."""
    host = list(_fused_inputs(64, 30, 2))
    host[1][::3] = 1e6
    choice, cand, _ = _assert_k4_matches_reference(tuple(host), 0.5, False)
    assert int(cand.min()) >= 0 and int(cand.max()) < 30


@pytest.mark.parametrize("T,N", [(16, 20), (300, 100), (137, 64)])
def test_k4_masked_plain_version_matches_the_oracle(T, N):
    """``test_kernels.py:172-173``'s shapes."""
    _assert_k4_matches_reference(_fused_inputs(T, N, T), 0.5, True)


def test_k4_masked_all_down_rows_fall_back_to_every_server():
    """Every row all down but row 5, where only server 4 is up (and every
    demand fits every server): row 5 draws server 4 twice, the others
    uniformly over all servers."""
    host = list(_fused_inputs(32, 9, 2))
    host[6][:] = False
    host[6][5, 4] = True
    _, cand, _ = _assert_k4_matches_reference(tuple(host), 0.5, True)
    assert cand[5].tolist() == [4, 4]
    assert len(set(cand.flatten().tolist())) > 5


def test_k4_masked_with_every_server_up_is_k4():
    host = _fused_inputs(128, 32, 5)
    keys, r, d, L, D, C, _ = _t(*host)
    keys = keys.to(torch.int64)
    a = dodoor_fused_ref(keys, r, d, L, D, C, 0.5, torch.ones(128, 32))
    b = dodoor_fused_ref(keys, r, d, L, D, C, 0.5)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def _sparse_inputs(T, N, seed):
    """A block with a per-type duration table, and down windows: [N, 3]
    planes with +inf pads, a window taking every server down on
    [2e5, 3e5), and rows 0-1 inside it."""
    rng = np.random.RandomState(seed)
    keys = rng.randint(0, 2 ** 32, (T, 2), dtype=np.uint64).astype(np.int64)
    r = np.stack([rng.choice([1, 2, 4, 8, 64], T),
                  rng.uniform(1e3, 1.3e5, T)], 1).astype(np.float32)
    d_types = rng.uniform(100, 2e4, (T, 4)).astype(np.float32)
    node_type = rng.randint(0, 4, N).astype(np.int32)
    L = rng.uniform(0, 50, (N, 2)).astype(np.float32)
    D = rng.uniform(0, 5e5, N).astype(np.float32)
    C = np.stack([rng.choice([8, 16, 32], N),
                  rng.uniform(1e4, 1.2e5, N)], 1).astype(np.float32)
    down0 = np.full((N, 3), np.inf, np.float32)
    down1 = np.full((N, 3), np.inf, np.float32)
    start = rng.uniform(0, 1e5, N).astype(np.float32)
    some = rng.rand(N) < 0.4
    down0[some, 0] = start[some]
    down1[some, 0] = start[some] + 3e4
    down0[:, 1], down1[:, 1] = 2e5, 3e5
    now = rng.uniform(0, 1.3e5, T).astype(np.float32)
    now[:2] = 2.5e5
    return (keys, r, d_types, node_type, L, D, C), (down0, down1, now)


@pytest.mark.parametrize("T,N", [(1, 100), (137, 100), (50, 1000)])
def test_k4_equals_k1_and_k4_masked_equals_k2(T, N):
    """On ``d = d_types[:, node_type]`` K4 is K1 bit for bit (the
    reference's own pin, ``test_kernels.py:271``), and K4-masked with
    ``avail = avail_rows(windows)`` is K2 bit for bit, all-down rows
    included."""
    host, win = _sparse_inputs(T, N, T + N)
    keys, r, d_types, node_type, L, D, C = _t(*host)
    down0, down1, now = _t(*win)
    d = d_types[:, node_type.long()]
    k1 = dodoor_fused_sparse_ref(keys, r, d_types, node_type, L, D, C, 0.5)
    k4 = dodoor_fused_ref(keys, r, d, L, D, C, 0.5)
    assert all(torch.equal(a, b) for a, b in zip(k4, k1))
    avail = avail_rows(down0, down1, now)
    k2 = dodoor_fused_sparse_ref(keys, r, d_types, node_type, L, D, C, 0.5,
                                 down0, down1, now)
    k4m = dodoor_fused_ref(keys, r, d, L, D, C, 0.5, avail.float())
    assert all(torch.equal(a, b) for a, b in zip(k4m, k2))
    assert not avail[: min(T, 2)].any()


# ------------------------------------------------------ K6 rl_score_matrix

def _rl_inputs(T, N, K, seed):
    rng = np.random.RandomState(seed)
    r = rng.rand(T, K).astype(np.float32) * 8
    L = rng.rand(N, K).astype(np.float32) * 100
    C = 1.0 + rng.rand(N, K).astype(np.float32) * 100
    return r, L, C


RL_CASES = [(8, 10, 2), (128, 128, 2), (200, 100, 2), (130, 300, 4),
            (1, 1, 2), (384, 257, 8), (2048, 100, 2), (9, 33, 4), (12, 7, 8)]


@pytest.mark.parametrize("T,N,K", RL_CASES)
def test_k6_plain_version_equals_the_pallas_kernel(T, N, K):
    """``test_kernels.py:19-20``'s shapes and more: bit for bit against the
    reference's K6 in interpret mode, whose K-long dot is a fused
    multiply-add chain in k order scaled by ``1/ΣC²``."""
    r, L, C = _rl_inputs(T, N, K, T + N)
    want = np.asarray(jax.jit(jrs.rl_score_matrix)(r, L, C))
    got = rl_score_matrix_ref(*_t(r, L, C))
    assert got.dtype == torch.float32 and got.shape == (T, N)
    assert np.array_equal(got.numpy(), want)


def test_k6_small_tiles_change_nothing():
    r, L, C = _rl_inputs(40, 70, 2, 0)
    want = np.asarray(jax.jit(functools.partial(
        jrs.rl_score_matrix, block_t=16, block_n=32))(r, L, C))
    assert np.array_equal(rl_score_matrix_ref(*_t(r, L, C)).numpy(), want)


@pytest.mark.parametrize("T,N,K", RL_CASES)
def test_core_rl_score_matrix_against_the_core_form(T, N, K):
    """The reference's core form ``(r @ L.T) * inv`` jitted, bit for bit
    at every K of these cases: the dot a chain at K = 2, pairwise sums at
    K = 4, four interleaved accumulators at K = 8, and ``ΣC²`` summed
    without contraction at 5 ≤ K ≤ 8 over N ≥ 16 servers (hazard P4)."""
    r, L, C = _rl_inputs(T, N, K, T + N)
    want = np.asarray(jax.jit(jrl.rl_score_matrix)(r, L, C))
    got = tcore.rl_score_matrix(*_t(r, L, C)).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("T,N,K", [(500, 1000, 4), (100, 300, 8),
                                   (2048, 100, 4), (17, 40, 8)])
def test_core_rl_score_matrix_at_further_shapes(T, N, K):
    """Shapes beyond the reference's pins where XLA:CPU runs the same
    forms: bit for bit."""
    r, L, C = _rl_inputs(T, N, K, T + N)
    want = np.asarray(jax.jit(jrl.rl_score_matrix)(r, L, C))
    assert np.array_equal(tcore.rl_score_matrix(*_t(r, L, C)).numpy(), want)


#: Shapes where XLA:CPU picks another order by shape (ROADMAP §3, F1),
#: with the number of scores that differ and the largest distance.
F1_UNPINNED = [(64, 64, 4, 1314, 3), (1000, 50, 8, 19817, 4),
               (2048, 100, 8, 1941, 2)]


@pytest.mark.parametrize("T,N,K,n_diff,ulps", F1_UNPINNED)
def test_core_rl_score_matrix_where_xla_orders_by_shape(T, N, K, n_diff,
                                                        ulps):
    """At these shapes XLA:CPU runs the dot as a chain, or sums the last
    rows' squares with fused multiply-adds: exactly ``n_diff`` scores
    differ, by at most ``ulps``."""
    r, L, C = _rl_inputs(T, N, K, T + N)
    want = np.asarray(jax.jit(jrl.rl_score_matrix)(r, L, C))
    got = tcore.rl_score_matrix(*_t(r, L, C)).numpy()
    assert int((got != want).sum()) == n_diff
    assert _ulps(got, want) == ulps


# ------------------------------------------------------ wrappers and build

def test_wrappers_on_cpu_run_the_plain_versions_without_counting():
    r, cand, d_cand, L, D, C = _t(*_pair_inputs(9, 20, 1))
    keys, rr, d, LL, DD, CC, avail = _t(*_fused_inputs(9, 20, 1))
    keys = keys.to(torch.int64)
    LAUNCHES.clear()
    got = dodoor_choice(r, cand, d_cand, L, D, C, 0.3)
    assert all(torch.equal(a, b) for a, b in zip(
        got, dodoor_choice_ref(r, cand, d_cand, L, D, C, 0.3)))
    got = dodoor_fused(keys, rr, d, LL, DD, CC, 0.5, avail=avail)
    assert all(torch.equal(a, b) for a, b in zip(
        got, dodoor_fused_ref(keys, rr, d, LL, DD, CC, 0.5, avail.float())))
    assert torch.equal(rl_score_matrix(rr, LL, CC),
                       rl_score_matrix_ref(rr, LL, CC))
    assert sum(LAUNCHES.values()) == 0


def test_wrappers_reject_other_devices():
    r, cand, d_cand, L, D, C = _t(*_pair_inputs(4, 20, 2))
    with pytest.raises(ValueError, match="unsupported device"):
        dodoor_choice(*(t.to("meta") for t in (r, cand, d_cand, L, D, C)))
    with pytest.raises(ValueError, match="several devices"):
        rl_score_matrix(r, L, C.to("meta"))
    keys, rr, d, LL, DD, CC, _ = _t(*_fused_inputs(4, 20, 2))
    with pytest.raises(ValueError, match="several devices"):
        dodoor_fused(keys, rr, d, LL, DD, CC, avail=torch.ones(
            4, 20, device="meta"))


def test_build_knows_the_rl_score_source():
    assert _build.SOURCES == ("dodoor_fused_sparse", "rl_score",
                              "flash_attention", "ssd_chunk")
    for name in _build.SOURCES:
        assert (_build.CSRC / f"{name}.cu").exists()
        assert _build.library_path(name).name.startswith(name + "-")


# ------------------------------------------------------------- on the card

def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU form)")


@pytest.mark.gpu
@pytest.mark.parametrize("T,N", [(50, 100), (2048, 100), (500, 10_000)])
def test_cuda_k5_matches_plain_version(T, N):
    _needs_card()
    host = _t(*_pair_inputs(T, N, T))
    dev = [t.cuda() for t in host]
    LAUNCHES.clear()
    choice, scores = dodoor_choice(*dev, alpha=0.3)
    torch.cuda.synchronize()
    assert LAUNCHES["dodoor_choice"] == 1
    p_choice, p_scores = dodoor_choice_ref(*host, alpha=0.3)
    assert torch.equal(choice.cpu(), p_choice)
    assert torch.equal(scores.cpu(), p_scores)


@pytest.mark.gpu
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("T,N", [(50, 100), (500, 10_000)])
def test_cuda_k4_matches_plain_version(T, N, masked):
    _needs_card()
    keys, r, d, L, D, C, avail = _t(*_fused_inputs(T, N, T))
    host = (keys.to(torch.int64), r, d, L, D, C)
    plane = avail.float() if masked else None
    LAUNCHES.clear()
    got = dodoor_fused(*(t.cuda() for t in host), 0.5,
                       avail=None if plane is None else plane.cuda())
    torch.cuda.synchronize()
    assert LAUNCHES["dodoor_fused_masked" if masked else "dodoor_fused"] == 1
    want = dodoor_fused_ref(*host, 0.5, plane)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))


@pytest.mark.gpu
@pytest.mark.parametrize("T,N,K", [(2048, 100, 2), (500, 10_000, 2),
                                   (384, 257, 8), (9, 33, 4)])
def test_cuda_k6_matches_plain_version(T, N, K):
    _needs_card()
    host = _t(*_rl_inputs(T, N, K, T + N))
    LAUNCHES.clear()
    got = rl_score_matrix(*(t.cuda() for t in host))
    torch.cuda.synchronize()
    assert LAUNCHES["rl_score_matrix"] == 1
    assert torch.equal(got.cpu(), rl_score_matrix_ref(*host))
