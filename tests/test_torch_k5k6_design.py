"""The designs of the library-API kernels K5 (score and select for
pre-sampled pairs) and K6 (the RL score matrix), on the CPU.

- ``plan_k6`` keeps its tiling within the kernel's bounds (≤ 32 groups
  of 4 servers a tile, ≤ 256 threads a block, R·N % 4 == 0) and fills the
  card at the 10⁴-server shapes; ``plan_k5`` keeps whole
  warps, one block up to 256 tasks, and spreads T = 2048 over the card;
- the tiling ``plan_k6`` implies covers every (t, j) exactly once, every
  16-byte store aligned, for N ∈ {1, 3, 4, 100, 257, 10⁴} and T ∈ {1, 50,
  2048};
- a plain-torch mirror of each kernel's decomposition — K6's per-block
  ``1/ΣC²`` prologue over the tile's shifted columns and its head, body
  and tail groups; K5's blocks of tasks and its gathers in the kernel's
  order of operations — held bit for bit against ``rl_score_matrix_ref``,
  ``dodoor_choice_ref`` and the reference's Pallas kernels in interpret
  mode, at the reference's pins, K = 1..8, and K5's edge rows (ties,
  identical and idle candidates, candidates 0 and N − 1).

On a machine with a card, each kernel runs in every regime its plan can
choose against its plain version, and two calls are bit for bit equal
(``gpu`` marker)."""
import functools
import os
import sys

import numpy as np
import pytest

from _reference_cache import no_persistent_compile_cache  # noqa: F401

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro.kernels import dodoor_choice as jdc  # noqa: E402
from repro.kernels import rl_score as jrs  # noqa: E402
from repro_torch._arith import dot_fma, fma  # noqa: E402
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.kernels.dodoor_choice import (  # noqa: E402
    dodoor_choice, dodoor_choice_ref)
from repro_torch.kernels.dodoor_choice.ops import plan_k5  # noqa: E402
from repro_torch.kernels.rl_score import (rl_score_matrix,  # noqa: E402
                                          rl_score_matrix_ref)
from repro_torch.kernels.rl_score.ref import unfused_columns  # noqa: E402
from repro_torch.kernels.rl_score.ops import (K6_MAX_G,  # noqa: E402
                                              K6_THREADS, k6_grid,
                                              k6_groups, plan_k6)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402

SMS = 132
EPS = np.float32(1e-9)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


# ------------------------------------------------------------ the plans

@pytest.mark.parametrize("T,N,sms", [
    (1, 1, 132), (50, 100, 132), (2048, 100, 132), (500, 10_000, 132),
    (1024, 10_000, 132), (384, 257, 132), (50, 3, 132), (2048, 6, 132),
    (7, 129, 132), (10**5, 130, 1), (1024, 10_000, 16), (3, 10**6, 132),
    (0, 5, 132)])
def test_plan_k6_stays_within_its_bounds(T, N, sms):
    G, R, rpt = plan_k6(T, N, sms)
    assert 1 <= G <= K6_MAX_G and R >= 1 and R * G <= K6_THREADS
    assert (R * N) % 4 == 0 and rpt in (2, 4)
    rows, cols = k6_grid(T, N, (G, R, rpt))
    assert cols * G >= k6_groups(T, N) and rows * cols < 2 ** 31
    assert rows * R * rpt >= T


@pytest.mark.parametrize("T", [500, 1024])
def test_plan_k6_fills_the_card_at_10k_servers(T):
    """A full wave or more of 256-thread blocks (8 resident an SM), each
    thread issuing 4 independent 16-byte stores."""
    G, R, rpt = plan = plan_k6(T, 10_000, SMS)
    rows, cols = k6_grid(T, 10_000, plan)
    assert (G, R, rpt) == (32, 8, 4)
    assert rows * cols >= SMS * 8


def test_plan_k6_gives_every_thread_work_at_100_servers():
    """N = 100: a row is 25 aligned float4 groups, 25 threads; a block
    holds 10 rows and every one of its 250 threads owns a group."""
    assert plan_k6(2048, 100, SMS) == (25, 10, 2)
    assert plan_k6(50, 100, SMS) == (25, 10, 2)
    assert k6_groups(2048, 100) == 25


@pytest.mark.parametrize("T,sms", [(1, 132), (50, 132), (256, 132),
                                   (257, 132), (500, 132), (2048, 132),
                                   (10**5, 132), (2048, 1), (300, 16)])
def test_plan_k5_stays_within_its_bounds(T, sms):
    tpb = plan_k5(T, sms)
    assert tpb % 32 == 0 and 32 <= tpb <= 256
    if T <= 256:
        assert tpb >= T                  # one lean block
    else:
        assert tpb >= 64


def test_plan_k5_at_the_main_path_shapes():
    assert plan_k5(50, SMS) == 64                      # one block
    assert plan_k5(2048, SMS) == 64                    # 32 blocks
    assert plan_k5(500, SMS) == 64                     # 8 blocks


# ------------------------------------------------------ K6's tiling covered

def k6_writes(T, N, plan, bx):
    """Every score row tile ``bx`` writes, as ``rl_score.cu`` walks it:
    thread (slot, g) of column tile by writes rows t0 + i·R (t0 =
    bx·R·rpt + slot) at columns jb..jb + 3, jb = 4(by·G + g) − s, s =
    t0·N mod 4.  Returns the flat indices t·N + j written and, for each,
    whether it is the first of a 16-byte store (a group inside [0, N))."""
    G, R, rpt = plan
    _, cols = k6_grid(T, N, plan)
    t0 = bx * R * rpt + np.arange(R)
    s = (t0 * N) % 4
    t = t0[:, None] + R * np.arange(rpt)[None, :]             # [R, rpt]
    live = (t0 < T)[:, None] & (t < T)
    jb = 4 * np.arange(cols * G)[None, :] - s[:, None]        # [R, groups]
    j = jb[:, :, None] + np.arange(4)                         # [R, gr, 4]
    ok = (j >= 0) & (j < N) & (jb < N)[:, :, None]
    start = ((jb >= 0) & (jb + 4 <= N))[:, :, None] & (np.arange(4) == 0)
    flat = t[:, :, None, None] * N + j[:, None]               # [R, rpt, gr, 4]
    mask = live[:, :, None, None] & ok[:, None]
    return flat[mask], np.broadcast_to(start[:, None], flat.shape)[mask]


@pytest.mark.parametrize("N", [1, 3, 4, 100, 257, 10_000])
@pytest.mark.parametrize("T", [1, 50, 2048])
def test_k6_tiling_covers_each_score_once(T, N):
    """The plan's tiling, and forced ones of several column tiles (3
    groups a tile, 4 rows a block) with 2 and 5 rows a thread, write every
    score exactly once, and every 16-byte store starts 16-byte aligned;
    only a row's head and tail are scalar (fewer than 4 of each a row)."""
    for plan in {plan_k6(T, N, SMS), (3, 4, 2), (3, 4, 5)}:
        rows, _ = k6_grid(T, N, plan)
        span = plan[1] * plan[2] * N          # a row tile's scores
        seen = np.zeros(rows * span, np.int64)
        vector = 0
        for bx in range(rows):
            flat, start = k6_writes(T, N, plan, bx)
            assert ((flat >= bx * span) & (flat < (bx + 1) * span)).all()
            seen[bx * span:(bx + 1) * span] += np.bincount(
                flat - bx * span, minlength=span)
            assert (flat[start] % 4 == 0).all()
            vector += 4 * int(start.sum())
        assert (seen[:T * N] == 1).all(), (plan, int((seen != 1).sum()))
        assert not seen[T * N:].any()
        assert T * N - vector <= T * 6


# ------------------------------------------------- K6's decomposition

def k6_mirror(r, L, C, plan):
    """``rl_score.cu``'s decomposition in plain torch: per column tile,
    the prologue's ``1/ΣC²`` and L over columns [4G·by − 3, 4G·by + 4G)
    (0 off the edges; the squares of a column below ``unfused_columns``
    rounded and added, the others fused); per block and thread slot, the shift s of its
    first row, its groups' 4 columns taken from the tile at 4g − s + 3,
    and its rows' scores written where the columns are in [0, N).  Every
    score must be written exactly once."""
    T, K = r.shape
    N = L.shape[0]
    G, R, rpt = plan
    rows, cols = k6_grid(T, N, plan)
    out = torch.full((T * N,), float("nan"))
    writes = torch.zeros((T * N,), dtype=torch.int64)
    W = 4 * G + 3
    g = torch.arange(G)
    c4 = torch.arange(4)
    slot = torch.arange(R)
    for by in range(cols):
        col = torch.arange(4 * G * by - 3, 4 * G * by - 3 + W)
        edge = (col >= 0) & (col < N)
        cc = col.clamp(0, N - 1)
        sq = C[cc] * C[cc]
        unf = sq[:, 0]
        for k in range(1, C.shape[1]):
            unf = unf + sq[:, k]
        ss = torch.where(col < unfused_columns(N, C.shape[1]), unf,
                         dot_fma(C[cc], C[cc]))
        inv_s = torch.where(edge, 1.0 / ss, 0.0)
        l_s = torch.where(edge[:, None], L[cc], 0.0)
        for bx in range(rows):
            t0 = bx * R * rpt + slot                             # [R]
            s = (t0 * N) % 4
            t = t0[:, None] + R * torch.arange(rpt)[None, :]     # [R, rpt]
            live = (t0 < T)[:, None] & (t < T)
            jb = 4 * (by * G + g)[None, :] - s[:, None]          # [R, G]
            idx = (4 * g[None, :] - s[:, None] + 3)[..., None] + c4
            lc, ic = l_s[idx], inv_s[idx]                        # [R, G, 4]
            j = jb[..., None] + c4
            ok = (j >= 0) & (j < N) & (jb < N)[..., None]
            rr = r[t.clamp(max=T - 1)][:, :, None, None, :]      # [R, rpt, ..]
            o = dot_fma(rr, lc[:, None]) * ic[:, None]           # [R, rpt, G, 4]
            keep = live[:, :, None, None] & ok[:, None]
            flat = (t[:, :, None, None] * N + j[:, None])[keep]
            out[flat] = o[keep]
            writes.index_add_(0, flat, torch.ones_like(flat))
    assert bool((writes == 1).all()), "a score written twice or never"
    return out.view(T, N)


def _rl_inputs(T, N, K, seed):
    rng = np.random.RandomState(seed)
    return _t((rng.rand(T, K) * 8).astype(np.float32),
              (rng.rand(N, K) * 100).astype(np.float32),
              (1.0 + rng.rand(N, K) * 100).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _jax_rl():
    return jax.jit(jrs.rl_score_matrix)


#: The reference's pins (``test_kernels.py:19-20``, seed T + N) and K =
#: 1..8 at shifted widths (N % 4 = 1, 2, 3 and 0).
K6_PINS = [(T, N, K, T + N) for T, N, K in (
    (8, 10, 2), (128, 128, 2), (200, 100, 2), (130, 300, 4), (1, 1, 2),
    (384, 257, 8))]
K6_WIDTHS = [(T, N, K, T + N + K) for T, N, K in (
    (50, 257, 1), (50, 3, 2), (50, 6, 3), (50, 100, 4), (1, 257, 5),
    (33, 41, 6), (50, 4, 7), (50, 101, 8))]


@pytest.mark.parametrize("T,N,K,seed", K6_PINS + K6_WIDTHS)
def test_k6_mirror_matches_ref_and_pallas(T, N, K, seed):
    """The mirror under the plan's tiling and under a forced one of
    several column tiles, bit for bit against the plain version; and the
    plain version against the reference's K6 in interpret mode: bit for
    bit at the pins and at K ≤ 4.  At K ≥ 5 the reference's wrapper
    reduces ``ΣC²`` in XLA:CPU's own order, outside the Pallas kernel,
    which at some shapes differs from the chain (ROADMAP §3, F4): there
    the scores stay within 4 ulp."""
    r, L, C = _rl_inputs(T, N, K, seed)
    want = rl_score_matrix_ref(r, L, C)
    for plan in {plan_k6(T, N, SMS), (3, 4, 2), (3, 4, 5)}:
        assert torch.equal(k6_mirror(r, L, C, plan), want), plan
    pallas = np.asarray(_jax_rl()(*(t.numpy() for t in (r, L, C))))
    if K <= 4 or (T, N, K, seed) in K6_PINS:
        assert np.array_equal(want.numpy(), pallas)
    else:
        ia = want.numpy().view(np.int32).astype(np.int64)
        ib = pallas.view(np.int32).astype(np.int64)
        assert int(np.abs(ia - ib).max()) <= 4


# ------------------------------------------------- K5's decomposition

def k5_mirror(r, cand, d_cand, L, D, C, alpha, tpb):
    """``dodoor_choice_kernel`` in plain torch: per block of ``tpb``
    tasks, the live ones gather L, C and D at both candidates and score in
    the kernel's order (inv, dot, RL, the fused pair sums, the duration
    fractions, the α-mix); ties keep A.  Every task is written once."""
    T = r.shape[0]
    choice = torch.full((T,), -7, dtype=torch.int32)
    scores = torch.full((T, 2), float("nan"))
    a, one_m = np.float32(alpha), np.float32(1.0 - alpha)
    for b0 in range(0, T, tpb):
        t = torch.arange(b0, min(T, b0 + tpb))
        ca, cb = cand[t, 0].long(), cand[t, 1].long()
        la, lb, Ca, Cb = L[ca], L[cb], C[ca], C[cb]
        inv_a = 1.0 / fma(Ca[:, 1], Ca[:, 1], Ca[:, 0] * Ca[:, 0])
        inv_b = 1.0 / fma(Cb[:, 1], Cb[:, 1], Cb[:, 0] * Cb[:, 0])
        rt = r[t]
        dot_a = fma(rt[:, 1], la[:, 1], rt[:, 0] * la[:, 0])
        dot_b = fma(rt[:, 1], lb[:, 1], rt[:, 0] * lb[:, 0])
        rl_a, rl_b = dot_a * inv_a, dot_b * inv_b
        ok = (rl_a + rl_b) > EPS
        half = torch.full_like(rl_a, 0.5)
        rfa = torch.where(ok, rl_a / (fma(dot_b, inv_b, rl_a) + EPS), half)
        rfb = torch.where(ok, rl_b / (fma(dot_a, inv_a, rl_b) + EPS), half)
        Da, Db = D[ca] + d_cand[t, 0], D[cb] + d_cand[t, 1]
        ds = Da + Db
        dfa = torch.where(ds > EPS, Da / (ds + EPS), half)
        dfb = torch.where(ds > EPS, Db / (ds + EPS), half)
        sa, sb = rfa * one_m + dfa * a, rfb * one_m + dfb * a
        assert bool(torch.isnan(scores[t]).all()), "a task written twice"
        scores[t] = torch.stack([sa, sb], 1)
        choice[t] = torch.where(sa > sb, cand[t, 1], cand[t, 0])
    assert bool((choice != -7).all()), "a task never written"
    return choice, scores


@functools.lru_cache(maxsize=None)
def _jax_choice(alpha):
    return jax.jit(functools.partial(jdc.dodoor_choice, alpha=alpha,
                                     interpret=True))


def _k5_plans(T):
    return sorted({plan_k5(T, SMS), 32, 64, 256})


def _check_k5(args, alpha):
    want = dodoor_choice_ref(*args, alpha=alpha)
    ref = _jax_choice(alpha)(*(t.numpy() for t in args))
    assert np.array_equal(want[0].numpy(), np.asarray(ref[0]))
    assert np.array_equal(want[1].numpy(), np.asarray(ref[1]))
    for tpb in _k5_plans(args[0].shape[0]):
        got = k5_mirror(*args, alpha, tpb)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), tpb
    return want


#: The reference's pins (``test_kernels.py:43-44``, seed T).
K5_PINS = [(16, 20, 0.5), (300, 100, 0.5), (257, 64, 0.0), (64, 500, 1.0)]


@pytest.mark.parametrize("T,N,alpha", K5_PINS)
def test_k5_mirror_at_the_reference_pins(T, N, alpha):
    rng = np.random.RandomState(T)
    args = _t(rng.rand(T, 2).astype(np.float32) * 8,
              rng.randint(0, N, size=(T, 2)).astype(np.int32),
              rng.rand(T, 2).astype(np.float32) * 1000,
              rng.rand(N, 2).astype(np.float32) * 50,
              rng.rand(N).astype(np.float32) * 5000,
              8.0 + rng.rand(N, 2).astype(np.float32) * 100)
    _check_k5(args, alpha)


@pytest.mark.parametrize("T,N", [(1, 1), (1, 100), (50, 1), (50, 7),
                                 (50, 101), (50, 100), (300, 819)])
def test_k5_mirror_at_the_edges(T, N):
    """chip_smoke's K5 edge rows: candidates 0 and N − 1 both ways,
    identical candidates, an exact tie (A wins) and idle candidates (both
    fractions 0.5)."""
    args = _t(*cs.k5_edge_host(T, N, T + N))
    choice, scores = _check_k5(args, 0.3)
    cand = args[1]
    assert tuple(cand[0].tolist()) == (0, N - 1) or T == 0
    if T >= 3:
        assert torch.equal(scores[2, 0], scores[2, 1])
    if T >= 4 and N >= 2:
        assert int(choice[3]) == 0 and torch.equal(scores[3, 0],
                                                   scores[3, 1])
    if T >= 5 and N >= 4:
        assert bool((scores[4] == np.float32(0.5)).all())


def test_wrappers_on_the_cpu_plan_nothing_and_count_nothing():
    args = _t(*cs.k5_edge_host(50, 100, 1))
    r, L, C = _rl_inputs(50, 257, 3, 0)
    LAUNCHES.clear()
    got = dodoor_choice(*args, alpha=0.3)
    assert all(torch.equal(g, w) for g, w in
               zip(got, dodoor_choice_ref(*args, alpha=0.3)))
    assert torch.equal(rl_score_matrix(r, L, C), rl_score_matrix_ref(r, L, C))
    assert not LAUNCHES


# ------------------------------------------------------------- on the card

def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU form)")


@pytest.mark.gpu
@pytest.mark.parametrize("N", [1, 3, 4, 100, 257, 10_000])
@pytest.mark.parametrize("T", [1, 50, 2048])
def test_cuda_k6_in_every_regime(T, N):
    _needs_card()
    for K in range(1, 9):
        r, L, C = (t.cuda() for t in _rl_inputs(T, N, K, T + N + K))
        want = rl_score_matrix_ref(r, L, C)
        for plan in cs.k6_plans(torch, T, N, K):
            assert torch.equal(cs.k6_forced(torch, r, L, C, plan), want)
        first = rl_score_matrix(r, L, C)
        assert torch.equal(first, want)
        assert torch.equal(first, rl_score_matrix(r, L, C))


@pytest.mark.gpu
@pytest.mark.parametrize("T,N", cs.K5_EDGES)
def test_cuda_k5_in_every_regime(T, N):
    _needs_card()
    for misaligned in (False, True):
        args = cs.k5_edge_operands(torch, T, N, T + N, misaligned)
        want = dodoor_choice_ref(*args, alpha=0.3)
        for tpb in cs.k5_plans(torch, T):
            got = cs.k5_forced(torch, args, tpb, 0.3)
            assert all(torch.equal(g, w) for g, w in zip(got, want))
        first = dodoor_choice(*args, alpha=0.3)
        again = dodoor_choice(*args, alpha=0.3)
        assert all(torch.equal(a, b) for a, b in zip(first, again))
        assert all(torch.equal(a, b) for a, b in zip(first, want))
