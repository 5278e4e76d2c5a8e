"""K7's backward at head width 256 (recurrentgemma-2b), on the CPU.

- ``attention_bwd_ref`` and ``attention_lse_ref`` at D = 256 against
  ``jax.vjp`` of the reference's ``models.common.attention`` and
  ``jax.nn.logsumexp`` of its logits.
- The D = 256 passes' tiles ("wide" in flash_attention.cu): shared memory
  a block within the 232 448 B a block may opt into, one 8-warp block an
  SM; ``plan_k7_bwd``'s runs at D = 256 (rows of at most
  ``K7_BWD_RUN_ROWS_WIDE``); the dk/dv pass's 32-key blocks and runs
  taking each (row, key block) pair a row sees once, and the dq pass's
  16-key tiles every key a 32-row block's rows see.
- The split tiles' swizzle and each lane's offsets at D = 256 (rows of
  128 chunks), as ``tests/test_torch_k7_bwd_design.py`` holds them at
  D ≤ 128; the raw tiles' swizzle (``rsw``): a permutation of each row's
  8-byte chunks that keeps 16-byte pieces whole, free of bank conflicts
  for the 8-byte reads along D and the 4-byte reads across rows.
- A plain-torch mirror of the wide decomposition: the dk/dv pass on
  32-key blocks walking 16-row tiles, the dq pass on 32-row blocks
  walking 16-key tiles, each product reduced over D formed per quarter of
  D (64 columns) and the quarters added in order, every product 3×TF32
  emulated; held against ``attention_bwd_ref`` and the reference's vjp
  within the card's tolerance (``K7_BWD_RTOL``·|ref| +
  ``K7_BWD_ATOL_OF_MAX``·max|ref|).

On a machine with a card the forward's lse and the backward are held
against the plain versions at D = 256 (``gpu`` marker)."""
import math
import os
import sys

import numpy as np
import pytest

from _reference_cache import no_persistent_compile_cache  # noqa: F401

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention_bwd_ref, attention_lse_ref, flash_attention,
    flash_attention_bwd, flash_attention_lse)
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    BWD_HEAD_DIMS, K7_BWD_ROWS, K7_BWD_RUN_ROWS_WIDE, check_backward,
    plan_k7_bwd)
import test_torch_k7_bwd_design as kd  # noqa: E402
from test_torch_attention_grad import _inputs, _reference_vjp  # noqa: E402
from test_torch_k7_design import LOG2E, _rows, tc_matmul  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402

RTOL, ATOL_OF_MAX = cs.K7_BWD_RTOL, cs.K7_BWD_ATOL_OF_MAX
D = 256
#: The wide passes' tiles (flash_attention.cu): keys a dk/dv block, rows a
#: tile it walks, rows a dq block, keys a tile it walks; warps a block (two
#: 16-key or 16-row groups by four quarters of D).
KEYS, BR, ROWS, BK, WARPS = 32, 16, 32, 16, 8

#: (B, H, Hkv, Lq, Lk, D, causal, window): GQA with one KV head, Lq < Lk
#: with a window, non-causal, non-causal Lq < Lk with a window, a group of
#: 16 rows, and ragged edges with several runs.
SHAPES = [
    (1, 2, 1, 20, 20, D, True, None),
    (1, 4, 1, 24, 56, D, True, 16),
    (1, 2, 2, 33, 33, D, False, None),
    (1, 4, 2, 24, 56, D, False, 9),
    (2, 8, 1, 2, 40, D, True, None),
    (1, 10, 1, 30, 70, D, True, 24),
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _tensors(shape):
    B, H, Hkv, Lq, Lk, d, causal, window = shape
    return tuple(map(torch.from_numpy, _inputs(B, H, Hkv, Lq, Lk, d)))


_close = kd._close


# ------------------------------------------- the plain versions at D = 256

@pytest.mark.parametrize("shape", SHAPES[:4], ids=str)
def test_plain_backward_and_lse_match_the_reference(shape):
    B, H, Hkv, Lq, Lk, d, causal, window = shape
    q, k, v, do = _tensors(shape)
    got = attention_bwd_ref(q, k, v, do, causal=causal, window=window)
    for chunk, (_, *want) in _reference_vjp(shape).items():
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            assert g.dtype == torch.float32 and g.shape == w.shape
            _close(f"{name} (reference chunks of {chunk})", g, w)
    rep = H // Hkv
    logits = jnp.einsum("bhqd,bhkd->bhqk", jnp.asarray(q.numpy()),
                        jnp.repeat(jnp.asarray(k.numpy()), rep, axis=1)
                        ) * d ** -0.5
    qpos = jnp.arange(Lq)[:, None] + (Lk - Lq)
    kpos = jnp.arange(Lk)[None, :]
    mask = jnp.ones((Lq, Lk), bool)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    want = jax.nn.logsumexp(jnp.where(mask, logits, -jnp.inf),
                            axis=-1) / math.log(2.0)
    lse = attention_lse_ref(q, k, causal=causal, window=window)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-5)


def test_head_width_256_is_taken_by_the_backward():
    """D = 256 float32 passes ``check_backward``; bf16 stays refused."""
    assert D in BWD_HEAD_DIMS
    q = torch.zeros(1, 2, 4, D)
    check_backward(q, q[:, :1], q[:, :1])
    with pytest.raises(NotImplementedError, match="bfloat16"):
        check_backward(q.bfloat16(), q[:, :1].bfloat16(),
                       q[:, :1].bfloat16())


# --------------------------------------------------- the plan and tiles

def smem_dkdv_wide(d: int) -> int:
    """``smem_bwd_dkdv_wide``: K, V split, two buffers of raw Q, dO and of
    their (lse, Δ), the quarters' partials."""
    return (2 * KEYS * d * 8 + 2 * 2 * BR * d * 4 + WARPS * 2 * 2 * 32 * 16
            + 2 * BR * 8)


def smem_dq_wide(d: int) -> int:
    """``smem_bwd_dq_wide``: Q, dO split, two buffers of raw K, V, the
    quarters' partials."""
    return 2 * ROWS * d * 8 + 2 * 2 * BK * d * 4 + WARPS * 2 * 2 * 32 * 16


def test_shared_memory_one_block_of_eight_warps_an_sm():
    """Both wide passes fit what a block may opt into, and one 8-warp block
    an SM (two would need more than the SM's 233 472 B); a 64-key split
    tile of K and V at D = 256 alone would not fit."""
    assert smem_dkdv_wide(D) == 213_248 and smem_dq_wide(D) == 212_992
    for smem in (smem_dkdv_wide(D), smem_dq_wide(D)):
        assert smem <= 232_448
        assert 233_472 // (smem + 1024) == 1
    assert 2 * 64 * D * 8 > 232_448


def _rsw(r):
    """``rsw``: the XOR of row r's 8-byte chunk slots in a raw tile."""
    return ((r ^ (r >> 1)) & 3) << 2


def test_raw_tile_swizzle_is_conflict_free():
    """Each row's chunks land on each slot once and a 16-byte piece
    (chunks 2j, 2j + 1) stays whole; a half warp's 8-byte reads of chunk
    4s + t of rows r0 + g (g < 4, or g ≥ 4) and a warp's 4-byte reads of
    element 8m + g of rows r0 + 2t + e each cover the 32 banks once."""
    for r in range(64):
        assert sorted(c ^ _rsw(r) for c in range(D // 2)) == list(
            range(D // 2))
        for c in range(0, D // 2, 2):
            assert (c ^ _rsw(r)) % 2 == 0 and (c + 1) ^ _rsw(r) == \
                (c ^ _rsw(r)) + 1
    for r0 in range(0, 64, 8):
        for s in range(D // 8):
            for gs in (range(4), range(4, 8)):
                banks = []
                for g in gs:
                    for t in range(4):
                        w = (r0 + g) * D + 2 * ((4 * s + t) ^ _rsw(r0 + g))
                        banks += [w % 32, (w + 1) % 32]
                assert sorted(banks) == list(range(32)), (r0, s)
        for m in range(D // 8):
            for e in (0, 1):
                banks = []
                for g in range(8):
                    for t in range(4):
                        r, d = r0 + 2 * t + e, 8 * m + g
                        banks.append((r * D + 2 * ((d >> 1) ^ _rsw(r))
                                      + (d & 1)) % 32)
                assert sorted(banks) == list(range(32)), (r0, m, e)


@pytest.mark.parametrize("H,Hkv,Lq", [
    (10, 1, 4096), (10, 1, 1), (2, 1, 20), (16, 1, 4097), (8, 2, 2048)])
def test_plan_k7_bwd_at_d256(H, Hkv, Lq):
    """Runs of at most ``K7_BWD_RUN_ROWS_WIDE`` rows, none empty; 10 at
    recurrentgemma-2b's 4 096 positions (10 heads over one KV head); the
    D ≤ 128 plan unchanged."""
    rows = H // Hkv * Lq
    runs = plan_k7_bwd(H, Hkv, Lq, D)
    run_rows = -(-rows // runs)
    assert runs >= 1 and run_rows <= K7_BWD_RUN_ROWS_WIDE
    assert (runs - 1) * run_rows < rows
    if (H, Hkv, Lq) == (10, 1, 4096):
        assert runs == 10
    assert plan_k7_bwd(H, Hkv, Lq, 128) == plan_k7_bwd(H, Hkv, Lq)


def _run_rows(rep, Lq, Lk, causal, window, runs, j0):
    """The rows [f_beg, f_end) of each run of the 32-key block at j0."""
    rows, off = rep * Lq, Lk - Lq
    j1 = min(j0 + KEYS, Lk)
    p_lo = max(0, j0 - off) if causal else 0
    p_hi = min(Lq, j1 - 1 + window - off) if window else Lq
    run_rows = -(-rows // runs)
    return [(p_lo * rep + r * run_rows,
             min(p_hi * rep, p_lo * rep + r * run_rows + run_rows))
            for r in range(runs)]


def _sees(pos, j, causal, window):
    return (not causal or j <= pos) and (window is None or j > pos - window)


@pytest.mark.parametrize("shape", SHAPES + [
    (1, 10, 1, 300, 300, D, True, 48), (2, 10, 1, 64, 64, D, True, None)],
    ids=str)
def test_wide_blocks_and_tiles_cover_each_visible_pair_once(shape):
    B, H, Hkv, Lq, Lk, d, causal, window = shape
    rep, off = H // Hkv, Lk - Lq
    rows = rep * Lq
    for runs in sorted({1, 2, 3, plan_k7_bwd(H, Hkv, Lq, D)}):
        for j0 in range(0, Lk, KEYS):
            keys = range(j0, min(j0 + KEYS, Lk))
            want = [f for f in range(rows)
                    if any(_sees(f // rep + off, j, causal, window)
                           for j in keys)]
            got = [f for a, b in _run_rows(rep, Lq, Lk, causal, window,
                                           runs, j0) for f in range(a, b)]
            assert sorted(got) == want and len(set(got)) == len(got)
    for f0 in range(0, rows, ROWS):
        f_last = min(f0 + ROWS, rows) - 1
        p0, p1 = f0 // rep + off, f_last // rep + off
        lo = max(0, p0 - window + 1) if window else 0
        hi = min(Lk, p1 + 1) if causal else Lk
        tiles = set(range((lo // BK) * BK, hi, BK))
        for f in range(f0, f_last + 1):
            for j in range(Lk):
                if _sees(f // rep + off, j, causal, window):
                    assert (j // BK) * BK in tiles
    assert -(-rows // K7_BWD_ROWS) * K7_BWD_ROWS % ROWS == 0


def test_split_tile_swizzle_and_lane_offsets_at_d256():
    """Rows of 128 chunks (512 words, a multiple of the 32 banks): the
    swizzle stays a bank-conflict-free permutation and ``StLane``'s
    offsets address the slots ``st_slot`` maps, as at D ≤ 128."""
    kd.test_split_tile_swizzle_is_a_bank_conflict_free_permutation(D)
    kd.test_lane_offsets_are_the_slot_map(D)


# ------------------------------------ the wide decomposition, mirrored

def _quarters(a, b_t, terms=3):
    """a @ b_tᵀ reduced over D as the wide passes form it: each quarter of
    D (64 columns) a 3×TF32 product, the four added in quarter order."""
    q = a.shape[1] // 4
    out = tc_matmul(a[:, :q], b_t[:, :q].T, terms)
    for i in range(1, 4):
        out = out + tc_matmul(a[:, i * q:(i + 1) * q],
                              b_t[:, i * q:(i + 1) * q].T, terms)
    return out


def mirror_backward_wide(q, k, v, do, *, causal, window, scale, runs=None,
                         terms=3):
    """The D = 256 backward's passes in plain torch: (dq, dk, dv)."""
    B, H, Lq, d = q.shape
    Hkv, Lk = k.shape[1], k.shape[2]
    rep, off, rows = H // Hkv, Lk - Lq, H // Hkv * Lq
    o, lse = kd.mirror_forward(q, k, v, causal=causal, window=window,
                               scale=scale, terms=terms)
    c = torch.tensor(scale, dtype=torch.float32) * LOG2E
    prod = lambda a, b: tc_matmul(a, b, terms)  # noqa: E731
    runs = runs or plan_k7_bwd(H, Hkv, Lq, d)
    pad = -(-rows // K7_BWD_ROWS) * K7_BWD_ROWS + max(BR, ROWS)
    dq = torch.zeros(B, H, Lq, d)
    dk, dv = torch.zeros(B, Hkv, Lk, d), torch.zeros(B, Hkv, Lk, d)
    for b in range(B):
        for hk in range(Hkv):
            heads = slice(hk * rep, (hk + 1) * rep)
            Q, dO = torch.zeros(pad, d), torch.zeros(pad, d)
            Q[:rows] = _rows(q[b, heads], rep, Lq)
            dO[:rows] = _rows(do[b, heads], rep, Lq)
            st = torch.zeros(pad, 2)
            st[:rows, 0] = lse[b, heads].T.reshape(rows)
            # Δ = rowsum(dO ∘ o) of each row, o the forward's output.
            st[:rows, 1] = (dO[:rows] * _rows(o[b, heads], rep, Lq)).sum(1)
            # dk/dv: 32-key blocks, runs, 16-row tiles.
            for j0 in range(0, Lk, KEYS):
                kn = min(j0 + KEYS, Lk) - j0
                Kt, Vt = torch.zeros(KEYS, d), torch.zeros(KEYS, d)
                Kt[:kn], Vt[:kn] = k[b, hk, j0:j0 + kn], v[b, hk, j0:j0 + kn]
                keys = torch.arange(j0, j0 + KEYS)
                sk = torch.zeros(KEYS, d)
                sv = torch.zeros(KEYS, d)
                for f_beg, f_end in _run_rows(rep, Lq, Lk, causal, window,
                                              runs, j0):
                    ak, av = torch.zeros(KEYS, d), torch.zeros(KEYS, d)
                    for f0 in range(f_beg, f_end, BR):
                        live = (torch.arange(f0, f0 + BR) < f_end)[:, None]
                        Qt = torch.where(live, Q[f0:f0 + BR], 0.0)
                        Ot = torch.where(live, dO[f0:f0 + BR], 0.0)
                        S = torch.where(live, st[f0:f0 + BR], 0.0)
                        sT, dpT = _quarters(Kt, Qt, terms), _quarters(
                            Vt, Ot, terms)
                        pT = torch.exp2(sT * c - S[:, 0][None, :])
                        if not kd._full(f0 // rep + off,
                                        (f0 + BR - 1) // rep + off, j0,
                                        KEYS, Lk, causal, window):
                            pos = torch.arange(f0, f0 + BR) // rep + off
                            pT = torch.where(kd._visible(
                                pos, keys, causal, window, Lk).T, pT, 0.0)
                        dsT = pT * (dpT - S[:, 1][None, :])
                        av = av + prod(pT, Ot)
                        ak = ak + prod(dsT, Qt)
                    sk, sv = sk + ak, sv + av          # in run order
                dk[b, hk, j0:j0 + kn] = (sk * scale)[:kn]
                dv[b, hk, j0:j0 + kn] = sv[:kn]
            # dq: 32-row blocks, 16-key tiles.
            DQ = torch.zeros(pad, d)
            for f0 in range(0, rows, ROWS):
                f_last = min(f0 + ROWS, rows) - 1
                p0, p1 = f0 // rep + off, f_last // rep + off
                lo = max(0, p0 - window + 1) if window else 0
                hi = min(Lk, p1 + 1) if causal else Lk
                pos = torch.arange(f0, f0 + ROWS) // rep + off
                acc = torch.zeros(ROWS, d)
                for kt in range((lo // BK) * BK, hi, BK):
                    kn = min(kt + BK, Lk) - kt
                    Kt, Vt = torch.zeros(BK, d), torch.zeros(BK, d)
                    Kt[:kn], Vt[:kn] = k[b, hk, kt:kt + kn], v[b, hk,
                                                               kt:kt + kn]
                    s = _quarters(Q[f0:f0 + ROWS], Kt, terms)
                    dp = _quarters(dO[f0:f0 + ROWS], Vt, terms)
                    p = torch.exp2(s * c - st[f0:f0 + ROWS, 0][:, None])
                    if not kd._full(p0, p1, kt, BK, Lk, causal, window):
                        p = torch.where(kd._visible(pos, torch.arange(
                            kt, kt + BK), causal, window, Lk), p, 0.0)
                    ds = p * (dp - st[f0:f0 + ROWS, 1][:, None])
                    acc = acc + prod(ds, Kt)
                DQ[f0:f0 + ROWS] = acc
            dq[b, heads] = (DQ[:rows] * scale).reshape(Lq, rep, d) \
                .permute(1, 0, 2)
    return dq, dk, dv


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_wide_mirror_matches_the_plain_version(shape):
    B, H, Hkv, Lq, Lk, d, causal, window = shape
    q, k, v, do = _tensors(shape)
    got = mirror_backward_wide(q, k, v, do, causal=causal, window=window,
                               scale=d ** -0.5)
    want = attention_bwd_ref(q, k, v, do, causal=causal, window=window)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _close(f"{name} vs attention_bwd_ref", g, w)
    if shape in SHAPES[:4]:
        for name, g, w in zip(("dq", "dk", "dv"), got,
                              _reference_vjp(shape)[1024][1:]):
            _close(f"{name} vs the reference's vjp", g, w)


@pytest.mark.parametrize("runs", [2, 3])
def test_wide_mirror_with_several_runs(runs):
    """The runs' partials added in run order, whatever the runs."""
    shape = SHAPES[5]
    B, H, Hkv, Lq, Lk, d, causal, window = shape
    q, k, v, do = _tensors(shape)
    got = mirror_backward_wide(q, k, v, do, causal=causal, window=window,
                               scale=d ** -0.5, runs=runs)
    want = attention_bwd_ref(q, k, v, do, causal=causal, window=window)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _close(f"{name} with {runs} runs", g, w)


def test_cpu_wrappers_at_d256_are_the_plain_versions():
    q, k, v, do = _tensors(SHAPES[1])
    LAUNCHES.clear()
    o, lse = flash_attention_lse(q, k, v, window=16)
    got = flash_attention_bwd(q, k, v, do, window=16, lse=lse, o=o)
    for g, w in zip(got, attention_bwd_ref(q, k, v, do, window=16)):
        assert torch.equal(g, w)
    assert not LAUNCHES


# ------------------------------------------------------------- on the card

@pytest.mark.gpu
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_cuda_backward_at_d256(shape):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU form)")
    B, H, Hkv, Lq, Lk, d, causal, window = shape
    host = _tensors(shape)
    q, k, v = (t.cuda().requires_grad_(True) for t in host[:3])
    LAUNCHES.clear()
    o = flash_attention(q, k, v, causal=causal, window=window)
    o.backward(host[3].cuda())
    assert dict(LAUNCHES) == {"flash_attention": 1, "flash_attention_bwd": 1}
    want = attention_bwd_ref(*host, causal=causal, window=window)
    for name, t, w in zip(("dq", "dk", "dv"), (q, k, v), want):
        _close(name, t.grad.cpu(), w)
