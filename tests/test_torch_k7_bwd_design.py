"""The tensor-core design of K7's backward, on the CPU.

- ``attention_lse_ref`` (the log2-sum-exp K7's forward writes under grad)
  against ``jax.nn.logsumexp`` of the reference's logits divided by ln 2.
- ``plan_k7_bwd`` within its bounds, and the decomposition's coverage:
  the dk/dv pass's runs take each (row, key tile) pair a row sees exactly
  once, and the dq pass's key tiles every key a block's rows see.
- The split tiles' swizzle: a permutation of each row's chunks, free of
  bank conflicts for the 16-byte reads along D and the 8-byte reads
  across rows; and the kernels' shared memory within what a block may
  opt into, eight warps an SM at every head width.
- A plain-torch mirror of the backward's decomposition: the lse from a
  mirror of the forward's tensor-core regime (64-row blocks, 32-key
  tiles, online softmax), Δ = rowsum(dO ∘ o) of its output, the dk/dv
  pass (64-key blocks, runs
  of rows, tiles of 64 rows at D = 32 and 32 above, the warp pairs'
  halves at D = 128 added in order, the runs' partials in run order), the
  dq pass (64-row blocks, 32-key tiles, pairs at D = 128), every product
  3×TF32 emulated as ``tests/test_torch_k7_design.py`` does, masks only
  on the tiles the kernels mask.  It is held against ``attention_bwd_ref``
  and against ``jax.vjp`` of the reference's ``models.common.attention``
  at ``tests/test_torch_attention_grad.py``'s eight shapes, a grad call of
  16 rows a group and ``chip_smoke.py``'s D = 128 causal window case,
  within the card's tolerance (``K7_BWD_RTOL``·|ref| +
  ``K7_BWD_ATOL_OF_MAX``·max|ref|: float32-accurate products summed in
  another order).  With one TF32 product instead of three the mirror
  misses that tolerance: the reason the kernels split their products.

On a machine with a card, the forward's lse is held against
``attention_lse_ref`` and the backward given it against
``attention_bwd_ref`` (``gpu`` marker)."""
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
    attention_bwd_ref, attention_lse_ref, attention_ref,
    flash_attention_bwd, flash_attention_lse)
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    K7_BWD_ROWS, K7_BWD_RUN_ROWS, plan_k7_bwd)
from test_torch_attention_grad import (  # noqa: E402
    SHAPES, _inputs, _reference_vjp)
from test_torch_k7_design import (  # noqa: E402
    LOG2E, _key_ok, _rows, _softmax_step, _tile_full, k7_tile_a, tc_matmul)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402

RTOL, ATOL_OF_MAX = cs.K7_BWD_RTOL, cs.K7_BWD_ATOL_OF_MAX
#: The kernels' tiles (flash_attention.cu): keys a dk/dv block, rows a dq
#: block, keys a dq tile.
KEYS, ROWS, BK = 64, 64, 32
#: A grad call of 16 rows a group, which the forward without grad would
#: give the split kernel, and chip_smoke's D = 128 causal case with a
#: window.
MORE = [(2, 8, 2, 4, 40, 64, True, None), (1, 4, 2, 130, 200, 128, True, 48)]


def bwd_br(D: int) -> int:
    """Rows a tile of the dk/dv pass (``bwd_br``)."""
    return 64 if D <= 32 else 32


def bwd_pair(D: int) -> int:
    """Warps sharing a 16-key or 16-row group (``bwd_pair``)."""
    return 2 if D > 64 else 1


def smem_dkdv(D: int) -> int:
    br = bwd_br(D)
    return 2 * KEYS * D * 8 + 2 * br * D * 12 + br * (2 * 8 + 4)


def smem_dq(D: int) -> int:
    return 2 * ROWS * D * 8 + 2 * BK * D * 12


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _tensors(shape):
    B, H, Hkv, Lq, Lk, D, causal, window = shape
    return tuple(map(torch.from_numpy, _inputs(B, H, Hkv, Lq, Lk, D)))


def _close(name, got, want):
    """|got − want| ≤ RTOL·|want| + ATOL_OF_MAX·max|want| everywhere."""
    g = got.detach().double() if isinstance(got, torch.Tensor) else \
        torch.from_numpy(np.asarray(got, np.float64))
    w = want.detach().double() if isinstance(want, torch.Tensor) else \
        torch.from_numpy(np.asarray(want, np.float64))
    assert g.shape == w.shape, name
    assert bool(g.isfinite().all()), name
    tol = RTOL * w.abs() + ATOL_OF_MAX * float(w.abs().max())
    bad = (g - w).abs() > tol
    assert not bool(bad.any()), (f"{name}: {int(bad.sum())} outside, max "
                                 f"|Δ| {float((g - w).abs().max()):.3g}")


# ------------------------------------------------------------- the lse

@pytest.mark.parametrize("shape", SHAPES + MORE, ids=str)
def test_attention_lse_ref_matches_jax_logsumexp(shape):
    B, H, Hkv, Lq, Lk, D, causal, window = shape
    q, k, _, _ = _inputs(B, H, Hkv, Lq, Lk, D)
    rep = H // Hkv
    logits = jnp.einsum("bhqd,bhkd->bhqk", jnp.asarray(q),
                        jnp.repeat(jnp.asarray(k), rep, axis=1)) * D ** -0.5
    qpos = jnp.arange(Lq)[:, None] + (Lk - Lq)
    kpos = jnp.arange(Lk)[None, :]
    mask = jnp.ones((Lq, Lk), bool)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    want = jax.nn.logsumexp(jnp.where(mask, logits, -jnp.inf),
                            axis=-1) / math.log(2.0)
    got = attention_lse_ref(torch.from_numpy(q), torch.from_numpy(k),
                            causal=causal, window=window)
    assert got.dtype == torch.float32 and got.shape == (B, H, Lq)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-5)


def test_cpu_wrappers_are_the_plain_versions():
    """``flash_attention_lse`` on the CPU is (``attention_ref``,
    ``attention_lse_ref``) and ``flash_attention_bwd`` given its lse and
    output is ``attention_bwd_ref``, bit for bit, with no launch."""
    q, k, v, do = _tensors(SHAPES[6])
    LAUNCHES.clear()
    o, lse = flash_attention_lse(q, k, v, window=16)
    assert torch.equal(o, attention_ref(q, k, v, window=16))
    assert torch.equal(lse, attention_lse_ref(q, k, window=16))
    got = flash_attention_bwd(q, k, v, do, window=16, lse=lse, o=o)
    for g, w in zip(got, attention_bwd_ref(q, k, v, do, window=16)):
        assert torch.equal(g, w)
    assert not LAUNCHES


# ------------------------------------------------------------- the plan

@pytest.mark.parametrize("H,Hkv,Lq", [
    (2, 2, 64), (4, 1, 24), (8, 1, 150), (32, 4, 1024), (64, 4, 1024),
    (8, 2, 4), (16, 1, 1024), (8, 8, 1), (12, 4, 341), (64, 4, 4096)])
def test_plan_k7_bwd_within_its_bounds(H, Hkv, Lq):
    """At least one run, none longer than ``K7_BWD_RUN_ROWS`` rows and
    none empty; 8 runs at tinyllama-1.1b's prefill, 16 at qwen3-moe's."""
    rows = H // Hkv * Lq
    runs = plan_k7_bwd(H, Hkv, Lq)
    run_rows = -(-rows // runs)
    assert runs >= 1 and run_rows <= K7_BWD_RUN_ROWS
    assert (runs - 1) * run_rows < rows
    if (H, Hkv, Lq) == (32, 4, 1024):
        assert runs == 8
    if (H, Hkv, Lq) == (64, 4, 1024):
        assert runs == 16


def _run_rows(rep, Lq, Lk, causal, window, runs, j0):
    """The flattened rows [f_beg, f_end) of each run of the dk/dv block of
    key tile j0, as the kernel cuts them."""
    rows, off = rep * Lq, Lk - Lq
    j1 = min(j0 + KEYS, Lk)
    p_lo = max(0, j0 - off) if causal else 0
    p_hi = min(Lq, j1 - 1 + window - off) if window else Lq
    run_rows = -(-rows // runs)
    out = []
    for run in range(runs):
        f_beg = p_lo * rep + run * run_rows
        out.append((f_beg, min(p_hi * rep, f_beg + run_rows)))
    return out


def _sees(pos, j, causal, window):
    return (not causal or j <= pos) and (window is None or j > pos - window)


@pytest.mark.parametrize("shape", SHAPES + MORE + list(cs.K7_BWD_CASES),
                         ids=str)
def test_runs_and_tiles_cover_each_visible_pair_once(shape):
    B, H, Hkv, Lq, Lk, D, causal, window = shape
    rep, off = H // Hkv, Lk - Lq
    rows = rep * Lq
    for runs in sorted({1, 2, 3, plan_k7_bwd(H, Hkv, Lq)}):
        for j0 in range(0, Lk, KEYS):
            keys = range(j0, min(j0 + KEYS, Lk))
            want = [f for f in range(rows)
                    if any(_sees(f // rep + off, j, causal, window)
                           for j in keys)]
            got = [f for a, b in _run_rows(rep, Lq, Lk, causal, window,
                                           runs, j0) for f in range(a, b)]
            assert sorted(got) == want and len(set(got)) == len(got)
    # dq: a block's key tiles, from the aligned start, hold every key any
    # of its rows sees.
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


# ------------------------------------------------ the split tiles' layout

def _slot(r, c, D):
    """``st_slot``: the 16-byte slot of chunk c of row r."""
    return r * (D // 2) + (c ^ ((((r >> 1) & 3) << 1) ^ ((r & 1) << 2)))


@pytest.mark.parametrize("D", [32, 64, 128])
def test_split_tile_swizzle_is_a_bank_conflict_free_permutation(D):
    """Each row's chunks land on each of its slots once; a quarter warp's
    16-byte reads (lane (g, t) of row r0 + g, g < 2, chunk 4s + t: the
    S^T, dP^T, S, dP operands and the A fragments) cover the 32 banks once,
    and so do a half warp's 8-byte reads (element 8m + g of rows r0 + 2t
    and r0 + 2t + 1, g, t < 4: the dK, dV, dQ operands)."""
    for r in range(64):
        assert sorted(_slot(r, c, D) - r * (D // 2)
                      for c in range(D // 2)) == list(range(D // 2))

    def banks16(slot):          # the four 4-byte banks of a 16-byte slot
        return {(4 * slot + w) % 32 for w in range(4)}

    for r0 in range(0, 64, 2):
        for s in range(D // 8):
            got = [b for g in range(2) for t in range(4)
                   for b in banks16(_slot(r0 + g, 4 * s + t, D))]
            assert sorted(got) == list(range(32)), (r0, s)
    for r0 in range(0, 64, 8):
        for m in range(D // 8):
            for rr in (0, 1):
                got = []
                for g in range(4):
                    for t in range(4):
                        d = 8 * m + g
                        word = 4 * _slot(r0 + 2 * t + rr, d >> 1, D) + \
                            2 * (d & 1)
                        got += [word % 32, (word + 1) % 32]
                assert sorted(got) == list(range(32)), (r0, m, rr)


@pytest.mark.parametrize("D", [32, 64, 128])
def test_lane_offsets_are_the_slot_map(D):
    """``StLane``: lane (g, t)'s base offsets plus compile-time constants
    (4s, 8m, the 8-row group) address exactly the slots ``st_slot`` maps
    its fragments to: chunk 4s + t of row g (16-byte reads) and element
    8m + g of rows 2t, 2t + 1 (8-byte reads), g < 8, t < 4."""
    for g in range(8):
        for t in range(4):
            sw = (((g >> 1) & 3) << 1) ^ ((g & 1) << 2)
            h, h0 = sw >> 2, t >> 1
            col = (g & 3) + 4 * ((g >> 2) ^ (t & 1))
            p1e = g * (D // 2) + (t ^ (sw & 3)) + 4 * h
            p1 = (p1e, p1e - 8 * h)
            p2 = []
            for e in (0, 1):
                he = h0 ^ e
                base = (2 * t + e) * D + col + 8 * he
                p2.append((base, base - 16 * he))
            for r0 in (0, 8, 48):
                for s in range(D // 8):
                    assert (r0 * (D // 2) + p1[s & 1] + 4 * s
                            == _slot(r0 + g, 4 * s + t, D))
                for e in (0, 1):
                    for m in range(D // 8):
                        d = 8 * m + g
                        want = 2 * _slot(r0 + 2 * t + e, d >> 1, D) + (d & 1)
                        assert r0 * D + p2[e][m & 1] + 8 * m == want


def test_shared_memory_and_warps_an_sm():
    """Every backward kernel's shared memory within the 232 448 B a block
    may opt into; at D ≤ 64 two 4-warp blocks fit an SM's 233 472 B (1 KB
    reserved a block), at D = 128 one 8-warp block (two warps a 16-key or
    16-row group): eight warps an SM at every head width.  Four warps a
    block at D = 128 would not fit two: their K and V split tiles alone
    take 128 KB."""
    for D in (32, 64, 128):
        for smem in (smem_dkdv(D), smem_dq(D)):
            assert smem <= 232_448, D
            blocks = 233_472 // (smem + 1024)
            warps = 4 * bwd_pair(D)
            assert min(blocks, 2) * warps == 8, D
    assert smem_dkdv(64) == 115_328 and smem_dq(64) == 114_688
    assert smem_dkdv(128) == 230_016 and smem_dq(128) == 229_376
    assert 2 * KEYS * 128 * 8 > 233_472 // 2 - 1024
    assert K7_BWD_ROWS == ROWS


# ----------------------------------------- the decomposition, mirrored

def mirror_forward(q, k, v, *, causal, window, scale, terms=3):
    """The tensor-core forward in plain torch, with its lse: per (b, hk),
    64-row blocks of position-major rows, ``k7_tile_a(D)``-key tiles from
    the block's aligned start, masks only on the tiles the kernel masks,
    the online softmax on logits in log2 units; o = acc / l and lse = m +
    log2(l).  Returns float32 (o [B, H, Lq, D], lse [B, H, Lq])."""
    B, H, Lq, D = q.shape
    Hkv, Lk = k.shape[1], k.shape[2]
    rep, off, rows = H // Hkv, Lk - Lq, H // Hkv * Lq
    BKA = k7_tile_a(D)
    sl2 = torch.tensor(scale, dtype=torch.float32) * LOG2E
    prod = lambda a, b: tc_matmul(a, b, terms)  # noqa: E731
    o = torch.zeros(B, H, Lq, D)
    lse = torch.zeros(B, H, Lq)
    for b in range(B):
        for hk in range(Hkv):
            Q = _rows(q[b, hk * rep:(hk + 1) * rep].float(), rep, Lq)
            O, L = torch.zeros(rows, D), torch.zeros(rows)
            for f0 in range(0, rows, 64):
                f1 = min(f0 + 64, rows) - 1
                imin, imax = f0 // rep, f1 // rep
                hi = min(Lk, imax + off + 1) if causal else Lk
                lo = max(0, imin + off - window + 1) if window else 0
                qpos = torch.arange(f0, f1 + 1) // rep + off
                n = f1 + 1 - f0
                m = torch.full((n,), -1e30)
                l, acc = torch.zeros(n), torch.zeros(n, D)
                for kt in range((lo // BKA) * BKA, hi, BKA):
                    kn = min(hi, kt + BKA) - kt
                    Kt, Vt = torch.zeros(BKA, D), torch.zeros(BKA, D)
                    Kt[:kn], Vt[:kn] = k[b, hk, kt:kt + kn], v[b, hk,
                                                               kt:kt + kn]
                    s = prod(Q[f0:f1 + 1], Kt.T) * sl2
                    ok = _key_ok(torch.arange(kt, kt + BKA), hi, causal,
                                 window, qpos)
                    if not _tile_full(kt, BKA, hi, causal, window, imin,
                                      imax, off):
                        s = torch.where(ok, s, torch.full((), -1e30))
                    m, l, acc = _softmax_step(m, l, acc, s, ok, Vt, prod)
                O[f0:f1 + 1] = acc * (1.0 / torch.clamp(l, min=1e-30))[:,
                                                                     None]
                L[f0:f1 + 1] = m + torch.log2(l)
            o[b, hk * rep:(hk + 1) * rep] = O.reshape(Lq, rep, D) \
                .permute(1, 0, 2)
            lse[b, hk * rep:(hk + 1) * rep] = L.reshape(Lq, rep).T
    return o, lse


def _full(p0, p1, j0, n, Lk, causal, window):
    """``bwd_full``: rows at positions [p0, p1] see every key of [j0, j0 +
    n)."""
    return (j0 + n <= Lk and (not causal or j0 + n - 1 <= p0)
            and (window is None or j0 > p1 - window))


def _visible(pos, keys, causal, window, Lk):
    """[len(pos), len(keys)]: row at position pos sees key j."""
    ok = keys[None, :] < Lk
    if causal:
        ok = ok & (keys[None, :] <= pos[:, None])
    if window is not None:
        ok = ok & (keys[None, :] > pos[:, None] - window)
    return ok


def mirror_backward(q, k, v, do, *, causal, window, scale, terms=3,
                    runs=None):
    """The backward's four passes in plain torch on float32 operands;
    returns (dq, dk, dv)."""
    B, H, Lq, D = q.shape
    Hkv, Lk = k.shape[1], k.shape[2]
    rep, off, rows = H // Hkv, Lk - Lq, H // Hkv * Lq
    q, k, v, do = (t.float() for t in (q, k, v, do))
    o, lse = mirror_forward(q, k, v, causal=causal, window=window,
                            scale=scale, terms=terms)
    c = torch.tensor(scale, dtype=torch.float32) * LOG2E
    prod = lambda a, b: tc_matmul(a, b, terms)  # noqa: E731
    runs = runs or plan_k7_bwd(H, Hkv, Lq)
    BR, P = bwd_br(D), bwd_pair(D)
    rows_pad = -(-rows // ROWS) * ROWS
    pad = rows_pad + max(BR, ROWS)
    dq = torch.zeros(B, H, Lq, D)
    dk, dv = torch.zeros(B, Hkv, Lk, D), torch.zeros(B, Hkv, Lk, D)
    for b in range(B):
        for hk in range(Hkv):
            heads = slice(hk * rep, (hk + 1) * rep)
            # 1, 2. the lse and Δ of each flattened row, zeros past `rows`.
            Q, dO = torch.zeros(pad, D), torch.zeros(pad, D)
            Q[:rows] = _rows(q[b, heads], rep, Lq)
            dO[:rows] = _rows(do[b, heads], rep, Lq)
            st = torch.zeros(pad, 2)
            st[:rows, 0] = lse[b, heads].T.reshape(rows)
            # Δ = rowsum(dO ∘ o) of each row, o the forward's output.
            st[:rows, 1] = (dO[:rows] * _rows(o[b, heads], rep, Lq)).sum(1)
            # 2, 3. dk/dv: 64-key blocks, runs of rows, BR-row tiles.
            dk_sum = torch.zeros(Lk + KEYS, D)
            dv_sum = torch.zeros(Lk + KEYS, D)
            for j0 in range(0, Lk, KEYS):
                kn = min(j0 + KEYS, Lk) - j0
                Kt, Vt = torch.zeros(KEYS, D), torch.zeros(KEYS, D)
                Kt[:kn], Vt[:kn] = k[b, hk, j0:j0 + kn], v[b, hk, j0:j0 + kn]
                keys = torch.arange(j0, j0 + KEYS)
                parts = []
                for f_beg, f_end in _run_rows(rep, Lq, Lk, causal, window,
                                              runs, j0):
                    ak = [torch.zeros(KEYS, D) for _ in range(P)]
                    av = [torch.zeros(KEYS, D) for _ in range(P)]
                    for f0 in range(f_beg, f_end, BR):
                        live = (torch.arange(f0, f0 + BR) < f_end)[:, None]
                        Qt = torch.where(live, Q[f0:f0 + BR], 0.0)
                        Ot = torch.where(live, dO[f0:f0 + BR], 0.0)
                        S = torch.where(live, st[f0:f0 + BR], 0.0)
                        sT, dpT = prod(Kt, Qt.T), prod(Vt, Ot.T)
                        pT = torch.exp2(sT * c - S[:, 0][None, :])
                        if not _full(f0 // rep + off, (f0 + BR - 1) // rep
                                     + off, j0, KEYS, Lk, causal, window):
                            pos = torch.arange(f0, f0 + BR) // rep + off
                            pT = torch.where(_visible(pos, keys, causal,
                                                      window, Lk).T, pT, 0.0)
                        dsT = pT * (dpT - S[:, 1][None, :])
                        for h in range(P):      # a pair's halves of the rows
                            cols = slice(h * BR // P, (h + 1) * BR // P)
                            av[h] = av[h] + prod(pT[:, cols], Ot[cols])
                            ak[h] = ak[h] + prod(dsT[:, cols], Qt[cols])
                    parts.append((ak[0] + ak[1] if P == 2 else ak[0],
                                  av[0] + av[1] if P == 2 else av[0]))
                sk, sv = parts[0]
                for pk, pv in parts[1:]:                 # in run order
                    sk, sv = sk + pk, sv + pv
                dk_sum[j0:j0 + KEYS], dv_sum[j0:j0 + KEYS] = sk, sv
            dk[b, hk], dv[b, hk] = dk_sum[:Lk] * scale, dv_sum[:Lk]
            # 4. dq: 64-row blocks, 32-key tiles from the aligned start.
            DQ = torch.zeros(rows_pad, D)
            for f0 in range(0, rows, ROWS):
                f_last = min(f0 + ROWS, rows) - 1
                p0, p1 = f0 // rep + off, f_last // rep + off
                lo = max(0, p0 - window + 1) if window else 0
                hi = min(Lk, p1 + 1) if causal else Lk
                pos = torch.arange(f0, f0 + ROWS) // rep + off
                acc = [torch.zeros(ROWS, D) for _ in range(P)]
                for kt in range((lo // BK) * BK, hi, BK):
                    kn = min(kt + BK, Lk) - kt
                    Kt, Vt = torch.zeros(BK, D), torch.zeros(BK, D)
                    Kt[:kn], Vt[:kn] = k[b, hk, kt:kt + kn], v[b, hk,
                                                               kt:kt + kn]
                    s = prod(Q[f0:f0 + ROWS], Kt.T)
                    dp = prod(dO[f0:f0 + ROWS], Vt.T)
                    p = torch.exp2(s * c - st[f0:f0 + ROWS, 0][:, None])
                    if not _full(p0, p1, kt, BK, Lk, causal, window):
                        p = torch.where(_visible(pos, torch.arange(
                            kt, kt + BK), causal, window, Lk), p, 0.0)
                    ds = p * (dp - st[f0:f0 + ROWS, 1][:, None])
                    for h in range(P):          # a pair's halves of the keys
                        cols = slice(h * BK // P, (h + 1) * BK // P)
                        acc[h] = acc[h] + prod(ds[:, cols], Kt[cols])
                DQ[f0:f0 + ROWS] = acc[0] + acc[1] if P == 2 else acc[0]
            dq[b, heads] = (DQ[:rows] * scale).reshape(Lq, rep, D) \
                .permute(1, 0, 2)
    return dq, dk, dv


@pytest.mark.parametrize("shape", SHAPES + MORE, ids=str)
def test_mirror_matches_the_plain_version_and_the_reference_vjp(shape):
    B, H, Hkv, Lq, Lk, D, causal, window = shape
    q, k, v, do = _tensors(shape)
    o, lse = mirror_forward(q, k, v, causal=causal, window=window,
                            scale=D ** -0.5)
    _close("mirror's o", o, attention_ref(q, k, v, causal=causal,
                                          window=window))
    np.testing.assert_allclose(lse.numpy(), attention_lse_ref(
        q, k, causal=causal, window=window).numpy(), **cs.K7_LSE_TOL)
    got = mirror_backward(q, k, v, do, causal=causal, window=window,
                          scale=D ** -0.5)
    want = attention_bwd_ref(q, k, v, do, causal=causal, window=window)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _close(f"{name} vs attention_bwd_ref", g, w)
    if shape in SHAPES:
        for chunk, (_, *ref) in _reference_vjp(shape).items():
            for name, g, w in zip(("dq", "dk", "dv"), got, ref):
                _close(f"{name} vs the reference's vjp (chunks of {chunk})",
                       g, w)


@pytest.mark.parametrize("shape,runs", [
    (SHAPES[2], 2), (SHAPES[4], 3), (MORE[1], 2),
    ((1, 8, 1, 150, 260, 32, True, 30), 5)], ids=str)
def test_mirror_with_other_run_counts(shape, runs):
    """The dk/dv pass's partials added in run order, whatever the runs
    (runs that see none of a key tile's rows add zeros)."""
    B, H, Hkv, Lq, Lk, D, causal, window = shape
    rng = np.random.RandomState(Lq + Lk)
    q, k, v, do = (torch.from_numpy(rng.randn(*s).astype(np.float32))
                   for s in ((B, H, Lq, D), (B, Hkv, Lk, D), (B, Hkv, Lk, D),
                             (B, H, Lq, D)))
    want = attention_bwd_ref(q, k, v, do, causal=causal, window=window)
    got = mirror_backward(q, k, v, do, causal=causal, window=window,
                          scale=D ** -0.5, runs=runs)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _close(f"{name} with {runs} runs", g, w)


@pytest.mark.parametrize("shape", [SHAPES[1], SHAPES[5], MORE[1]], ids=str)
def test_mirror_with_one_tf32_product_misses_the_tolerance(shape):
    B, H, Hkv, Lq, Lk, D, causal, window = shape
    q, k, v, do = _tensors(shape)
    want = attention_bwd_ref(q, k, v, do, causal=causal, window=window)
    three = mirror_backward(q, k, v, do, causal=causal, window=window,
                            scale=D ** -0.5)
    one = mirror_backward(q, k, v, do, causal=causal, window=window,
                          scale=D ** -0.5, terms=1)
    for g, w in zip(three, want):
        _close("3 products", g, w)
    with pytest.raises(AssertionError):
        for g, w in zip(one, want):
            _close("1 product", g, w)


# ------------------------------------------------------------- on the card

@pytest.mark.gpu
@pytest.mark.parametrize("shape", SHAPES + MORE, ids=str)
def test_cuda_lse_and_backward_given_it(shape):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU form)")
    B, H, Hkv, Lq, Lk, D, causal, window = shape
    q, k, v, do = (t.cuda() for t in _tensors(shape))
    o, lse = flash_attention_lse(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(lse.cpu().numpy(), attention_lse_ref(
        q, k, causal=causal, window=window).cpu().numpy(), **cs.K7_LSE_TOL)
    got = flash_attention_bwd(q, k, v, do, causal=causal, window=window,
                              lse=lse, o=o)
    want = attention_bwd_ref(q, k, v, do, causal=causal, window=window)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _close(name, g.cpu(), w.cpu())
