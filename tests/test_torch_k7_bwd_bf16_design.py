"""The bf16 design of K7's backward, on the CPU.

The bf16 passes (``flash_attention.cu``, "backward on bf16 operands")
keep Q, dO, K and V as bf16 tiles in shared memory, read their fragments
by ``ldmatrix`` (``.trans`` for the operands of the products reduced over
rows or keys), multiply on m16n8k16 bf16 MMAs, and carry the float32 P
and dS into their products as three bf16 pieces.  Here:

- The three-piece split (``split3``): hi = bf16(x), mid = bf16(x − hi),
  lo = bf16(x − hi − mid), each a bf16 value, and hi + mid + lo == x
  exactly over a seeded sweep of P ∈ [0, 1] (0 past the mask included)
  and of dS of both signs, down to 2⁻¹¹⁰; below that, subnormals
  included, the bits under bf16's least subnormal 2⁻¹³³ drop (at most
  2⁻¹³⁴, exact where x is a multiple of 2⁻¹³³).
- The passes' shared memory (``plan_k7_bwd_bf16``) within the 232 448 B a
  block may opt into, two 4-warp blocks an SM at every head width.
- The tiles' swizzle (``bf_sw``): a permutation of each row's 16-byte
  chunks, and each lane's ldmatrix address (``BfLane``, both patterns)
  the chunk the fragment wants, every 8-lane phase on the 32 banks once.
- The plan's coverage: each (row, 64-key block) pair in one run once,
  and each dq block's 64-key tiles every key its rows see.
- A plain-torch mirror of the decomposition (64-key dk/dv blocks walking
  runs of rows ``rows`` a tile, 64-row dq blocks walking ``dq_keys``-key
  tiles,
  masks only where the kernels mask, S and dP from the bf16 operands,
  each P and dS product as three bf16-piece products lo, mid, hi summed
  in float32 a tile, dq, dk, dv rounded once to bf16) against
  ``attention_bwd_ref`` on the widened operands and against ``jax.vjp``
  of the reference's ``attention`` under bf16, at
  ``tests/test_torch_bf16_grad.py``'s shapes, within the bf16 pin
  (2e-4·|ref| + 2e-5·max|ref| + 2⁻⁸·|ref|: one rounding to bf16).  The
  reference's gradients are themselves rounded, so its comparison takes
  the mirror's sums before their rounding, and on a GQA group, whose
  heads' dk, dv the reference rounds one by one before it sums them, the
  rounding term over the heads' magnitudes.  A mirror with two pieces
  (hi, mid) meets the same pin at these shapes: 16 bits of P and dS are
  already below it (recorded, not shipped).

On a machine with a card the kernel is held against its plain version
(``gpu`` marker)."""
import os
import sys

import numpy as np
import pytest

from _reference_cache import no_persistent_compile_cache  # noqa: F401

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.models import common as jcommon  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention_bwd_ref, attention_lse_ref, attention_ref,
    flash_attention_bwd, flash_attention_lse)
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    BWD_BF16_HEAD_DIMS, K7_BWD_ROWS, plan_k7_bwd, plan_k7_bwd_bf16)
from test_torch_k7_bwd_design import (  # noqa: E402
    _full, _run_rows, _sees, _visible)
from test_torch_k7_design import LOG2E, _rows  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402

RTOL, ATOL_OF_MAX = cs.K7_BWD_RTOL, cs.K7_BWD_ATOL_OF_MAX
ROUND = cs.K7_BF16_ROUND
#: tests/test_torch_bf16_grad.py's shapes (B, H, Hkv, Lq, Lk, D, causal,
#: window): GQA, a window with Lq < Lk, non-causal D = 128, a narrow
#: window.
BF16_SHAPES = [(2, 4, 2, 48, 48, 32, True, None),
               (1, 4, 1, 40, 72, 64, True, 16),
               (1, 2, 2, 24, 56, 128, False, None),
               (2, 8, 2, 33, 33, 64, True, 8)]
#: Bytes a block may opt into, and an SM's shared memory (1 KB of it
#: reserved a block).
OPT_IN, SM_SMEM = 232_448, 233_472


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ------------------------------------------------------ the three pieces

def pieces(x, n=3):
    """``split3`` in torch: x's first n bf16 pieces (hi, mid, lo), each
    rounded to nearest even from the float32 remainder, as float32."""
    out, r = [], x.float()
    for _ in range(n):
        p = r.to(torch.bfloat16).float()
        out.append(p)
        r = r - p
    return out


def _sweep():
    """P ∈ [0, 1] (uniform, exp2 of the logits' range, 0 and 1) and dS
    of both signs over magnitudes 2⁻¹⁴⁹ .. 2⁸, zeros and subnormals."""
    rng = np.random.RandomState(34)
    p = np.concatenate([rng.rand(20_000), np.exp2(-rng.rand(20_000) * 150),
                        [0.0, 1.0, 0.5, 2.0 ** -126, 2.0 ** -149]])
    mag = np.exp2(rng.uniform(-149, 8, 40_000))
    ds = np.concatenate([mag * np.where(rng.rand(40_000) < 0.5, -1.0, 1.0),
                         [0.0, -0.0, 2.0 ** -149, -(2.0 ** -149),
                          2.0 ** -127, -(2.0 ** -130), 2.0 ** -110]])
    sub = rng.randint(1, 1 << 23, 5_000) * 2.0 ** -149      # subnormals
    return torch.from_numpy(np.concatenate([p, ds, sub, -sub])
                            .astype(np.float32))


def test_three_bf16_pieces_are_exact():
    x = _sweep()
    hi, mid, lo = pieces(x)
    for piece in (hi, mid, lo):
        assert torch.equal(piece, piece.to(torch.bfloat16).float())
    total = hi.double() + mid.double() + lo.double()
    err = (total - x.double()).abs()
    normal = x.double().abs() >= 2.0 ** -110
    assert bool(normal.sum() > 60_000)
    assert bool((err[normal] == 0).all())
    # The float32 sum of the pieces, in the order a product adds them,
    # is x as well.
    assert torch.equal(((lo + mid) + hi)[normal], x[normal])
    # Below 2^-110 the bits under bf16's least subnormal drop.
    assert bool((err <= 2.0 ** -134).all())
    step = (x.double() / 2.0 ** -133)
    exact = step == step.round()
    assert bool((err[exact] == 0).all())
    assert bool((hi[x == 0] == 0).all() and (lo[x == 0] == 0).all())


def test_two_pieces_carry_16_bits():
    """hi + mid alone leaves at most 2⁻¹⁷ of |x| (x ≥ 2⁻¹¹⁰): what the
    two-piece ablation drops."""
    x = _sweep()
    hi, mid = pieces(x, 2)
    keep = x.abs() >= 2.0 ** -110
    rel = ((hi.double() + mid.double() - x.double()).abs()
           / x.double().abs())[keep]
    assert float(rel.max()) <= 2.0 ** -17


# ------------------------------------------------ shared memory and tiles

@pytest.mark.parametrize("D", BWD_BF16_HEAD_DIMS)
def test_shared_memory_two_blocks_an_sm(D):
    t = plan_k7_bwd_bf16(D)
    assert (t.keys, t.dq_rows) == (64, 64)
    assert (t.rows, t.dq_keys) == ((32, 64) if D <= 64 else (16, 32))
    for smem in (t.smem_dkdv, t.smem_dq):
        assert smem <= OPT_IN
        assert SM_SMEM // (smem + 1024) >= 2
    want = {32: (16_896, 24_576), 64: (33_280, 49_152),
            128: (49_408, 65_536)}[D]
    assert (t.smem_dkdv, t.smem_dq) == want
    # A quarter of the float32 passes' split tiles (8 B an element).
    assert 2 * t.keys * D * 2 * 4 == 2 * 64 * D * 8
    assert t.dq_rows == K7_BWD_ROWS
    with pytest.raises(ValueError):
        plan_k7_bwd_bf16(256)


def bf_sw(r, D):
    """``bf_sw``: the swizzle of row r's 16-byte chunks."""
    return (r & 7) if D >= 64 else ((r >> 1) & 3)


def bf_at(r, c, D):
    """``bf_at``: the byte offset of chunk c of row r."""
    return r * 2 * D + ((c ^ bf_sw(r, D)) << 4)


def lane_addr(pattern, lane, r0, c, D):
    """``BfLane::a`` / ``BfLane::b``: lane's ldmatrix address (bytes), a
    row base, the constant (c & ~7) << 4 and one of the lane's four
    offsets."""
    if pattern == "a":
        row, bit = lane & 15, lane >> 4
    else:
        row, bit = (lane & 7) + 8 * (lane >> 4), (lane >> 3) & 1
    x = bit ^ bf_sw(row, D)
    offs = [row * 2 * D + (((2 * i) ^ x) << 4) for i in range(4)]
    return r0 * 2 * D + ((c & ~7) << 4) + offs[(c & 7) >> 1]


@pytest.mark.parametrize("D", BWD_BF16_HEAD_DIMS)
def test_swizzle_is_a_bank_conflict_free_permutation(D):
    """Each row's chunks land on each of its slots once; each lane's
    address is the chunk its fragment wants (``a``: rows r0 + (l & 15) at
    chunk c + (l >> 4); ``b``: rows r0 + (l & 7) + 8 (l >> 4) at chunk c +
    ((l >> 3) & 1)); and each 8-lane phase of an ldmatrix.x4, plain or
    .trans, reads 8 chunks on distinct 16-byte bank groups."""
    cpr = D // 8
    for r in range(64):
        assert sorted((bf_at(r, c, D) - r * 2 * D) >> 4
                      for c in range(cpr)) == list(range(cpr))
    for pattern in ("a", "b"):
        for r0 in range(0, 64 - 15, 8):
            for c in range(0, cpr, 2):
                addrs = [lane_addr(pattern, l, r0, c, D) for l in range(32)]
                for l, got in enumerate(addrs):
                    if pattern == "a":
                        want = bf_at(r0 + (l & 15), c + (l >> 4), D)
                    else:
                        want = bf_at(r0 + (l & 7) + 8 * (l >> 4),
                                     c + ((l >> 3) & 1), D)
                    assert got == want
                for ph in range(4):
                    groups = {(a >> 4) % 8 for a in addrs[8 * ph:8 * ph + 8]}
                    assert len(groups) == 8, (pattern, r0, c, ph)


# ------------------------------------------------------------- the plan

@pytest.mark.parametrize("shape", BF16_SHAPES + [
    s for s in cs.K7_BWD_CASES if s[5] in BWD_BF16_HEAD_DIMS], ids=str)
def test_plan_covers_each_visible_pair_once(shape):
    B, H, Hkv, Lq, Lk, D, causal, window = shape
    t = plan_k7_bwd_bf16(D)
    rep, off = H // Hkv, Lk - Lq
    rows = rep * Lq
    for runs in sorted({1, 2, plan_k7_bwd(H, Hkv, Lq, D, bf16=True)}):
        for j0 in range(0, Lk, t.keys):
            keys = range(j0, min(j0 + t.keys, Lk))
            want = [f for f in range(rows)
                    if any(_sees(f // rep + off, j, causal, window)
                           for j in keys)]
            got = []
            for a, b in _run_rows(rep, Lq, Lk, causal, window, runs, j0):
                for f0 in range(a, b, t.rows):     # the walked row tiles
                    got += range(f0, min(f0 + t.rows, b))
            assert sorted(got) == want and len(set(got)) == len(got)
    for f0 in range(0, rows, t.dq_rows):
        f_last = min(f0 + t.dq_rows, rows) - 1
        p0, p1 = f0 // rep + off, f_last // rep + off
        lo = max(0, p0 - window + 1) if window else 0
        hi = min(Lk, p1 + 1) if causal else Lk
        tiles = set(range((lo // t.dq_keys) * t.dq_keys, hi, t.dq_keys))
        for f in range(f0, f_last + 1):
            for j in range(Lk):
                if _sees(f // rep + off, j, causal, window):
                    assert (j // t.dq_keys) * t.dq_keys in tiles


# ----------------------------------------- the decomposition, mirrored

def piece_product(a, b, n=3):
    """a @ b for a float32 a (P or dS) and a bf16-valued b: a partial of
    the tile, a's pieces lo, mid, hi (the first n) multiplied exactly and
    summed in float32 in that order."""
    out = None
    for p in reversed(pieces(a, n)):
        term = p @ b
        out = term if out is None else out + term
    return out


def mirror_backward_bf16(q, k, v, do, *, causal, window, n=3,
                         rounded=True):
    """The bf16 backward's passes in plain torch: bf16 q, k, v, dO;
    returns (dq, dk, dv) as float32, rounded once to bf16 (as the kernels
    store them) unless ``rounded`` is False."""
    B, H, Lq, D = q.shape
    Hkv, Lk = k.shape[1], k.shape[2]
    rep, off, rows = H // Hkv, Lk - Lq, H // Hkv * Lq
    scale = D ** -0.5
    t = plan_k7_bwd_bf16(D)
    q, k, v, do = (x.float() for x in (q, k, v, do))
    o = attention_ref(q, k, v, causal=causal, window=window)
    lse = attention_lse_ref(q, k, causal=causal, window=window)
    c = torch.tensor(scale, dtype=torch.float32) * LOG2E
    runs = plan_k7_bwd(H, Hkv, Lq, D, bf16=True)
    rows_pad = -(-rows // K7_BWD_ROWS) * K7_BWD_ROWS
    pad = rows_pad + max(t.rows, t.dq_rows)
    dq = torch.zeros(B, H, Lq, D)
    dk, dv = torch.zeros(B, Hkv, Lk, D), torch.zeros(B, Hkv, Lk, D)
    for b in range(B):
        for hk in range(Hkv):
            heads = slice(hk * rep, (hk + 1) * rep)
            Q, dO = torch.zeros(pad, D), torch.zeros(pad, D)
            Q[:rows] = _rows(q[b, heads], rep, Lq)
            dO[:rows] = _rows(do[b, heads], rep, Lq)
            st = torch.zeros(pad, 2)
            st[:rows, 0] = lse[b, heads].T.reshape(rows)
            st[:rows, 1] = (dO[:rows] * _rows(o[b, heads], rep, Lq)).sum(1)
            # dk/dv: 64-key blocks, runs of rows, t.rows rows a tile.
            NK = t.keys
            Kp, Vp = torch.zeros(Lk + NK, D), torch.zeros(Lk + NK, D)
            Kp[:Lk], Vp[:Lk] = k[b, hk], v[b, hk]
            for j0 in range(0, Lk, NK):
                Kt, Vt = Kp[j0:j0 + NK], Vp[j0:j0 + NK]
                keys = torch.arange(j0, j0 + NK)
                parts = []
                for f_beg, f_end in _run_rows(rep, Lq, Lk, causal, window,
                                              runs, j0):
                    ak, av = torch.zeros(NK, D), torch.zeros(NK, D)
                    for f0 in range(f_beg, f_end, t.rows):
                        live = (torch.arange(f0, f0 + t.rows) < f_end)[:, None]
                        Qt = torch.where(live, Q[f0:f0 + t.rows], 0.0)
                        Ot = torch.where(live, dO[f0:f0 + t.rows], 0.0)
                        S = torch.where(live, st[f0:f0 + t.rows], 0.0)
                        sT, dpT = Kt @ Qt.T, Vt @ Ot.T
                        pT = torch.exp2(sT * c - S[:, 0][None, :])
                        if not _full(f0 // rep + off, (f0 + t.rows - 1) // rep
                                     + off, j0, NK, Lk, causal, window):
                            pos = torch.arange(f0, f0 + t.rows) // rep + off
                            pT = torch.where(_visible(pos, keys, causal,
                                                      window, Lk).T, pT, 0.0)
                        dsT = pT * (dpT - S[:, 1][None, :])
                        av = av + piece_product(pT, Ot, n)
                        ak = ak + piece_product(dsT, Qt, n)
                    parts.append((ak, av))
                sk, sv = parts[0]
                for pk, pv in parts[1:]:                 # in run order
                    sk, sv = sk + pk, sv + pv
                kn = min(NK, Lk - j0)
                dk[b, hk, j0:j0 + kn] = (sk * scale)[:kn]
                dv[b, hk, j0:j0 + kn] = sv[:kn]
            # dq: 64-row blocks, dq_keys-key tiles from the aligned start.
            BQ, BK = t.dq_rows, t.dq_keys
            DQ = torch.zeros(rows_pad, D)
            Kp, Vp = torch.zeros(Lk + BK, D), torch.zeros(Lk + BK, D)
            Kp[:Lk], Vp[:Lk] = k[b, hk], v[b, hk]
            for f0 in range(0, rows, BQ):
                f_last = min(f0 + BQ, rows) - 1
                p0, p1 = f0 // rep + off, f_last // rep + off
                lo = max(0, p0 - window + 1) if window else 0
                hi = min(Lk, p1 + 1) if causal else Lk
                pos = torch.arange(f0, f0 + BQ) // rep + off
                acc = torch.zeros(BQ, D)
                for kt in range((lo // BK) * BK, hi, BK):
                    Kt, Vt = Kp[kt:kt + BK], Vp[kt:kt + BK]
                    s = Q[f0:f0 + BQ] @ Kt.T
                    dp = dO[f0:f0 + BQ] @ Vt.T
                    p = torch.exp2(s * c - st[f0:f0 + BQ, 0][:, None])
                    if not _full(p0, p1, kt, BK, Lk, causal, window):
                        p = torch.where(_visible(pos, torch.arange(
                            kt, kt + BK), causal, window, Lk), p, 0.0)
                    ds = p * (dp - st[f0:f0 + BQ, 1][:, None])
                    acc = acc + piece_product(ds, Kt, n)
                DQ[f0:f0 + BQ] = acc
            dq[b, heads] = (DQ[:rows] * scale).reshape(Lq, rep, D) \
                .permute(1, 0, 2)
    if not rounded:
        return dq, dk, dv
    return tuple(x.to(torch.bfloat16).float() for x in (dq, dk, dv))


def _bf16_inputs(shape):
    """test_torch_bf16_grad.py's inputs: seeded, rounded to bf16."""
    B, H, Hkv, Lq, Lk, D, causal, window = shape
    rng = np.random.RandomState(B * Lq + D)
    return [torch.from_numpy(rng.randn(*s).astype(np.float32) * sc)
            .to(torch.bfloat16)
            for s, sc in (((B, H, Lq, D), 0.5), ((B, Hkv, Lk, D), 0.5),
                          ((B, Hkv, Lk, D), 1.0), ((B, H, Lq, D), 1.0))]


def _outside(got, want, rounded=None):
    """Elements outside the bf16 pin, |got − want| > 2e-4·|want| +
    2e-5·max|want| + 2⁻⁸·``rounded`` (the magnitude rounded once to bf16:
    |want| unless given), and the largest |Δ|."""
    g, w = got.double(), want.double()
    assert g.shape == w.shape and bool(g.isfinite().all())
    r = w.abs() if rounded is None else rounded.double()
    tol = RTOL * w.abs() + ATOL_OF_MAX * float(w.abs().max()) + ROUND * r
    return int(((g - w).abs() > tol).sum()), float((g - w).abs().max())


def _reference_vjp_bf16(shape, q, k, v, do):
    """``jax.vjp`` of the reference's ``attention`` under bf16 on the same
    values, with k and v given one head per query head: dq, and each query
    head's dk, dv [B, H, Lk, D], each a bf16 gradient rounded once.  On a
    GQA group the reference itself rounds each head's dk, dv to bf16
    before it sums them (the transpose of its broadcast), so the group's
    sum is taken here, in float64, beside the sum of the heads'
    magnitudes that were rounded."""
    B, H, Hkv, Lq, Lk, D, causal, window = shape
    rep = H // Hkv
    jq, jk, jv, jdo = (jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
                       for x in (q, k, v, do))
    jk, jv = (jnp.repeat(x, rep, axis=1) for x in (jk, jv))
    _, vjp = jax.vjp(lambda a, b, c: jcommon.attention(
        a, b, c, causal=causal, window=window), jq, jk, jv)
    dq, dk, dv = (torch.from_numpy(np.array(g.astype(jnp.float32)))
                  .double() for g in vjp(jdo))
    group = [x.reshape(B, Hkv, rep, Lk, D) for x in (dk, dv)]
    return ((dq, dq.abs()),
            *((x.sum(2), x.abs().sum(2)) for x in group))


@pytest.mark.parametrize("shape", BF16_SHAPES, ids=str)
def test_mirror_matches_the_plain_version_and_the_reference_vjp(shape):
    B, H, Hkv, Lq, Lk, D, causal, window = shape
    q, k, v, do = _bf16_inputs(shape)
    got = mirror_backward_bf16(q, k, v, do, causal=causal, window=window)
    want = attention_bwd_ref(q.float(), k.float(), v.float(), do.float(),
                             causal=causal, window=window)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        n, big = _outside(g, w)
        assert n == 0, f"{name} vs attention_bwd_ref: {n} outside, {big:.3g}"
    # The reference's gradients are bf16, rounded once (a head at a time):
    # the pin holds the mirror's float32 sums, before their own rounding,
    # to them.
    sums = mirror_backward_bf16(q, k, v, do, causal=causal, window=window,
                                rounded=False)
    ref = _reference_vjp_bf16(shape, q, k, v, do)
    for name, g, (w, r) in zip(("dq", "dk", "dv"), sums, ref):
        n, big = _outside(g, w, r)
        assert n == 0, f"{name} vs the reference's vjp: {n} outside, {big:.3g}"


@pytest.mark.parametrize("shape", BF16_SHAPES, ids=str)
def test_two_piece_mirror_meets_the_pin(shape):
    """The ablation's form (hi + mid, 16 bits of P and dS) also meets the
    bf16 pin against ``attention_bwd_ref`` here; the kernel keeps three
    pieces, float32-accurate products, as the reference keeps P and dS in
    float32."""
    B, H, Hkv, Lq, Lk, D, causal, window = shape
    q, k, v, do = _bf16_inputs(shape)
    got = mirror_backward_bf16(q, k, v, do, causal=causal, window=window,
                               n=2)
    want = attention_bwd_ref(q.float(), k.float(), v.float(), do.float(),
                             causal=causal, window=window)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        n, big = _outside(g, w)
        assert n == 0, f"{name}: {n} outside, {big:.3g}"


def test_cpu_wrapper_is_the_plain_version_in_bf16():
    """On the CPU ``flash_attention_bwd`` on bf16 operands is
    ``attention_bwd_ref`` rounded once to bf16, given the forward's lse
    and output or not."""
    shape = BF16_SHAPES[1]
    B, H, Hkv, Lq, Lk, D, causal, window = shape
    q, k, v, do = _bf16_inputs(shape)
    o, lse = flash_attention_lse(q, k, v, causal=causal, window=window)
    want = attention_bwd_ref(q, k, v, do, causal=causal, window=window)
    for given in ({}, {"lse": lse, "o": o}):
        got = flash_attention_bwd(q, k, v, do, causal=causal, window=window,
                                  **given)
        for g, w in zip(got, want):
            assert g.dtype == torch.bfloat16
            assert torch.equal(g, w.to(torch.bfloat16))


# ------------------------------------------------------------- on the card

@pytest.mark.gpu
@pytest.mark.parametrize("shape", BF16_SHAPES + [
    s for s in cs.K7_BWD_CASES if s[5] in BWD_BF16_HEAD_DIMS], ids=str)
def test_cuda_bf16_backward_against_the_plain_version(shape):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU form)")
    B, H, Hkv, Lq, Lk, D, causal, window = shape
    q, k, v, do = (x.cuda() for x in _bf16_inputs(shape))
    o, lse = flash_attention_lse(q, k, v, causal=causal, window=window)
    got = flash_attention_bwd(q, k, v, do, causal=causal, window=window,
                              lse=lse, o=o)
    again = flash_attention_bwd(q, k, v, do, causal=causal, window=window,
                                lse=lse, o=o)
    want = attention_bwd_ref(q.float(), k.float(), v.float(), do.float(),
                             causal=causal, window=window)
    for name, g, a, w in zip(("dq", "dk", "dv"), got, again, want):
        assert g.dtype == torch.bfloat16 and torch.equal(g, a), name
        n, big = _outside(g.float().cpu(), w.cpu())
        assert n == 0, f"{name}: {n} outside, {big:.3g}"
