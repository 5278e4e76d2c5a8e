"""The two-regime design of the flash-attention kernel K7, on the CPU.

- TF32 arithmetic emulated in plain torch: ``tf32_rna`` rounds to 10 bits
  of mantissa with ties away from zero, as ``cvt.rna.tf32.f32`` does, and
  the kernel's 3×TF32 product (lo·hi + hi·lo + hi·hi) is within 2⁻²¹ of
  the exact one, a 64-term dot within 2⁻²¹ of Σ|qᵢkᵢ|; a bf16 value's lo
  part is exactly 0.
- ``plan_k7``'s bounds: the regime switches between 16 and 17 rows a
  group, the runs of keys (``k7_split_ranges``) cover each key a row may
  see exactly once (ragged tails, Lk < 64, windows that leave runs
  empty, the last row), and the reference's pins take one run.
- A plain-torch mirror of both decompositions: regime A (64-row blocks
  of position-major rows, 32-key tiles from the aligned start, masks only
  on the tiles the kernel masks, its online-softmax order on logits in
  log2 units, 3×TF32 products) and regime B (runs of keys, each a
  partial (m, l, acc), then the fixed-order combine).  Both are held
  against ``attention_ref`` and
  the reference's ``flash_attention`` in interpret mode at the
  reference's seven pins, its bf16 pin and ``chip_smoke.py``'s
  ``K7_EDGES`` (head widths 32 to 256: 16-key tiles at 256), within
  rtol 2e-4 / atol 2e-5 (``K7_F32_TOL``; for a bf16
  q ``K7_BF16_TOL``, one more rounding of the output).  With one TF32
  product instead of three the mirror misses that tolerance: the reason
  the kernel splits its products.

On a machine with a card, the CUDA kernel is held against its plain
version at ``K7_EDGES`` and two calls at the prefill and decode shapes
are bit for bit equal (``gpu`` marker)."""
import os
import sys

import numpy as np
import pytest

from _reference_cache import no_persistent_compile_cache  # noqa: F401

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import flash_attention as jfa  # noqa: E402
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention_ref, flash_attention)
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    K7_SERIAL_TILES, K7_SPLIT_ROWS, K7_TILE, _plain, k7_split_ranges,
    k7_visible, plan_k7)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402

F32 = cs.K7_F32_TOL
BF16 = cs.K7_BF16_TOL
SMS = 132


def k7_tile_a(D: int) -> int:
    """Keys a tile of the tensor-core kernel (``bka`` in
    flash_attention.cu): 32, or 16 at D = 256."""
    return 16 if D > 128 else 32


#: log2 e in float32, as the kernels scale their logits by scale · log2 e.
LOG2E = torch.tensor(1.4426950408889634, dtype=torch.float32)
#: The reference's seven float32 pins and its bf16 pin (chip_smoke's
#: K7_PINS and phase 16's bf16 case), as K7_EDGES entries.
PINS = [pin + ("float32", None) for pin in cs.K7_PINS] + [
    (1, 2, 2, 128, 128, 64, True, None, "bfloat16", None)]
EDGES = list(cs.K7_EDGES)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ------------------------------------------------------ TF32, emulated

def tf32_rna(x):
    """float32 → TF32 (10 mantissa bits), to nearest, ties away from
    zero: half an ulp added to the magnitude bits, the low 13 cleared."""
    bits = x.float().contiguous().view(torch.int32).to(torch.int64)
    bits = ((bits & 0xFFFFFFFF) + 0x1000) & 0xFFFFE000
    return bits.to(torch.uint32).view(torch.float32)


def split3(x):
    """x = hi + lo, both TF32, as the kernel splits an operand."""
    hi = tf32_rna(x)
    return hi, tf32_rna(x.float() - hi)


def tc_matmul(a, b, terms: int = 3):
    """a @ b with the kernel's TF32 products: lo·hi + hi·lo + hi·hi
    (``terms`` = 3), or hi·hi alone (1); exact products, summed in
    float64, then rounded to float32 once."""
    ah, al = split3(a)
    bh, bl = split3(b)
    out = ah.double() @ bh.double()
    if terms == 3:
        out = out + al.double() @ bh.double() + ah.double() @ bl.double()
    return out.float()


def test_tf32_rna_rounds_ties_away_from_zero():
    lsb = 2.0 ** -10
    for sign in (1.0, -1.0):
        base = sign * (1.0 + 3 * lsb)
        x = torch.tensor([base + sign * lsb / 2,         # a tie
                          base + sign * lsb * 0.49,     # below half
                          base + sign * lsb * 0.51,     # above half
                          base], dtype=torch.float32)
        got = tf32_rna(x).double()
        want = torch.tensor([base + sign * lsb, base, base + sign * lsb,
                             base], dtype=torch.float64)
        assert torch.equal(got, want)
    # The result has 10 mantissa bits: its low 13 bits are 0.
    x = torch.from_numpy(np.random.RandomState(0).randn(1000)
                         .astype(np.float32))
    assert not bool((tf32_rna(x).view(torch.int32) & 0x1FFF).any())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_three_tf32_products_are_float32_accurate(dtype):
    rng = np.random.RandomState(1)
    a = torch.from_numpy((rng.randn(4096) * np.exp2(rng.randint(
        -20, 20, 4096))).astype(np.float32)).to(getattr(torch, dtype))
    b = torch.from_numpy(rng.randn(4096).astype(np.float32)).to(
        getattr(torch, dtype))
    ah, al = split3(a)
    bh, bl = split3(b)
    exact = a.double() * b.double()
    got = (al.double() * bh.double() + ah.double() * bl.double()
           + ah.double() * bh.double())
    assert bool(((got - exact).abs() <= 2.0 ** -21 * exact.abs()).all())
    if dtype == "bfloat16":
        assert not bool(al.any()) and not bool(bl.any())
        assert torch.equal(ah, a.float())
    # 64-term dots: within 2^-21 of the sum of |q_i k_i|.
    q = torch.from_numpy(rng.randn(256, 64).astype(np.float32))
    k = torch.from_numpy(rng.randn(64, 32).astype(np.float32))
    q, k = q.to(getattr(torch, dtype)), k.to(getattr(torch, dtype))
    exact = q.double() @ k.double()
    scale = q.double().abs() @ k.double().abs()
    qh, ql = split3(q)
    kh, kl = split3(k)
    dot = (ql.double() @ kh.double() + qh.double() @ kl.double()
           + qh.double() @ kh.double())
    assert bool(((dot - exact).abs() <= 2.0 ** -21 * scale).all())


def test_one_tf32_product_is_not_float32_accurate():
    """hi·hi alone is off by ~2⁻¹¹ of Σ|qᵢkᵢ|: 1×TF32 would not hold the
    float32 pins, which is why the kernel pays for three products."""
    rng = np.random.RandomState(2)
    q = torch.from_numpy(rng.randn(256, 64).astype(np.float32))
    k = torch.from_numpy(rng.randn(64, 32).astype(np.float32))
    exact = q.double() @ k.double()
    scale = q.double().abs() @ k.double().abs()
    err = ((tf32_rna(q).double() @ tf32_rna(k).double() - exact).abs()
           / scale).max()
    assert float(err) > 2.0 ** -16


# ------------------------------------------------------------- the plan

@pytest.mark.parametrize("H,Hkv,Lq,regime", [
    (16, 1, 1, "decode"), (17, 1, 1, "prefill"), (8, 1, 2, "decode"),
    (8, 2, 4, "decode"), (8, 2, 5, "prefill"), (32, 4, 1, "decode"),
    (64, 4, 1, "decode"), (2, 1, 8, "decode"), (2, 1, 9, "prefill"),
    (32, 4, 1024, "prefill")])
def test_plan_k7_switches_regime_between_16_and_17_rows(H, Hkv, Lq, regime):
    plan = plan_k7(2, H, Hkv, Lq, 1024, None, SMS)
    assert plan.regime == regime
    assert ((H // Hkv) * Lq <= K7_SPLIT_ROWS) == (regime == "decode")
    if regime == "prefill":
        assert plan.splits == 1


@pytest.mark.parametrize("B,Hkv,Lq,Lk,window,sms", [
    (4, 4, 1, 1024, None, 132), (4, 4, 1, 1025, None, 132),
    (2, 1, 1, 1024, None, 132), (1, 1, 1, 384, None, 132),
    (1, 1, 1, 1, None, 132), (1, 1, 1, 63, None, 132),
    (1, 1, 1, 65, None, 132), (1, 1, 2, 1024, 40, 132),
    (1, 1, 1, 32768, None, 132), (64, 4, 1, 4096, None, 132),
    (33, 4, 1, 4096, None, 132), (1, 1, 1, 4096, 1000, 16),
    (3, 2, 1, 700, None, 7)])
def test_plan_k7_runs_stay_within_their_bounds(B, Hkv, Lq, Lk, window, sms):
    plan = plan_k7(B, 8 * Hkv, Hkv, Lq, Lk, window, sms)
    assert plan.regime == "decode"
    lo, hi = k7_visible(Lq, Lk, window)
    tiles = -(-(hi - lo) // K7_TILE)
    assert 1 <= plan.splits <= tiles
    if B * Hkv >= sms or tiles <= K7_SERIAL_TILES:
        assert plan.splits == 1
    else:
        # about one to two blocks an SM, never more than two
        assert B * Hkv * plan.splits <= 2 * sms + B * Hkv
    runs = k7_split_ranges(lo, hi, plan.splits)
    # whole tiles a run but the last; no run empty; Lk - 1 in the last
    assert all(b > a for a, b in runs)
    assert all((b - a) % K7_TILE == 0 for a, b in runs[:-1])
    assert runs[-1][0] <= Lk - 1 < runs[-1][1]


def test_plan_k7_at_tinyllama_decode_and_the_pins():
    """tinyllama-1.1b's decode at Lk = 1024 on 132 SMs: 16 runs of one
    tile, 256 blocks.  The reference's six prefill pins take the
    tensor-core kernel, one run; its decode pin (one group, 6 tiles) six
    runs of one tile, since a walk of 6 tiles costs more than the merge
    (phase 16's split sweep); a group of at most K7_SERIAL_TILES tiles
    walks them in one block, with no scratch and no second launch."""
    plan = plan_k7(4, 32, 4, 1, 1024, None, SMS)
    assert plan == ("decode", 16)
    assert k7_split_ranges(0, 1024, 16) == [(64 * s, 64 * s + 64)
                                           for s in range(16)]
    for B, H, Hkv, Lq, Lk, D, causal, window, *_ in PINS:
        plan = plan_k7(B, H, Hkv, Lq, Lk, window, SMS)
        assert plan.splits == (1 if plan.regime == "prefill" else 6)
    for Lk in range(1, 161):
        tiles = -(-Lk // K7_TILE)
        want = 1 if tiles <= K7_SERIAL_TILES else tiles
        assert plan_k7(4, 32, 4, 1, Lk, None, SMS).splits == want


def _visible(Lq, Lk, causal, window, i):
    """The keys query position i (right-aligned) may see."""
    pos = i + Lk - Lq
    return {j for j in range(Lk) if (not causal or j <= pos)
            and (window is None or j > pos - window)}


@pytest.mark.parametrize("Lq,Lk,causal,window,splits", [
    (1, 1024, True, None, 16), (1, 1025, True, None, 17),
    (1, 1025, True, None, 5), (1, 1, True, None, 1), (1, 1, True, None, 3),
    (1, 63, True, None, 2), (1, 65, True, None, 2), (2, 600, True, 40, 4),
    (2, 1024, True, 40, 3), (16, 300, True, 20, 6), (3, 200, False, 10, 2),
    (1, 700, True, None, 11), (4, 97, False, None, 3)])
def test_k7_runs_cover_each_visible_key_once(Lq, Lk, causal, window,
                                             splits):
    lo, hi = k7_visible(Lq, Lk, window)
    runs = k7_split_ranges(lo, hi, splits)
    assert len(runs) == splits
    assert runs[0][0] == lo and max(b for _, b in runs) == hi
    for (a0, b0), (a1, b1) in zip(runs, runs[1:]):
        assert b0 == a1 or (a1 == b1 == hi)          # contiguous, then empty
    for i in range(Lq):
        want = _visible(Lq, Lk, causal, window, i)
        seen = [j for a, b in runs for j in range(a, b) if j in want]
        assert sorted(seen) == sorted(want)          # each once, none lost
    # Lk - 1 (where the last row goes) lies in the last run that has keys
    last = [r for r in runs if r[1] > r[0]][-1]
    assert last[0] <= Lk - 1 < last[1]


# ----------------------------------------- the decompositions, mirrored

def _rows(t, rep, Lq):
    """[rep, Lq, D] → position-major rows [Lq·rep, D] (row f is position
    f // rep of head f % rep)."""
    return t.permute(1, 0, 2).reshape(rep * Lq, -1)


def _tile_full(kt, n, kend, causal, window, imin, imax, off):
    return (kt + n <= kend and (not causal or kt + n - 1 <= imin + off)
            and (window is None or kt > imax + off - window))


def _key_ok(kj, kend, causal, window, qpos):
    ok = kj[None, :] < kend
    if causal:
        ok = ok & (kj[None, :] <= qpos[:, None])
    if window is not None:
        ok = ok & (kj[None, :] > qpos[:, None] - window)
    return ok


def _operands(q, k, v, kv_last):
    """Keys and values as the kernel reads them: in q's dtype, the last
    row replaced; everything then widened to float32."""
    dt = q.dtype
    if kv_last is not None:
        k = torch.cat([k[:, :, :-1].to(dt), kv_last[0]], dim=2)
        v = torch.cat([v[:, :, :-1].to(dt), kv_last[1]], dim=2)
    return q.float(), k.to(dt).float(), v.to(dt).float()


def _softmax_step(m, l, acc, s, ok, vt, products):
    """One key tile of the online softmax, in the kernel's order, on
    logits ``s`` in log2 units (scaled by scale·log2 e): the new max, the
    correction, p (0 where masked), l = l·corr + Σp, and acc·corr plus
    the tile's p·v: ``products`` summed into a partial that starts at zero
    for the tile, then acc·corr + partial rounded once, as the kernel's
    fmaf does (regime A's order since F7; chaining the products into the
    accumulator biased o towards zero)."""
    m_new = torch.maximum(m, s.amax(dim=1))
    corr = torch.exp2(m - m_new)
    p = torch.where(ok, torch.exp2(s - m_new[:, None]), torch.zeros(()))
    l = l * corr + p.sum(dim=1)
    partial = torch.zeros_like(acc) + products(p, vt)
    return m_new, l, (acc.double() * corr.double()[:, None]
                      + partial.double()).float()


def mirror_a(q, k, v, *, causal, window, scale, kv_last=None, terms=3):
    """Regime A in plain torch: per (b, hk), 64-row blocks of the
    position-major rows; tiles of ``k7_tile_a(D)`` keys (32, or 16 at D =
    256) from the block's aligned start to its end; masks only on the
    tiles the kernel masks (others must not need one); TF32 products with
    ``terms`` terms."""
    B, H, Lq, D = q.shape
    Hkv, Lk = k.shape[1], k.shape[2]
    rep, off = H // Hkv, Lk - Lq
    BK = k7_tile_a(D)
    sl2 = torch.tensor(scale, dtype=torch.float32) * LOG2E
    qf, kf, vf = _operands(q, k, v, kv_last)
    rows = rep * Lq
    out = torch.full((B, H, Lq, D), float("nan"))
    prod = lambda a, b: tc_matmul(a, b, terms)  # noqa: E731
    for b in range(B):
        for hk in range(Hkv):
            Q = _rows(qf[b, hk * rep:(hk + 1) * rep], rep, Lq)
            O = torch.full((rows, D), float("nan"))
            for f0 in range(0, rows, 64):
                f1 = min(f0 + 64, rows) - 1
                imin, imax = f0 // rep, f1 // rep
                hi = min(Lk, imax + off + 1) if causal else Lk
                lo = max(0, imin + off - window + 1) if window else 0
                qpos = torch.arange(f0, f1 + 1) // rep + off
                n = f1 + 1 - f0
                m = torch.full((n,), -1e30)
                l, acc = torch.zeros(n), torch.zeros(n, D)
                for kt in range((lo // BK) * BK, hi, BK):
                    kj = torch.arange(kt, kt + BK)
                    Kt = torch.zeros(BK, D)
                    Vt = torch.zeros(BK, D)
                    kn = min(hi, kt + BK) - kt
                    Kt[:kn], Vt[:kn] = kf[b, hk, kt:kt + kn], vf[b, hk,
                                                                kt:kt + kn]
                    s = prod(Q[f0:f1 + 1], Kt.T) * sl2
                    ok = _key_ok(kj, hi, causal, window, qpos)
                    if _tile_full(kt, BK, hi, causal, window, imin, imax,
                                  off):
                        assert bool(ok.all()), "an unmasked tile needs a mask"
                    else:
                        s = torch.where(ok, s, torch.full((), -1e30))
                    m, l, acc = _softmax_step(m, l, acc, s, ok, Vt, prod)
                O[f0:f1 + 1] = acc * (1.0 / torch.clamp(l, min=1e-30))[:,
                                                                     None]
            out[b, hk * rep:(hk + 1) * rep] = O.reshape(Lq, rep, D) \
                .permute(1, 0, 2)
    return out.to(q.dtype)


def mirror_b(q, k, v, *, causal, window, scale, kv_last=None, splits=None):
    """Regime B in plain torch: per (b, hk), the keys [lo, hi) the group
    may see cut into runs (``k7_split_ranges``), each walked in 64-key
    tiles into a partial (m, l, acc) with float32 products; then the runs
    merged in increasing order: m = max m_s, each scaled by exp(m_s −
    m)."""
    B, H, Lq, D = q.shape
    Hkv, Lk = k.shape[1], k.shape[2]
    rep, off = H // Hkv, Lk - Lq
    assert rep * Lq <= K7_SPLIT_ROWS
    qf, kf, vf = _operands(q, k, v, kv_last)
    if splits is None:
        splits = plan_k7(B, H, Hkv, Lq, Lk, window, SMS).splits
    lo, hi = k7_visible(Lq, Lk, window)
    qpos = torch.arange(rep * Lq) // rep + off
    sl2 = torch.tensor(scale, dtype=torch.float32) * LOG2E
    prod = lambda a, b: a @ b  # noqa: E731
    out = torch.full((B, H, Lq, D), float("nan"))
    for b in range(B):
        for hk in range(Hkv):
            Q = _rows(qf[b, hk * rep:(hk + 1) * rep], rep, Lq)
            parts = []
            for s_lo, s_hi in k7_split_ranges(lo, hi, splits):
                m = torch.full((rep * Lq,), -1e30)
                l, acc = torch.zeros(rep * Lq), torch.zeros(rep * Lq, D)
                for kt in range(s_lo, s_hi, K7_TILE):
                    kn = min(s_hi, kt + K7_TILE) - kt
                    Kt = torch.zeros(K7_TILE, D)
                    Vt = torch.zeros(K7_TILE, D)
                    Kt[:kn], Vt[:kn] = kf[b, hk, kt:kt + kn], vf[b, hk,
                                                                kt:kt + kn]
                    kj = torch.arange(kt, kt + K7_TILE)
                    ok = _key_ok(kj, s_hi, causal, window, qpos)
                    s = torch.where(ok, (Q @ Kt.T) * sl2,
                                    torch.full((), -1e30))
                    m, l, acc = _softmax_step(m, l, acc, s, ok, Vt, prod)
                parts.append((m, l, acc))
            mx = torch.stack([p[0] for p in parts]).amax(dim=0)
            lt, at = torch.zeros(rep * Lq), torch.zeros(rep * Lq, D)
            for m_s, l_s, a_s in parts:
                w = torch.exp2(m_s - mx)
                lt = lt + l_s * w
                at = at + a_s * w[:, None]
            O = at * (1.0 / torch.clamp(lt, min=1e-30))[:, None]
            out[b, hk * rep:(hk + 1) * rep] = O.reshape(Lq, rep, D) \
                .permute(1, 0, 2)
    return out.to(q.dtype)


def _mirror(edge, q, k, v, last, **kw):
    B, H, Hkv, Lq, Lk, D, causal, window, dtype, cache = edge
    fn = mirror_b if (H // Hkv) * Lq <= K7_SPLIT_ROWS else mirror_a
    return fn(q, k, v, causal=causal, window=window, scale=D ** -0.5,
              kv_last=last, **kw)


def _close(got, want, tol, what):
    g, w = got.double().numpy(), want.double().numpy()
    assert np.isfinite(g).all(), what
    np.testing.assert_allclose(g, w, **tol, err_msg=what)


def _reference_kernel(edge, q, k, v, last):
    """The reference's Pallas kernel in interpret mode on the operands the
    kernel reads (the last row in place; a bf16 q with bf16 k and v)."""
    B, H, Hkv, Lq, Lk, D, causal, window, dtype, cache = edge
    _, kf, vf = _operands(q, k, v, last)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jq, jk, jv = (jnp.asarray(t.float().numpy()).astype(jdt)
                  for t in (q, kf, vf))
    got = jfa.flash_attention(jq, jk, jv, causal=causal, window=window,
                              block_q=64, block_k=64)
    return torch.from_numpy(np.array(got, np.float32))


@pytest.mark.parametrize("edge", PINS + EDGES, ids=str)
def test_mirror_matches_attention_ref_and_the_reference_kernel(edge):
    q, k, v, last = cs.k7_edge_tensors(torch, edge, "cpu")
    D, causal, window, dtype = edge[5], edge[6], edge[7], edge[8]
    tol = BF16 if dtype == "bfloat16" else F32
    got = _mirror(edge, q, k, v, last)
    assert got.dtype == q.dtype
    want = cs.k7_want(torch, q, k, v, last, causal, window)
    _close(got, want, tol, "mirror vs attention_ref")
    ref = _reference_kernel(edge, q, k, v, last)
    _close(got, ref, dict(tol, rtol=tol["rtol"] + (
        2 ** -8 if dtype == "bfloat16" else 0.0)), "mirror vs Pallas")


@pytest.mark.parametrize("edge", [e for e in EDGES
                                  if (e[1] // e[2]) * e[3] <= K7_SPLIT_ROWS],
                         ids=str)
def test_mirror_b_with_other_run_counts(edge):
    """The split decomposition with 1, 2, 3 and more runs than tiles
    (runs past the end empty: m = −1e30, l = 0 adds exactly 0)."""
    q, k, v, last = cs.k7_edge_tensors(torch, edge, "cpu")
    B, H, Hkv, Lq, Lk, D, causal, window, dtype, cache = edge
    tol = BF16 if dtype == "bfloat16" else F32
    want = cs.k7_want(torch, q, k, v, last, causal, window)
    lo, hi = k7_visible(Lq, Lk, window)
    for splits in (1, 2, 3, -(-(hi - lo) // K7_TILE) + 1):
        got = _mirror(edge, q, k, v, last, splits=splits)
        _close(got, want, tol, f"{splits} runs")


@pytest.mark.parametrize("edge", [PINS[0], PINS[5], EDGES[16]], ids=str)
def test_mirror_with_one_tf32_product_misses_the_tolerance(edge):
    q, k, v, last = cs.k7_edge_tensors(torch, edge, "cpu")
    D, causal, window = edge[5], edge[6], edge[7]
    want = _plain(q, k, v, causal=causal, window=window, scale=D ** -0.5,
                  kv_last=last)
    _close(_mirror(edge, q, k, v, last), want, F32, "3 products")
    with pytest.raises(AssertionError):
        _close(_mirror(edge, q, k, v, last, terms=1), want, F32, "1 product")


def test_k7_tile_a_fits_the_shared_memory_a_block_may_opt_into():
    """The tensor-core kernel's shared memory (``smem_a`` in
    flash_attention.cu: the raw and split K/V tiles, and Q's hi/lo copy
    above D = 64) stays within the 232 448 B an H100 block may opt into at
    every head width, with float32 and with bf16 keys; at D = 256 it
    would not with 32-key tiles."""
    def smem_a(D, kv_bytes, tile):
        split = (2 * D + 16) + (2 * D + 4)            # K and V words a key
        q_copy = 2 * (D // 8) * 128 * 16 if D > 64 else 0
        return tile * (2 * D * kv_bytes + split * 4) + q_copy

    for D in (32, 64, 128, 256):
        for kv_bytes in (4, 2):
            assert smem_a(D, kv_bytes, k7_tile_a(D)) <= 232_448, D
    assert k7_tile_a(256) == 16 and k7_tile_a(128) == 32
    assert smem_a(256, 4, 32) == 330_240 and smem_a(256, 2, 32) == 297_472
    assert smem_a(256, 4, 16) == 230_656


def test_the_wrapper_on_the_cpu_is_the_plain_version():
    edge = EDGES[19]
    q, k, v, last = cs.k7_edge_tensors(torch, edge, "cpu")
    LAUNCHES.clear()
    got = flash_attention(q, k, v, kv_last=last)
    assert not LAUNCHES
    assert torch.equal(got, _plain(q, k, v, causal=True, window=None,
                                   scale=64 ** -0.5, kv_last=last))


# ------------------------------------------------------------- on the card

def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU form)")


@pytest.mark.gpu
@pytest.mark.parametrize("edge", EDGES, ids=str)
def test_cuda_k7_at_the_edges(edge):
    _needs_card()
    q, k, v, last = cs.k7_edge_tensors(torch, edge, "cuda")
    D, causal, window, dtype = edge[5], edge[6], edge[7], edge[8]
    LAUNCHES.clear()
    got = flash_attention(q, k, v, causal=causal, window=window,
                          kv_last=last)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == 1
    want = cs.k7_want(torch, q, k, v, last, causal, window)
    _close(got.cpu(), want.cpu(), BF16 if dtype == "bfloat16" else F32,
           "kernel vs plain")


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [cs.K7_PREFILL, cs.K7_DECODE], ids=str)
def test_cuda_k7_is_bit_for_bit_repeatable(shape):
    _needs_card()
    B, H, Hkv, Lq, Lk, D, causal, window = shape
    rng = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rng.randn(*s).astype(np.float32)).cuda()
               for s in ((B, H, Lq, D), (B, Hkv, Lk, D), (B, Hkv, Lk, D)))
    first = flash_attention(q, k, v, causal=causal, window=window)
    again = flash_attention(q, k, v, causal=causal, window=window)
    assert torch.equal(first, again)
    want = attention_ref(q, k, v, causal=causal, window=window)
    _close(first.cpu(), want.cpu(), F32, "kernel vs plain")
