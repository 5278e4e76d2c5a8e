"""F7: why K7's forward adds each key tile's tensor-core partial with a
rounding add, on the CPU.

The tensor cores add each MMA's products into their float32 accumulator
and drop the low bits of the sum, towards zero.  Chained into one
accumulator across every key tile, as K7's regime A did, those drops add
up to a bias of the output towards zero (F7: −9.07e-6 of |o| at
whisper-base's cross-attention on the card, ``tools/k7_output_bias.py``).
Regime A now sums each tile's P·V into a partial that starts at zero and
adds it to the rescaled accumulator with one fmaf that rounds to nearest,
so a drop is of the size of one tile's partial.

- A model of the truncating accumulator (each MMA: the exact sum of its
  eight products added to the float32 accumulator in float64, the result
  truncated to float32) runs regime A's order at a causal shape with
  1 024 keys (64 queries, the last of which see all of them): the
  running chain's mean signed error is at least 10× that of the per-tile
  partial with a rounding fmaf, and negative.
- The per-tile order stays within ``K7_F32_TOL`` of ``attention_ref``,
  which holds to the JAX package's ``attention_ref`` on the same seeded
  numpy inputs."""
import os
import sys

import numpy as np
import pytest

from _reference_cache import no_persistent_compile_cache  # noqa: F401

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import flash_attention as jfa  # noqa: E402
from repro_torch.kernels.flash_attention import attention_ref  # noqa: E402
from test_torch_k7_design import LOG2E, split3, tc_matmul  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402

#: (B, H, Hkv, Lq, Lk, D): causal, queries right-aligned, 1 024 keys.
SHAPE = (1, 2, 1, 64, 1024, 64)
#: Regime A's keys a tile at D ≤ 128 and keys an MMA k-step.
BK, KSTEP = 32, 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _inputs(seed=0):
    B, H, Hkv, Lq, Lk, D = SHAPE
    rng = np.random.RandomState(seed)
    return (rng.randn(B, H, Lq, D).astype(np.float32) * 0.5,
            rng.randn(B, Hkv, Lk, D).astype(np.float32) * 0.5,
            rng.randn(B, Hkv, Lk, D).astype(np.float32))


def trunc32(x):
    """float64 → float32, rounded towards zero."""
    f = x.float()
    over = f.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


def mma_chain(c, ph, pl, vh, vl):
    """One k-step's three MMAs (lo·hi, hi·lo, hi·hi, small terms first)
    into the float32 accumulator c, each the exact sum of its products
    added in float64 and truncated: [rows, keys] p parts, [keys, D] v
    parts."""
    for a, b in ((pl, vh), (ph, vl), (ph, vh)):
        c = trunc32(c.double() + a.double() @ b.double())
    return c


def regime_a(q, k, v, *, partial: bool):
    """Regime A's online softmax for one group of rows (Hkv = 1, rows
    head-major within a position as the kernel flattens them does not
    matter here: each row is its own sum), causal, 32-key tiles, with the
    P·V accumulation of the truncating model: chained into the running
    accumulator (``partial`` False) or into a zero partial a tile that is
    then added to acc·corr in one rounding (the kernel's fmaf).  Logits as
    ``tc_matmul`` (3×TF32) forms them."""
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    off = Lk - Lq
    sl2 = torch.tensor(D ** -0.5, dtype=torch.float32) * LOG2E
    out = torch.empty(B, H, Lq, D)
    for b in range(B):
        for h in range(H):
            Q, K, V = q[b, h], k[b, 0], v[b, 0]
            qpos = torch.arange(Lq) + off
            m = torch.full((Lq,), -1e30)
            l, acc = torch.zeros(Lq), torch.zeros(Lq, D)
            for kt in range(0, Lk, BK):
                keys = torch.arange(kt, kt + BK)
                ok = keys[None, :] <= qpos[:, None]
                s = tc_matmul(Q, K[kt:kt + BK].T) * sl2
                s = torch.where(ok, s, torch.full((), -1e30))
                m_new = torch.maximum(m, s.amax(dim=1))
                corr = torch.exp2(m - m_new)
                p = torch.where(ok, torch.exp2(s - m_new[:, None]),
                                torch.zeros(()))
                l = l * corr + p.sum(dim=1)
                c = torch.zeros(Lq, D) if partial else acc * corr[:, None]
                ph, pl = split3(p)
                vh, vl = split3(V[kt:kt + BK])
                for j in range(0, BK, KSTEP):
                    c = mma_chain(c, ph[:, j:j + KSTEP], pl[:, j:j + KSTEP],
                                  vh[j:j + KSTEP], vl[j:j + KSTEP])
                # the partial lands as one rounding of acc·corr + c (fmaf)
                acc = ((acc.double() * corr.double()[:, None] + c.double())
                       .float() if partial else c)
                m = m_new
            out[b, h] = acc * (1.0 / torch.clamp(l, min=1e-30))[:, None]
    return out


def _exact(q, k, v):
    return attention_ref(q.double(), k.double(), v.double(), causal=True)


def _bias(got, want):
    d = got.double() - want
    return float((d * want.sign()).mean() / want.abs().mean())


def test_trunc32_rounds_towards_zero():
    x = torch.tensor([1.0 + 2.0 ** -30, -(1.0 + 2.0 ** -30), 3.0,
                      1.0 - 2.0 ** -40, -(1.0 - 2.0 ** -40)],
                     dtype=torch.float64)
    got = trunc32(x)
    assert got.tolist() == [1.0, -1.0, 3.0, float(np.nextafter(
        np.float32(1), np.float32(0))), -float(np.nextafter(
            np.float32(1), np.float32(0)))]
    assert bool((got.double().abs() <= x.abs()).all())


def test_running_chain_is_biased_ten_times_the_per_tile_partial():
    q, k, v = map(torch.from_numpy, _inputs())
    want = _exact(q, k, v)
    running = _bias(regime_a(q, k, v, partial=False), want)
    per_tile = _bias(regime_a(q, k, v, partial=True), want)
    assert running < 0, running
    assert abs(running) >= 10 * abs(per_tile), (running, per_tile)


def test_per_tile_order_within_k7_tolerance_of_the_plain_version():
    qn, kn, vn = _inputs(1)
    q, k, v = map(torch.from_numpy, (qn, kn, vn))
    plain = attention_ref(q, k, v, causal=True)
    got = regime_a(q, k, v, partial=True)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **cs.K7_F32_TOL)
    ref = np.asarray(jfa.attention_ref(jnp.asarray(qn), jnp.asarray(kn),
                                       jnp.asarray(vn), causal=True))
    np.testing.assert_allclose(plain.numpy(), ref, **cs.K7_F32_TOL)
