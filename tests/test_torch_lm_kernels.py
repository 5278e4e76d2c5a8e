"""The LM kernels of the port — K7 (flash attention) and K8 (the Mamba-2
SSD chunk block) — and the SSD wrappers around K8: their plain versions
against the JAX reference on the CPU (the Pallas kernels in interpret
mode, as the reference's own tests run them), the wrappers' device
dispatch and launch counter, and — on a machine with a card — the CUDA
kernels against the plain versions.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances are the reference's own pins in ``tests/test_kernels.py``:
K7 rtol 2e-4 / atol 2e-5 in float32; the SSD outputs rtol = atol =
2e-4; the one-token update rtol 1e-4 / atol 1e-5.  For bf16 inputs the
reference pins 0.05; both sides compute in float32 on the same rounded
inputs and round the output once, so here the float32 bound plus half a
bf16 step (2^-8 relative) holds against the float32 oracle, and a whole
step (2^-7) against the reference kernel's own rounding.
The two sides sum in other orders (XLA's dot and cumsum against torch's),
so nothing here is bit-exact."""
import re

import numpy as np
import pytest

from _reference_cache import no_persistent_compile_cache  # noqa: F401

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import flash_attention as jfa  # noqa: E402
from repro.kernels import ssd_chunk as jssd  # noqa: E402
from repro.kernels.ssd_chunk.kernel import ssd_chunk_pallas  # noqa: E402
from repro.kernels.ssd_chunk.ops import (  # noqa: E402
    ssd_decode_step as j_ssd_decode_step)
from repro_torch.kernels import LAUNCHES, _build  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention_ref, flash_attention)
from repro_torch.kernels.ssd_chunk import (  # noqa: E402
    ssd, ssd_chunk, ssd_chunk_ref, ssd_decode_step, ssd_ref)

F32 = dict(rtol=2e-4, atol=2e-5)
BF16 = dict(rtol=2 ** -8 + 2e-4, atol=2e-5)      # one rounding to bf16
BF16_STEP = dict(rtol=2 ** -7 + 2e-4, atol=2e-5)  # two roundings apart
SSD = dict(rtol=2e-4, atol=2e-4)

#: The reference's K7 pins (tests/test_kernels.py:534-541), then three at
#: recurrentgemma-2b's head width 256 (10 query heads over one KV head).
FA_SHAPES = [
    (1, 2, 2, 128, 128, 64, True, None),      # square causal
    (2, 4, 2, 128, 128, 64, True, None),      # GQA 2:1
    (1, 8, 2, 64, 256, 64, True, None),       # Lq < Lk (chunked prefill)
    (1, 2, 1, 1, 384, 64, True, None),        # decode: 1 query vs cache
    (1, 2, 2, 128, 256, 64, True, 64),        # local window
    (1, 2, 2, 100, 200, 32, True, None),      # ragged (padding path)
    (1, 2, 2, 64, 64, 128, False, None),      # non-causal (cross-attn)
    (1, 10, 1, 96, 96, 256, True, 40),        # D = 256 (recurrentgemma)
    (1, 10, 1, 1, 200, 256, True, None),      # D = 256 decode
    (1, 2, 1, 50, 120, 256, False, None),     # D = 256 non-causal
]

#: The reference's SSD pins (tests/test_kernels.py:569-573), and a chunk
#: of 12 steps (a sequence shorter than a chunk, as the decode pin runs).
SSD_SHAPES = [
    (1, 64, 2, 16, 1, 32, 32),
    (2, 128, 4, 32, 2, 64, 64),
    (1, 256, 2, 64, 1, 128, 64),    # mamba2-1.3b head geometry
    (1, 64, 4, 16, 4, 16, 16),      # G == H (ungrouped)
    (2, 12, 2, 32, 1, 32, 12),      # Q = 12
]


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(
        t, np.float32)


def _fa_inputs(B, H, Hkv, Lq, Lk, D):
    rng = np.random.RandomState(Lq + Lk)
    q = rng.randn(B, H, Lq, D).astype(np.float32) * 0.5
    k = rng.randn(B, Hkv, Lk, D).astype(np.float32) * 0.5
    v = rng.randn(B, Hkv, Lk, D).astype(np.float32)
    return q, k, v


# ------------------------------------------------------------ K7 on the CPU

@pytest.mark.parametrize("B,H,Hkv,Lq,Lk,D,causal,window", FA_SHAPES)
def test_flash_attention_plain_matches_jax(B, H, Hkv, Lq, Lk, D, causal,
                                           window):
    """The wrapper on CPU tensors (the plain version) against the
    reference's Pallas kernel in interpret mode (blocks of 64) and its
    dense oracle."""
    q, k, v = _fa_inputs(B, H, Hkv, Lq, Lk, D)
    LAUNCHES.clear()
    got = flash_attention(*map(torch.from_numpy, (q, k, v)), causal=causal,
                          window=window)
    assert not LAUNCHES
    assert got.dtype == torch.float32 and got.shape == (B, H, Lq, D)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    kern = jfa.flash_attention(jq, jk, jv, causal=causal, window=window,
                               block_q=64, block_k=64)
    oracle = jfa.attention_ref(jq, jk, jv, causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(kern), **F32)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), **F32)


def test_flash_attention_plain_bf16_inputs():
    """bf16 in, bf16 out, against the reference kernel on the same bf16
    inputs (one bf16 step) and the float32 oracle (half a step)."""
    rng = np.random.RandomState(0)
    q, k, v = (rng.randn(1, 2, 128, 64).astype(np.float32) for _ in range(3))
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = flash_attention(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    kern = jfa.flash_attention(jq, jk, jv, block_q=64, block_k=64)
    oracle = jfa.attention_ref(jq.astype(jnp.float32), jk.astype(jnp.float32),
                               jv.astype(jnp.float32))
    np.testing.assert_allclose(_np(got), np.asarray(kern, np.float32),
                               **BF16_STEP)
    np.testing.assert_allclose(_np(got), np.asarray(oracle), **BF16)


def test_flash_attention_scale_argument():
    q, k, v = _fa_inputs(1, 4, 2, 16, 40, 32)
    got = flash_attention(*map(torch.from_numpy, (q, k, v)), scale=0.3)
    want = jfa.attention_ref(*map(jnp.asarray, (q, k, v)), scale=0.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_attention_ref_on_a_cache_slice():
    """A decode reads a prefix of a preallocated cache as it lies (a
    non-contiguous slice): the same result as the compact keys."""
    q, k, v = _fa_inputs(2, 8, 2, 1, 64, 32)
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    sl = attention_ref(torch.from_numpy(q), tk[:, :, :37], tv[:, :, :37])
    dense = attention_ref(torch.from_numpy(q), tk[:, :, :37].contiguous(),
                          tv[:, :, :37].contiguous())
    assert torch.equal(sl, dense)
    want = jfa.attention_ref(jnp.asarray(q), jnp.asarray(k[:, :, :37]),
                             jnp.asarray(v[:, :, :37]))
    np.testing.assert_allclose(sl.numpy(), np.asarray(want), **F32)


def _decode_over_bf16_cache(B, H, Hkv, Lk, D, cache, seed=0):
    """A decode step's operands as ``attn_decode`` hands them over: a
    float32 query, the prefix of a bf16 cache, and the step's own key and
    value in float32 (and, as numpy, the keys the reference attends
    over: the cache widened, the last slot unrounded)."""
    rng = np.random.RandomState(seed)
    q = rng.randn(B, H, 1, D).astype(np.float32) * 0.5
    kc = rng.randn(B, Hkv, cache, D).astype(np.float32) * 0.5
    vc = rng.randn(B, Hkv, cache, D).astype(np.float32)
    kt = rng.randn(B, Hkv, 1, D).astype(np.float32) * 0.5
    vt = rng.randn(B, Hkv, 1, D).astype(np.float32)
    tkc, tvc = (torch.from_numpy(a).to(torch.bfloat16) for a in (kc, vc))
    tkc[:, :, Lk - 1:Lk], tvc[:, :, Lk - 1:Lk] = (
        torch.from_numpy(kt), torch.from_numpy(vt))
    keys = np.concatenate([_np(tkc[:, :, :Lk - 1]), kt], axis=2)
    vals = np.concatenate([_np(tvc[:, :, :Lk - 1]), vt], axis=2)
    ops = (torch.from_numpy(q), tkc[:, :, :Lk], tvc[:, :, :Lk],
           (torch.from_numpy(kt), torch.from_numpy(vt)))
    return ops, (q, keys, vals)


@pytest.mark.parametrize("window", [None, 9])
def test_flash_attention_over_a_bf16_cache_with_the_last_row(window):
    """A float32 query over a bf16 cache prefix reads the keys widened,
    with ``kv_last`` in place of the last slot: the reference's decode
    (its cache cast to the activations' dtype, the step's own k/v
    unrounded)."""
    (q, k, v, last), (jq, jk, jv) = _decode_over_bf16_cache(2, 8, 2, 37, 32,
                                                            64)
    got = flash_attention(q, k, v, window=window, kv_last=last)
    assert got.dtype == torch.float32
    want = jfa.attention_ref(*map(jnp.asarray, (jq, jk, jv)), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    # Without the last row the rounded slot is read: a different answer.
    assert not torch.equal(flash_attention(q, k, v, window=window), got)


def test_flash_attention_reads_keys_in_the_query_dtype():
    q, k, v = map(torch.from_numpy, _fa_inputs(1, 4, 2, 8, 40, 32))
    got = flash_attention(q.bfloat16(), k, v)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, flash_attention(q.bfloat16(), k.bfloat16(),
                                            v.bfloat16()))
    assert torch.equal(flash_attention(q, k.bfloat16(), v.bfloat16()),
                       attention_ref(q, k.bfloat16().float(),
                                     v.bfloat16().float()))


def test_flash_attention_checks_the_last_row():
    q, k, v = map(torch.from_numpy, _fa_inputs(1, 4, 2, 1, 40, 32))
    row = torch.zeros((1, 2, 1, 32))
    with pytest.raises(ValueError, match="kv_last"):
        flash_attention(q, k, v, kv_last=(row[:, :1], row[:, :1]))
    with pytest.raises(ValueError, match="kv_last"):
        flash_attention(q, k, v, kv_last=(row.bfloat16(), row.bfloat16()))


# ------------------------------------------------------------ K8 on the CPU

def _ssd_inputs(B, L, H, P, G, S, seed=None):
    rng = np.random.RandomState(L + S if seed is None else seed)
    x = rng.randn(B, L, H, P).astype(np.float32) * 0.5
    dt = 0.01 + rng.rand(B, L, H).astype(np.float32)
    A = -(0.1 + rng.rand(H).astype(np.float32))
    Bm = rng.randn(B, L, G, S).astype(np.float32) * 0.3
    Cm = rng.randn(B, L, G, S).astype(np.float32) * 0.3
    return x, dt, A, Bm, Cm


def _chunk_layout(x, dt, A, Bm, Cm, chunk):
    """The kernel's operands, laid out as the reference's ``ssd`` lays
    them out (heads into the batch dim, chunked time)."""
    Bb, L, H, P = x.shape
    G, S = Bm.shape[2], Bm.shape[3]
    NC = L // chunk
    xk = x.transpose(0, 2, 1, 3).reshape(Bb * H, NC, chunk, P)
    dtk = dt.transpose(0, 2, 1).reshape(Bb * H, NC, chunk)
    delta = (dtk * np.tile(A, Bb)[:, None, None]).astype(np.float32)
    Bk = Bm.transpose(0, 2, 1, 3).reshape(Bb, G, NC, chunk, S)
    Ck = Cm.transpose(0, 2, 1, 3).reshape(Bb, G, NC, chunk, S)
    return [np.ascontiguousarray(a) for a in (xk, delta, dtk, Bk, Ck)], H // G


@pytest.mark.parametrize("B,L,H,P,G,S,chunk", SSD_SHAPES)
def test_ssd_chunk_plain_matches_pallas(B, L, H, P, G, S, chunk):
    """K8's plain version against the reference's Pallas kernel in
    interpret mode: y_intra, H_out and exp_s."""
    ops, hpg = _chunk_layout(*_ssd_inputs(B, L, H, P, G, S), chunk)
    LAUNCHES.clear()
    got = ssd_chunk(*map(torch.from_numpy, ops), heads_per_group=hpg)
    assert not LAUNCHES
    want = ssd_chunk_pallas(*map(jnp.asarray, ops), heads_per_group=hpg,
                            interpret=True)
    for name, g, w in zip(("y_intra", "H_out", "exp_s"), got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **SSD,
                                   err_msg=name)


@pytest.mark.parametrize("B,L,H,P,G,S,chunk", SSD_SHAPES)
def test_ssd_matches_jax_and_recurrence(B, L, H, P, G, S, chunk):
    """The port's chunked ``ssd`` against the reference's ``ssd`` and the
    literal recurrence ``ssd_ref`` of both packages."""
    ins = _ssd_inputs(B, L, H, P, G, S)
    y, h = ssd(*map(torch.from_numpy, ins), chunk=chunk)
    jy, jh = jssd.ssd(*map(jnp.asarray, ins), chunk=chunk)
    ry, rh = jssd.ssd_ref(*map(jnp.asarray, ins))
    ty, th = ssd_ref(*map(torch.from_numpy, ins))
    for got, want in ((y, jy), (y, ry), (h, jh), (h, rh), (ty, ry),
                      (th, rh)):
        np.testing.assert_allclose(_np(got), np.asarray(want), **SSD)


def test_ssd_initial_state_threading():
    """Splitting a sequence across two ssd() calls equals one call — the
    property serving (stateful decode) depends on (reference pin
    tests/test_kernels.py:588)."""
    x, dt, A, Bm, Cm = map(torch.from_numpy,
                           _ssd_inputs(1, 128, 2, 16, 1, 32, seed=7))
    y_full, h_full = ssd(x, dt, A, Bm, Cm, chunk=32)
    y1, h1 = ssd(x[:, :64], dt[:, :64], A, Bm[:, :64], Cm[:, :64], chunk=32)
    y2, h2 = ssd(x[:, 64:], dt[:, 64:], A, Bm[:, 64:], Cm[:, 64:], h0=h1,
                 chunk=32)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(),
                               y_full.numpy(), **SSD)
    np.testing.assert_allclose(h2.numpy(), h_full.numpy(), **SSD)


def test_ssd_decode_step_matches_recurrence():
    """Eight one-token updates equal the recurrence (reference pin
    tests/test_kernels.py:610), and the reference's own update."""
    rng = np.random.RandomState(9)
    B, H, P, G, S = 2, 2, 16, 1, 32
    A = -(0.1 + rng.rand(H).astype(np.float32))
    xs = rng.randn(B, 8, H, P).astype(np.float32)
    dts = 0.01 + rng.rand(B, 8, H).astype(np.float32)
    Bms = rng.randn(B, 8, G, S).astype(np.float32) * 0.3
    Cms = rng.randn(B, 8, G, S).astype(np.float32) * 0.3
    h = torch.zeros((B, H, S, P))
    jh = jnp.zeros((B, H, S, P))
    ys = []
    for t in range(8):
        y, h = ssd_decode_step(*(torch.from_numpy(a[:, t]) for a in
                                 (xs, dts)), torch.from_numpy(A),
                               *(torch.from_numpy(a[:, t]) for a in
                                 (Bms, Cms)), h)
        jy, jh = j_ssd_decode_step(xs[:, t], dts[:, t], A, Bms[:, t],
                                   Cms[:, t], jh)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-4,
                                   atol=1e-5)
        ys.append(y)
    y_ref, h_ref = jssd.ssd_ref(*map(jnp.asarray, (xs, dts, A, Bms, Cms)))
    np.testing.assert_allclose(torch.stack(ys, 1).numpy(), np.asarray(y_ref),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_ref), rtol=1e-4,
                               atol=1e-5)


def test_ssd_rejects_a_ragged_length():
    ins = map(torch.from_numpy, _ssd_inputs(1, 40, 2, 16, 1, 32))
    with pytest.raises(ValueError, match="multiple of chunk"):
        ssd(*ins, chunk=32)


# -------------------------------------------------- dispatch and the build

def test_wrappers_reject_other_devices():
    q = torch.zeros((1, 2, 4, 32), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention(q, q, q)
    with pytest.raises(ValueError, match="several devices"):
        flash_attention(torch.zeros((1, 2, 4, 32)), q, q)
    x = torch.zeros((2, 1, 8, 16), device="meta")
    d = torch.zeros((2, 1, 8), device="meta")
    bc = torch.zeros((1, 1, 1, 8, 16), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ssd_chunk(x, d, d, bc, bc, heads_per_group=2)


def test_build_lists_the_lm_kernels():
    for name in ("flash_attention", "ssd_chunk"):
        assert name in _build.SOURCES
        assert (_build.CSRC / f"{name}.cu").exists()
        assert _build.library_path(name).name.startswith(name + "-")


def test_kernel_sources_are_hand_written():
    """Both kernels are CUDA written here: their sources include only the
    CUDA runtime, bf16 and fixed-width integer headers (no cuBLAS, cuDNN,
    CUTLASS or PyTorch) and call no library kernel."""
    allowed = {"cuda_runtime.h", "cuda_bf16.h", "stdint.h"}
    for name in ("flash_attention", "ssd_chunk"):
        src = (_build.CSRC / f"{name}.cu").read_text()
        assert set(re.findall(r"#include <([^>]+)>", src)) <= allowed, name
        assert not re.search(r"\b(cublas|cudnn)\w*\(", src), name
        assert "__global__" in src and 'extern "C"' in src


# ------------------------------------------------------------- on the card

def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU form)")


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,Hkv,Lq,Lk,D,causal,window", FA_SHAPES)
def test_cuda_flash_attention_matches_plain_version(B, H, Hkv, Lq, Lk, D,
                                                    causal, window):
    _needs_card()
    host = list(map(torch.from_numpy, _fa_inputs(B, H, Hkv, Lq, Lk, D)))
    LAUNCHES.clear()
    got = flash_attention(*(t.cuda() for t in host), causal=causal,
                          window=window)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == 1
    want = attention_ref(*host, causal=causal, window=window)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), **F32)


@pytest.mark.gpu
def test_cuda_flash_attention_bf16_and_cache_slice():
    _needs_card()
    q, k, v = (torch.from_numpy(a).cuda() for a in
               _fa_inputs(2, 8, 2, 1, 64, 32))
    got = flash_attention(q, k[:, :, :37], v[:, :, :37])
    want = attention_ref(q, k[:, :, :37], v[:, :, :37])
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **F32)
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    got = flash_attention(qb, kb, vb)
    assert got.dtype == torch.bfloat16
    want = attention_ref(qb.float(), kb.float(), vb.float())
    np.testing.assert_allclose(_np(got.cpu()), want.cpu().numpy(), **BF16)


@pytest.mark.gpu
@pytest.mark.parametrize("window", [None, 9])
def test_cuda_flash_attention_over_a_bf16_cache_with_the_last_row(window):
    _needs_card()
    (q, k, v, last), _ = _decode_over_bf16_cache(2, 8, 2, 37, 32, 64)
    LAUNCHES.clear()
    got = flash_attention(q.cuda(), k.cuda(), v.cuda(), window=window,
                          kv_last=tuple(t.cuda() for t in last))
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == 1
    want = flash_attention(q, k, v, window=window, kv_last=last)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), **F32)


@pytest.mark.gpu
@pytest.mark.parametrize("B,L,H,P,G,S,chunk", SSD_SHAPES)
def test_cuda_ssd_chunk_matches_plain_version(B, L, H, P, G, S, chunk):
    _needs_card()
    ops, hpg = _chunk_layout(*_ssd_inputs(B, L, H, P, G, S), chunk)
    host = list(map(torch.from_numpy, ops))
    LAUNCHES.clear()
    got = ssd_chunk(*(t.cuda() for t in host), heads_per_group=hpg)
    torch.cuda.synchronize()
    assert LAUNCHES["ssd_chunk"] == 1
    for g, w in zip(got, ssd_chunk_ref(*host, heads_per_group=hpg)):
        np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), **SSD)
