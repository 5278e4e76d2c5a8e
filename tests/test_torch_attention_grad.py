"""Gradients through the port's attention — the plain backward
``attention_bwd_ref`` and autograd through the CPU attention — against
``jax.vjp`` of the reference's ``models.common.attention``, at the shapes
of the reference's attention pins (tests/test_kernels.py:534-541:
causal, GQA, Lq < Lk, a window, non-causal), and the dispatch rules of
the card's backward (what raises before any launch).

Tolerance: float32 throughout; the two sides sum the same products in
another order (torch's einsum against XLA's dots and its chunked running
softmax), so each gradient is held elementwise to rtol 1e-5 plus 1e-6 of
that gradient's largest magnitude (values near zero have no relative
meaning)."""
import functools

import numpy as np
import pytest

from _reference_cache import no_persistent_compile_cache  # noqa: F401

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.models import common as jcommon  # noqa: E402
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention_bwd_ref, flash_attention, flash_attention_bwd)
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    BWD_HEAD_DIMS, check_backward)
from repro_torch.kernels.ssd_chunk import ops as k8ops  # noqa: E402
from repro_torch.kernels.ssd_chunk import (  # noqa: E402
    ssd_chunk_bwd_ref, ssd_chunk_ref)
from repro_torch.models import common as tcommon  # noqa: E402

RTOL, ATOL_OF_MAX = 1e-5, 1e-6

#: (B, H, Hkv, Lq, Lk, D, causal, window): the reference's pins with the
#: window pin, a ragged Lq < Lk, GQA and a non-causal window added.
SHAPES = [
    (1, 2, 2, 128, 128, 64, True, None),
    (2, 4, 2, 128, 128, 64, True, None),
    (1, 8, 2, 64, 256, 64, True, None),
    (1, 2, 2, 128, 256, 64, True, 64),
    (1, 2, 2, 100, 200, 32, True, None),
    (1, 2, 2, 64, 64, 128, False, None),
    (1, 4, 1, 24, 56, 32, True, 16),
    (2, 4, 2, 30, 70, 32, False, 9),
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _inputs(B, H, Hkv, Lq, Lk, D, seed=0):
    rng = np.random.RandomState(seed + Lq + Lk + D)
    return (rng.randn(B, H, Lq, D).astype(np.float32) * 0.5,
            rng.randn(B, Hkv, Lk, D).astype(np.float32) * 0.5,
            rng.randn(B, Hkv, Lk, D).astype(np.float32),
            rng.randn(B, H, Lq, D).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _reference_vjp(shape):
    """(o, dq, dk, dv) of the reference's attention by ``jax.vjp`` on
    ``_inputs(shape)``, with its default 1024-row chunks and with 64-row
    chunks (its running softmax across chunks); cached across tests."""
    B, H, Hkv, Lq, Lk, D, causal, window = shape
    q, k, v, do = _inputs(B, H, Hkv, Lq, Lk, D)
    out = {}
    for chunk in (1024, 64):
        fn = jax.jit(lambda q, k, v: jcommon.attention(
            q, k, v, causal=causal, window=window, q_chunk=chunk,
            k_chunk=chunk))
        o, vjp = jax.vjp(fn, *map(jnp.asarray, (q, k, v)))
        out[chunk] = (np.asarray(o),) + tuple(
            np.asarray(g) for g in vjp(jnp.asarray(do)))
    return out


def _close(name, got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    atol = ATOL_OF_MAX * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol,
                               err_msg=name)


@pytest.mark.parametrize("B,H,Hkv,Lq,Lk,D,causal,window", SHAPES)
def test_plain_backward_matches_reference_vjp(B, H, Hkv, Lq, Lk, D, causal,
                                              window):
    q, k, v, do = _inputs(B, H, Hkv, Lq, Lk, D)
    got = attention_bwd_ref(*map(torch.from_numpy, (q, k, v, do)),
                            causal=causal, window=window)
    shape = (B, H, Hkv, Lq, Lk, D, causal, window)
    for chunk, (_, *want) in _reference_vjp(shape).items():
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            assert g.dtype == torch.float32 and g.shape == w.shape
            _close(f"{name} (reference chunks of {chunk})", g, w)


@pytest.mark.parametrize("B,H,Hkv,Lq,Lk,D,causal,window", SHAPES)
def test_autograd_through_cpu_attention_matches_reference_vjp(
        B, H, Hkv, Lq, Lk, D, causal, window):
    """The train step's path on the CPU: ``common.attention`` (the
    wrapper's plain form) under autograd."""
    q, k, v, do = _inputs(B, H, Hkv, Lq, Lk, D)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    o = tcommon.attention(tq, tk, tv, causal=causal, window=window)
    o.backward(torch.from_numpy(do))
    want = _reference_vjp((B, H, Hkv, Lq, Lk, D, causal, window))[1024]
    _close("o", o, want[0])
    for name, t, w in zip(("dq", "dk", "dv"), (tq, tk, tv), want[1:]):
        _close(name, t.grad, w)


def test_cpu_backward_wrapper_is_the_plain_version():
    """``flash_attention_bwd`` on CPU tensors is ``attention_bwd_ref``,
    bit for bit, and launches nothing; the output gradient of a GQA call
    reaches each key/value head once per query head of its group."""
    q, k, v, do = map(torch.from_numpy, _inputs(1, 4, 2, 24, 40, 32))
    LAUNCHES.clear()
    got = flash_attention_bwd(q, k, v, do, window=7)
    want = attention_bwd_ref(q, k, v, do, window=7)
    assert not LAUNCHES
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # Duplicating each kv head as its own group gives dk, dv per query
    # head; their sums over the group are the GQA gradients.
    kr, vr = (t.repeat_interleave(2, dim=1) for t in (k, v))
    _, dk1, dv1 = attention_bwd_ref(q, kr, vr, do, window=7)
    torch.testing.assert_close(dk1.view(1, 2, 2, 40, 32).sum(2), got[1],
                               rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(dv1.view(1, 2, 2, 40, 32).sum(2), got[2],
                               rtol=1e-6, atol=1e-6)


def test_grad_with_kv_last_raises():
    """``kv_last`` is decode only: a call that needs a gradient raises on
    every device; without grad it runs."""
    q, k, v, _ = map(torch.from_numpy, _inputs(1, 2, 1, 1, 9, 32))
    last = (k[:, :, -1:].clone(), v[:, :, -1:].clone())
    flash_attention(q, k, v, kv_last=last)
    with pytest.raises(NotImplementedError, match="kv_last"):
        flash_attention(q.requires_grad_(True), k, v, kv_last=last)
    with torch.no_grad():
        flash_attention(q, k, v, kv_last=last)


@pytest.mark.parametrize("D,dtype,ok", [
    (32, torch.float32, True), (64, torch.float32, True),
    (128, torch.float32, True), (256, torch.float32, True),
    (256, torch.bfloat16, False)])
def test_backward_refusals(D, dtype, ok):
    """The card's backward takes float32 at head widths 32, 64, 128 and
    256; bf16 at 256 raises, naming the missing backward, before any
    launch (bf16 at 32–128 is taken: tests/test_torch_bf16_grad.py)."""
    q = torch.zeros(1, 2, 4, D, dtype=dtype)
    k = torch.zeros(1, 1, 4, D, dtype=dtype)
    if ok:
        assert D in BWD_HEAD_DIMS
        check_backward(q, k, k)
        return
    with pytest.raises(NotImplementedError, match="backward"):
        check_backward(q, k, k)


def test_k8_guard_raises_only_when_a_gradient_is_needed(monkeypatch):
    """K8 has a backward now, so nothing raises: on the card ``ssd_chunk``
    under grad, with an input requiring grad, goes through ``SSDChunk``
    (its outputs keep a grad_fn, whose backward is K8's), and otherwise
    through the kernel alone.  The card is stood in for by CPU tensors:
    the device reads as CUDA and the launch is the plain forward,
    detached, as the kernel's output is."""
    launched = []

    def launch(x, delta, dtv, Bm, Cm, hpg):
        launched.append(torch.is_grad_enabled())
        with torch.no_grad():
            return ssd_chunk_ref(x, delta, dtv, Bm, Cm, heads_per_group=hpg)

    monkeypatch.setattr(k8ops, "_launch", launch)
    monkeypatch.setattr(k8ops, "device_of",
                        lambda fn, ts: torch.device("cuda"))
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(2, 1, 8, 4).astype(np.float32))
    dt = torch.from_numpy(0.1 + rng.rand(2, 1, 8).astype(np.float32))
    Bm = torch.from_numpy(rng.randn(1, 1, 1, 8, 6).astype(np.float32))
    ins = (x, -dt, dt, Bm, Bm * 0.5)
    outs = k8ops.ssd_chunk(*ins, heads_per_group=2)
    assert all(o.grad_fn is None for o in outs)
    leaf = x.clone().requires_grad_(True)
    outs = k8ops.ssd_chunk(leaf, *ins[1:], heads_per_group=2)
    assert all(type(o.grad_fn).__name__ == "SSDChunkBackward" for o in outs)
    with torch.no_grad():
        assert all(o.grad_fn is None for o in k8ops.ssd_chunk(
            leaf, *ins[1:], heads_per_group=2))
    assert launched == [True, False, False]
    monkeypatch.undo()
    dy = torch.ones_like(outs[0])
    (got,) = torch.autograd.grad(outs[0], leaf, dy)
    want = ssd_chunk_bwd_ref(*ins, dy, torch.zeros_like(outs[1]),
                             torch.zeros_like(outs[2]), heads_per_group=2)[0]
    assert torch.equal(got, want)


# ------------------------------------------------------------- on the card

@pytest.mark.gpu
@pytest.mark.parametrize("B,H,Hkv,Lq,Lk,D,causal,window", SHAPES)
def test_cuda_backward_matches_plain_version(B, H, Hkv, Lq, Lk, D, causal,
                                             window):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU form)")
    host = list(map(torch.from_numpy, _inputs(B, H, Hkv, Lq, Lk, D)))
    q, k, v = (t.cuda().requires_grad_(True) for t in host[:3])
    LAUNCHES.clear()
    o = flash_attention(q, k, v, causal=causal, window=window)
    o.backward(host[3].cuda())
    torch.cuda.synchronize()
    assert dict(LAUNCHES) == {"flash_attention": 1, "flash_attention_bwd": 1}
    want = attention_bwd_ref(*host, causal=causal, window=window)
    for t, w in zip((q, k, v), want):
        g = t.grad.cpu()
        tol = 2e-4 * w.abs() + 2e-5 * w.abs().max()
        assert bool(((g - w).abs() <= tol).all())
