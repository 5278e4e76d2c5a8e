"""bf16 under grad: K7's plain version differentiated in bf16 against the
reference's jnp attention, ``check_backward``'s bf16 rule, and the train
step's gradients under ``precision.options(dtype=bf16)`` against the JAX
package's under ``jprecision.options(dtype=bf16)`` on the CPU (smoke
configs, the reference's weights carried by ``params_from_numpy``).

Tolerances.
* Attention: both sides form the logits, P and the output in float32
  and round the gradients to bf16, but the reference rounds each query
  head's dk, dv to bf16 before summing a GQA group's heads (the transpose
  of its broadcast), where the port sums in float32 and rounds once; so
  dq, dk, dv agree within ``ATTN_OF_MAX`` (four bf16 steps, 2⁻⁶) of each
  gradient's largest value.
* The train step: the loss within ``LOSS_RTOL`` and each gradient leaf
  within ``GRAD_OF_MAX`` of its largest value.  Source: this file's CPU
  runs of the same comparison gave the loss within 3.4e-5–4.6e-5
  relative and the worst leaf at 2.05e-2 (smollm-135m), 2.13e-2
  (qwen3-moe), 2.26e-2 (tinyllama) and 2.41e-2 (qwen2-vl) of its largest
  value, medians 1.3–1.8e-2; the reference's own bf16 gradients stand
  2.4e-2–4.2e-2 from its float32 ones.  The bounds sit above that band
  and at or below the reference's own bf16 gap: XLA:CPU and torch round
  bf16 elementwise ops (norms, SiLU, RoPE, the residual adds) at
  different points, and every such rounding is 2⁻⁹ relative.
* A control: the port run in float32 against the same bf16 reference
  gradients gave the loss within 9.83e-5 / 1.24e-5 / 7.81e-5 / 1.39e-4
  relative and the worst leaf at 2.92e-2 / 3.36e-2 / 2.37e-2 / 4.15e-2
  of its largest value (smollm-135m / tinyllama-1.1b / qwen3-moe /
  qwen2-vl), so those bounds alone would pass a port that ignored
  ``compute_dtype`` for smollm-135m and qwen3-moe.  The test therefore
  also asserts that every attention call of the step took bf16
  operands."""
import numpy as np
import pytest

from _reference_cache import no_persistent_compile_cache  # noqa: F401

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.models import common as jcommon  # noqa: E402
from repro.models import precision as jprecision  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    BWD_BF16_HEAD_DIMS, check_backward)
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import precision  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402
from test_torch_train import _reference_grads, _setup  # noqa: E402

ATTN_OF_MAX = 2.0 ** -6
LOSS_RTOL = 1e-4
GRAD_OF_MAX = 3e-2
ARCHS = ["smollm-135m", "tinyllama-1.1b", "qwen3-moe-235b-a22b",
         "qwen2-vl-2b"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def bf16_grads_close(jg, tg):
    """Each port gradient leaf (float32, the master weights') within
    ``GRAD_OF_MAX`` of the reference leaf's largest magnitude."""
    jl = [np.asarray(x, np.float32) for x in jax.tree.leaves(jg)]
    tl = tree_leaves(tg)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert a.shape == tuple(b.shape) and b.dtype == torch.float32
        b = b.numpy()
        assert np.isfinite(b).all()
        np.testing.assert_allclose(b, a, rtol=0,
                                   atol=GRAD_OF_MAX * np.abs(a).max())


def _bf16(x):
    """A float32 array rounded to bf16 as numpy floats (both sides then
    start from the same bf16 values)."""
    return np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("B,H,Hkv,Lq,Lk,D,causal,window", [
    (2, 4, 2, 48, 48, 32, True, None),       # GQA
    (1, 4, 1, 40, 72, 64, True, 16),         # a window, Lq < Lk
    (1, 2, 2, 24, 56, 128, False, None),     # non-causal, Lq < Lk
    (2, 8, 2, 33, 33, 64, True, 8),
])
def test_plain_attention_grads_in_bf16(B, H, Hkv, Lq, Lk, D, causal, window):
    """``flash_attention``'s plain form under autograd with bf16 q, k, v
    (what the card's bf16 backward is held to) against ``jax.vjp`` of the
    reference's ``common.attention`` on the same bf16 inputs."""
    rng = np.random.RandomState(B * Lq + D)
    q, k, v, do = (_bf16(rng.randn(*s).astype(np.float32) * sc).copy()
                   for s, sc in (((B, H, Lq, D), 0.5), ((B, Hkv, Lk, D), 0.5),
                                 ((B, Hkv, Lk, D), 1.0), ((B, H, Lq, D), 1.0)))
    jq, jk, jv, jdo = (jnp.asarray(x).astype(jnp.bfloat16)
                       for x in (q, k, v, do))
    out, vjp = jax.vjp(lambda a, b, c: jcommon.attention(
        a, b, c, causal=causal, window=window), jq, jk, jv)
    want = vjp(jdo)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
                  for x in (q, k, v))
    got = flash_attention(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == torch.bfloat16
    # The outputs: float32 sums in two orders, rounded once to bf16, so a
    # value may round to a neighbouring bf16 step (2⁻⁷ relative at most).
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(out.astype(jnp.float32)),
                               rtol=2.0 ** -7, atol=0)
    grads = torch.autograd.grad(got, (tq, tk, tv),
                                torch.from_numpy(do).to(torch.bfloat16))
    for g, w in zip(grads, want):
        assert g.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16
        w = np.asarray(w.astype(jnp.float32))
        np.testing.assert_allclose(g.float().numpy(), w, rtol=0,
                                   atol=ATTN_OF_MAX * np.abs(w).max())


@pytest.mark.parametrize("D", [32, 64, 128, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_check_backward_takes_bf16_up_to_128(D, dtype):
    """The card's backward takes bf16 q, k, v at head widths up to 128
    (every family that honours ``compute_dtype``) and float32 at every
    width; bf16 at 256 raises before any launch."""
    dt = getattr(torch, dtype)
    q = torch.zeros((1, 2, 4, D), dtype=dt)
    k = v = torch.zeros((1, 1, 4, D), dtype=dt)
    if dt == torch.bfloat16 and D not in BWD_BF16_HEAD_DIMS:
        with pytest.raises(NotImplementedError, match="bfloat16"):
            check_backward(q, k, v)
    else:
        check_backward(q, k, v)
    if dt == torch.bfloat16:
        with pytest.raises(NotImplementedError, match="one dtype"):
            check_backward(q, k.float(), v.float())


@pytest.mark.parametrize("name", ARCHS)
def test_bf16_loss_and_grads_match_reference(name, monkeypatch):
    jcfg, tcfg, jp, tp, jb, tb = _setup(name)
    with jprecision.options(dtype=jnp.bfloat16):
        jtotal, jg = _reference_grads(jcfg, jp, jb)
    dtypes = []

    def recorded(q, k, v, **kw):
        dtypes.append((q.dtype, k.dtype, v.dtype))
        return flash_attention(q, k, v, **kw)

    monkeypatch.setattr(tcommon, "flash_attention", recorded)
    with precision.options(dtype=torch.bfloat16):
        total, ce, tg = tsteps.loss_and_grads(tcfg, tp, tb)
    assert total.dtype == torch.float32
    # The step ran in bf16: every attention call of the forward (and of
    # its recomputation under remat) took bf16 q, k, v.
    assert dtypes and set(dtypes) == {(torch.bfloat16,) * 3}
    np.testing.assert_allclose(float(total), float(jtotal), rtol=LOSS_RTOL)
    bf16_grads_close(jg, tg)
