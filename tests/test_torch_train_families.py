"""The train step of the three families ``tests/test_torch_train.py``
leaves out — mamba2-1.3b (the SSM: its chunk scan on the CPU), the RG-LRU
hybrid (recurrentgemma-2b: the scan's multiply-adds replayed in float64
with XLA's rounding, and local attention) and whisper-base (the
encoder-decoder, frames in the batch) — against the JAX package's on the
CPU, smoke configs with the reference's weights carried by
``params_from_numpy`` and the same synthetic batches: the loss of one
``make_train_step`` step and the gradients of ``loss_and_grads`` against
``jax.value_and_grad``, within ``tests/test_torch_train.py``'s
tolerances (the loss within rtol 1e-5, each gradient leaf within 1e-4 of
its largest magnitude).  With the CPU's multiply-add replay under
autograd the hybrid's gradient is that of a·b + c, and its value the
replay's own bit for bit."""
import numpy as np
import pytest

from _reference_cache import no_persistent_compile_cache  # noqa: F401

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.train import steps as jsteps  # noqa: E402
from repro_torch import _arith  # noqa: E402
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402
from test_torch_train import (  # noqa: E402
    LOSS_RTOL, _grads_close, _reference_grads, _setup)

FAMILIES = ["mamba2-1.3b", "recurrentgemma-2b", "whisper-base"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _family_setup(name, B=2, L=40):
    """``test_torch_train._setup``'s models and batches, with whisper's
    encoder frames (from a seed) added to both batches."""
    jcfg, tcfg, jp, tp, jb, tb = _setup(name, B=B, L=L)
    if jcfg.family == "audio":
        frames = np.random.RandomState(3).randn(
            B, jcfg.encoder_frames, jcfg.d_model).astype(np.float32) * 0.5
        jb = dict(jb, frames=jnp.asarray(frames))
        tb = dict(tb, frames=torch.from_numpy(frames))
    return jcfg, tcfg, jp, tp, jb, tb


@pytest.mark.parametrize("name", FAMILIES)
def test_train_step_matches_reference(name):
    jcfg, tcfg, jp, tp, jb, tb = _family_setup(name)
    jstep = jax.jit(jsteps.make_train_step(jcfg, lr=1e-3))
    _, _, jm = jstep(jp, jsteps.adamw_init(jp), jb)
    LAUNCHES.clear()
    _, opt, tm = tsteps.make_train_step(tcfg, lr=1e-3)(tp, adamw_init(tp),
                                                        tb)
    assert not LAUNCHES and int(opt.step) == 1
    for k in ("loss", "total"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                   rtol=LOSS_RTOL)
    jtotal, jg = _reference_grads(jcfg, jp, jb)
    total, ce, tg = tsteps.loss_and_grads(tcfg, tp, tb)
    np.testing.assert_allclose(float(total), float(jtotal), rtol=LOSS_RTOL)
    _grads_close(jg, tg)


def test_fma_replay_under_autograd():
    """``_arith.fma`` with inputs that need a gradient: the same bits as
    without (its midpoint step added as a constant), and the gradient of
    a·b + c."""
    rng = np.random.RandomState(0)
    a, b, c = (torch.from_numpy(rng.randn(50_000).astype(np.float32))
               for _ in range(3))
    # Sums at and next to a float32 rounding midpoint (1 + 2⁻²⁴).
    c[:1000] = torch.from_numpy(np.float32(1.0) + np.zeros(1000, np.float32))
    a[:1000] = torch.from_numpy(np.full(1000, 2.0 ** -24, np.float32))
    b[:1000] = torch.from_numpy(np.float32(1.0) + rng.randint(
        0, 4, 1000).astype(np.float32) * np.float32(2.0 ** -23))
    want = _arith.fma(a, b, c)
    leaves = [t.clone().requires_grad_(True) for t in (a, b, c)]
    got = _arith.fma(*leaves)
    assert torch.equal(got.detach().view(torch.int32), want.view(torch.int32))
    ga, gb, gc = torch.autograd.grad(got, leaves, torch.ones_like(got))
    assert torch.equal(ga, b) and torch.equal(gb, a)
    assert bool((gc == 1).all())


def test_hybrid_scan_gradient_on_the_cpu():
    """The hybrid's CPU scan under autograd: its gradients are those of
    the same scan in plain float32 multiply-adds, within float32
    rounding."""
    from repro_torch.models import rglru

    rng = np.random.RandomState(1)
    a = torch.from_numpy(rng.rand(2, 37, 8).astype(np.float32) * 0.1 + 0.9)
    b = torch.from_numpy(rng.randn(2, 37, 8).astype(np.float32))
    la, lb = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
    _, h = rglru.associative_scan(la, lb)
    g = torch.from_numpy(rng.randn(*h.shape).astype(np.float32))
    got = torch.autograd.grad(h, (la, lb), g)
    madd = rglru._madd
    try:
        rglru._madd = lambda x, y, z: torch.addcmul(z, x, y)
        la2, lb2 = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
        _, h2 = rglru.associative_scan(la2, lb2)
        want = torch.autograd.grad(h2, (la2, lb2), g)
    finally:
        rglru._madd = madd
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-5)
