"""The port's synthetic token pipeline (``repro_torch.data``) and the
draws it needs (``random.uniform`` with bounds, ``gumbel``,
``_arith.log``) against the JAX package's, exactly.

The reference draws each token with ``jax.random.categorical``, whose
Gumbel noise takes two float32 ``log``s; XLA:CPU's ``log`` differs from
``torch.log`` by an ulp on ≈ 14 % of arguments, and a near-tie argmax
would then flip a token, so the port replays XLA's ``log`` and its noise
is bit for bit the reference's."""
import numpy as np
import pytest

from _reference_cache import no_persistent_compile_cache  # noqa: F401

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.data import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.data import make_batch_iterator as j_iter  # noqa: E402
from repro_torch import _arith  # noqa: E402
from repro_torch import random as jr  # noqa: E402
from repro_torch.data import SyntheticLM, make_batch_iterator  # noqa: E402


def _key(seed):
    return jr.PRNGKey(seed, device="cpu")


def test_log_is_xlas():
    """``_arith.log`` against ``jax.jit(jnp.log)`` over the ranges the
    Gumbel noise feeds it: uniforms in [tiny, 1) and their −log."""
    rng = np.random.RandomState(0)
    u = np.maximum(rng.rand(200_000).astype(np.float32),
                   np.finfo(np.float32).tiny)
    u[:4] = [np.finfo(np.float32).tiny, 1e-30, 0.5, np.float32(1) - 2**-24]
    for x in (u, -np.asarray(jax.jit(jnp.log)(u))):
        want = np.asarray(jax.jit(jnp.log)(x))
        np.testing.assert_array_equal(
            _arith.log(torch.from_numpy(x)).numpy(), want)


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (float(np.finfo(np.float32)
                                                      .tiny), 1.0),
                                   (-2.5, 3.0)])
def test_uniform_with_bounds_matches_reference(lo, hi):
    key = _key(11)
    want = np.asarray(jax.random.uniform(jax.random.PRNGKey(11), (4, 50),
                                         minval=lo, maxval=hi))
    got = jr.uniform(key, (4, 50), minval=lo, maxval=hi).numpy()
    np.testing.assert_array_equal(got, want)


def test_gumbel_matches_reference_bit_for_bit():
    for seed in range(3):
        want = np.asarray(jax.random.gumbel(jax.random.PRNGKey(seed),
                                            (64, 64)))
        got = jr.gumbel(_key(seed), (64, 64)).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_synthetic_batches_equal_the_reference(seed):
    """Tokens and labels of steps 0–3 on each of two hosts (one host:
    ``test_batch_iterator_equals_the_reference``)."""
    for step in range(4):
        for host in (0, 1):
            want = JSyntheticLM(512, 48, 4, seed).batch(
                step, host_index=host, num_hosts=2)
            got = SyntheticLM(512, 48, 4, seed, device="cpu").batch(
                step, host_index=host, num_hosts=2)
            for k in ("tokens", "labels"):
                assert got[k].dtype == torch.int32
                np.testing.assert_array_equal(got[k].numpy(),
                                              np.asarray(want[k]))


def test_batch_iterator_equals_the_reference():
    """Resumable from ``start_step``; a vocabulary that is no multiple of
    the 64 states (stride 1)."""
    it = make_batch_iterator(50, 32, 2, seed=3, start_step=5, device="cpu")
    jit_ = j_iter(50, 32, 2, seed=3, start_step=5)
    for _ in range(3):
        (s, got), (js, want) = next(it), next(jit_)
        assert s == js
        np.testing.assert_array_equal(got["tokens"].numpy(),
                                      np.asarray(want["tokens"]))


def test_pipeline_runs_on_the_card_unless_asked():
    """The default device is the card: without one it raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SyntheticLM(512, 8, 2).batch(0)
