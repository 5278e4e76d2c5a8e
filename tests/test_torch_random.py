"""The port's threefry PRNG (``repro_torch.random``) is bit-exact against
``jax.random`` under the partitionable layout JAX runs by default, and so
is its ``exponential`` (XLA:CPU's float32 ``log1p``)."""
import numpy as np
import pytest

from _reference_cache import no_persistent_compile_cache  # noqa: F401

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
from hypothesis_compat import given, settings, st  # noqa: E402

from repro_torch import random as trand  # noqa: E402

SEEDS = st.integers(min_value=0, max_value=2 ** 31 - 1)
IDS = st.lists(st.integers(min_value=0, max_value=2 ** 31 - 1),
               min_size=8, max_size=8)


def _key_np(key) -> np.ndarray:
    return np.asarray(key).astype(np.int64)


def test_partitionable_layout_is_the_default():
    """The formulas the port implements are the partitionable ones."""
    assert jax.config.jax_threefry_partitionable


@settings(max_examples=25, deadline=None)
@given(seed=SEEDS, ids=IDS)
def test_prngkey_fold_in_split_uniform_bit_exact(seed, ids):
    kj = jax.random.PRNGKey(seed)
    kt = trand.PRNGKey(seed, device="cpu")
    assert np.array_equal(_key_np(kj), kt.numpy())

    ids_np = np.asarray(ids, np.int32)
    fj = jax.vmap(lambda t: jax.random.fold_in(kj, t))(ids_np)
    ft = trand.fold_in(kt, torch.from_numpy(ids_np))
    assert np.array_equal(_key_np(fj), ft.numpy())

    sj = jax.vmap(jax.random.split)(fj)                       # [T, 2, 2]
    st_ = trand.split(ft)
    assert np.array_equal(_key_np(sj), st_.numpy())

    uj = jax.vmap(lambda k: jax.random.uniform(k, (2,)))(sj[:, 0])
    assert np.array_equal(np.asarray(uj), trand.uniform(st_[:, 0], (2,))
                          .numpy())
    u0 = jax.vmap(jax.random.uniform)(sj[:, 1])
    assert np.array_equal(np.asarray(u0), trand.uniform(st_[:, 1]).numpy())


@pytest.mark.parametrize("shape", [(), (1,), (7,), (3, 5)])
def test_uniform_shapes_bit_exact(shape):
    kj = jax.random.PRNGKey(123)
    kt = trand.PRNGKey(123, device="cpu")
    uj = np.asarray(jax.random.uniform(kj, shape))
    ut = trand.uniform(kt, shape)
    assert ut.dtype == torch.float32 and tuple(ut.shape) == shape
    assert np.array_equal(uj, ut.numpy())


@pytest.mark.parametrize("num", [2, 3, 5])
def test_split_num_bit_exact(num):
    kj = jax.random.fold_in(jax.random.PRNGKey(7), 99)
    kt = trand.fold_in(trand.PRNGKey(7, device="cpu"), 99)
    assert np.array_equal(_key_np(jax.random.split(kj, num)),
                          trand.split(kt, num).numpy())


@pytest.mark.parametrize("seed", [0, 12345])
def test_exponential_bit_exact_over_a_million_draws(seed):
    """``jax.random.exponential`` is ``-log1p(-u)`` with XLA:CPU's own
    float32 ``log1p``; torch's ``log1p`` differs from it in about 7 % of
    these draws by one ulp, the port's rewrite in none."""
    kj = jax.random.fold_in(jax.random.PRNGKey(seed), 0x0A21)
    ej = np.asarray(jax.jit(lambda k: jax.random.exponential(
        k, (1_000_000,)))(kj))
    kt = trand.fold_in(trand.PRNGKey(seed, device="cpu"), 0x0A21)
    et = trand.exponential(kt, (1_000_000,))
    assert et.dtype == torch.float32
    assert np.array_equal(ej.view(np.int32), et.numpy().view(np.int32))
    shaped = trand.exponential(kt, (3, 2)).numpy()
    assert np.array_equal(shaped, np.asarray(jax.random.exponential(
        kj, (3, 2))))


def test_log1p_bit_exact_across_its_domain():
    from repro_torch._arith import log1p

    x = np.concatenate([
        np.linspace(-0.9999, 4.0, 300_001, dtype=np.float32),
        np.float32(10.0) ** np.linspace(-9, 7, 50_001, dtype=np.float32)])
    ref = np.asarray(jax.jit(jax.numpy.log1p)(x))
    got = log1p(torch.from_numpy(x)).numpy()
    assert np.array_equal(ref.view(np.int32), got.view(np.int32))


def test_uniform_is_in_unit_interval():
    u = trand.uniform(trand.PRNGKey(0, device="cpu"), (4096,))
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0


def test_prngkey_without_device_needs_a_gpu():
    """Entry points default to the GPU and never fall back to the CPU."""
    if torch.cuda.is_available():
        assert trand.PRNGKey(0).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            trand.PRNGKey(0)
