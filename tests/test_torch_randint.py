"""``repro_torch.random.randint`` bit for bit against ``jax.random.randint``
(the partitionable threefry layout), and the balls-into-bins processes of
``repro_torch.core.balls_bins`` that draw with it against the reference's
scan: final loads exact for integer weights."""
import math

import numpy as np
import pytest

from _reference_cache import no_persistent_compile_cache  # noqa: F401

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro.core import balls_bins as jbb  # noqa: E402
from repro_torch import random as trand  # noqa: E402
from repro_torch.core import balls_bins as tbb  # noqa: E402

#: (minval, maxval): spans 1, 2, 100, 101, 10⁴ and 2³¹ − 1 from 0; a
#: negative minval; the whole int32 range (a span of 2³² − 1, whose
#: multiplier wraps); maxval ≤ minval (minval comes back).
BOUNDS = [(0, 1), (0, 2), (0, 100), (0, 101), (0, 10_000),
          (0, 2 ** 31 - 1), (-50, 51), (-7, -3), (-2 ** 31, 2 ** 31 - 1),
          (5, 5), (9, 3)]
SHAPES = [(), (3,), (7, 5)]


def _keys(kind, seed):
    """The same key from both packages: a ``PRNGKey``, a ``fold_in`` of
    one and a half of a ``split``."""
    jk, tk = jax.random.PRNGKey(seed), trand.PRNGKey(seed, device="cpu")
    if kind == "fold_in":
        return jax.random.fold_in(jk, 77), trand.fold_in(tk, 77)
    if kind == "split":
        return jax.random.split(jk)[1], trand.split(tk)[1]
    return jk, tk


@pytest.mark.parametrize("lo,hi", BOUNDS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("kind", ["PRNGKey", "fold_in", "split"])
def test_randint_matches_jax(kind, shape, lo, hi):
    for seed in (0, 1, 12345):
        jk, tk = _keys(kind, seed)
        want = np.asarray(jax.random.randint(jk, shape, lo, hi))
        got = trand.randint(tk, shape, lo, hi)
        assert got.dtype == torch.int32 and tuple(got.shape) == shape
        assert np.array_equal(got.numpy(), want), (seed, lo, hi)


def test_randint_broadcasts_over_a_block_of_keys():
    """A [T, 2] block of keys gives [T, *shape] draws, row t equal to the
    draw from key t alone (the engine draws every task's probes at once)."""
    base = trand.PRNGKey(3, device="cpu")
    keys = trand.fold_in(base, torch.arange(6))
    block = trand.randint(keys, (3,), 0, 20)
    jbase = jax.random.PRNGKey(3)
    for t in range(6):
        want = jax.random.randint(jax.random.fold_in(jbase, t), (3,), 0, 20)
        assert np.array_equal(block[t].numpy(), np.asarray(want))


def test_randint_takes_int32_only():
    with pytest.raises(TypeError, match="int32"):
        trand.randint(trand.PRNGKey(0, device="cpu"), (2,), 0, 5,
                      dtype=torch.int64)


# ------------------------------------------------------------ balls_bins

@pytest.mark.parametrize("batch", [1, 16])
@pytest.mark.parametrize("beta", [0.5, 1.0])
@pytest.mark.parametrize("d", [1, 2])
def test_balls_into_bins_matches_reference(d, beta, batch):
    """Integer weights, so every float32 load is exact: the final loads
    are equal bit for bit."""
    for seed, n in ((0, 37), (3, 8)):
        w = np.random.RandomState(seed).randint(1, 5, 300).astype(np.float32)
        want = np.asarray(jbb.run_balls_into_bins(
            jax.random.PRNGKey(seed), w, n, d, beta, batch))
        got = tbb.run_balls_into_bins(trand.PRNGKey(seed, device="cpu"), w,
                                      n, d, beta, batch)
        assert got.dtype == torch.float32
        assert np.array_equal(got.numpy(), want)
        # The mean's summation order is torch's: gap within float32 rtol.
        assert math.isclose(float(tbb.gap(got)), float(jbb.gap(want)),
                            rel_tol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [1, 16])
@pytest.mark.parametrize("beta", [0.5, 1.0])
def test_cuda_balls_into_bins_matches_cpu(beta, batch):
    """The placement loop on the card gives the CPU's loads bit for bit,
    and leaves them on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    w = np.random.RandomState(5).randint(1, 5, 2000).astype(np.float32)
    cpu = tbb.run_balls_into_bins(trand.PRNGKey(5, device="cpu"), w, 100,
                                  2, beta, batch)
    gpu = tbb.run_balls_into_bins(trand.PRNGKey(5, device="cuda"), w, 100,
                                  2, beta, batch)
    assert gpu.device.type == "cuda"
    assert torch.equal(gpu.cpu(), cpu)


def test_gap_bounds_match_reference():
    for m, n, b, d in ((1000, 10, 50, 2), (10 ** 5, 1000, 5000, 3)):
        assert tbb.single_choice_gap_bound(m, n) == \
            jbb.single_choice_gap_bound(m, n)
        assert tbb.power_of_d_gap_bound(n, d) == jbb.power_of_d_gap_bound(n, d)
        assert tbb.batched_gap_bound(b, n) == jbb.batched_gap_bound(b, n)
        assert tbb.one_plus_beta_batched_gap_bound(b, n) == \
            jbb.one_plus_beta_batched_gap_bound(b, n)
        assert tbb.tuned_beta(b, n) == jbb.tuned_beta(b, n)
