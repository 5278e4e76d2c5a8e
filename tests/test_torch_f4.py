"""K6's ``1/ΣC²`` at K ≥ 5 in XLA:CPU's order (ROADMAP §3, F4): the
plain version ``rl_score_matrix_ref`` and the plain-torch mirror of the
CUDA kernel's decomposition under forced tilings, bit for bit against the
reference's jitted wrapper over its Pallas kernel in interpret mode.

The reference reduces ``ΣC²`` in its wrapper, outside the kernel, and at
K ≥ 5 XLA vectorises that reduction across servers: the leading
``unfused_columns(N, K)`` servers sum rounded squares left to right, the
rest are a fused multiply-add chain.  One column is not replayed (N = 2,
K = 5, column 1); its scores are counted and bounded."""
import numpy as np
import pytest

from _reference_cache import no_persistent_compile_cache  # noqa: F401

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro_torch.kernels.rl_score import rl_score_matrix_ref  # noqa: E402
from repro_torch.kernels.rl_score.ops import plan_k6  # noqa: E402
from repro_torch.kernels.rl_score.ref import unfused_columns  # noqa: E402
from test_torch_k5k6_design import (K6_WIDTHS, SMS, _jax_rl,  # noqa: E402
                                    _rl_inputs, k6_mirror)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


#: (50, 100, 5), where the fused chain alone missed 909 of 5 000 scores;
#: K6_WIDTHS' K ≥ 5 shapes; K = 5..8 at N across every regime of
#: ``unfused_columns`` (scalar, a power-of-two vector, 4- and 8-wide
#: tails, past 128).
F4_SHAPES = sorted({(50, 100, 5)}
                   | {(T, N, K) for T, N, K, _ in K6_WIDTHS if K >= 5}
                   | {(50, N, K) for K in range(5, 9)
                      for N in (1, 7, 8, 9, 100, 101, 257)}
                   | {(8, N, 6) for N in (4, 16, 20, 37, 44, 128, 129)})

#: The plan's tiling and forced ones of several column tiles.
TILINGS = ((3, 4, 2), (3, 4, 5), (1, 4, 1))


def _ref(r, L, C):
    return np.asarray(_jax_rl()(*(t.numpy() for t in (r, L, C))))


@pytest.mark.parametrize("T,N,K", F4_SHAPES)
def test_scores_equal_the_reference(T, N, K):
    for seed in (T + N + K, 7):
        r, L, C = _rl_inputs(T, N, K, seed)
        want = _ref(r, L, C)
        got = rl_score_matrix_ref(r, L, C)
        assert np.array_equal(got.numpy(), want), seed
        for plan in {plan_k6(T, N, SMS), *TILINGS}:
            assert torch.equal(k6_mirror(r, L, C, plan), got), plan


def test_unfused_columns_regimes():
    assert [unfused_columns(N, 4) for N in (2, 20, 100, 256)] == [0] * 4
    assert [unfused_columns(N, 5) for N in (1, 2, 3, 4, 8, 12, 15)] == [
        0, 2, 0, 4, 8, 0, 0]
    # 4-wide remainders below 40 servers at K = 5, 8-wide from there.
    assert [unfused_columns(N, 5) for N in (37, 39, 44, 47)] == [
        36, 36, 40, 40]
    assert [unfused_columns(N, 6) for N in (30, 37)] == [28, 32]
    assert [unfused_columns(N, 8) for N in (16, 19, 20, 79, 87, 128, 129,
                                            200, 255, 256, 383, 10_000)] == [
        16, 16, 20, 76, 80, 128, 0, 0, 248, 256, 376, 0]


#: Shapes past 128 servers that XLA:CPU vectorises (N mod 128 ∈ {0,
#: 127}) and three that it does not, up to the 10⁴-server fleet.
@pytest.mark.parametrize("N", [200, 255, 256, 383, 512, 1023, 4095, 4096,
                               8192, 10_000])
def test_wide_fleets(N):
    for K in (5, 8):
        r, L, C = _rl_inputs(4, N, K, N + K)
        assert np.array_equal(rl_score_matrix_ref(r, L, C).numpy(),
                              _ref(r, L, C))


def test_the_unreplayed_column_is_bounded():
    """N = 2, K = 5: XLA:CPU contracts the last terms of column 1 only.
    Over 20 seeds at T = 50 exactly 95 of the 2 000 scores differ, all in
    that column (at seeds 16 and 18), by at most 2 ulp; column 0 is
    exact."""
    differ = 0
    for seed in range(20):
        r, L, C = _rl_inputs(50, 2, 5, seed)
        want = _ref(r, L, C).view(np.int32).astype(np.int64)
        got = rl_score_matrix_ref(r, L, C).numpy().view(np.int32)
        ulp = np.abs(got.astype(np.int64) - want)
        assert not ulp[:, 0].any()
        assert int(ulp.max()) <= 2
        differ += int((ulp > 0).sum())
    assert differ == 95
