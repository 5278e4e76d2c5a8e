"""``models.precision`` in the port against the JAX package's: the
transformer's ``forward`` under ``options(dtype=bf16)`` on both, with the
reference's weights carried by ``params_from_numpy``; the knobs' store
and restore; ``constrain`` a no-op on one card.

Tolerance: both sides round the weights and the residual stream to bf16
at the same points, but XLA:CPU and torch round bf16 elementwise ops
(norms, SiLU, RoPE) at different points, so the logits agree to 2e-2 of
the largest |logit| (a few bf16 steps over three layers).  The logits
are bf16 themselves: at the smoke vocabulary, with random weights, the
largest two of a row often tie or differ by one bf16 step (the
reference's own bf16 and float32 argmaxes agree on only 96–97 % of
positions).  So the argmax is held two ways: the port's equals the
reference's on ≥ 95 % of positions, and on ≥ 99 % it scores within one
bf16 step of the reference's maximum in the reference's logits (a tie
or a one-step difference, which every disagreement seen was)."""
import numpy as np
import pytest

from _reference_cache import no_persistent_compile_cache  # noqa: F401

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.models import precision as jprecision  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro_torch.models import params_from_numpy, precision  # noqa: E402
from repro_torch.models import registry  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("name", ["tinyllama-1.1b", "smollm-135m",
                                  "qwen2-7b"])
def test_bf16_forward_matches_reference(name):
    jcfg, tcfg = jconfigs.ARCHS[name].smoke(), tconfigs.ARCHS[name].smoke()
    jp = jregistry.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    tokens = np.random.RandomState(1).randint(0, jcfg.vocab, (4, 128))
    with jprecision.options(dtype=jnp.bfloat16):
        want, _ = jax.jit(lambda p, t: jregistry.forward(
            jcfg, p, {"tokens": t}))(jp, jnp.asarray(tokens))
    with precision.options(dtype=torch.bfloat16):
        got, _ = registry.forward(tcfg, tp, {"tokens": torch.from_numpy(
            tokens)})
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    g, w = got.float().numpy(), np.asarray(want.astype(jnp.float32))
    assert np.isfinite(g).all()
    top = np.abs(w).max()
    assert np.abs(g - w).max() <= 2e-2 * top
    pick = g.argmax(-1)
    assert (pick == w.argmax(-1)).mean() >= 0.95
    lead = w.max(-1) - np.take_along_axis(w, pick[..., None], -1)[..., 0]
    step = 2.0 ** (np.floor(np.log2(top)) - 7)      # bf16 spacing at top
    assert (lead <= step).mean() >= 0.99
    # The float32 master weights are untouched, and float32 comes back.
    assert all(t.dtype == torch.float32 for t in
               registry.module(tcfg).init_params(tcfg, 0,
                                                 device="cpu").values()
               if isinstance(t, torch.Tensor))
    f32, _ = registry.forward(tcfg, tp, {"tokens": torch.from_numpy(tokens)})
    assert f32.dtype == torch.float32


def test_options_set_and_restore():
    assert precision._DTYPE is None and precision._RESIDUAL_SPEC is None
    with precision.options(dtype=torch.bfloat16, residual_spec="spec"):
        assert precision._DTYPE is torch.bfloat16
        assert precision._RESIDUAL_SPEC == "spec"
        with precision.options():
            assert precision._DTYPE is None
        assert precision._DTYPE is torch.bfloat16
    assert precision._DTYPE is None
    with pytest.raises(ZeroDivisionError):
        with precision.options(dtype=torch.bfloat16):
            1 / 0
    assert precision._DTYPE is None and precision._RESIDUAL_SPEC is None
    precision.set_compute_dtype(torch.bfloat16)
    precision.set_residual_spec(("data", "model", None))
    try:
        assert precision._DTYPE is torch.bfloat16
        assert precision._RESIDUAL_SPEC == ("data", "model", None)
    finally:
        precision.set_compute_dtype(None)
        precision.set_residual_spec(None)


def test_casts_and_constrain():
    """``cast_params`` casts the float leaves of a tree (dicts and tuples)
    and leaves integer ones; ``cast_act`` casts; without a dtype both
    return their input; ``constrain`` returns its input whatever the
    spec (one card has no mesh)."""
    tree = {"w": torch.ones(2, 3), "i": torch.arange(3),
            "t": (torch.zeros(2), torch.ones(1, dtype=torch.float64))}
    assert precision.cast_params(tree) is tree
    x = torch.randn(4)
    assert precision.cast_act(x) is x
    with precision.options(dtype=torch.bfloat16, residual_spec="sp"):
        out = precision.cast_params(tree)
        assert out["w"].dtype == torch.bfloat16
        assert out["i"].dtype == torch.int64
        assert all(t.dtype == torch.bfloat16 for t in out["t"])
        assert precision.cast_act(x).dtype == torch.bfloat16
        assert precision.constrain(x) is x
