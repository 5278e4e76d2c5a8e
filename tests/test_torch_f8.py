"""F8: the MoE layer under bf16.  ``moe_group_apply`` combines the kept
choices in x's dtype, as the reference's ``combine.astype(x.dtype)``
einsum does (each gate rounded to bf16, the k products summed in float32
in choice order, the sum rounded once), so the residual stream leaves
the layer in bf16 and the next layer's projections take it.  The
qwen3-moe-235b-a22b and dbrx-132b smoke models run ``forward``,
``decode_step`` and ``loss_and_grads`` under bf16 against the JAX
package's on the CPU, with the reference's weights carried by
``params_from_numpy``; the float32 path is unchanged bit for bit.

Tolerances.  ``forward``'s logits within 2e-2 of the largest |logit|,
``tests/test_torch_precision.py``'s bound for the dense models (the two
frameworks round bf16 elementwise ops at different points).  A decode
step with bf16 weights (the reference's ``decode_step`` applies no
compute dtype, so bf16 decoding means bf16 parameters on both sides) the
same.  The train step: the loss within ``LOSS_RTOL`` and each gradient
leaf within ``GRAD_OF_MAX`` of its largest value, the bounds of
``tests/test_torch_bf16_grad.py`` (whose docstring gives their source).
A bf16 router logit can tie or round across an expert boundary on one
side only, and one flipped route moves two experts' gradients by tens
of per cent (dbrx's smoke model on its first batch: 0.21 of the largest
value, the reference's own bf16-against-float32 gap there 0.207): so,
as ``chip_smoke.py``'s MoE copies do, ``forward`` and the step run on
the first of ``SEEDS`` batches whose forward routes agree on both sides,
and the tests assert that one does (``moe_aux`` within 2e-2 relative: the
router's bf16 probabilities)."""
import numpy as np
import pytest

from _reference_cache import no_persistent_compile_cache  # noqa: F401

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.models import precision as jprecision  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro_torch.models import params_from_numpy, precision  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402
from test_torch_bf16_grad import LOSS_RTOL, bf16_grads_close  # noqa: E402
from test_torch_train import _reference_grads, _setup  # noqa: E402

MOE = ["qwen3-moe-235b-a22b", "dbrx-132b"]
LOGIT_OF_MAX = 2e-2
SEEDS = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _models(name):
    jcfg, tcfg = jconfigs.ARCHS[name].smoke(), tconfigs.ARCHS[name].smoke()
    jp = jregistry.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _close(got, want):
    g, w = got.float().numpy(), np.asarray(want.astype(jnp.float32))
    assert np.isfinite(g).all()
    assert np.abs(g - w).max() <= LOGIT_OF_MAX * np.abs(w).max()


def _port_routes(fn):
    """``fn()`` and the experts [g, k] (sorted in each row) of every MoE
    group it routed, in call order."""
    apply_group, rec = T.moe_group_apply, []

    def recording(p, x, cfg, load):
        _, idx, _ = T.moe_route(p, x, cfg, load)
        rec.append(np.sort(idx.numpy(), axis=1))
        return apply_group(p, x, cfg, load)

    T.moe_group_apply = recording
    try:
        return fn(), rec
    finally:
        T.moe_group_apply = apply_group


def _reference_routes(fn):
    """``fn()`` (jitted inside) and the reference's routes, read back from
    the compiled run by an ordered callback in its top-k router."""
    route, rec = jtransformer._route_topk, []

    def recording(probs, k):
        idx, vals = route(probs, k)
        jax.debug.callback(lambda i: rec.append(np.sort(np.asarray(i), 1)),
                           idx, ordered=True)
        return idx, vals

    jtransformer._route_topk = recording
    try:
        out = fn()
        jax.effects_barrier()
        return out, rec
    finally:
        jtransformer._route_topk = route


def _routes_agree(jcfg, tcfg, jp, tp, tokens) -> bool:
    """Whether the bf16 forwards of both sides route ``tokens`` alike."""
    with jprecision.options(dtype=jnp.bfloat16):
        _, want = _reference_routes(lambda: jax.jit(
            lambda p, t: jregistry.forward(jcfg, p, {"tokens": t}))(
                jp, jnp.asarray(tokens)))
    with precision.options(dtype=torch.bfloat16), torch.no_grad():
        _, got = _port_routes(lambda: registry.forward(
            tcfg, tp, {"tokens": torch.as_tensor(tokens)}))
    return len(got) == len(want) > 0 and all(
        np.array_equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("name", MOE)
def test_bf16_forward_matches_reference(name):
    """Logits and ``moe_aux`` on the first of ``SEEDS`` token batches
    whose routes agree."""
    jcfg, tcfg, jp, tp = _models(name)
    for seed in range(SEEDS):
        tokens = np.random.RandomState(seed).randint(0, jcfg.vocab, (2, 32))
        if _routes_agree(jcfg, tcfg, jp, tp, tokens):
            break
    else:
        pytest.fail(f"{name}: no batch of {SEEDS} seeds routes alike")
    with jprecision.options(dtype=jnp.bfloat16):
        want, waux = jax.jit(lambda p, t: jregistry.forward(
            jcfg, p, {"tokens": t}))(jp, jnp.asarray(tokens))
    with precision.options(dtype=torch.bfloat16):
        got, aux = registry.forward(tcfg, tp, {"tokens": torch.from_numpy(
            tokens)})
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    _close(got, want)
    np.testing.assert_allclose(float(aux["moe_aux"]),
                               float(waux["moe_aux"]), rtol=LOGIT_OF_MAX)


@pytest.mark.parametrize("name", MOE)
def test_bf16_layer_output_keeps_the_dtype(name):
    """One group under bf16 returns bf16 (F8: it returned float32, and
    the next layer's ``x @ wq`` raised on the mixed dtypes)."""
    _, tcfg, _, tp = _models(name)
    lp = T.layer(tp["layers"], 0)
    with precision.options(dtype=torch.bfloat16):
        moe = precision.cast_params(lp["moe"])
    x = torch.from_numpy(np.random.RandomState(2).randn(
        64, tcfg.d_model).astype(np.float32)).to(torch.bfloat16)
    y, aux, load = T.moe_group_apply(moe, x, tcfg, torch.zeros(
        tcfg.n_experts))
    assert y.dtype == torch.bfloat16 and y.shape == x.shape
    assert aux.dtype == torch.float32 and load.dtype == torch.float32


@pytest.mark.parametrize("name", MOE)
def test_bf16_decode_step_matches_reference(name):
    """Four decode steps with the weights cast to bf16 on both sides and
    a bf16 cache."""
    jcfg, tcfg, jp, tp = _models(name)
    jp = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp)
    with precision.options(dtype=torch.bfloat16):
        tp = precision.cast_params(tp)
    B, steps = 2, 4
    tokens = np.random.RandomState(7).randint(0, jcfg.vocab, (B, steps))
    jcache = jregistry.init_cache(jcfg, B, steps, dtype=jnp.bfloat16)
    cache = registry.init_cache(tcfg, B, steps, dtype=torch.bfloat16,
                                device="cpu")
    jstep = jax.jit(lambda p, c, t: jregistry.decode_step(jcfg, p, c, t))
    for t in range(steps):
        want, jcache = jstep(jp, jcache, jnp.asarray(tokens[:, t:t + 1]))
        got, cache = registry.decode_step(
            tcfg, tp, cache, torch.from_numpy(tokens[:, t:t + 1]))
        assert got.dtype == torch.bfloat16
        _close(got, want)
    assert cache["idx"] == steps


@pytest.mark.parametrize("name", MOE)
def test_bf16_train_step_matches_reference(name):
    """``loss_and_grads`` under bf16 against ``jax.value_and_grad`` under
    ``jprecision.options(bf16)``, and one ``make_train_step`` step: finite
    float32 gradients and a finite loss."""
    for seed in range(SEEDS):
        jcfg, tcfg, jp, tp, jb, tb = _setup(name, B=2, L=32, seed=seed)
        if _routes_agree(jcfg, tcfg, jp, tp, np.asarray(jb["tokens"])):
            break
    else:
        pytest.fail(f"{name}: no batch of {SEEDS} seeds routes alike")
    with jprecision.options(dtype=jnp.bfloat16):
        jtotal, jg = _reference_grads(jcfg, jp, jb)
    with precision.options(dtype=torch.bfloat16):
        total, ce, tg = tsteps.loss_and_grads(tcfg, tp, tb)
        _, opt, m = tsteps.make_train_step(tcfg, lr=1e-3)(
            tp, tsteps.adamw_init(tp), tb)
    np.testing.assert_allclose(float(total), float(jtotal), rtol=LOSS_RTOL)
    bf16_grads_close(jg, tg)
    assert np.isfinite(float(m["loss"])) and int(opt.step) == 1


@pytest.mark.parametrize("name", MOE)
def test_float32_moe_unchanged(name):
    """The float32 combine is the running float32 sum of gate × expert
    output it was before F8's repair, bit for bit."""
    _, tcfg, _, tp = _models(name)
    moe = T.layer(tp["layers"], 0)["moe"]
    x = torch.from_numpy(np.random.RandomState(3).randn(
        96, tcfg.d_model).astype(np.float32))
    load = torch.zeros(tcfg.n_experts)
    y, _, _ = T.moe_group_apply(moe, x, tcfg, load)
    # The combine as it was written before the repair.
    E, k, g = tcfg.n_experts, tcfg.top_k, x.shape[0]
    cap = T._capacity(g, tcfg)
    _, idx, vals = T.moe_route(moe, x, tcfg, load)
    pos, _ = T.moe_queue(idx, E)
    keep = pos < cap
    slot = torch.where(keep, idx * cap + pos, E * cap)
    src = torch.full((E * cap + 1,), g, dtype=torch.long)
    src.scatter_(0, slot.reshape(-1), torch.arange(g).repeat_interleave(k))
    xe = torch.nn.functional.pad(x, (0, 0, 0, 1))[src[:-1]].view(E, cap, -1)
    h = torch.nn.functional.silu(torch.bmm(xe, moe["w_gate"])) * \
        torch.bmm(xe, moe["w_up"])
    ye = torch.bmm(h, moe["w_down"]).view(E * cap, -1)
    slot = torch.where(keep, slot, 0)
    gate = vals * keep
    want = torch.zeros_like(x)
    for j in range(k):
        want = want + ye[slot[:, j]] * gate[:, j, None]
    assert y.dtype == torch.float32 and torch.equal(y, want)
