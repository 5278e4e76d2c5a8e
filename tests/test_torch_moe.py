"""The port's MoE layer — its two expert routers, one token group, the
grouped layer, and the dbrx-132b and qwen3-moe-235b-a22b smoke models
through ``registry`` — against the JAX reference on the CPU, with the
reference's weights carried by ``params_from_numpy``; and, on a machine
with a card, the MoE smoke models on the card against the CPU.

The JAX reference is imported inside the ``ref`` fixture, so the card test
runs on a machine without JAX.

Tolerances (float32): the routers are exact on identical probabilities —
the same experts, bit-equal gates — including rows that tie entirely.
A group's and a model's outputs agree to the model pins of
``tests/test_torch_models.py`` (rtol 2e-4 / atol 2e-5; ``moe_aux`` rtol
2e-4): the router logits, the experts' products and the combine sum in
another order than XLA's, and the chosen experts, the kept choices, the
queue positions and the expert loads are equal."""
import functools
import types
from dataclasses import replace

import numpy as np
import pytest

from _reference_cache import no_persistent_compile_cache  # noqa: F401

torch = pytest.importorskip("torch")

import repro_torch.configs as tconfigs  # noqa: E402
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models import params_from_numpy  # noqa: E402

MODEL = dict(rtol=2e-4, atol=2e-5)
MOE = ["dbrx-132b", "qwen3-moe-235b-a22b"]
ROUTERS = ["topk", "dodoor"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def ref():
    """The JAX reference: ``jax``, ``jnp``, its configs, ``transformer``
    and ``registry``."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    import repro.configs as jconfigs
    from repro.models import registry as jregistry
    from repro.models import transformer as jtransformer
    return types.SimpleNamespace(jax=jax, jnp=jnp, configs=jconfigs,
                                 T=jtransformer, registry=jregistry)


def _cfgs(ref, name, **kw):
    """The reference's and the port's smoke config, with ``kw`` set."""
    return (replace(ref.configs.ARCHS[name].smoke(), **kw),
            replace(tconfigs.ARCHS[name].smoke(), **kw))


@functools.lru_cache(maxsize=None)
def _smoke_params(name):
    """The reference's smoke parameters (``PRNGKey(0)``) as numpy."""
    import jax

    import repro.configs as jconfigs
    from repro.models import registry as jregistry
    cfg = jconfigs.ARCHS[name].smoke()
    return jax.tree.map(np.asarray, jregistry.init_params(
        cfg, jax.random.PRNGKey(0)))


def _moe_params(ref, cfg, seed):
    """One MoE layer's parameters from the reference's ``moe_init``, as
    numpy, with the router scaled up so the gates are far from uniform."""
    p = ref.T.moe_init(ref.jax.random.PRNGKey(seed), cfg)
    p = {k: np.asarray(v) for k, v in p.items()}
    p["router"] = p["router"] * 50.0
    return p


def _torch_tree(p):
    return {k: torch.tensor(v) for k, v in p.items()}


def _ref_queue(ref, idx, E, cap):
    """The reference's queue positions and kept mask for chosen experts
    ``idx`` (``moe_group_apply``'s own lines)."""
    jnp = ref.jnp
    g, k = idx.shape
    eoh = ref.jax.nn.one_hot(jnp.asarray(idx), E, dtype=jnp.float32)
    flat = eoh.reshape(g * k, E)
    pos = jnp.cumsum(flat, axis=0) - flat
    pos = jnp.sum(pos * flat, axis=-1).reshape(g, k).astype(jnp.int32)
    return np.asarray(pos), np.asarray(pos < cap)


# ------------------------------------------------------------------ routers

def _probs_cases(E: int, seed: int):
    """Probability rows [g, E]: random rows, rows that tie entirely (a
    padded row's softmax), rows with tied pairs and a tied top."""
    rng = np.random.RandomState(seed)
    logits = rng.randn(12, E).astype(np.float32) * 2
    logits[3] = 0.0                                       # uniform
    logits[5] = 1.5                                       # uniform
    logits[7, : E // 2] = logits[7, E // 2:]              # tied pairs
    logits[9, 1] = logits[9, 2] = logits[9].max() + 1     # tied top
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("E,k", [(4, 2), (8, 2), (16, 4), (128, 8)])
def test_route_topk_exact(ref, E, k):
    probs = _probs_cases(E, E + k)
    want_idx, want_vals = ref.T._route_topk(ref.jnp.asarray(probs), k)
    idx, vals = T._route_topk(torch.from_numpy(probs), k)
    assert np.array_equal(idx.numpy(), np.asarray(want_idx))
    assert np.array_equal(vals.numpy(), np.asarray(want_vals))
    assert np.array_equal(idx[3].numpy(), np.arange(k))   # ties: lower index


def _loads(E: int, probs, seed: int):
    """Cached loads: all zero (every pair ties: A), small integers (many
    pairs of equal load), and loads rising with the probability order of
    every row (every pair flips to B)."""
    rng = np.random.RandomState(seed)
    order = np.argsort(-probs[0], kind="stable")
    rising = np.empty(E, np.float32)
    rising[order] = np.arange(E, 0, -1)
    return {"zero": np.zeros(E, np.float32),
            "ties": rng.randint(0, 3, E).astype(np.float32),
            "flip": rising}


@pytest.mark.parametrize("load_kind", ["zero", "ties", "flip"])
@pytest.mark.parametrize("E,k", [(4, 2), (8, 2), (16, 4), (128, 8)])
def test_route_dodoor_exact(ref, E, k, load_kind):
    probs = _probs_cases(E, E * k)
    if load_kind == "flip":
        # Every row in the same expert order, so one load flips them all.
        probs = np.sort(probs, axis=-1)[:, ::-1][:, np.argsort(
            np.random.RandomState(E).permutation(E))]
        probs = np.ascontiguousarray(probs)
    load = _loads(E, probs, E)[load_kind]
    want_idx, want_vals = ref.T._route_dodoor(
        ref.jnp.asarray(probs), ref.jnp.asarray(load), k)
    idx, vals = T._route_dodoor(torch.from_numpy(probs),
                                torch.from_numpy(load), k)
    assert np.array_equal(idx.numpy(), np.asarray(want_idx))
    assert np.array_equal(vals.numpy(), np.asarray(want_vals))
    _, cand = T._top(torch.from_numpy(probs), 2 * k)
    distinct = torch.tensor([len(set(row)) == E for row in probs])
    if load_kind == "zero":
        assert torch.equal(idx, cand[:, 0::2])
    elif load_kind == "flip":
        assert torch.equal(idx[distinct], cand[distinct][:, 1::2])


# ------------------------------------------------------------- one group

@pytest.mark.parametrize("router", ROUTERS)
@pytest.mark.parametrize("g", [8, 16])
@pytest.mark.parametrize("E,k", [(4, 2), (8, 2)])
def test_group_matches_reference(ref, g, router, E, k):
    """``moe_group_apply`` at capacity factor 1.0 (choices are dropped)
    on a non-zero cached load: y, aux and the new load against the
    reference, and the chosen experts, queue positions and kept mask
    against the reference's own lines."""
    jcfg, tcfg = _cfgs(ref, "dbrx-132b", router=router, n_experts=E,
                       top_k=k, capacity_factor=1.0)
    p = _moe_params(ref, jcfg, g)
    rng = np.random.RandomState(g + E)
    x = rng.randn(g, jcfg.d_model).astype(np.float32)
    load = rng.randint(0, 4, E).astype(np.float32)
    jy, jaux, jload = ref.T.moe_group_apply(
        {k_: ref.jnp.asarray(v) for k_, v in p.items()}, ref.jnp.asarray(x),
        jcfg, ref.jnp.asarray(load))
    tp = _torch_tree(p)
    y, aux, new_load = T.moe_group_apply(tp, torch.from_numpy(x), tcfg,
                                         torch.from_numpy(load))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **MODEL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=2e-4)
    assert np.array_equal(new_load.numpy(), np.asarray(jload))

    # The routing itself: the reference's router on the reference's
    # probabilities, and its queue, against the port's.
    jprobs = ref.jax.nn.softmax((ref.jnp.asarray(x) @ p["router"]).astype(
        ref.jnp.float32), axis=-1)
    if router == "dodoor":
        jidx, _ = ref.T._route_dodoor(jprobs, ref.jnp.asarray(load), k)
    else:
        jidx, _ = ref.T._route_topk(jprobs, k)
    cap = T._capacity(g, tcfg)
    assert cap == ref.T._capacity(g, jcfg)
    jpos, jkeep = _ref_queue(ref, np.asarray(jidx), E, cap)
    _, idx, _ = T.moe_route(tp, torch.from_numpy(x), tcfg,
                            torch.from_numpy(load))
    pos, counts = T.moe_queue(idx, E)
    assert np.array_equal(idx.numpy(), np.asarray(jidx))
    assert np.array_equal(pos.numpy(), jpos)
    assert np.array_equal((pos < cap).numpy(), jkeep)
    assert np.array_equal(counts.numpy(), np.asarray(jload))
    assert not jkeep.all()                                # drops happen


@pytest.mark.parametrize("router", ROUTERS)
@pytest.mark.parametrize("B,L,group", [(2, 8, 6), (1, 16, 16), (2, 9, 4)])
def test_moe_apply_matches_reference(ref, router, B, L, group):
    """Grouped, zero-padded tail, the dodoor load carried from group to
    group: y and the mean aux against the reference's ``moe_apply``."""
    jcfg, tcfg = _cfgs(ref, "qwen3-moe-235b-a22b", router=router,
                       capacity_factor=1.0)
    p = _moe_params(ref, jcfg, B * L)
    x = np.random.RandomState(L).randn(B, L, jcfg.d_model).astype(
        np.float32)
    jy, jaux = ref.T.moe_apply({k: ref.jnp.asarray(v) for k, v in p.items()},
                               ref.jnp.asarray(x), jcfg, group=group)
    y, aux = T.moe_apply(_torch_tree(p), torch.from_numpy(x), tcfg,
                         group=group)
    assert y.shape == (B, L, jcfg.d_model)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **MODEL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=2e-4)


def test_capacity_is_the_references():
    cfg = tconfigs.ARCHS["qwen3-moe-235b-a22b"]
    assert T._capacity(2048, cfg) == 160
    assert T._capacity(4, cfg) == 1                       # a decode step
    assert T._capacity(2048, tconfigs.ARCHS["dbrx-132b"]) == 640
    assert T._capacity(6, replace(cfg.smoke(), capacity_factor=1.0)) == 3


# ------------------------------------------------------------------ models

def _model(ref, name, router):
    jcfg, tcfg = _cfgs(ref, name, router=router)
    tree = _smoke_params(name)
    jp = ref.jax.tree.map(ref.jnp.asarray, tree)
    return jcfg, tcfg, jp, params_from_numpy(tcfg, tree, device="cpu")


@pytest.mark.parametrize("router", ROUTERS)
@pytest.mark.parametrize("name", MOE)
@pytest.mark.parametrize("B,L", [(2, 32), (2, 1100)])
def test_forward_matches_reference(ref, name, router, B, L):
    """``registry.forward``: logits and ``moe_aux``; at 2 × 1100 tokens the
    layer runs a full group of 2048 and a mostly padded one."""
    jcfg, tcfg, jp, tp = _model(ref, name, router)
    tokens = np.random.RandomState(B + L).randint(0, jcfg.vocab, (B, L))
    want, waux = ref.registry.forward(
        jcfg, jp, {"tokens": ref.jnp.asarray(tokens)}, remat=False)
    got, aux = registry.forward(tcfg, tp, {"tokens": torch.from_numpy(
        tokens)})
    assert got.shape == (B, L, jcfg.vocab) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL)
    np.testing.assert_allclose(float(aux["moe_aux"]),
                               float(waux["moe_aux"]), rtol=2e-4)
    assert float(aux["moe_aux"]) > 0.0


@pytest.mark.parametrize("router", ROUTERS)
@pytest.mark.parametrize("name", MOE)
def test_decode_steps_match_reference(ref, name, router):
    """Six decode steps from an empty float32 cache, each step's B tokens
    routed as one group (capacity 1 at B = 2: choices dropped)."""
    jcfg, tcfg, jp, tp = _model(ref, name, router)
    B, steps = 2, 6
    tokens = np.random.RandomState(7).randint(0, jcfg.vocab, (B, steps))
    jcache = ref.registry.init_cache(jcfg, B, steps,
                                     dtype=ref.jnp.float32)
    cache = registry.init_cache(tcfg, B, steps, dtype=torch.float32,
                                device="cpu")
    for t in range(steps):
        want, jcache = ref.registry.decode_step(
            jcfg, jp, jcache, ref.jnp.asarray(tokens[:, t:t + 1]))
        got, cache = registry.decode_step(
            tcfg, tp, cache, torch.from_numpy(tokens[:, t:t + 1]))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL)
    assert cache["idx"] == steps


@pytest.mark.parametrize("name", MOE)
def test_init_params_follows_moe_init(ref, name):
    """The port's own init has the reference's tree and shapes, and each
    MoE leaf ``moe_init``'s scale: the router 0.02, w_gate and w_up
    d^-0.5, w_down ff^-0.5."""
    jcfg, tcfg = _cfgs(ref, name)
    tree = _smoke_params(name)
    ours = registry.init_params(tcfg, 0, device="cpu")
    flat_o = dict(ref.jax.tree_util.tree_flatten_with_path(ours)[0])
    flat_j = ref.jax.tree_util.tree_flatten_with_path(tree)[0]
    assert len(flat_o) == len(flat_j)
    d, ff = tcfg.d_model, tcfg.moe_d_ff
    scales = {"router": 0.02, "w_gate": d ** -0.5, "w_up": d ** -0.5,
              "w_down": ff ** -0.5}
    for path, leaf in flat_j:
        got, want = flat_o[path].numpy(), np.asarray(leaf)
        assert got.shape == want.shape, path
        if want.std() == 0:
            assert np.array_equal(got, want), path
        else:
            assert abs(got.std() / want.std() - 1) < 0.1, path
        if len(path) > 2 and path[-2].key == "moe":
            assert abs(got.std() / scales[path[-1].key] - 1) < 0.05, path
    assert ours["layers"]["moe"]["w_down"].shape == (
        tcfg.n_layers, tcfg.n_experts, ff, d)
    assert "mlp" not in ours["layers"]


def test_dodoor_router_balances_better():
    """The port's counterpart of the reference's MoE routing test: under
    a router skewed toward expert 0, the two-choice cached-load router
    spreads one group's tokens at least as evenly as plain top-k."""
    cfg0 = replace(tconfigs.ARCHS["dbrx-132b"].smoke(), n_experts=8,
                   top_k=2, capacity_factor=1.0)
    p = T.moe_init(tcommon.generator(0, "cpu"), cfg0, device="cpu")
    p["router"][:, 0] += 2.0
    x = torch.randn((512, cfg0.d_model),
                    generator=tcommon.generator(1, "cpu"))

    def load_imbalance(cfg):
        _, aux, load = T.moe_group_apply(p, x, cfg,
                                         torch.zeros((cfg.n_experts,)))
        return float(load.max() / torch.clamp(load.mean(), min=1e-9)), aux

    imb_topk, _ = load_imbalance(cfg0)
    imb_dd, _ = load_imbalance(replace(cfg0, router="dodoor"))
    assert imb_dd <= imb_topk + 1e-6


# ------------------------------------------------------------- on the card

@pytest.mark.gpu
@pytest.mark.parametrize("router", ROUTERS)
@pytest.mark.parametrize("name", MOE)
def test_cuda_moe_matches_cpu(name, router):
    """forward (two groups) and three decode steps of an MoE smoke model
    on the card (one K7 launch an attention layer) against the CPU run:
    the same routes on the card as on the CPU at this size."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K7 has no CPU form)")
    cfg = replace(tconfigs.ARCHS[name].smoke(), router=router)
    tp = registry.init_params(cfg, 0, device="cpu")
    gp = tcommon.tree_map(lambda a: a.cuda(), tp)
    tokens = torch.from_numpy(np.random.RandomState(6).randint(
        0, cfg.vocab, (2, 1100)))
    LAUNCHES.clear()
    got, gaux = registry.forward(cfg, gp, {"tokens": tokens.cuda()})
    torch.cuda.synchronize()
    assert LAUNCHES == {"flash_attention": cfg.n_layers}
    want, waux = registry.forward(cfg, tp, {"tokens": tokens})
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), **MODEL)
    np.testing.assert_allclose(float(gaux["moe_aux"]),
                               float(waux["moe_aux"]), rtol=2e-4)
    gc = registry.init_cache(cfg, 2, 4, dtype=torch.float32, device="cuda")
    cc = registry.init_cache(cfg, 2, 4, dtype=torch.float32, device="cpu")
    for t in range(3):
        g, gc = registry.decode_step(cfg, gp, gc, tokens[:, t:t + 1].cuda())
        c, cc = registry.decode_step(cfg, tp, cc, tokens[:, t:t + 1])
        np.testing.assert_allclose(g.cpu().numpy(), c.numpy(), **MODEL)
