"""The port's LM serving path — configs, the shared blocks, the dense
transformer and Mamba-2 through ``registry`` — against the JAX reference
on the CPU, with the reference's weights carried by ``params_from_numpy``,
and — on a machine with a card — the same models on the card against the
CPU.

Tolerances (float32 throughout): the blocks (norm, RoPE, attention, MLP)
agree to rtol 1e-5 / atol 1e-6 — one or two roundings in another order.
Whole smoke models agree to rtol 2e-4 / atol 2e-5 on logits of order 1:
three layers of float32 matmuls summed in XLA's order against torch's,
and for Mamba-2 two chunk scans whose exp/cumsum round differently.  The
port's own decode-vs-prefill property uses the reference pin's bounds
(tests/test_models.py: rtol 1e-3 / atol 2e-3 dense, 5e-3 Mamba-2)."""
import dataclasses
import functools

import numpy as np
import pytest

from _reference_cache import no_persistent_compile_cache  # noqa: F401

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.kernels.ssd_chunk import ssd as j_ssd  # noqa: E402
from repro.kernels.ssd_chunk import ssd_ref as j_ssd_ref  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import mamba2 as jmamba2  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import mamba2 as tmamba2  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models import params_from_numpy  # noqa: E402

BLOCK = dict(rtol=1e-5, atol=1e-6)
MODEL = dict(rtol=2e-4, atol=2e-5)
PORTED = ["tinyllama-1.1b", "smollm-135m", "qwen2-7b", "mamba2-1.3b"]
#: The families ported after the dense and SSM ones, each held to the
#: reference in its own file (MoE: test_torch_moe.py; VLM, hybrid, audio:
#: test_torch_{vlm,rglru,whisper}.py).
LATER = ["dbrx-132b", "qwen3-moe-235b-a22b", "qwen2-vl-2b",
         "recurrentgemma-2b", "whisper-base"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@functools.lru_cache(maxsize=None)
def _smoke(name):
    """(cfg, the reference's params as numpy, the port's params on the
    CPU) for a smoke config; cached across tests."""
    cfg = jconfigs.ARCHS[name].smoke()
    jp = jregistry.init_params(cfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jp)
    tcfg = tconfigs.ARCHS[name].smoke()
    return cfg, tcfg, jp, params_from_numpy(tcfg, tree, device="cpu")


def _tokens(cfg, B, L, seed):
    return np.random.RandomState(seed).randint(0, cfg.vocab, (B, L))


# ------------------------------------------------------------------ configs

@pytest.mark.parametrize("name", list(jconfigs.ARCHS))
def test_configs_equal_the_reference(name):
    j, t = jconfigs.ARCHS[name], tconfigs.ARCHS[name]
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(t.smoke()) == dataclasses.asdict(j.smoke())
    assert t.param_count() == j.param_count()
    assert t.active_param_count() == j.active_param_count()
    for shape in jconfigs.SHAPES:
        assert (tconfigs.applicable(t, tconfigs.SHAPES[shape])
                == jconfigs.applicable(j, jconfigs.SHAPES[shape]))


def test_shapes_and_cells_equal_the_reference():
    assert ({k: dataclasses.asdict(v) for k, v in tconfigs.SHAPES.items()}
            == {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()})
    assert tconfigs.cells(tconfigs.ARCHS) == jconfigs.cells(jconfigs.ARCHS)


# ------------------------------------------------------------------- blocks

def test_rms_norm_matches():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 64).astype(np.float32) * 3
    w = rng.randn(64).astype(np.float32)
    got = tcommon.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6)
    want = jcommon.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BLOCK)


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_matches(theta):
    """RoPE rotates interleaved channel pairs, as the reference does."""
    rng = np.random.RandomState(1)
    x = rng.randn(2, 3, 17, 32).astype(np.float32)
    pos = np.stack([np.arange(17), np.arange(100, 117)])
    got = tcommon.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                             theta)
    want = jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=2e-5)
    np.testing.assert_allclose(tcommon.rope_freqs(32, theta).numpy(),
                               np.asarray(jcommon.rope_freqs(32, theta)),
                               rtol=1e-6)


@pytest.mark.parametrize("Lq,Lk,causal,window,chunk", [
    (40, 40, True, None, 16),
    (24, 56, True, None, 16),
    (40, 40, True, 9, 8),
    (1, 33, True, None, 1024),
    (30, 30, False, None, 7),
])
def test_attention_matches(Lq, Lk, causal, window, chunk):
    """The port's attention on the CPU (the ``flash_attention`` wrapper's
    plain form, the one CPU attention since the chunked copy went) against
    the reference's chunked attention at small chunks (its k-range
    skipping and running softmax exercised)."""
    rng = np.random.RandomState(Lq + Lk)
    q = rng.randn(2, 4, Lq, 32).astype(np.float32)
    k = rng.randn(2, 2, Lk, 32).astype(np.float32)
    v = rng.randn(2, 2, Lk, 32).astype(np.float32)
    got = tcommon.attention(*map(torch.from_numpy, (q, k, v)), causal=causal,
                            window=window)
    want = jcommon.attention(*map(jnp.asarray, (q, k, v)), causal=causal,
                             window=window, q_chunk=chunk, k_chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=2e-6)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_mlp_matches(act):
    """``gelu`` is the tanh approximation, jax.nn.gelu's default."""
    rng = np.random.RandomState(3)
    p = {k: rng.randn(*s).astype(np.float32) * 0.2 for k, s in
         (("up", (32, 48)), ("down", (48, 32)), ("gate", (32, 48)))}
    if act != "silu":
        del p["gate"]
    x = rng.randn(3, 32).astype(np.float32)
    got = tcommon.mlp_apply({k: torch.from_numpy(v) for k, v in p.items()},
                            torch.from_numpy(x), act)
    want = jcommon.mlp_apply({k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(x), act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BLOCK)


# ----------------------------------------------------------------- the SSD

@pytest.mark.parametrize("L,chunk", [(12, 64), (64, 16), (100, 32)])
def test_ssd_scan_forms_match_reference(L, chunk):
    """Both forms of the port's ``ssd_scan`` — the chunk scan the CPU runs
    and the padded ``ssd`` the card runs (here on its plain version) —
    against the reference's chunk scan, its ``ssd`` on the same padding,
    and the recurrence."""
    rng = np.random.RandomState(L)
    B, H, P, G, S = 2, 4, 16, 2, 32
    x = rng.randn(B, L, H, P).astype(np.float32) * 0.5
    dt = 0.01 + rng.rand(B, L, H).astype(np.float32)
    A = -(0.1 + rng.rand(H).astype(np.float32))
    Bm = rng.randn(B, L, G, S).astype(np.float32) * 0.3
    Cm = rng.randn(B, L, G, S).astype(np.float32) * 0.3
    ins_t = list(map(torch.from_numpy, (x, dt, A, Bm, Cm)))
    ins_j = list(map(jnp.asarray, (x, dt, A, Bm, Cm)))
    scan = tmamba2.ssd_scan_chunks(*ins_t, chunk=chunk)
    kern = tmamba2.ssd_scan_kernel(*ins_t, chunk=chunk)
    assert all(torch.equal(a, b) for a, b in
               zip(tmamba2.ssd_scan(*ins_t, chunk=chunk), scan))
    j_scan = jmamba2.ssd_scan(*ins_j, chunk=chunk)
    ref = j_ssd_ref(*ins_j)
    Q = min(chunk, L)
    pad = (-L) % Q
    padded = [jnp.pad(a, [(0, 0), (0, pad)] + [(0, 0)] * (a.ndim - 2))
              if a.ndim > 1 else a for a in ins_j]
    jy, jh = j_ssd(*padded, chunk=Q)
    for got, want in ((scan, j_scan), (kern, (jy[:, :L], jh)),
                      (scan, ref), (kern, ref)):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4,
                                       atol=2e-4)


# ------------------------------------------------------------------ models

@pytest.mark.parametrize("name", PORTED)
def test_forward_matches_reference(name):
    cfg, tcfg, jp, tp = _smoke(name)
    tokens = _tokens(cfg, 2, 32, 0)
    want, _ = jregistry.forward(cfg, jp, {"tokens": jnp.asarray(tokens)},
                                remat=False)
    got, aux = registry.forward(tcfg, tp, {"tokens": torch.from_numpy(
        tokens)})
    assert got.shape == (2, 32, cfg.vocab) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL)
    if cfg.family == "dense":
        assert float(aux["moe_aux"]) == 0.0


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", PORTED)
def test_decode_steps_match_reference(name, cache_dtype):
    """Six decode steps from an empty cache against the reference's, in
    the float32 cache the reference pins use and in the transformer's
    default bf16 cache (Mamba-2's state is float32 either way)."""
    cfg, tcfg, jp, tp = _smoke(name)
    if cfg.family == "ssm" and cache_dtype == "bfloat16":
        pytest.skip("Mamba-2's cache is float32 by default")
    B, L = 2, 6
    tokens = _tokens(cfg, B, L, 4)
    jstep = jax.jit(functools.partial(jregistry.decode_step, cfg))
    jcache = jregistry.init_cache(cfg, B, 8, dtype=getattr(jnp, cache_dtype))
    tcache = registry.init_cache(tcfg, B, 8, dtype=getattr(torch, cache_dtype),
                                 device="cpu")
    for t in range(L):
        want, jcache = jstep(jp, jcache, jnp.asarray(tokens[:, t:t + 1]))
        got, tcache = registry.decode_step(tcfg, tp, tcache,
                                           torch.from_numpy(
                                               tokens[:, t:t + 1]))
        assert tcache["idx"] == t + 1
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL)
    for key in tcache:
        if key != "idx":
            np.testing.assert_allclose(tcache[key].float().numpy(),
                                       np.asarray(jcache[key], np.float32),
                                       **MODEL)


@pytest.mark.parametrize("name", ["smollm-135m", "tinyllama-1.1b",
                                  "qwen2-7b", "granite-3-8b"])
def test_decode_matches_prefill_dense(name):
    """Token-by-token decode reproduces the prefill logits (the
    reference's pin, tests/test_models.py:83, on the port alone)."""
    cfg = tconfigs.ARCHS[name].smoke()
    params = registry.init_params(cfg, 0, device="cpu")
    tokens = torch.from_numpy(_tokens(cfg, 2, 8, 1))
    full, _ = registry.forward(cfg, params, {"tokens": tokens})
    cache = registry.init_cache(cfg, 2, 8, dtype=torch.float32, device="cpu")
    outs = []
    for t in range(8):
        lg, cache = registry.decode_step(cfg, params, cache,
                                         tokens[:, t:t + 1])
        outs.append(lg)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(),
                               rtol=1e-3, atol=2e-3)


def test_decode_matches_prefill_mamba():
    cfg = tconfigs.ARCHS["mamba2-1.3b"].smoke()
    params = registry.init_params(cfg, 0, device="cpu")
    tokens = torch.from_numpy(_tokens(cfg, 2, 12, 2))
    full, _ = registry.forward(cfg, params, {"tokens": tokens})
    cache = registry.init_cache(cfg, 2, 12, device="cpu")
    outs = []
    for t in range(12):
        lg, cache = registry.decode_step(cfg, params, cache,
                                         tokens[:, t:t + 1])
        outs.append(lg)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(),
                               rtol=5e-3, atol=5e-3)


def test_decode_ignores_future_cache_slots():
    """A decode step attends to slots ≤ idx only: garbage in the later
    slots of the preallocated cache changes nothing."""
    cfg = tconfigs.ARCHS["tinyllama-1.1b"].smoke()
    params = registry.init_params(cfg, 1, device="cpu")
    tokens = torch.from_numpy(_tokens(cfg, 2, 3, 5))
    outs = []
    for junk in (0.0, 1e4):
        cache = registry.init_cache(cfg, 2, 16, dtype=torch.float32,
                                    device="cpu")
        cache["k"][:, :, :, 3:] = junk
        cache["v"][:, :, :, 3:] = junk
        for t in range(3):
            lg, cache = registry.decode_step(cfg, params, cache,
                                             tokens[:, t:t + 1])
        outs.append(lg)
    assert torch.equal(outs[0], outs[1])


def test_decode_past_the_cache_raises():
    cfg = tconfigs.ARCHS["smollm-135m"].smoke()
    params = registry.init_params(cfg, 0, device="cpu")
    cache = registry.init_cache(cfg, 1, 2, device="cpu")
    cache["idx"] = 2
    with pytest.raises(ValueError, match="holds 2 positions"):
        registry.decode_step(cfg, params, cache, torch.zeros((1, 1),
                                                             dtype=torch.long))


# -------------------------------------------------- parameters and registry

@pytest.mark.parametrize("name", PORTED)
def test_params_from_numpy_carries_the_tree(name):
    """Every leaf arrives under its reference name and layout, equal."""
    cfg, tcfg, jp, tp = _smoke(name)
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(flat_j) == len(jax.tree.leaves(tp, is_leaf=torch.is_tensor))
    for path, leaf in flat_j:
        node = tp
        for k in path:
            node = node[k.key]
        assert node.dtype == torch.float32
        assert np.array_equal(node.numpy(), np.asarray(leaf)), path


def test_params_from_numpy_rejects_a_wrong_tree():
    cfg, tcfg, jp, _ = _smoke("tinyllama-1.1b")
    tree = jax.tree.map(np.asarray, jp)
    bad = dict(tree, ln_f=np.ones((7,), np.float32))
    with pytest.raises(ValueError, match="/ln_f has shape"):
        params_from_numpy(tcfg, bad, device="cpu")
    bad = {k: v for k, v in tree.items() if k != "lm_head"}
    with pytest.raises(ValueError, match="has keys"):
        params_from_numpy(tcfg, bad, device="cpu")


@pytest.mark.parametrize("name", PORTED)
def test_init_params_follows_reference_distributions(name):
    """The port's own init has the reference's tree, shapes and, leaf by
    leaf, its distribution: constants equal, random leaves with the same
    mean and standard deviation (the numbers themselves differ)."""
    cfg, tcfg, jp, _ = _smoke(name)
    ours = registry.init_params(tcfg, 0, device="cpu")
    again = registry.init_params(tcfg, 0, device="cpu")
    other = registry.init_params(tcfg, 1, device="cpu")
    flat_o = dict(jax.tree_util.tree_flatten_with_path(ours)[0])
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        want = np.asarray(leaf)
        got = flat_o[path].numpy()
        assert got.shape == want.shape, path
        if want.std() == 0:
            assert np.array_equal(got, want), path
        elif path[-1].key == "A_log":
            np.testing.assert_allclose(got, want, rtol=1e-6)
        else:
            assert abs(got.std() / want.std() - 1) < 0.1, path
            assert abs(got.mean()) < 3 * want.std() / np.sqrt(want.size) \
                + 1e-7, path
    assert all(torch.equal(a, b) for a, b in zip(
        jax.tree.leaves(ours, is_leaf=torch.is_tensor),
        jax.tree.leaves(again, is_leaf=torch.is_tensor)))
    assert not torch.equal(ours["embed"], other["embed"])


@pytest.mark.parametrize("name", LATER)
def test_unported_families_raise(name):
    """The families once unported here now run: each config gives finite
    logits of the right shape through ``registry`` (the MoE family with
    a load-balance loss).  Each is held to the reference in its own file
    (tests/test_torch_moe.py, test_torch_vlm.py, test_torch_rglru.py,
    test_torch_whisper.py); their dense-only pins (decode against prefill
    with plain inputs) do not fit them, which is why these names stay out
    of ``PORTED``.  An unknown family still raises."""
    cfg = tconfigs.ARCHS[name].smoke()
    params = registry.init_params(cfg, 0, device="cpu")
    batch = {"tokens": torch.zeros((1, 2), dtype=torch.long)}
    L = 2
    if cfg.family == "vlm":
        batch["patches"] = torch.ones((1, 4, cfg.d_model))
        L += 4
    if cfg.family == "audio":
        batch["frames"] = torch.ones((1, cfg.encoder_frames, cfg.d_model))
    logits, aux = registry.forward(cfg, params, batch)
    assert logits.shape == (1, L, cfg.vocab)
    assert bool(logits.isfinite().all())
    if cfg.family == "moe":
        assert float(aux["moe_aux"]) > 0
    with pytest.raises(NotImplementedError, match="no model in the port"):
        registry.init_params(dataclasses.replace(cfg, family="diffusion"), 0,
                             device="cpu")


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default is valid here")
    cfg = tconfigs.ARCHS["smollm-135m"].smoke()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        registry.init_params(cfg, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        registry.init_cache(cfg, 1, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_numpy(cfg, {})


def test_cpu_forward_launches_no_kernel():
    cfg, tcfg, _, tp = _smoke("tinyllama-1.1b")
    LAUNCHES.clear()
    registry.forward(tcfg, tp, {"tokens": torch.zeros((1, 4),
                                                      dtype=torch.long)})
    assert not LAUNCHES


# ------------------------------------------------------------- on the card

def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU form)")


@pytest.mark.gpu
@pytest.mark.parametrize("name", PORTED)
def test_cuda_serving_matches_cpu(name):
    """forward and three decode steps on the card (K7 per attention
    layer, K8 per mixer layer of forward) against the CPU run."""
    _needs_card()
    _, tcfg, _, tp = _smoke(name)
    gp = tcommon.tree_map(lambda a: a.cuda(), tp)
    tokens = torch.from_numpy(_tokens(tcfg, 2, 32, 6))
    LAUNCHES.clear()
    got, _ = registry.forward(tcfg, gp, {"tokens": tokens.cuda()})
    torch.cuda.synchronize()
    kernel = "ssd_chunk" if tcfg.family == "ssm" else "flash_attention"
    assert LAUNCHES == {kernel: tcfg.n_layers}
    want, _ = registry.forward(tcfg, tp, {"tokens": tokens})
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), **MODEL)
    gc = registry.init_cache(tcfg, 2, 4, dtype=torch.float32, device="cuda")
    cc = registry.init_cache(tcfg, 2, 4, dtype=torch.float32, device="cpu")
    for t in range(3):
        g, gc = registry.decode_step(tcfg, gp, gc, tokens[:, t:t + 1].cuda())
        c, cc = registry.decode_step(tcfg, tp, cc, tokens[:, t:t + 1])
        np.testing.assert_allclose(g.cpu().numpy(), c.numpy(), **MODEL)
