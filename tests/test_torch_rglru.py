"""RecurrentGemma (the RG-LRU hybrid, recurrentgemma-2b) in the port
against the JAX reference on the CPU, with the reference's weights carried
by ``params_from_numpy`` (which walks the tuples of the hybrid's tree).

- The prefill scan replays ``lax.associative_scan``'s odd/even recursion
  with XLA's FMA: its h is bit for bit the reference's compiled scan, and
  so is the product of the decays wherever the reference's is a normal
  float32 (XLA:CPU flushes subnormal products to zero; torch keeps them).
  In the card's arithmetic (one float32 ``addcmul`` a multiply-add) it
  holds to the LM tolerance, rtol 2e-4 / atol 2e-5.
- The blocks and the smoke model (one (R, R, A) block; five layers for
  the remainder's two R layers) hold to rtol 2e-4 / atol 2e-5 (the
  gates' exp/sigmoid and the matmuls round differently), the blocks to
  rtol 1e-5 / atol 1e-6.
- Decode follows the reference's ring exactly, fault R2 included (ROADMAP
  §3): the ring slot idx % window is the RoPE position and the mask's
  bound, so past the wrap decode leaves ``forward``; a ring shorter than
  the window (max_len < window) clamps its writes to the last slot.
  Both are held against the reference step by step, with a window of 8
  so the ring wraps twice.  The bf16 cache (conv state and the ring) is
  held as ``tests/test_torch_whisper.py`` holds Whisper's: an entry
  rounded from float32 values that differ in their last bits may land
  one bf16 step away, so logits and states within 2⁻⁸ of their largest
  magnitude on top of the float32 rtol."""
import dataclasses
import functools

import numpy as np
import pytest

from _reference_cache import no_persistent_compile_cache  # noqa: F401

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro.models import rglru as jrglru  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import params_from_numpy, registry  # noqa: E402
from repro_torch.models import rglru as trglru  # noqa: E402

BLOCK = dict(rtol=1e-5, atol=1e-6)
MODEL = dict(rtol=2e-4, atol=2e-5)
BF16 = 2.0 ** -8
NAME = "recurrentgemma-2b"
TINY = 2.0 ** -126                   # the smallest normal float32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@functools.lru_cache(maxsize=None)
def _smoke(n_layers=3, window=64):
    cfg = dataclasses.replace(jconfigs.ARCHS[NAME].smoke(),
                              n_layers=n_layers, window=window)
    tcfg = dataclasses.replace(tconfigs.ARCHS[NAME].smoke(),
                               n_layers=n_layers, window=window)
    jp = jregistry.init_params(cfg, jax.random.PRNGKey(0))
    return cfg, tcfg, jp, params_from_numpy(
        tcfg, jax.tree.map(np.asarray, jp), device="cpu")


def _tokens(cfg, B, L, seed):
    return np.random.RandomState(seed).randint(0, cfg.vocab, (B, L))


# -------------------------------------------------------------- the scan

def _jax_scan(a, b):
    def combine(lhs, rhs):
        return lhs[0] * rhs[0], rhs[0] * lhs[1] + rhs[1]
    return jax.jit(lambda x, y: jax.lax.associative_scan(
        combine, (x, y), axis=1))(jnp.asarray(a), jnp.asarray(b))


@pytest.mark.parametrize("L", [1, 2, 3, 7, 64, 100, 257, 4096])
def test_scan_is_the_references_bit_for_bit(L):
    rng = np.random.RandomState(L)
    a = rng.uniform(0.5, 1.0, (2, L, 64)).astype(np.float32)
    b = rng.randn(2, L, 64).astype(np.float32)
    A, Bv = (np.asarray(t) for t in _jax_scan(a, b))
    tA, tB = trglru.associative_scan(torch.from_numpy(a), torch.from_numpy(b))
    assert np.array_equal(tB.numpy(), Bv)
    normal = np.abs(A) >= TINY
    assert np.array_equal(tA.numpy()[normal], A[normal])
    assert np.all(np.abs(tA.numpy()[~normal]) < TINY)
    if L == 4096:                    # the decays do underflow there
        assert not normal.all()


def test_scan_needs_the_fma():
    """Without XLA's contraction of a₂·b₁ + b₂ the scan drifts from the
    reference's by an ulp at most places: the FMA is what makes it
    exact."""
    rng = np.random.RandomState(0)
    a = rng.uniform(0.5, 1.0, (2, 100, 64)).astype(np.float32)
    b = rng.randn(2, 100, 64).astype(np.float32)
    _, Bv = _jax_scan(a, b)
    fma = trglru.fma
    try:
        trglru.fma = lambda x, y, z: x * y + z
        _, tB = trglru.associative_scan(torch.from_numpy(a),
                                        torch.from_numpy(b))
    finally:
        trglru.fma = fma
    assert not np.array_equal(tB.numpy(), np.asarray(Bv))


@pytest.mark.parametrize("L", [100, 4096])
def test_scan_in_the_cards_arithmetic_holds_to_the_lm_tolerance(L):
    """The card computes each multiply-add as one float32 ``addcmul``
    (``rglru._madd``); in that arithmetic the scan stays within the LM
    tolerance of the reference's compiled scan."""
    rng = np.random.RandomState(L)
    a = rng.uniform(0.5, 1.0, (2, L, 64)).astype(np.float32)
    b = rng.randn(2, L, 64).astype(np.float32)
    A, Bv = (np.asarray(t) for t in _jax_scan(a, b))
    madd = trglru._madd
    try:
        trglru._madd = lambda x, y, z: torch.addcmul(z, x, y)
        tA, tB = trglru.associative_scan(torch.from_numpy(a),
                                         torch.from_numpy(b))
    finally:
        trglru._madd = madd
    np.testing.assert_allclose(tB.numpy(), Bv, **MODEL)
    np.testing.assert_allclose(tA.numpy(), A, **MODEL)


@pytest.mark.parametrize("h0", [False, True])
@pytest.mark.parametrize("L", [1, 33, 100])
def test_rglru_apply_matches(L, h0):
    cfg, tcfg, jp, tp = _smoke()
    lp = tcommon.layer(tp["blocks"], 0)[0]["mix"]["lru"]
    jl = jax.tree.map(lambda a: a[0], jp["blocks"])[0]["mix"]["lru"]
    rng = np.random.RandomState(L)
    x = rng.randn(2, L, 128).astype(np.float32)
    h = rng.randn(2, 128).astype(np.float32) if h0 else None
    wy, wh = jrglru.rglru_apply(jl, jnp.asarray(x),
                                None if h is None else jnp.asarray(h))
    gy, gh = trglru.rglru_apply(lp, torch.from_numpy(x),
                                None if h is None else torch.from_numpy(h))
    np.testing.assert_allclose(gy.numpy(), np.asarray(wy), **BLOCK)
    np.testing.assert_allclose(gh.numpy(), np.asarray(wh), **BLOCK)


def test_blocks_match():
    """The recurrent block in prefill (causal conv, scan) and its decode
    step (conv window, one step of the recurrence) against the
    reference's."""
    cfg, tcfg, jp, tp = _smoke()
    sp = tcommon.layer(tp["blocks"], 0)[0]["mix"]
    jsp = jax.tree.map(lambda a: a[0], jp["blocks"])[0]["mix"]
    rng = np.random.RandomState(1)
    x = rng.randn(2, 20, 128).astype(np.float32)
    want = jrglru.rec_block_apply(jsp, jnp.asarray(x))
    got = trglru.rec_block_apply(sp, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BLOCK)
    conv = rng.randn(2, cfg.conv_kernel - 1, 128).astype(np.float32)
    h = rng.randn(2, 128).astype(np.float32)
    want = jrglru.rec_block_decode(jsp, jnp.asarray(x[:, :1]),
                                   jnp.asarray(conv), jnp.asarray(h))
    got = trglru.rec_block_decode(sp, torch.from_numpy(x[:, :1]),
                                  torch.from_numpy(conv), torch.from_numpy(h))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **BLOCK)


# ------------------------------------------------------------------ models

@pytest.mark.parametrize("n_layers,L", [(3, 32), (3, 100), (5, 100)])
def test_forward_matches_reference(n_layers, L):
    """One (R, R, A) block, and five layers (the remainder's two R layers);
    100 tokens let the 64-token window cut keys."""
    cfg, tcfg, jp, tp = _smoke(n_layers)
    tokens = _tokens(cfg, 2, L, L)
    want, _ = jregistry.forward(cfg, jp, {"tokens": jnp.asarray(tokens)},
                                remat=False)
    got, aux = registry.forward(tcfg, tp, {"tokens": torch.from_numpy(
        tokens)})
    assert got.shape == (2, L, cfg.vocab) and aux == {}
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL)


def _close_bf16(got, want):
    np.testing.assert_allclose(got, want, rtol=MODEL["rtol"],
                               atol=BF16 * float(np.abs(want).max()))


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_layers,max_len,steps", [
    (3, 24, 20),      # a ring of 8 slots, wrapped twice (R2)
    (5, 5, 12),       # max_len < window: a ring of 5, writes clamped
    (5, 40, 20)])
def test_decode_steps_match_reference(n_layers, max_len, steps,
                                      cache_dtype):
    cfg, tcfg, jp, tp = _smoke(n_layers, 8)
    B = 2
    tokens = _tokens(cfg, B, steps, 4)
    dt = (getattr(jnp, cache_dtype), getattr(torch, cache_dtype))
    jstep = jax.jit(functools.partial(jregistry.decode_step, cfg))
    jcache = jregistry.init_cache(cfg, B, max_len, dtype=dt[0])
    tcache = registry.init_cache(tcfg, B, max_len, dtype=dt[1],
                                 device="cpu")
    assert tcache["blocks"]["k2"].shape[3] == min(8, max_len)
    for t in range(steps):
        want, jcache = jstep(jp, jcache, jnp.asarray(tokens[:, t:t + 1]))
        got, tcache = registry.decode_step(tcfg, tp, tcache,
                                           torch.from_numpy(
                                               tokens[:, t:t + 1]))
        assert tcache["idx"] == t + 1
        if cache_dtype == "float32":
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       **MODEL)
        else:
            _close_bf16(got.numpy(), np.asarray(want))
    flat_j = dict(jax.tree_util.tree_flatten_with_path(
        {k: v for k, v in jcache.items() if k != "idx"})[0])
    flat_t = dict(jax.tree_util.tree_flatten_with_path(
        {k: v for k, v in tcache.items() if k != "idx"})[0])
    assert flat_j.keys() == flat_t.keys()
    for path, want in flat_j.items():
        got = flat_t[path]
        assert str(got.dtype).split(".")[-1] == str(want.dtype), path
        want = np.asarray(want, np.float32)
        if cache_dtype == "float32":
            np.testing.assert_allclose(got.float().numpy(), want, **MODEL)
        else:
            _close_bf16(got.float().numpy(), want)


def test_ring_decode_leaves_forward_after_the_wrap():
    """R2 made visible: decode equals ``forward`` while idx < window, and
    from the wrap on (idx = 8: slot 0, attending to its own key only,
    rotated by 0) it does not — the reference's behaviour, replayed."""
    cfg, tcfg, jp, tp = _smoke(3, 8)
    tokens = torch.from_numpy(_tokens(cfg, 2, 12, 7))
    full, _ = registry.forward(tcfg, tp, {"tokens": tokens})
    cache = registry.init_cache(tcfg, 2, 12, dtype=torch.float32,
                                device="cpu")
    outs = []
    for t in range(12):
        lg, cache = registry.decode_step(tcfg, tp, cache, tokens[:, t:t + 1])
        outs.append(lg)
    dec = torch.cat(outs, 1)
    scale = float(full.abs().max())
    np.testing.assert_allclose(dec[:, :8].numpy(), full[:, :8].numpy(),
                               rtol=1e-3, atol=2e-3)
    assert float((dec[:, 8] - full[:, 8]).abs().max()) > 1e-2 * scale


def test_clamped_ring_writes_its_last_slot():
    """A ring of 3 slots under a window of 8: steps 3.. all write slot 2
    (``dynamic_update_slice`` clamps), and every slot stays visible."""
    _, tcfg, _, tp = _smoke(3, 8)
    cache = registry.init_cache(tcfg, 1, 3, dtype=torch.float32,
                                device="cpu")
    tokens = torch.from_numpy(_tokens(tcfg, 1, 6, 8))
    seen = []
    for t in range(6):
        _, cache = registry.decode_step(tcfg, tp, cache, tokens[:, t:t + 1])
        seen.append(cache["blocks"]["k2"][0, 0, 0].clone())
    for t in range(3, 6):
        assert torch.equal(seen[t][:2], seen[2][:2])
        assert not torch.equal(seen[t][2], seen[t - 1][2])


# -------------------------------------------------- parameters and registry

def test_params_from_numpy_walks_the_tuples():
    cfg, tcfg, jp, tp = _smoke(5)
    assert isinstance(tp["blocks"], tuple) and len(tp["blocks"]) == 3
    assert isinstance(tp["rem"], tuple) and len(tp["rem"]) == 2
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(flat_j) == len(jax.tree.leaves(tp, is_leaf=torch.is_tensor))
    for path, leaf in flat_j:
        node = tp
        for k in path:
            node = node[k.key if hasattr(k, "key") else k.idx]
        assert np.array_equal(node.numpy(), np.asarray(leaf)), path


def test_params_from_numpy_names_the_leaf():
    cfg, tcfg, jp, _ = _smoke(5)
    tree = jax.tree.map(np.asarray, jp)
    with pytest.raises(ValueError, match="/rem has 1 entries"):
        params_from_numpy(tcfg, dict(tree, rem=tree["rem"][:1]),
                          device="cpu")
    blocks = (dict(tree["blocks"][0], ln1=np.ones((3, 7), np.float32)),) \
        + tuple(tree["blocks"][1:])
    with pytest.raises(ValueError, match="/blocks/0/ln1 has shape"):
        params_from_numpy(tcfg, dict(tree, blocks=blocks), device="cpu")
    with pytest.raises(ValueError, match="/blocks has"):
        params_from_numpy(tcfg, dict(tree, blocks=tree["blocks"][0]),
                          device="cpu")


def test_init_params_and_cache_follow_the_reference_trees():
    cfg, tcfg, jp, _ = _smoke(5)
    ours = registry.init_params(tcfg, 0, device="cpu")
    flat_o = dict(jax.tree_util.tree_flatten_with_path(ours)[0])
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(flat_o) == len(flat_j)
    for path, leaf in flat_j:
        assert flat_o[path].shape == leaf.shape, path
        if np.asarray(leaf).std() == 0:
            assert np.array_equal(flat_o[path].numpy(), np.asarray(leaf))
        elif path[-1].key == "lam":          # a linspace, rounded its way
            np.testing.assert_allclose(flat_o[path].numpy(),
                                       np.asarray(leaf), rtol=1e-6)
    jc = jregistry.init_cache(cfg, 2, 16)
    tc = registry.init_cache(tcfg, 2, 16, device="cpu")
    assert tc["idx"] == 0
    for (pj, a), (pt, b) in zip(
            jax.tree_util.tree_flatten_with_path({k: v for k, v in jc.items()
                                                  if k != "idx"})[0],
            jax.tree_util.tree_flatten_with_path({k: v for k, v in tc.items()
                                                  if k != "idx"})[0]):
        assert pj == pt and a.shape == b.shape
        assert str(b.dtype).split(".")[-1] == str(a.dtype)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default is valid here")
    tcfg = tconfigs.ARCHS[NAME].smoke()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        registry.init_params(tcfg, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        registry.init_cache(tcfg, 1, 4)


def test_cpu_forward_launches_no_kernel():
    _, tcfg, _, tp = _smoke()
    LAUNCHES.clear()
    registry.forward(tcfg, tp, {"tokens": torch.zeros((1, 4),
                                                      dtype=torch.long)})
    assert not LAUNCHES


def test_config_is_the_reference():
    j, t = jconfigs.ARCHS[NAME], tconfigs.ARCHS[NAME]
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.head_dim == 256 and t.n_layers == 26 and t.window == 2048


@pytest.mark.gpu
def test_cuda_hybrid_matches_cpu():
    """``forward`` (one K7 launch, at head width 32 here) and decode
    steps past the ring's wrap on the card against the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU form)")
    _, tcfg, _, tp = _smoke(5, 8)
    gp = tcommon.tree_map(lambda a: a.cuda(), tp)
    tokens = torch.from_numpy(_tokens(tcfg, 2, 40, 6))
    LAUNCHES.clear()
    got, _ = registry.forward(tcfg, gp, {"tokens": tokens.cuda()})
    torch.cuda.synchronize()
    assert LAUNCHES == {"flash_attention": 1}
    want, _ = registry.forward(tcfg, tp, {"tokens": tokens})
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), **MODEL)
    gc = registry.init_cache(tcfg, 2, 16, dtype=torch.float32, device="cuda")
    cc = registry.init_cache(tcfg, 2, 16, dtype=torch.float32, device="cpu")
    for t in range(12):
        g, gc = registry.decode_step(tcfg, gp, gc, tokens[:, t:t + 1].cuda())
        c, cc = registry.decode_step(tcfg, tp, cc, tokens[:, t:t + 1])
        np.testing.assert_allclose(g.cpu().numpy(), c.numpy(), **MODEL)
