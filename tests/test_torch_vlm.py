"""The VLM backbone of the port (qwen2-vl-2b: M-RoPE, the stub frontend's
``patch_proj``) against the JAX reference on the CPU, with the reference's
weights carried by ``params_from_numpy``.

Tolerances (float32): the M-RoPE block rtol 1e-5 / atol 1e-6 (one or two
roundings in another order); the smoke model's logits rtol 2e-4 / atol
2e-5, as ``tests/test_torch_models.py`` holds the dense models (three
layers of float32 matmuls summed in XLA's order against torch's), in
``forward`` and in decode with the float32 and the default bf16 cache.
Equal M-RoPE streams give plain RoPE bit for bit, and decode (plain RoPE
at the step's position, as the reference's) matches ``forward`` on text
at the reference pin's rtol 1e-3 / atol 2e-3."""
import dataclasses
import functools

import numpy as np
import pytest

from _reference_cache import no_persistent_compile_cache  # noqa: F401

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import params_from_numpy, registry  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

BLOCK = dict(rtol=1e-5, atol=1e-6)
MODEL = dict(rtol=2e-4, atol=2e-5)
NAME = "qwen2-vl-2b"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@functools.lru_cache(maxsize=None)
def _smoke():
    cfg = jconfigs.ARCHS[NAME].smoke()
    jp = jregistry.init_params(cfg, jax.random.PRNGKey(0))
    tcfg = tconfigs.ARCHS[NAME].smoke()
    return cfg, tcfg, jp, params_from_numpy(
        tcfg, jax.tree.map(np.asarray, jp), device="cpu")


def _streams(B, grid, n_text):
    """Patches at (0, row, column) of a grid × grid image, then text from
    grid on with equal streams: [B, 3, grid² + n_text]."""
    rows, cols = np.divmod(np.arange(grid * grid), grid)
    img = np.stack([np.zeros_like(rows), rows, cols])
    text = np.broadcast_to(grid + np.arange(n_text), (3, n_text))
    return np.broadcast_to(np.concatenate([img, text], 1),
                           (B, 3, grid * grid + n_text)).astype(np.int32)


def _batch(cfg, B, grid, n_text, seed, streams=True):
    rng = np.random.RandomState(seed)
    out = {"tokens": rng.randint(0, cfg.vocab, (B, n_text)),
           "patches": rng.randn(B, grid * grid, cfg.d_model)
           .astype(np.float32)}
    if streams:
        out["positions3"] = _streams(B, grid, n_text)
    return out


# ------------------------------------------------------------------ M-RoPE

@pytest.mark.parametrize("half,want", [(16, [4, 10]), (64, [16, 40]),
                                       (12, [3, 7]), (20, [5, 13]),
                                       (4, [1, 3])])
def test_mrope_section_bounds(half, want):
    """Sections (2, 3, 3) over the D/2 rotary channels, each bound the
    running share rounded as Python's ``round`` does (half to even: 4.5 →
    4 at half = 12, 7.5 → 8 at half = 20)."""
    assert tcommon.mrope_bounds(half) == want


@pytest.mark.parametrize("D", [8, 24, 32, 40, 128])
@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_apply_mrope_matches(D, theta):
    rng = np.random.RandomState(D)
    x = rng.randn(2, 3, 10, D).astype(np.float32)
    pos3 = rng.randint(0, 50, (2, 3, 10)).astype(np.int32)
    want = jcommon.apply_mrope(jnp.asarray(x), jnp.asarray(pos3), theta)
    got = tcommon.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3),
                              theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BLOCK)


def test_equal_streams_are_plain_rope():
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(2, 4, 9, 32).astype(np.float32))
    pos = torch.arange(9)[None].expand(2, 9) + 5
    p3 = tcommon.text_positions3(pos)
    assert p3.shape == (2, 3, 9) and torch.equal(p3[:, 2], pos)
    assert torch.equal(tcommon.apply_mrope(x, p3, 1e6),
                       tcommon.apply_rope(x, pos, 1e6))
    want = jcommon.text_positions3(jnp.asarray(pos.numpy()))
    assert np.array_equal(p3.numpy(), np.asarray(want))


# ------------------------------------------------------------------ models

def test_params_carry_patch_proj():
    cfg, tcfg, jp, tp = _smoke()
    assert np.array_equal(tp["patch_proj"].numpy(),
                          np.asarray(jp["patch_proj"]))
    ours = registry.init_params(tcfg, 0, device="cpu")
    assert ours["patch_proj"].shape == (cfg.d_model, cfg.d_model)
    assert set(ours) == set(jp)


@pytest.mark.parametrize("streams", [True, False])
@pytest.mark.parametrize("grid,n_text", [(4, 12), (2, 30)])
def test_forward_matches_reference(grid, n_text, streams):
    """Patches ahead of the tokens, rotated by their (t, h, w) streams, or
    by ``text_positions3`` when the batch has none."""
    cfg, tcfg, jp, tp = _smoke()
    b = _batch(cfg, 2, grid, n_text, grid + n_text, streams)
    want, _ = jregistry.forward(cfg, jp, {k: jnp.asarray(v)
                                          for k, v in b.items()},
                                remat=False)
    got, aux = registry.forward(tcfg, tp, {k: torch.from_numpy(v)
                                           for k, v in b.items()})
    assert got.shape == (2, grid * grid + n_text, cfg.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL)
    assert float(aux["moe_aux"]) == 0.0


def test_streams_change_the_logits():
    """The image's streams matter: the same batch with text positions
    throughout gives other logits on the image and after it."""
    cfg, tcfg, _, tp = _smoke()
    b = {k: torch.from_numpy(v) for k, v in _batch(cfg, 1, 4, 8, 0).items()}
    with3, _ = registry.forward(tcfg, tp, b)
    plain, _ = registry.forward(tcfg, tp, {k: v for k, v in b.items()
                                           if k != "positions3"})
    assert not torch.allclose(with3, plain, atol=1e-3)


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_decode_steps_match_reference(cache_dtype):
    """Six decode steps from an empty cache against the reference's
    (plain RoPE at the step's position: its ``decode_step`` passes no
    M-RoPE streams)."""
    cfg, tcfg, jp, tp = _smoke()
    B, L = 2, 6
    tokens = np.random.RandomState(4).randint(0, cfg.vocab, (B, L))
    jstep = jax.jit(functools.partial(jregistry.decode_step, cfg))
    jcache = jregistry.init_cache(cfg, B, 8, dtype=getattr(jnp, cache_dtype))
    tcache = registry.init_cache(tcfg, B, 8, dtype=getattr(torch, cache_dtype),
                                 device="cpu")
    for t in range(L):
        want, jcache = jstep(jp, jcache, jnp.asarray(tokens[:, t:t + 1]))
        got, tcache = registry.decode_step(tcfg, tp, tcache, torch.from_numpy(
            tokens[:, t:t + 1]))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL)
    for key in ("k", "v"):
        np.testing.assert_allclose(tcache[key].float().numpy(),
                                   np.asarray(jcache[key], np.float32),
                                   **MODEL)


def test_decode_matches_forward_on_text():
    """Token-by-token decode reproduces ``forward`` on a text-only batch
    (no patches: M-RoPE's equal streams are plain RoPE)."""
    tcfg = tconfigs.ARCHS[NAME].smoke()
    params = registry.init_params(tcfg, 0, device="cpu")
    tokens = torch.from_numpy(np.random.RandomState(1).randint(
        0, tcfg.vocab, (2, 8)))
    full, _ = registry.forward(tcfg, params, {
        "tokens": tokens, "patches": torch.zeros((2, 0, tcfg.d_model))})
    cache = registry.init_cache(tcfg, 2, 8, dtype=torch.float32,
                                device="cpu")
    outs = []
    for t in range(8):
        lg, cache = registry.decode_step(tcfg, params, cache,
                                         tokens[:, t:t + 1])
        outs.append(lg)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(),
                               rtol=1e-3, atol=2e-3)


def test_attn_decode_takes_mrope_streams():
    """``attn_decode``'s ``positions3_t`` (the counterpart of the
    reference's argument): equal streams at the step give the plain-RoPE
    step bit for bit; other streams another output."""
    _, tcfg, _, tp = _smoke()
    lp = tcommon.layer(tp["layers"], 0)["attn"]
    x = torch.from_numpy(np.random.RandomState(2).randn(
        2, 1, tcfg.d_model).astype(np.float32))
    outs = []
    for p3 in (None, torch.full((2, 3, 1), 3), torch.tensor([3, 1, 2])
               .view(1, 3, 1).expand(2, 3, 1)):
        k = torch.zeros((2, tcfg.n_kv, 4, tcfg.head_dim))
        outs.append(ttf.attn_decode(lp, x, tcfg, k, k.clone(), 3,
                                    positions3_t=p3)[0])
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], outs[2])


def test_forward_launches_no_kernel_on_the_cpu():
    cfg, tcfg, _, tp = _smoke()
    LAUNCHES.clear()
    b = _batch(cfg, 1, 2, 3, 0)
    registry.forward(tcfg, tp, {k: torch.from_numpy(v) for k, v in b.items()})
    assert not LAUNCHES


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default is valid here")
    tcfg = tconfigs.ARCHS[NAME].smoke()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        registry.init_params(tcfg, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        registry.init_cache(tcfg, 1, 4)


# ------------------------------------------------------------- on the card

@pytest.mark.gpu
def test_cuda_vlm_matches_cpu():
    """``forward`` with patches and streams, and three decode steps, on
    the card (one K7 launch an attention call) against the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU form)")
    cfg, tcfg, _, tp = _smoke()
    gp = tcommon.tree_map(lambda a: a.cuda(), tp)
    b = {k: torch.from_numpy(v) for k, v in _batch(cfg, 2, 4, 12, 5).items()}
    LAUNCHES.clear()
    got, _ = registry.forward(tcfg, gp, {k: v.cuda() for k, v in b.items()})
    torch.cuda.synchronize()
    assert LAUNCHES == {"flash_attention": tcfg.n_layers}
    want, _ = registry.forward(tcfg, tp, b)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), **MODEL)
    gc = registry.init_cache(tcfg, 2, 4, dtype=torch.float32, device="cuda")
    cc = registry.init_cache(tcfg, 2, 4, dtype=torch.float32, device="cpu")
    for t in range(3):
        tok = b["tokens"][:, t:t + 1]
        g, gc = registry.decode_step(tcfg, gp, gc, tok.cuda())
        c, cc = registry.decode_step(tcfg, tp, cc, tok)
        np.testing.assert_allclose(g.cpu().numpy(), c.numpy(), **MODEL)


def test_config_is_the_reference():
    j, t = jconfigs.ARCHS[NAME], tconfigs.ARCHS[NAME]
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.mrope and t.family == "vlm" and t.head_dim == 128
