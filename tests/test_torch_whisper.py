"""Whisper (whisper-base) in the port against the JAX reference on the CPU:
``encode``, ``forward``, ``prime_cache`` and ``decode_step`` of the smoke
model with the reference's weights carried by ``params_from_numpy``.

Tolerances.  Float32 logits rtol 2e-4 / atol 2e-5, as the dense models in
``tests/test_torch_models.py`` (the same matmuls summed in XLA's order
against torch's).  With the default bf16 caches the two sides round the
cross-attention keys and values, and every decode step's own key and
value, to bf16 from float32 values that differ in their last bits, so an
entry may round to the neighbouring bf16 value (one bf16 step, at most
2⁻⁷ of it, apart); the primed caches are held within the float32 bound
plus one bf16 step (``BF16_STEP``), and what is computed from them —
the logits and the later steps' cached keys and values — within 2⁻⁸ of
the largest magnitude (``BF16_LOGITS``) on top of the float32 rtol.
Decode
against ``forward`` on the port alone: the reference pin's rtol 1e-3 /
atol 2e-3."""
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
from repro.models import whisper as jwhisper  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import params_from_numpy, registry  # noqa: E402
from repro_torch.models import whisper as twhisper  # noqa: E402

MODEL = dict(rtol=2e-4, atol=2e-5)
#: A bf16 cache entry may round one step away: 2⁻⁸ of the largest |logit|.
BF16_LOGITS = 2.0 ** -8
#: ... and the entry itself the float32 bound plus one bf16 step (at most
#: 2⁻⁷ of its magnitude).
BF16_STEP = dict(rtol=2.0 ** -7 + MODEL["rtol"], atol=MODEL["atol"])
NAME = "whisper-base"


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


def _inputs(cfg, B, L, seed, frames=None):
    rng = np.random.RandomState(seed)
    F = cfg.encoder_frames if frames is None else frames
    return (rng.randn(B, F, cfg.d_model).astype(np.float32),
            rng.randint(0, cfg.vocab, (B, L)))


def test_params_follow_the_reference_tree():
    cfg, tcfg, jp, tp = _smoke()
    ours = registry.init_params(tcfg, 0, device="cpu")
    flat_o = dict(jax.tree_util.tree_flatten_with_path(ours)[0])
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        assert flat_o[path].shape == leaf.shape, path
    assert ours["pos_dec"].shape == (40960, cfg.d_model)
    assert abs(float(ours["pos_dec"].std()) - 0.01) < 1e-3
    assert np.array_equal(tp["pos_enc"].numpy(), np.asarray(jp["pos_enc"]))


@pytest.mark.parametrize("frames", [64, 37])
def test_encode_matches_reference(frames):
    cfg, tcfg, jp, tp = _smoke()
    fr, _ = _inputs(cfg, 2, 1, 0, frames)
    want = jwhisper.encode(cfg, jp, jnp.asarray(fr))
    got = twhisper.encode(tcfg, tp, torch.from_numpy(fr))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL)


@pytest.mark.parametrize("L", [1, 12, 40])
def test_forward_matches_reference(L):
    """The causal decoder over the tokens, cross-attention with Lq ≠ Lk
    over the encoder's frames."""
    cfg, tcfg, jp, tp = _smoke()
    fr, tok = _inputs(cfg, 2, L, L)
    want, _ = jregistry.forward(cfg, jp, {"frames": jnp.asarray(fr),
                                          "tokens": jnp.asarray(tok)},
                                remat=False)
    got, aux = registry.forward(tcfg, tp, {"frames": torch.from_numpy(fr),
                                           "tokens": torch.from_numpy(tok)})
    assert got.shape == (2, L, cfg.vocab) and aux == {}
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL)


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_prime_cache_matches_reference(cache_dtype):
    cfg, tcfg, jp, tp = _smoke()
    fr, _ = _inputs(cfg, 2, 1, 5)
    jc = jwhisper.prime_cache(cfg, jp, jregistry.init_cache(
        cfg, 2, 4, dtype=getattr(jnp, cache_dtype)), jnp.asarray(fr))
    tc = registry.prime_cache(tcfg, tp, registry.init_cache(
        tcfg, 2, 4, dtype=getattr(torch, cache_dtype), device="cpu"),
        torch.from_numpy(fr))
    tol = MODEL if cache_dtype == "float32" else BF16_STEP
    for key in ("xk", "xv"):
        assert tc[key].dtype == getattr(torch, cache_dtype)
        assert tc[key].shape == (cfg.n_layers, 2, cfg.n_heads,
                                 cfg.encoder_frames, cfg.head_dim)
        np.testing.assert_allclose(tc[key].float().numpy(),
                                   np.asarray(jc[key], np.float32), **tol)


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_decode_steps_match_reference(cache_dtype):
    """Six steps from a primed cache against the reference's."""
    cfg, tcfg, jp, tp = _smoke()
    B, L = 2, 6
    fr, tok = _inputs(cfg, B, L, 4)
    jstep = jax.jit(functools.partial(jregistry.decode_step, cfg))
    jc = jwhisper.prime_cache(cfg, jp, jregistry.init_cache(
        cfg, B, 8, dtype=getattr(jnp, cache_dtype)), jnp.asarray(fr))
    tc = registry.prime_cache(tcfg, tp, registry.init_cache(
        tcfg, B, 8, dtype=getattr(torch, cache_dtype), device="cpu"),
        torch.from_numpy(fr))
    for t in range(L):
        want, jc = jstep(jp, jc, jnp.asarray(tok[:, t:t + 1]))
        got, tc = registry.decode_step(tcfg, tp, tc,
                                       torch.from_numpy(tok[:, t:t + 1]))
        assert tc["idx"] == t + 1
        want = np.asarray(want)
        if cache_dtype == "float32":
            np.testing.assert_allclose(got.numpy(), want, **MODEL)
        else:
            np.testing.assert_allclose(
                got.numpy(), want, rtol=MODEL["rtol"],
                atol=BF16_LOGITS * float(np.abs(want).max()))
    for key in ("k", "v"):
        want = np.asarray(jc[key], np.float32)
        tol = MODEL if cache_dtype == "float32" else dict(
            rtol=BF16_STEP["rtol"],
            atol=BF16_LOGITS * float(np.abs(want).max()))
        np.testing.assert_allclose(tc[key].float().numpy(), want, **tol)


def test_decode_reads_its_own_key_rounded(monkeypatch):
    """The reference writes the step's own key and value into the cache
    rounded to its dtype and attends over the cache as written: the port
    calls K7's wrapper on the cache prefix, in the cache's dtype, with no
    ``kv_last`` (unlike the transformer's ``attn_decode``), and the
    step's slot holds the rounded key."""
    cfg, tcfg, _, tp = _smoke()
    fr, tok = _inputs(cfg, 1, 3, 6)
    calls = []
    real = twhisper.flash_attention

    def spy(q, k, v, **kw):
        calls.append((k, v, kw))
        return real(q, k, v, **kw)

    monkeypatch.setattr(twhisper, "flash_attention", spy)
    cache = registry.prime_cache(tcfg, tp, registry.init_cache(
        tcfg, 1, 4, device="cpu"), torch.from_numpy(fr))
    for t in range(3):
        calls.clear()
        _, cache = registry.decode_step(tcfg, tp, cache,
                                        torch.from_numpy(tok[:, t:t + 1]))
        assert len(calls) == 2 * cfg.n_layers
        for i in range(cfg.n_layers):
            k, v, kw = calls[2 * i]                       # self-attention
            assert kw.get("kv_last") is None and kw["causal"]
            assert k.dtype == v.dtype == torch.bfloat16
            assert k.shape[2] == t + 1
            assert k.data_ptr() == cache["k"][i].data_ptr()
            xk, _, xkw = calls[2 * i + 1]                 # cross-attention
            assert not xkw["causal"] and xkw.get("kv_last") is None
            assert xk.shape[2] == cfg.encoder_frames


def test_decode_matches_forward():
    tcfg = tconfigs.ARCHS[NAME].smoke()
    params = registry.init_params(tcfg, 0, device="cpu")
    fr, tok = _inputs(tcfg, 2, 8, 1)
    fr, tok = torch.from_numpy(fr), torch.from_numpy(tok)
    full, _ = registry.forward(tcfg, params, {"frames": fr, "tokens": tok})
    cache = registry.prime_cache(tcfg, params, registry.init_cache(
        tcfg, 2, 8, dtype=torch.float32, device="cpu"), fr)
    outs = []
    for t in range(8):
        lg, cache = registry.decode_step(tcfg, params, cache, tok[:, t:t + 1])
        outs.append(lg)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(),
                               rtol=1e-3, atol=2e-3)


def test_decode_past_the_cache_raises():
    _, tcfg, _, tp = _smoke()
    cache = registry.init_cache(tcfg, 1, 2, device="cpu")
    cache["idx"] = 2
    with pytest.raises(ValueError, match="holds 2 positions"):
        registry.decode_step(tcfg, tp, cache, torch.zeros((1, 1),
                                                          dtype=torch.long))


def test_prime_cache_is_whispers():
    cfg = tconfigs.ARCHS["tinyllama-1.1b"].smoke()
    with pytest.raises(ValueError, match="audio"):
        registry.prime_cache(cfg, {}, {}, None)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default is valid here")
    tcfg = tconfigs.ARCHS[NAME].smoke()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        registry.init_params(tcfg, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        registry.init_cache(tcfg, 1, 4)


def test_cpu_forward_launches_no_kernel():
    cfg, tcfg, _, tp = _smoke()
    fr, tok = _inputs(cfg, 1, 3, 0)
    LAUNCHES.clear()
    registry.forward(tcfg, tp, {"frames": torch.from_numpy(fr),
                                "tokens": torch.from_numpy(tok)})
    assert not LAUNCHES


def test_config_is_the_reference():
    j, t = jconfigs.ARCHS[NAME], tconfigs.ARCHS[NAME]
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.family == "audio" and t.encoder_frames == 1500


@pytest.mark.gpu
def test_cuda_whisper_matches_cpu():
    """``forward`` (18 K7 launches at the smoke depth: 2 encoder, 3 + 3
    decoder calls), ``prime_cache`` and three decode steps on the card
    against the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU form)")
    cfg, tcfg, _, tp = _smoke()
    gp = tcommon.tree_map(lambda a: a.cuda(), tp)
    fr, tok = (torch.from_numpy(a) for a in _inputs(cfg, 2, 12, 5))
    LAUNCHES.clear()
    got, _ = registry.forward(tcfg, gp, {"frames": fr.cuda(),
                                         "tokens": tok.cuda()})
    torch.cuda.synchronize()
    assert LAUNCHES == {"flash_attention": cfg.encoder_layers
                        + 2 * cfg.n_layers}
    want, _ = registry.forward(tcfg, tp, {"frames": fr, "tokens": tok})
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), **MODEL)
    gc = registry.prime_cache(tcfg, gp, registry.init_cache(
        tcfg, 2, 4, dtype=torch.float32, device="cuda"), fr.cuda())
    cc = registry.prime_cache(tcfg, tp, registry.init_cache(
        tcfg, 2, 4, dtype=torch.float32, device="cpu"), fr)
    for t in range(3):
        g, gc = registry.decode_step(tcfg, gp, gc, tok[:, t:t + 1].cuda())
        c, cc = registry.decode_step(tcfg, tp, cc, tok[:, t:t + 1])
        np.testing.assert_allclose(g.cpu().numpy(), c.numpy(), **MODEL)
