"""Whisper-base: an encoder-decoder with a stubbed conv frontend — the port
of the JAX package's ``models/whisper.py``.

The modality frontend is a stub: the caller supplies the frame embeddings
[B, frames, d_model] that the two conv layers would produce.  The
backbone is real: a bidirectional encoder and a causal decoder with
cross-attention, learned positional embeddings, pre-norm (``rms_norm``,
as the reference) and GELU MLPs (arXiv:2212.04356).

Every attention goes through ``common.attention`` / ``flash_attention``,
so the card runs the kernel K7 for the encoder's non-causal
self-attention, the decoder's causal self-attention and its non-causal
cross-attention (Lq ≠ Lk).  Decode caches the decoder's self-attention
keys and values (growing with the generated tokens) and the
cross-attention keys and values, computed once a request from the encoder
output (``prime_cache``).  A decode step writes its own key and value
into the cache ROUNDED to the cache's dtype and attends over the cache as
written, as the reference does — unlike the transformer's
``attn_decode``, which keeps the step's own row unrounded.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from .._device import resolve_device
from ..configs.base import ModelConfig
from ..kernels.flash_attention import flash_attention
from .common import (attention, dense_init, generator, layer, mlp_apply,
                     mlp_init, normal, rms_norm, stack_init)

Params = Dict[str, Any]

#: Rows of the decoder's learned position table: the reference sizes it to
#: its 32k shape grid (the published whisper-base has 448).
POS_DEC = 40960


def _mha_init(gen, cfg: ModelConfig, device=None) -> Params:
    d = cfg.d_model
    return {name: dense_init(gen, d, d, device=device)
            for name in ("wq", "wk", "wv", "wo")}


def _heads(cfg: ModelConfig, x):
    """[B, L, H·hd] → [B, H, L, hd]."""
    B, L, _ = x.shape
    return x.reshape(B, L, cfg.n_heads, cfg.head_dim).transpose(1, 2)


def _merge(o):
    """[B, H, L, hd] → [B, L, H·hd]."""
    B, _, L, _ = o.shape
    return o.transpose(1, 2).reshape(B, L, -1)


def _mha(p, cfg: ModelConfig, x, kv, *, causal: bool):
    """x attends to kv (self-attention when kv is x)."""
    q = _heads(cfg, x @ p["wq"])
    k = _heads(cfg, kv @ p["wk"])
    v = _heads(cfg, kv @ p["wv"])
    o = attention(q, k, v, causal=causal)
    return _merge(o) @ p["wo"]


def _enc_layer_init(gen, cfg: ModelConfig, device=None) -> Params:
    return {"ln1": torch.ones((cfg.d_model,), device=device),
            "ln2": torch.ones((cfg.d_model,), device=device),
            "attn": _mha_init(gen, cfg, device),
            "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, "gelu", device)}


def _dec_layer_init(gen, cfg: ModelConfig, device=None) -> Params:
    return {"ln1": torch.ones((cfg.d_model,), device=device),
            "ln2": torch.ones((cfg.d_model,), device=device),
            "ln3": torch.ones((cfg.d_model,), device=device),
            "self": _mha_init(gen, cfg, device),
            "cross": _mha_init(gen, cfg, device),
            "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, "gelu", device)}


def init_params(cfg: ModelConfig, seed=0, *, device=None) -> Params:
    """Random parameters with the reference's tree, distributions and
    scales, drawn from a ``torch.Generator`` (``seed``: an int or a
    generator)."""
    device = resolve_device(device)
    gen = generator(seed, device)
    d = cfg.d_model
    return {
        "embed": normal(gen, (cfg.vocab, d), 0.02, device),
        "pos_dec": normal(gen, (POS_DEC, d), 0.01, device),
        "pos_enc": normal(gen, (cfg.encoder_frames, d), 0.01, device),
        "enc_layers": stack_init(gen, cfg.encoder_layers,
                                 lambda g: _enc_layer_init(g, cfg, device)),
        "dec_layers": stack_init(gen, cfg.n_layers,
                                 lambda g: _dec_layer_init(g, cfg, device)),
        "ln_enc": torch.ones((d,), device=device),
        "ln_f": torch.ones((d,), device=device),
    }


def encode(cfg: ModelConfig, p: Params, frames):
    """frames [B, F, d] (the stub conv output) → encoder states [B, F, d]."""
    frames = torch.as_tensor(frames, device=p["embed"].device)
    x = frames + p["pos_enc"][None, :frames.shape[1]]
    for i in range(cfg.encoder_layers):
        lp = layer(p["enc_layers"], i)
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        x = x + _mha(lp["attn"], cfg, h, h, causal=False)
        x = x + mlp_apply(lp["mlp"], rms_norm(x, lp["ln2"], cfg.norm_eps),
                          "gelu")
    return rms_norm(x, p["ln_enc"], cfg.norm_eps)


def _dec_layer_fn(cfg: ModelConfig, lp, x, enc):
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    x = x + _mha(lp["self"], cfg, h, h, causal=True)
    x = x + _mha(lp["cross"], cfg, rms_norm(x, lp["ln2"], cfg.norm_eps),
                 enc, causal=False)
    return x + mlp_apply(lp["mlp"], rms_norm(x, lp["ln3"], cfg.norm_eps),
                         "gelu")


def forward(cfg: ModelConfig, p: Params, batch, *, remat: bool = True,
            unembed: bool = True):
    """batch: frames [B, F, d] and tokens [B, L] → (logits [B, L, V], {}).
    ``remat``: while grad mode is on, each decoder layer runs under
    ``torch.utils.checkpoint`` (non-reentrant), as the reference wraps its
    decoder layer in ``jax.checkpoint``; the encoder is not checkpointed,
    as the reference's is not.  Without grad mode it changes nothing."""
    enc = encode(cfg, p, batch["frames"])
    tokens = torch.as_tensor(batch["tokens"], device=p["embed"].device)
    L = tokens.shape[1]
    x = p["embed"][tokens] + p["pos_dec"][None, :L]
    remat = remat and torch.is_grad_enabled()
    for i in range(cfg.n_layers):
        lp = layer(p["dec_layers"], i)
        if remat:
            x = checkpoint(_dec_layer_fn, cfg, lp, x, enc,
                           use_reentrant=False)
        else:
            x = _dec_layer_fn(cfg, lp, x, enc)
    x = rms_norm(x, p["ln_f"], cfg.norm_eps)
    return (x @ p["embed"].T if unembed else x), {}


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, *, device=None) -> Params:
    """The decode cache: self-attention k, v [n_layers, B, H, max_len, hd],
    cross-attention xk, xv [n_layers, B, H, frames, hd] (bf16 by default,
    as the reference; ``prime_cache`` fills them) and the write position
    ``idx``, a host int."""
    device = resolve_device(device)
    self_shape = (cfg.n_layers, batch, cfg.n_heads, max_len, cfg.head_dim)
    cross_shape = (cfg.n_layers, batch, cfg.n_heads, cfg.encoder_frames,
                   cfg.head_dim)
    return {"k": torch.zeros(self_shape, dtype=dtype, device=device),
            "v": torch.zeros(self_shape, dtype=dtype, device=device),
            "xk": torch.zeros(cross_shape, dtype=dtype, device=device),
            "xv": torch.zeros(cross_shape, dtype=dtype, device=device),
            "idx": 0}


def prime_cache(cfg: ModelConfig, p: Params, cache: Params, frames) -> Params:
    """Fill the cross-attention keys and values from the encoder (once a
    request), rounded to the cache's dtype.  Returns a new cache dict
    holding new xk, xv tensors (the self-attention tensors are shared)."""
    enc = encode(cfg, p, frames)
    xk, xv = [], []
    for i in range(cfg.n_layers):
        cp = layer(p["dec_layers"], i)["cross"]
        xk.append(_heads(cfg, enc @ cp["wk"]))
        xv.append(_heads(cfg, enc @ cp["wv"]))
    return {**cache, "xk": torch.stack(xk).to(cache["xk"].dtype),
            "xv": torch.stack(xv).to(cache["xv"].dtype)}


def decode_step(cfg: ModelConfig, p: Params, cache: Params, token):
    """token [B, 1] int → (logits [B, 1, V], cache').  The self-attention
    cache is written IN PLACE at slot ``idx``, the step's key and value
    rounded to the cache's dtype, and read back whole (slots ≤ idx) in
    the activations' dtype; cross-attention reads the primed xk, xv.
    Returns the cache with ``idx`` + 1."""
    idx = int(cache["idx"])
    if not 0 <= idx < cache["k"].shape[3]:
        raise ValueError(f"decode_step: the cache holds "
                         f"{cache['k'].shape[3]} positions; idx={idx}")
    token = torch.as_tensor(token, device=p["embed"].device)
    x = p["embed"][token] + p["pos_dec"][idx][None, None]
    for i in range(cfg.n_layers):
        lp = layer(p["dec_layers"], i)
        kc, vc = cache["k"][i], cache["v"][i]
        hn = rms_norm(x, lp["ln1"], cfg.norm_eps)
        q = _heads(cfg, hn @ lp["self"]["wq"])
        kc[:, :, idx] = _heads(cfg, hn @ lp["self"]["wk"])[:, :, 0]
        vc[:, :, idx] = _heads(cfg, hn @ lp["self"]["wv"])[:, :, 0]
        o = flash_attention(q, kc[:, :, :idx + 1], vc[:, :, :idx + 1],
                            causal=True)
        x = x + _merge(o) @ lp["self"]["wo"]
        q = _heads(cfg, rms_norm(x, lp["ln2"], cfg.norm_eps)
                   @ lp["cross"]["wq"])
        o = flash_attention(q, cache["xk"][i], cache["xv"][i], causal=False)
        x = x + _merge(o) @ lp["cross"]["wo"]
        x = x + mlp_apply(lp["mlp"], rms_norm(x, lp["ln3"], cfg.norm_eps),
                          "gelu")
    x = rms_norm(x, p["ln_f"], cfg.norm_eps)
    return x @ p["embed"].T, {**cache, "idx": idx + 1}
