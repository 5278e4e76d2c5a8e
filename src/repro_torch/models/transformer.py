"""Decoder-only transformer, dense GQA path — the port of the JAX package's
``models/transformer.py`` for qwen2-7b, granite-3-8b, smollm-135m and
tinyllama-1.1b (``qkv_bias`` included).  The MoE layer with its routers
and the VLM backbone (M-RoPE) are not ported yet (ROADMAP §1 item 10).

Every attention layer of ``forward`` and of ``decode_step`` goes through
``common.attention`` / ``flash_attention``: the kernel K7 on the card.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from .._device import resolve_device
from ..configs.base import ModelConfig
from ..kernels.flash_attention import flash_attention
from .common import (apply_rope, attention, dense_init, generator, layer,
                     mlp_apply, mlp_init, normal, rms_norm, stack_init)

Params = Dict[str, Any]


def _dense_only(cfg: ModelConfig) -> None:
    if cfg.is_moe or cfg.mrope:
        raise NotImplementedError(
            f"{cfg.name}: the MoE layer and M-RoPE are not ported yet "
            "(ROADMAP §1 item 10)")


# ---------------------------------------------------------------------------
# attention sublayer
# ---------------------------------------------------------------------------

def attn_init(gen, cfg: ModelConfig, device=None) -> Params:
    d, hd = cfg.d_model, cfg.head_dim
    p = {
        "wq": dense_init(gen, d, cfg.n_heads * hd, device=device),
        "wk": dense_init(gen, d, cfg.n_kv * hd, device=device),
        "wv": dense_init(gen, d, cfg.n_kv * hd, device=device),
        "wo": dense_init(gen, cfg.n_heads * hd, d, device=device),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", cfg.n_heads), ("bk", cfg.n_kv),
                            ("bv", cfg.n_kv)):
            p[name] = torch.zeros((width * hd,), device=device)
    return p


def _qkv(p, x, cfg: ModelConfig):
    B, L, _ = x.shape
    hd = cfg.head_dim
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, L, cfg.n_heads, hd).transpose(1, 2)
    k = k.reshape(B, L, cfg.n_kv, hd).transpose(1, 2)
    v = v.reshape(B, L, cfg.n_kv, hd).transpose(1, 2)
    return q, k, v


def attn_apply(p, x, cfg: ModelConfig, positions, *, causal=True,
               window=None):
    """Full-sequence (train/prefill) attention sublayer.  Returns (out
    [B, L, d], (k, v))."""
    B, L, _ = x.shape
    q, k, v = _qkv(p, x, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    o = attention(q, k, v, causal=causal, window=window)
    return o.transpose(1, 2).reshape(B, L, -1) @ p["wo"], (k, v)


def attn_decode(p, x_t, cfg: ModelConfig, k_cache, v_cache, idx: int, *,
                window=None):
    """One-token decode: x_t [B, 1, d]; caches [B, n_kv, L, hd] of any
    dtype, written IN PLACE at slot ``idx`` (a host int).  Attends over
    slots ≤ idx and inside the window, as the reference does: the cache
    is read in the activations' dtype, with this step's own key and value
    unrounded.  Returns (out [B, 1, d], k_cache, v_cache)."""
    B = x_t.shape[0]
    q, k_t, v_t = _qkv(p, x_t, cfg)
    pos = torch.full((B, 1), idx, dtype=torch.int64, device=x_t.device)
    q = apply_rope(q, pos, cfg.rope_theta)
    k_t = apply_rope(k_t, pos, cfg.rope_theta)
    k_cache[:, :, idx] = k_t[:, :, 0]
    v_cache[:, :, idx] = v_t[:, :, 0]
    # Only the slots written so far are keys: the future slots of the
    # preallocated cache must not enter the softmax.  The kernel reads the
    # prefix where it lies, in q's dtype, and takes slot idx from k_t and
    # v_t, unrounded when the cache has another dtype.
    o = flash_attention(q, k_cache[:, :, :idx + 1], v_cache[:, :, :idx + 1],
                        causal=True, window=window, kv_last=(k_t, v_t))
    o = o.transpose(1, 2).reshape(B, 1, cfg.n_heads * cfg.head_dim)
    return o @ p["wo"], k_cache, v_cache


# ---------------------------------------------------------------------------
# the decoder stack
# ---------------------------------------------------------------------------

def layer_init(gen, cfg: ModelConfig, device=None) -> Params:
    return {
        "ln1": torch.ones((cfg.d_model,), device=device),
        "ln2": torch.ones((cfg.d_model,), device=device),
        "attn": attn_init(gen, cfg, device),
        "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.act, device),
    }


def init_params(cfg: ModelConfig, seed=0, *, device=None) -> Params:
    """Random parameters with the reference's distributions and scales,
    drawn from a ``torch.Generator`` (``seed``: an int or a generator).
    They are not the reference's numbers; ``models.convert`` carries
    those."""
    _dense_only(cfg)
    device = resolve_device(device)
    gen = generator(seed, device)
    p = {
        "embed": normal(gen, (cfg.vocab, cfg.d_model), 0.02, device),
        "layers": stack_init(gen, cfg.n_layers,
                             lambda g: layer_init(g, cfg, device)),
        "ln_f": torch.ones((cfg.d_model,), device=device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab, scale=0.02,
                                  device=device)
    return p


def _unembed(cfg, p, x):
    if cfg.tie_embeddings:
        return x @ p["embed"].T
    return x @ p["lm_head"]


def forward(cfg: ModelConfig, p: Params, batch, *, remat: bool = True,
            unembed: bool = True):
    """Prefill forward → (logits [B, L, V], aux dict).  batch: tokens
    [B, L] int.  ``remat`` (rematerialisation for training) has no effect
    in the port's inference path."""
    _dense_only(cfg)
    tokens = torch.as_tensor(batch["tokens"], device=p["embed"].device)
    x = p["embed"][tokens]
    B, L = tokens.shape
    positions = torch.arange(L, device=x.device)[None].expand(B, L)
    for i in range(cfg.n_layers):
        lp = layer(p["layers"], i)
        a, _ = attn_apply(lp["attn"], rms_norm(x, lp["ln1"], cfg.norm_eps),
                          cfg, positions, window=cfg.window)
        x = x + a
        x = x + mlp_apply(lp["mlp"], rms_norm(x, lp["ln2"], cfg.norm_eps),
                          cfg.act)
    x = rms_norm(x, p["ln_f"], cfg.norm_eps)
    out = _unembed(cfg, p, x) if unembed else x
    return out, {"moe_aux": torch.zeros((), device=x.device)}


# ---------------------------------------------------------------------------
# decode (serving)
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, *, device=None) -> Params:
    """The KV cache: k, v [n_layers, B, n_kv, max_len, hd] (bf16 by
    default, as the reference) and the write position ``idx``, a host
    int."""
    device = resolve_device(device)
    shape = (cfg.n_layers, batch, cfg.n_kv, max_len, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device), "idx": 0}


def decode_step(cfg: ModelConfig, p: Params, cache: Params, token):
    """token [B, 1] int → (logits [B, 1, V], cache').  The cache's tensors
    are updated in place and returned with ``idx`` + 1."""
    _dense_only(cfg)
    idx = int(cache["idx"])
    if not 0 <= idx < cache["k"].shape[3]:
        raise ValueError(f"decode_step: the cache holds "
                         f"{cache['k'].shape[3]} positions; idx={idx}")
    token = torch.as_tensor(token, device=p["embed"].device)
    x = p["embed"][token]
    for i in range(cfg.n_layers):
        lp = layer(p["layers"], i)
        a, _, _ = attn_decode(lp["attn"],
                              rms_norm(x, lp["ln1"], cfg.norm_eps), cfg,
                              cache["k"][i], cache["v"][i], idx,
                              window=cfg.window)
        x = x + a
        x = x + mlp_apply(lp["mlp"], rms_norm(x, lp["ln2"], cfg.norm_eps),
                          cfg.act)
    x = rms_norm(x, p["ln_f"], cfg.norm_eps)
    return _unembed(cfg, p, x), {"k": cache["k"], "v": cache["v"],
                                 "idx": idx + 1}
