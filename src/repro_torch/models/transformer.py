"""Decoder-only transformer — the port of the JAX package's
``models/transformer.py`` for the dense GQA models (qwen2-7b, granite-3-8b,
smollm-135m, tinyllama-1.1b; ``qkv_bias`` included), the MoE models
(dbrx-132b, qwen3-moe-235b-a22b) and the VLM backbone (qwen2-vl-2b: the
vision frontend is a stub, pre-computed patch embeddings through
``patch_proj`` ahead of the tokens, and M-RoPE on q and k).

Every attention layer of ``forward`` and of ``decode_step`` goes through
``common.attention`` / ``flash_attention``: the kernel K7 on the card.

The MoE layer routes each token group (GShard-style capacity, top-k with
token dropping) with one of two routers: ``topk`` (the published configs'
softmax top-k with renormalised gates) or ``dodoor`` (the paper's
power-of-two choice applied to experts: pairs drawn from the top 2k gate
probabilities, the member with the lower *cached* expert load wins; the
load refreshes once per group, the b-batched model with b = the group
size).  Dispatch scatters the kept (token, choice) pairs into their
``[E, cap]`` slots by index and runs the experts as batched products
(``torch.bmm``).  The reference's one-hot dispatch and combine einsums
compute the same sums, but at qwen3-moe's width they add nearly as many
flops as the experts' own products, all of them copies.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .._device import resolve_device
from ..configs.base import ModelConfig
from ..kernels.flash_attention import flash_attention
from . import precision
from .common import (apply_mrope, apply_rope, attention, dense_init,
                     generator, layer, mlp_apply, mlp_init, normal, rms_norm,
                     stack_init, text_positions3)

Params = Dict[str, Any]


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


def _rope(cfg: ModelConfig, t, positions, positions3):
    """RoPE at ``positions`` [B, L], or M-RoPE on the three streams
    ``positions3`` [B, 3, L] when the model has it and they are given."""
    if cfg.mrope and positions3 is not None:
        return apply_mrope(t, positions3, cfg.rope_theta)
    return apply_rope(t, positions, cfg.rope_theta)


def attn_apply(p, x, cfg: ModelConfig, positions, *, causal=True,
               window=None, positions3=None):
    """Full-sequence (train/prefill) attention sublayer.  Returns (out
    [B, L, d], (k, v))."""
    B, L, _ = x.shape
    q, k, v = _qkv(p, x, cfg)
    q = _rope(cfg, q, positions, positions3)
    k = _rope(cfg, k, positions, positions3)
    o = attention(q, k, v, causal=causal, window=window)
    return o.transpose(1, 2).reshape(B, L, -1) @ p["wo"], (k, v)


def attn_decode(p, x_t, cfg: ModelConfig, k_cache, v_cache, idx: int, *,
                window=None, positions3_t=None):
    """One-token decode: x_t [B, 1, d]; caches [B, n_kv, L, hd] of any
    dtype, written IN PLACE at slot min(idx, L − 1) (``idx`` a host int:
    the RoPE position and the mask's bound; the reference's
    ``dynamic_update_slice`` clamps a write past the end to the last
    slot, which the hybrid's short ring cache reaches).  Attends over
    slots ≤ idx and inside the window, as the reference does: the cache
    is read in the activations' dtype, with this step's own key and value
    unrounded.  ``positions3_t`` [B, 3, 1]: M-RoPE streams for the step
    (the reference's decode passes none).  Returns (out [B, 1, d],
    k_cache, v_cache)."""
    B = x_t.shape[0]
    q, k_t, v_t = _qkv(p, x_t, cfg)
    pos = torch.full((B, 1), idx, dtype=torch.int64, device=x_t.device)
    q = _rope(cfg, q, pos, positions3_t)
    k_t = _rope(cfg, k_t, pos, positions3_t)
    slot = min(idx, k_cache.shape[2] - 1)
    k_cache[:, :, slot] = k_t[:, :, 0]
    v_cache[:, :, slot] = v_t[:, :, 0]
    # Only the slots written so far are keys: the future slots of the
    # preallocated cache must not enter the softmax.  The kernel reads the
    # prefix where it lies, in q's dtype, and takes the step's slot from
    # k_t and v_t, unrounded when the cache has another dtype.
    o = flash_attention(q, k_cache[:, :, :slot + 1],
                        v_cache[:, :, :slot + 1], causal=True, window=window,
                        kv_last=(k_t, v_t))
    o = o.transpose(1, 2).reshape(B, 1, cfg.n_heads * cfg.head_dim)
    return o @ p["wo"], k_cache, v_cache


# ---------------------------------------------------------------------------
# MoE sublayer
# ---------------------------------------------------------------------------

def moe_init(gen, cfg: ModelConfig, device=None) -> Params:
    d, ff, E = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    return {
        "router": dense_init(gen, d, E, scale=0.02, device=device),
        "w_gate": normal(gen, (E, d, ff), d ** -0.5, device),
        "w_up": normal(gen, (E, d, ff), d ** -0.5, device),
        "w_down": normal(gen, (E, ff, d), ff ** -0.5, device),
    }


def _capacity(g: int, cfg: ModelConfig) -> int:
    return max(1, int(g * cfg.top_k * cfg.capacity_factor) // cfg.n_experts)


def _top(probs, n: int):
    """The ``n`` largest probabilities of each row and their experts, ties
    to the lower expert as ``jax.lax.top_k`` breaks them (``torch.topk``
    promises no tie order; a padded row's softmax ties every expert)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :n], idx[:, :n]


def _renorm(vals):
    return vals / torch.clamp(vals.sum(-1, keepdim=True), min=1e-9)


def _route_topk(probs, k: int):
    vals, idx = _top(probs, k)
    return idx, _renorm(vals)


def _route_dodoor(probs, load, k: int):
    """Power-of-two expert choice on a cached load view: the top 2k gate
    probabilities paired (2i, 2i+1); the member with the lower cached load
    wins, a tie keeps A (the higher probability)."""
    _, cand = _top(probs, 2 * k)                          # [g, 2k]
    ca, cb = cand[:, 0::2], cand[:, 1::2]                 # [g, k] each
    idx = torch.where(load[cb] < load[ca], cb, ca)
    return idx, _renorm(probs.gather(1, idx))


def moe_route(p, x, cfg: ModelConfig, load):
    """The router of one token group x [g, d] on the cached expert load
    [E] → (probs [g, E], idx [g, k] chosen experts, vals [g, k] gates)."""
    probs = torch.softmax((x @ p["router"]).float(), dim=-1)
    if cfg.router == "dodoor":
        idx, vals = _route_dodoor(probs, load, cfg.top_k)
    else:
        idx, vals = _route_topk(probs, cfg.top_k)
    return probs, idx, vals


def moe_queue(idx, E: int):
    """Each (token, choice)'s position in its expert's queue, token-major
    and choice-minor (an exclusive cumsum over the flattened one-hot), and
    the choices per expert → (pos [g, k], counts [E] float32)."""
    flat = idx.reshape(-1)
    onehot = F.one_hot(flat, E)                           # [g·k, E]
    ahead = onehot.cumsum(0)
    pos = (ahead - onehot).gather(1, flat[:, None]).view(idx.shape)
    return pos, ahead[-1].float()


def moe_group_apply(p, x, cfg: ModelConfig, load):
    """One token group. x [g, d]; load [E] cached expert loads (dodoor).
    Returns (y [g, d], aux scalar, new_load [E]).  The gates are
    renormalised before the capacity drop, so a dropped choice's share is
    lost; ``aux`` and ``new_load`` count every choice, dropped and padded
    ones included, as the reference does."""
    E, k = cfg.n_experts, cfg.top_k
    g, d = x.shape
    cap = _capacity(g, cfg)
    probs, idx, vals = moe_route(p, x, cfg, load)
    pos, counts = moe_queue(idx, E)
    keep = pos < cap
    # Slot e·cap + pos of each kept choice; a dropped one goes to the spare
    # slot E·cap, which is cut off.  A kept slot has one writer, so the
    # scatter is deterministic on the card.
    slot = torch.where(keep, idx * cap + pos, E * cap)
    src = torch.full((E * cap + 1,), g, dtype=torch.long, device=x.device)
    src.scatter_(0, slot.reshape(-1),
                 torch.arange(g, device=x.device).repeat_interleave(k))
    xe = F.pad(x, (0, 0, 0, 1))[src[:-1]].view(E, cap, d)  # row g: zeros
    h = F.silu(torch.bmm(xe, p["w_gate"])) * torch.bmm(xe, p["w_up"])
    ye = torch.bmm(h, p["w_down"]).view(E * cap, d)
    slot = torch.where(keep, slot, 0)
    # The reference's combine einsum in x's dtype: each gate rounded to it,
    # the k products summed in float32 in choice order, the sum rounded
    # once (under bf16 the float32 gates would otherwise promote the
    # residual stream to float32; in float32 every cast is the identity).
    gate = (vals * keep).to(x.dtype).float()
    y = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for j in range(k):                                    # choice order
        y = y + ye[slot[:, j]].float() * gate[:, j, None]
    # Aux load-balance loss (Switch): E · Σ_e f_e · P_e.
    aux = E * torch.sum(counts / g * probs.mean(0))
    return y.to(x.dtype), aux, counts


def moe_apply(p, x, cfg: ModelConfig, group: int = 2048):
    """x [B, L, d] → (y, aux).  Token groups of ``min(group, B·L)`` rows
    (the tail zero-padded) run in order; the dodoor router's load cache
    starts at zero and refreshes once per group (b-batched)."""
    B, L, d = x.shape
    T = B * L
    g = min(group, T)
    xt = F.pad(x.reshape(T, d), (0, 0, 0, (-T) % g))
    load = torch.zeros((cfg.n_experts,), device=x.device)
    ys, auxs = [], []
    for xg in xt.split(g):
        y, aux, load = moe_group_apply(p, xg, cfg, load)
        ys.append(y)
        auxs.append(aux)
    return torch.cat(ys)[:T].reshape(B, L, d), torch.stack(auxs).mean()


def _ffn(lp, h, cfg: ModelConfig):
    """The feed-forward sublayer on the normed residual → (out, moe aux;
    0 for a dense layer)."""
    x = rms_norm(h, lp["ln2"], cfg.norm_eps)
    if cfg.is_moe:
        return moe_apply(lp["moe"], x, cfg)
    return mlp_apply(lp["mlp"], x, cfg.act), 0.0


# ---------------------------------------------------------------------------
# the decoder stack
# ---------------------------------------------------------------------------

def layer_init(gen, cfg: ModelConfig, device=None) -> Params:
    p = {
        "ln1": torch.ones((cfg.d_model,), device=device),
        "ln2": torch.ones((cfg.d_model,), device=device),
        "attn": attn_init(gen, cfg, device),
    }
    if cfg.is_moe:
        p["moe"] = moe_init(gen, cfg, device)
    else:
        p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.act, device)
    return p


def init_params(cfg: ModelConfig, seed=0, *, device=None) -> Params:
    """Random parameters with the reference's distributions and scales,
    drawn from a ``torch.Generator`` (``seed``: an int or a generator).
    They are not the reference's numbers; ``models.convert`` carries
    those.  The VLM backbone adds the stub frontend's ``patch_proj``."""
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
    if cfg.family == "vlm":
        p["patch_proj"] = dense_init(gen, cfg.d_model, cfg.d_model,
                                     device=device)
    return p


def _unembed(cfg, p, x):
    if cfg.tie_embeddings:
        return x @ p["embed"].T
    return x @ p["lm_head"]


def _layer_fn(cfg: ModelConfig, lp, h, positions, positions3):
    """One decoder layer on the residual stream h → (h', moe aux of the
    layer; 0 for a dense one), with the reference's three residual
    constraints (``precision.constrain``)."""
    h = precision.constrain(h)
    a, _ = attn_apply(lp["attn"], rms_norm(h, lp["ln1"], cfg.norm_eps), cfg,
                      positions, window=cfg.window, positions3=positions3)
    h = precision.constrain(h + a)
    f, aux_i = _ffn(lp, h, cfg)
    return precision.constrain(h + f), aux_i


def forward(cfg: ModelConfig, p: Params, batch, *, remat: bool = True,
            unembed: bool = True):
    """Training/prefill forward → (logits [B, L, V], aux dict).  batch:
    tokens [B, L] int; for the VLM backbone also patches [B, n_patches, d]
    (projected by ``patch_proj`` and put ahead of the tokens) and
    optionally positions3 [B, 3, n_patches + L] (the M-RoPE streams;
    ``text_positions3`` of the plain positions without them).
    ``aux["moe_aux"]`` is the MoE layers' mean load-balance loss (0 for a
    dense model).  Under ``precision.options(dtype=...)`` the parameters
    and the residual stream are cast to that dtype at use, as the
    reference casts them.  ``remat``: while grad mode is on, each layer
    runs under ``torch.utils.checkpoint`` (non-reentrant), as the
    reference wraps its layer in ``jax.checkpoint``: the backward pass
    recomputes the layer's activations from its input instead of keeping
    them; without grad mode it changes nothing."""
    p = precision.cast_params(p)
    dev = p["embed"].device
    tokens = torch.as_tensor(batch["tokens"], device=dev)
    x = precision.cast_act(p["embed"][tokens])
    positions3 = None
    if cfg.family == "vlm":
        patches = torch.as_tensor(batch["patches"], device=dev).float() \
            @ p["patch_proj"].float()
        x = torch.cat([patches.to(x.dtype), x], dim=1)
        if batch.get("positions3") is not None:
            positions3 = torch.as_tensor(batch["positions3"], device=dev)
    B, L = x.shape[:2]
    positions = torch.arange(L, device=x.device)[None].expand(B, L)
    if cfg.mrope and positions3 is None:
        positions3 = text_positions3(positions)
    aux = torch.zeros((), device=x.device)
    remat = remat and torch.is_grad_enabled()
    for i in range(cfg.n_layers):
        lp = layer(p["layers"], i)
        if remat:
            x, aux_i = checkpoint(_layer_fn, cfg, lp, x, positions,
                                  positions3, use_reentrant=False)
        else:
            x, aux_i = _layer_fn(cfg, lp, x, positions, positions3)
        aux = aux + aux_i
    x = rms_norm(x, p["ln_f"], cfg.norm_eps)
    out = _unembed(cfg, p, x) if unembed else x
    return out, {"moe_aux": aux / max(cfg.n_layers, 1)}


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
    are updated in place and returned with ``idx`` + 1.  An MoE layer
    routes the step's B tokens as one group from a zero load, as the
    reference does; the VLM backbone decodes with plain RoPE at ``idx``,
    as the reference's ``decode_step`` passes no M-RoPE streams."""
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
        x = x + _ffn(lp, x, cfg)[0]
    x = rms_norm(x, p["ln_f"], cfg.norm_eps)
    return _unembed(cfg, p, x), {"k": cache["k"], "v": cache["v"],
                                 "idx": idx + 1}
