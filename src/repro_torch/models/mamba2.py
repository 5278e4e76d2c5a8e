"""Mamba-2 (SSD — state-space duality), attention-free LM — the port of the
JAX package's ``models/mamba2.py``.

The mixer follows arXiv:2405.21060: fused in-projection → short causal
depthwise conv → SSD recurrence → skip (D), gate (z·silu), RMSNorm →
out-projection.  ``ssd_scan`` dispatches on the device: on the card it
pads to whole chunks and calls ``kernels.ssd_chunk.ssd``, which launches
the SSD chunk kernel K8 once per layer; on the CPU it is the reference's
own jnp chunk scan.  The two round differently (the chunk scan's decay is
``exp(Σ delta)``, ``ssd``'s is ``exp_s[-1]``); both are held against the
recurrence ``ssd_ref`` in the tests.  Decoding uses the one-token update
``ssd_decode_step`` and launches no kernel, as in the reference.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .._device import resolve_device
from ..configs.base import ModelConfig
from ..kernels.ssd_chunk import ssd, ssd_decode_step
from .common import (dense_init, generator, layer, normal, rms_norm,
                     stack_init)

Params = Dict[str, Any]

#: The one-token SSD update: the same function as the reference's
#: ``mamba2.ssd_step`` and ``ssd_chunk.ops.ssd_decode_step``.
ssd_step = ssd_decode_step


# ---------------------------------------------------------------------------
# chunked SSD
# ---------------------------------------------------------------------------

def _pad_to_chunks(x, dt, Bm, Cm, chunk: int):
    """Zero-pad the time axis to a whole number of chunks of ``Q =
    min(chunk, L)`` steps.  Exact: a padded step has dt = 0 (decay 1) and
    x = 0, so it changes no state and its outputs are dropped."""
    L = x.shape[1]
    Q = min(chunk, L)
    pad = (-L) % Q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
    return x, dt, Bm, Cm, Q


def ssd_scan_kernel(x, dt, A, Bm, Cm, h0=None, *, chunk: int = 64):
    """``ssd_scan`` as the card runs it: padded to chunks, then ``ssd``
    (K8 for the intra-chunk block; its plain version on the CPU)."""
    L = x.shape[1]
    x, dt, Bm, Cm, Q = _pad_to_chunks(x, dt, Bm, Cm, chunk)
    y, h = ssd(x, dt, A, Bm, Cm, h0, chunk=Q)
    return y[:, :L], h


def ssd_scan_chunks(x, dt, A, Bm, Cm, h0=None, *, chunk: int = 64):
    """The reference's jnp chunk scan: one [B,H,Q,Q] decay-masked product
    per chunk, an [B,H,S,P] state carried."""
    B, L, H, P = x.shape
    G, S = Bm.shape[2], Bm.shape[3]
    hpg = H // G
    x, dt, Bm, Cm, Q = _pad_to_chunks(x, dt, Bm, Cm, chunk)
    NC = x.shape[1] // Q
    tri = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    zero = torch.zeros((), device=x.device)
    h = (torch.zeros((B, H, S, P), device=x.device) if h0 is None else h0)
    ys = []
    for c in range(NC):
        sl = slice(c * Q, (c + 1) * Q)
        xq, dtq, Bq, Cq = x[:, sl], dt[:, sl], Bm[:, sl], Cm[:, sl]
        delta = dtq * A[None, None, :]                  # [B,Q,H] (negative)
        s = torch.cumsum(delta, dim=1)                  # inclusive
        # intra-chunk: G_mat[b,h,t,u] = (C_t·B_u)·exp(s_t−s_u)·dt_u, u ≤ t
        CB = torch.einsum("btgs,bugs->bgtu", Cq, Bq)    # [B,G,Q,Q]
        CBh = CB.repeat_interleave(hpg, dim=1)          # [B,H,Q,Q]
        diff = torch.clamp(s[:, :, None] - s[:, None], max=0.0)  # [B,Q,Q,H]
        M = torch.where(tri[None, :, :, None], torch.exp(diff), zero)
        Gm = CBh * M.permute(0, 3, 1, 2) * dtq.transpose(1, 2)[:, :, None]
        y = torch.einsum("bhtu,buhp->bthp", Gm, xq)
        # h_in correction + chunk state update
        es = torch.exp(s)                               # [B,Q,H]
        Ch = Cq.repeat_interleave(hpg, dim=2)           # [B,Q,H,S]
        y = y + torch.einsum("bths,bhsp->bthp", Ch, h) * es[..., None]
        w = torch.exp(s[:, -1:, :] - s) * dtq           # [B,Q,H]
        Bh = Bq.repeat_interleave(hpg, dim=2)           # [B,Q,H,S]
        decay = torch.exp(delta.sum(dim=1))             # [B,H]
        h = decay[:, :, None, None] * h + torch.einsum(
            "buhs,buh,buhp->bhsp", Bh, w, xq)
        ys.append(y)
    return torch.cat(ys, dim=1)[:, :L], h


def ssd_scan(x, dt, A, Bm, Cm, h0=None, *, chunk: int = 64):
    """x [B,L,H,P]; dt [B,L,H] (>0); A [H] (<0); Bm/Cm [B,L,G,S].
    Returns (y [B,L,H,P], h_final [B,H,S,P]).  K8 on the card, the chunk
    scan on the CPU."""
    if x.device.type == "cuda":
        return ssd_scan_kernel(x, dt, A, Bm, Cm, h0, chunk=chunk)
    return ssd_scan_chunks(x, dt, A, Bm, Cm, h0, chunk=chunk)


# ---------------------------------------------------------------------------
# the mixer layer
# ---------------------------------------------------------------------------

def _dims(cfg: ModelConfig):
    d_in = cfg.ssm_expand * cfg.d_model
    H = d_in // cfg.ssm_headdim
    conv_dim = d_in + 2 * cfg.ssm_groups * cfg.ssm_state
    return d_in, H, conv_dim


def mixer_init(gen, cfg: ModelConfig, device=None) -> Params:
    d = cfg.d_model
    d_in, H, conv_dim = _dims(cfg)
    return {
        "in_proj": dense_init(gen, d, 2 * d_in + 2 * cfg.ssm_groups
                              * cfg.ssm_state + H, device=device),
        "conv_w": normal(gen, (cfg.conv_kernel, conv_dim), 0.1, device),
        "conv_b": torch.zeros((conv_dim,), device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, device=device)),
        "D": torch.ones((H,), device=device),
        "dt_bias": torch.zeros((H,), device=device) - 1.0,
        "norm": torch.ones((d_in,), device=device),
        "out_proj": dense_init(gen, d_in, d, device=device),
    }


def _split_proj(cfg, zxbcdt):
    d_in, H, _ = _dims(cfg)
    gs = cfg.ssm_groups * cfg.ssm_state
    z = zxbcdt[..., :d_in]
    xBC = zxbcdt[..., d_in:d_in + d_in + 2 * gs]
    dt = zxbcdt[..., -H:]
    return z, xBC, dt


def _causal_conv(xBC, w, b):
    """Depthwise causal conv over time. xBC [B,L,C]; w [K,C]."""
    K, L = w.shape[0], xBC.shape[1]
    pad = F.pad(xBC, (0, 0, K - 1, 0))
    out = sum(pad[:, i:i + L] * w[i] for i in range(K))
    return F.silu(out + b)


def mixer_apply(p, x, cfg: ModelConfig, *, chunk: int = 64):
    """Full-sequence mixer. x [B,L,d] → [B,L,d]."""
    B, L, _ = x.shape
    d_in, H, _ = _dims(cfg)
    G, S, P = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_headdim
    z, xBC, dt = _split_proj(cfg, x @ p["in_proj"])
    xBC = _causal_conv(xBC, p["conv_w"], p["conv_b"])
    xs = xBC[..., :d_in].reshape(B, L, H, P)
    Bm = xBC[..., d_in:d_in + G * S].reshape(B, L, G, S)
    Cm = xBC[..., d_in + G * S:].reshape(B, L, G, S)
    dt = F.softplus(dt + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y, _ = ssd_scan(xs.float(), dt.float(), A, Bm.float(), Cm.float(),
                    chunk=chunk)
    y = y.to(x.dtype) + p["D"][None, None, :, None] * xs
    y = y.reshape(B, L, d_in) * F.silu(z)
    y = rms_norm(y, p["norm"], cfg.norm_eps)
    return y @ p["out_proj"]


def mixer_decode(p, x_t, cfg: ModelConfig, conv_state, ssm_state):
    """One-token mixer. x_t [B,1,d]; conv_state [B,K−1,conv_dim];
    ssm_state [B,H,S,P].  Returns (out [B,1,d], conv_state', ssm_state')."""
    B = x_t.shape[0]
    d_in, H, conv_dim = _dims(cfg)
    G, S, P = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_headdim
    z, xBC, dt = _split_proj(cfg, x_t @ p["in_proj"])
    xBC = xBC[:, 0]                                     # [B, conv_dim]
    window = torch.cat([conv_state, xBC[:, None]], dim=1)   # [B,K,C]
    conv_state = window[:, 1:]
    out = torch.einsum("bkc,kc->bc", window, p["conv_w"]) + p["conv_b"]
    xBC = F.silu(out)
    xs = xBC[..., :d_in].reshape(B, H, P)
    Bm = xBC[..., d_in:d_in + G * S].reshape(B, G, S)
    Cm = xBC[..., d_in + G * S:].reshape(B, G, S)
    dtv = F.softplus(dt[:, 0] + p["dt_bias"])           # [B, H]
    A = -torch.exp(p["A_log"])
    y, ssm_state = ssd_step(xs.float(), dtv.float(), A, Bm.float(),
                            Cm.float(), ssm_state)
    y = y.to(x_t.dtype) + p["D"][None, :, None] * xs
    y = y.reshape(B, 1, d_in) * F.silu(z)
    y = rms_norm(y, p["norm"], cfg.norm_eps)
    return y @ p["out_proj"], conv_state, ssm_state


# ---------------------------------------------------------------------------
# the LM
# ---------------------------------------------------------------------------

def layer_init(gen, cfg: ModelConfig, device=None) -> Params:
    return {"ln": torch.ones((cfg.d_model,), device=device),
            "mixer": mixer_init(gen, cfg, device)}


def init_params(cfg: ModelConfig, seed=0, *, device=None) -> Params:
    """Random parameters with the reference's distributions and scales,
    drawn from a ``torch.Generator`` (``seed``: an int or a generator)."""
    device = resolve_device(device)
    gen = generator(seed, device)
    return {
        "embed": normal(gen, (cfg.vocab, cfg.d_model), 0.02, device),
        "layers": stack_init(gen, cfg.n_layers,
                             lambda g: layer_init(g, cfg, device)),
        "ln_f": torch.ones((cfg.d_model,), device=device),
    }


def _layer_fn(cfg: ModelConfig, lp, h):
    return h + mixer_apply(lp["mixer"], rms_norm(h, lp["ln"], cfg.norm_eps),
                           cfg)


def forward(cfg: ModelConfig, p: Params, batch, *, remat: bool = True,
            unembed: bool = True):
    """Prefill / training forward → (logits [B, L, V], {}).  ``remat``:
    while grad mode is on, each layer runs under ``torch.utils.checkpoint``
    (non-reentrant), as the reference wraps its layer in
    ``jax.checkpoint``: the backward recomputes the layer (K8 launched
    again on the card) instead of keeping its activations; without grad
    mode it changes nothing."""
    tokens = torch.as_tensor(batch["tokens"], device=p["embed"].device)
    x = p["embed"][tokens]
    remat = remat and torch.is_grad_enabled()
    for i in range(cfg.n_layers):
        lp = layer(p["layers"], i)
        if remat:
            x = checkpoint(_layer_fn, cfg, lp, x, use_reentrant=False)
        else:
            x = _layer_fn(cfg, lp, x)
    x = rms_norm(x, p["ln_f"], cfg.norm_eps)
    return (x @ p["embed"].T if unembed else x), {}


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.float32, *, device=None) -> Params:
    """The recurrent state: conv [n_layers, B, K−1, conv_dim], ssm
    [n_layers, B, H, S, P] and the step count ``idx`` (a host int)."""
    device = resolve_device(device)
    d_in, H, conv_dim = _dims(cfg)
    return {
        "conv": torch.zeros((cfg.n_layers, batch, cfg.conv_kernel - 1,
                             conv_dim), dtype=dtype, device=device),
        "ssm": torch.zeros((cfg.n_layers, batch, H, cfg.ssm_state,
                            cfg.ssm_headdim), dtype=dtype, device=device),
        "idx": 0,
    }


def decode_step(cfg: ModelConfig, p: Params, cache: Params, token):
    """token [B, 1] int → (logits [B, 1, V], cache').  The cache's tensors
    are updated in place and returned with ``idx`` + 1."""
    token = torch.as_tensor(token, device=p["embed"].device)
    x = p["embed"][token]
    for i in range(cfg.n_layers):
        lp = layer(p["layers"], i)
        y, cs, ss = mixer_decode(lp["mixer"],
                                 rms_norm(x, lp["ln"], cfg.norm_eps), cfg,
                                 cache["conv"][i].float(),
                                 cache["ssm"][i].float())
        x = x + y
        cache["conv"][i] = cs
        cache["ssm"][i] = ss
    x = rms_norm(x, p["ln_f"], cfg.norm_eps)
    return x @ p["embed"].T, {"conv": cache["conv"], "ssm": cache["ssm"],
                              "idx": int(cache["idx"]) + 1}
