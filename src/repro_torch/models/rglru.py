"""RecurrentGemma (a Griffin-style hybrid): RG-LRU recurrent blocks and
local sliding-window attention in a repeating (R, R, A) pattern — the port
of the JAX package's ``models/rglru.py``.

Each residual layer is a temporal-mixing block (RG-LRU *or* local
attention) followed by a gated MLP.  The RG-LRU recurrence
(arXiv:2402.19427):

    r_t = σ(W_a x_t + b_a)            recurrence gate
    i_t = σ(W_x x_t + b_x)            input gate
    a_t = exp(−c · softplus(Λ) · r_t) per-channel decay (c = 8)
    h_t = a_t ⊙ h_{t-1} + √(1 − a_t²) ⊙ (i_t ⊙ x_t)

Prefill runs the recurrence as the reference's ``lax.associative_scan``
does: ``associative_scan`` replays JAX's odd/even recursion op for op in
torch (O(log L) depth, a few dozen elementwise launches on the card; no
kernel of its own, as the reference has no Pallas kernel here).  Decode is
one multiply-add a token.  On the CPU each multiply-add is XLA's FMA
(float64 ``_arith.fma``), bit for bit with the reference; on the card it
is one float32 ``addcmul``, held to the CPU within the LM tolerance.  The local attention layers go through
``transformer.attn_apply`` / ``attn_decode``, so the card runs the kernel
K7 at head width 256.

Parameters are stacked per *pattern block* (one (R, R, A) triple: a tuple
of three sublayer trees, each stacked over the blocks) with the remainder
(26 = 8·3 + 2 → two more R layers) in the tuple ``rem``, as the
reference's tree.

Decode keeps the attention layers' keys in a ring of min(window, max_len)
slots and follows the reference exactly, including its fault R2: the ring
slot ``idx % window`` is both the RoPE position and the mask's bound, and
a ring shorter than the window (max_len < window) takes every write past
its end in its last slot.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .._arith import fma
from .._device import resolve_device
from ..configs.base import ModelConfig
from .common import (dense_init, generator, layer, mlp_apply, mlp_init,
                     normal, rms_norm, stack_init)
from .transformer import attn_apply, attn_decode, attn_init

Params = Dict[str, Any]

_C = 8.0


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------

def rglru_init(gen, width: int, device=None) -> Params:
    return {
        "w_a": dense_init(gen, width, width, scale=width ** -0.5,
                          device=device),
        "b_a": torch.zeros((width,), device=device),
        "w_x": dense_init(gen, width, width, scale=width ** -0.5,
                          device=device),
        "b_x": torch.zeros((width,), device=device),
        # Λ so that a ∈ (0.9, 0.999) at r = 1 (Griffin's range).
        "lam": torch.linspace(0.2, 2.0, width, device=device),
    }


def _gates(p, x):
    """(a, √(1 − a²)·(i ⊙ x)) of the recurrence, x [..., W] float32."""
    r = torch.sigmoid(x @ p["w_a"] + p["b_a"])
    i = torch.sigmoid(x @ p["w_x"] + p["b_x"])
    a = torch.exp(-_C * F.softplus(p["lam"]) * r)
    gated = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * x)
    return a, gated


def _madd(a, b, c):
    """a·b + c in float32: on the CPU rounded once, as XLA:CPU contracts it
    into an FMA; on the card one ``addcmul`` (the float64 replay took
    0.117 of recurrentgemma-2b's ``forward`` there)."""
    if a.device.type == "cpu":
        return fma(a, b, c)
    return torch.addcmul(c, a, b)


def _combine(lhs, rhs):
    """The scan's operator: (a1, b1) then (a2, b2) → (a1·a2, a2·b1 + b2)."""
    a1, b1 = lhs
    a2, b2 = rhs
    return a1 * a2, _madd(a2, b1, b2)


def _interleave(even, odd):
    """even [B, n, W] and odd [B, n or n − 1, W] → [B, len(even) +
    len(odd), W], even elements first."""
    B, ne, W = even.shape
    out = even.new_empty((B, ne + odd.shape[1], W))
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out


def associative_scan(a, b):
    """The inclusive scan of the recurrence's pairs along axis 1 — (A_t,
    B_t) = (a_t ⋯ a_1, h_t with h_0 = 0) — in the order of JAX's
    ``lax.associative_scan``: combine adjacent pairs, scan the half-length
    sequence recursively (the odd elements), then combine each odd result
    with the next even element: the reference's products and sums, one by
    one (``_madd``).  On the CPU bit for bit with the reference's compiled
    scan but where XLA:CPU flushes a subnormal product to zero and torch
    keeps it (absolute differences below 2⁻¹²⁶)."""
    L = a.shape[1]
    if L < 2:
        return a, b
    reduced = _combine((a[:, 0:-1:2], b[:, 0:-1:2]), (a[:, 1::2], b[:, 1::2]))
    odd_a, odd_b = associative_scan(*reduced)
    if L % 2 == 0:
        ev_a, ev_b = _combine((odd_a[:, :-1], odd_b[:, :-1]),
                              (a[:, 2::2], b[:, 2::2]))
    else:
        ev_a, ev_b = _combine((odd_a, odd_b), (a[:, 2::2], b[:, 2::2]))
    ev_a = torch.cat([a[:, :1], ev_a], dim=1)
    ev_b = torch.cat([b[:, :1], ev_b], dim=1)
    return _interleave(ev_a, odd_a), _interleave(ev_b, odd_b)


def rglru_apply(p, x, h0=None):
    """x [B, L, W] → (y [B, L, W], h_last [B, W] float32)."""
    a, b = _gates(p, x.float())
    A, Bv = associative_scan(a, b)
    if h0 is not None:
        Bv = _madd(A, h0[:, None], Bv)
    return Bv.to(x.dtype), Bv[:, -1]


def rglru_step(p, x_t, h):
    """x_t [B, 1, W]; h [B, W] float32 → (y [B, 1, W], h')."""
    a, b = _gates(p, x_t.float())
    h = _madd(a[:, 0], h, b[:, 0])
    return h.to(x_t.dtype)[:, None], h


# ---------------------------------------------------------------------------
# recurrent block: y = W_o[ gelu(W_y x) ⊙ conv→rglru(W_in x) ]
# ---------------------------------------------------------------------------

def rec_block_init(gen, cfg: ModelConfig, device=None) -> Params:
    w = cfg.lru_width or cfg.d_model
    return {
        "w_y": dense_init(gen, cfg.d_model, w, device=device),
        "w_in": dense_init(gen, cfg.d_model, w, device=device),
        "conv_w": normal(gen, (cfg.conv_kernel, w), 0.1, device),
        "conv_b": torch.zeros((w,), device=device),
        "lru": rglru_init(gen, w, device),
        "w_out": dense_init(gen, w, cfg.d_model, device=device),
    }


def _causal_conv(x, w, b):
    """Depthwise causal conv over time, no activation.  x [B, L, W]; w
    [K, W]."""
    K, L = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, K - 1, 0))
    return sum(pad[:, i:i + L] * w[i] for i in range(K)) + b


def _gelu(x):
    return F.gelu(x, approximate="tanh")       # jax.nn.gelu's default


def rec_block_apply(p, x):
    y = _gelu(x @ p["w_y"])
    u = _causal_conv(x @ p["w_in"], p["conv_w"], p["conv_b"])
    u, _ = rglru_apply(p["lru"], u)
    return (y * u) @ p["w_out"]


def rec_block_decode(p, x_t, conv_state, h):
    """x_t [B, 1, d]; conv_state [B, K−1, W]; h [B, W] float32 → (out
    [B, 1, d], conv_state', h')."""
    y = _gelu(x_t @ p["w_y"])
    u_t = (x_t @ p["w_in"])[:, 0]                        # [B, W]
    window = torch.cat([conv_state, u_t[:, None]], dim=1)
    conv_state = window[:, 1:]
    u = torch.einsum("bkw,kw->bw", window, p["conv_w"]) + p["conv_b"]
    u, h = rglru_step(p["lru"], u[:, None], h)
    return (y * u) @ p["w_out"], conv_state, h


# ---------------------------------------------------------------------------
# the hybrid stack
# ---------------------------------------------------------------------------

def _sub_init(gen, cfg: ModelConfig, kind: str, device=None) -> Params:
    mix = (attn_init(gen, cfg, device) if kind == "attn"
           else rec_block_init(gen, cfg, device))
    return {"ln1": torch.ones((cfg.d_model,), device=device),
            "ln2": torch.ones((cfg.d_model,), device=device),
            "mix": mix,
            "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.act, device)}


def _block_init(gen, cfg: ModelConfig, device=None) -> tuple:
    """One pattern block: a sublayer tree (mixer + MLP) per kind."""
    return tuple(_sub_init(gen, cfg, kind, device)
                 for kind in cfg.block_pattern)


def _counts(cfg: ModelConfig) -> tuple:
    """(whole pattern blocks, remainder layers)."""
    n_blocks = cfg.n_layers // len(cfg.block_pattern)
    return n_blocks, cfg.n_layers - n_blocks * len(cfg.block_pattern)


def init_params(cfg: ModelConfig, seed=0, *, device=None) -> Params:
    """Random parameters with the reference's tree, distributions and
    scales, drawn from a ``torch.Generator`` (``seed``: an int or a
    generator)."""
    device = resolve_device(device)
    gen = generator(seed, device)
    n_blocks, n_rem = _counts(cfg)
    p = {
        "embed": normal(gen, (cfg.vocab, cfg.d_model), 0.02, device),
        "blocks": stack_init(gen, n_blocks,
                             lambda g: _block_init(g, cfg, device)),
        "ln_f": torch.ones((cfg.d_model,), device=device),
    }
    if n_rem:
        p["rem"] = tuple(_sub_init(gen, cfg, kind, device)
                         for kind in cfg.block_pattern[:n_rem])
    return p


def _sublayer(cfg: ModelConfig, kind: str, sp, x, positions):
    h = rms_norm(x, sp["ln1"], cfg.norm_eps)
    if kind == "attn":
        a, _ = attn_apply(sp["mix"], h, cfg, positions, window=cfg.window)
    else:
        a = rec_block_apply(sp["mix"], h)
    x = x + a
    return x + mlp_apply(sp["mlp"], rms_norm(x, sp["ln2"], cfg.norm_eps),
                         cfg.act)


def _block_fn(cfg: ModelConfig, bp, x, positions):
    """The sublayers of one ``block_pattern`` block (or of the remainder,
    ``rem``) in order."""
    for kind, sp in zip(cfg.block_pattern, bp):
        x = _sublayer(cfg, kind, sp, x, positions)
    return x


def forward(cfg: ModelConfig, p: Params, batch, *, remat: bool = True,
            unembed: bool = True):
    """batch: tokens [B, L] → (logits [B, L, V], {}).  ``remat``: while
    grad mode is on, each ``block_pattern`` block runs under
    ``torch.utils.checkpoint`` (non-reentrant), as the reference wraps its
    block in ``jax.checkpoint``; the remainder's sublayers (``rem``) run
    outside it, as the reference's do.  Without grad mode it changes
    nothing."""
    tokens = torch.as_tensor(batch["tokens"], device=p["embed"].device)
    x = p["embed"][tokens]
    B, L = tokens.shape
    positions = torch.arange(L, device=x.device)[None].expand(B, L)
    remat = remat and torch.is_grad_enabled()
    n_blocks, _ = _counts(cfg)
    for bi in range(n_blocks):
        bp = layer(p["blocks"], bi)
        if remat:
            x = checkpoint(_block_fn, cfg, bp, x, positions,
                           use_reentrant=False)
        else:
            x = _block_fn(cfg, bp, x, positions)
    x = _block_fn(cfg, p.get("rem", ()), x, positions)
    x = rms_norm(x, p["ln_f"], cfg.norm_eps)
    return (x @ p["embed"].T if unembed else x), {}


# ---------------------------------------------------------------------------
# decode — the attention layers cache only the local window
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, *, device=None) -> Params:
    """The decode state, in the reference's tree: per pattern position i
    of the blocks, an attention ring k{i}, v{i} [n_blocks, B, n_kv,
    min(window, max_len), hd] or a recurrent block's conv{i} [n_blocks, B,
    K − 1, W] (of ``dtype``, bf16 by default) and h{i} [n_blocks, B, W]
    (float32); the remainder's conv{i}, h{i} without the block axis; the
    step count ``idx``, a host int."""
    device = resolve_device(device)
    pat = cfg.block_pattern
    n_blocks, n_rem = _counts(cfg)
    w = cfg.lru_width or cfg.d_model
    win = min(cfg.window or max_len, max_len)
    blocks = {}
    for i, kind in enumerate(pat):
        if kind == "attn":
            for name in (f"k{i}", f"v{i}"):
                blocks[name] = torch.zeros(
                    (n_blocks, batch, cfg.n_kv, win, cfg.head_dim),
                    dtype=dtype, device=device)
        else:
            blocks[f"conv{i}"] = torch.zeros(
                (n_blocks, batch, cfg.conv_kernel - 1, w), dtype=dtype,
                device=device)
            blocks[f"h{i}"] = torch.zeros((n_blocks, batch, w),
                                          device=device)
    rem = {}
    for i in range(n_rem):
        rem[f"conv{i}"] = torch.zeros((batch, cfg.conv_kernel - 1, w),
                                      dtype=dtype, device=device)
        rem[f"h{i}"] = torch.zeros((batch, w), device=device)
    return {"blocks": blocks, "rem": rem, "idx": 0}


def _rec_step(sp, hn, conv, h):
    """A recurrent block's decode step on its state, written back in
    place: the conv window in the cache's dtype, h in float32."""
    a, cs, hs = rec_block_decode(sp["mix"], hn, conv.to(hn.dtype), h)
    conv.copy_(cs)
    h.copy_(hs)
    return a


def decode_step(cfg: ModelConfig, p: Params, cache: Params, token):
    """token [B, 1] int → (logits [B, 1, V], cache').  The cache's tensors
    are updated in place and returned with ``idx`` + 1.  The attention
    layers run ``attn_decode`` at the ring slot ``idx % window`` with no
    window, as the reference does (R2 in ROADMAP §3: after the ring wraps,
    keys in slots above the slot are masked though inside the window, and
    RoPE rotates by the slot, not the absolute position; a ring of
    max_len < window slots writes past its end into its last slot)."""
    idx = int(cache["idx"])
    token = torch.as_tensor(token, device=p["embed"].device)
    x = p["embed"][token]
    ring = idx % (cfg.window or 1)
    n_blocks, _ = _counts(cfg)
    blocks = cache["blocks"]
    for bi in range(n_blocks):
        bp = layer(p["blocks"], bi)
        for i, (kind, sp) in enumerate(zip(cfg.block_pattern, bp)):
            hn = rms_norm(x, sp["ln1"], cfg.norm_eps)
            if kind == "attn":
                a, _, _ = attn_decode(sp["mix"], hn, cfg,
                                      blocks[f"k{i}"][bi],
                                      blocks[f"v{i}"][bi], ring)
            else:
                a = _rec_step(sp, hn, blocks[f"conv{i}"][bi],
                              blocks[f"h{i}"][bi])
            x = x + a
            x = x + mlp_apply(sp["mlp"], rms_norm(x, sp["ln2"],
                                                  cfg.norm_eps), cfg.act)
    for i, sp in enumerate(p.get("rem", ())):
        hn = rms_norm(x, sp["ln1"], cfg.norm_eps)
        x = x + _rec_step(sp, hn, cache["rem"][f"conv{i}"],
                          cache["rem"][f"h{i}"])
        x = x + mlp_apply(sp["mlp"], rms_norm(x, sp["ln2"], cfg.norm_eps),
                          cfg.act)
    x = rms_norm(x, p["ln_f"], cfg.norm_eps)
    return x @ p["embed"].T, {"blocks": blocks, "rem": cache["rem"],
                              "idx": idx + 1}
