"""Shared model building blocks: parameter trees, norms, RoPE, attention
and MLPs — the port of the JAX package's ``models/common.py``.

Parameters are nested dicts of tensors with the reference's names and
layouts: a dense weight is ``[d_in, d_out]`` and applied as ``x @ W``,
and the layers of a model are stacked along a leading axis (``stack_init``),
so a JAX parameter tree converts leaf for leaf (``models.convert``).

``attention`` dispatches on the device of its inputs: on the card it is
the flash-attention kernel K7 (``kernels.flash_attention``), on the CPU
the chunked running-softmax form below, which computes the same function
(the reference's ``common.attention``, whose Pallas twin is K7).
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional

import torch
import torch.nn.functional as F

from .._device import resolve_device
from ..kernels.flash_attention import flash_attention
from ..kernels.flash_attention.ops import check_causal_rows

Params = Dict[str, Any]

_NEG = -1e30


# ---------------------------------------------------------------------------
# parameter trees and init helpers
# ---------------------------------------------------------------------------

def tree_map(fn: Callable, tree):
    """Apply ``fn`` to every tensor of a tree of dicts and tuples, keeping
    the keys and the tuples' order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(tree_map(fn, v) for v in tree)
    return fn(tree)


def layer(stacked: Params, i: int) -> Params:
    """The parameters of layer ``i`` of a stacked layer tree (views)."""
    return tree_map(lambda a: a[i], stacked)


def generator(seed, device) -> torch.Generator:
    """A ``torch.Generator`` for ``device`` seeded with ``seed`` (an int), or
    ``seed`` itself when it is already a generator.  Shape-only (``meta``)
    initialisation draws from a CPU generator."""
    if isinstance(seed, torch.Generator):
        return seed
    dev = resolve_device(device)
    gen = torch.Generator(device="cpu" if dev.type == "meta" else dev)
    return gen.manual_seed(int(seed))


def normal(gen: torch.Generator, shape, scale: float, device) -> torch.Tensor:
    """N(0, 1) · ``scale`` in float32, drawn from ``gen`` on ``device``."""
    return torch.randn(shape, generator=gen, device=device) * scale


def dense_init(gen, d_in: int, d_out: int, *, scale: float | None = None,
               device=None) -> torch.Tensor:
    """A [d_in, d_out] weight ~ N(0, 1) · scale, 1/√d_in by default."""
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return normal(gen, (d_in, d_out), scale, device)


def stack_init(gen, n: int, init_fn: Callable) -> Params:
    """Stack ``n`` independently initialised trees along axis 0 (the
    reference's layout for its scan over layers)."""
    def merge(ts):
        if isinstance(ts[0], dict):
            return {k: merge([t[k] for t in ts]) for k in ts[0]}
        if isinstance(ts[0], tuple):
            return tuple(merge([t[i] for t in ts]) for i in range(len(ts[0])))
        return torch.stack(ts)

    return merge([init_fn(gen) for _ in range(n)])


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5):
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * w


# ---------------------------------------------------------------------------
# RoPE (+ M-RoPE)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def _rotate(x, cos, sin):
    """Rotate the interleaved channel pairs (x[..., 0::2], x[..., 1::2]) and
    interleave the result back — the reference's pairing, not
    ``rotate_half``'s."""
    x1, x2 = x[..., ::2], x[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


def apply_rope(x, positions, theta: float):
    """x [B, H, L, D]; positions [B, L] (absolute token positions)."""
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)      # [D/2]
    angles = positions[:, None, :, None].float() * freqs
    return _rotate(x, torch.cos(angles), torch.sin(angles))


def mrope_bounds(half: int, sections=(2, 3, 3)) -> list:
    """The channels where M-RoPE's sections start, past the first: the
    sections are relative weights over the ``half`` = D/2 rotary channels,
    each bound Python's ``round`` of its running share (half to even), as
    the reference computes them."""
    total = sum(sections)
    bounds, acc = [], 0
    for s in sections[:-1]:
        acc += round(half * s / total)
        bounds.append(acc)
    return bounds


def apply_mrope(x, positions3, theta: float, sections=(2, 3, 3)):
    """Qwen2-VL multimodal RoPE: the D/2 rotary channels split into
    (temporal, height, width) sections (``mrope_bounds``), each rotated by
    its own position stream.  x [B, H, L, D]; positions3 [B, 3, L]; equal
    streams give ``apply_rope`` exactly."""
    half = x.shape[-1] // 2
    chan = torch.arange(half, device=x.device)
    sec = torch.zeros((half,), dtype=torch.long, device=x.device)
    for b in mrope_bounds(half, sections):
        sec = sec + (chan >= b).long()                           # [half]
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)      # [half]
    pos = positions3.transpose(1, 2).float()[..., sec]           # [B,L,half]
    angles = pos[:, None] * freqs                                # [B,1,L,half]
    return _rotate(x, torch.cos(angles), torch.sin(angles))


def text_positions3(positions):
    """[B, L] → [B, 3, L]: the degenerate M-RoPE streams of pure text."""
    return positions[:, None].expand(positions.shape[0], 3,
                                     positions.shape[1])


# ---------------------------------------------------------------------------
# attention: K7 on the card, chunked running softmax on the CPU
# ---------------------------------------------------------------------------

def _attn_block(q, k, v, m, l, acc, q0: int, k0: int, *, causal: bool,
                window: Optional[int], kv_offset: int, kv_len: int,
                scale: float):
    """One (q-chunk × kv-chunk) update of the running softmax.

    q [B,H,Qc,D]; k, v [B,H,Kc,D]; (m, l) [B,H,Qc,1]; acc [B,H,Qc,D].
    ``q0``/``k0``: absolute chunk-start positions; ``kv_offset`` = Lk − Lq
    aligns query positions; keys at or past ``kv_len`` are masked.
    """
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    Qc, Kc = q.shape[2], k.shape[2]
    q_pos = q0 + kv_offset + torch.arange(Qc, device=q.device)[:, None]
    k_pos = k0 + torch.arange(Kc, device=q.device)[None, :]
    mask = (k_pos < kv_len).expand(Qc, Kc)
    if causal:
        mask = mask & (k_pos <= q_pos)
    if window is not None:
        mask = mask & (k_pos > q_pos - window)
    logits = torch.where(mask, logits, torch.full((), _NEG,
                                                  device=q.device))
    m_new = torch.maximum(m, logits.amax(dim=-1, keepdim=True))
    p = torch.exp(logits - m_new)
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=-1, keepdim=True)
    acc_new = acc * corr + torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return m_new, l_new, acc_new


def chunked_attention(q, k, v, *, causal: bool = True,
                      window: Optional[int] = None, q_chunk: int = 1024,
                      k_chunk: int = 1024):
    """The reference's chunked attention: q-chunks each scan exactly the
    key extent that causality and the window allow, in k-chunks with a
    running (max, sum, acc), so no [Lq, Lk] logits tensor is made.
    q [B,H,Lq,D]; k, v [B,Hkv,Lk,D] (queries right-aligned)."""
    B, H, Lq, D = q.shape
    Hkv, Lk = k.shape[1], k.shape[2]
    rep = H // Hkv
    scale = D ** -0.5
    kv_offset = Lk - Lq
    kf = k.repeat_interleave(rep, dim=1)
    vf = v.repeat_interleave(rep, dim=1)
    q_chunk = min(q_chunk, Lq)
    k_chunk = min(k_chunk, Lk)
    outs = []
    for q0 in range(0, Lq, q_chunk):
        qc = min(q_chunk, Lq - q0)
        q_blk = q[:, :, q0:q0 + qc]
        hi = Lk if not causal else min(Lk, q0 + qc + kv_offset)
        lo = 0 if window is None else max(0, q0 + kv_offset - window + 1)
        lo = (lo // k_chunk) * k_chunk
        n_k = max(1, -(-(hi - lo) // k_chunk))
        m = torch.full((B, H, qc, 1), _NEG, device=q.device)
        l = torch.zeros((B, H, qc, 1), device=q.device)
        acc = torch.zeros((B, H, qc, D), device=q.device)
        for ki in range(n_k):
            k0 = lo + ki * k_chunk
            m, l, acc = _attn_block(
                q_blk, kf[:, :, k0:k0 + k_chunk], vf[:, :, k0:k0 + k_chunk],
                m, l, acc, q0, k0, causal=causal, window=window,
                kv_offset=kv_offset, kv_len=Lk, scale=scale)
        outs.append((acc / torch.clamp(l, min=1e-30)).to(q.dtype))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=2)


def attention(q, k, v, *, causal: bool = True, window: Optional[int] = None,
              q_chunk: int = 1024, k_chunk: int = 1024):
    """Attention. q [B,H,Lq,D]; k, v [B,Hkv,Lk,D] (H divisible by Hkv;
    queries are right-aligned against keys).  Returns [B,H,Lq,D].  CUDA
    tensors go to the kernel K7; CPU tensors to ``chunked_attention``.
    A causal call with Lq > Lk raises ``ValueError`` on either device."""
    check_causal_rows("attention", causal, q.shape[2], k.shape[2])
    if q.device.type == "cuda":
        return flash_attention(q, k, v, causal=causal, window=window)
    return chunked_attention(q, k, v, causal=causal, window=window,
                             q_chunk=q_chunk, k_chunk=k_chunk)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def mlp_init(gen, d: int, d_ff: int, act: str, device=None) -> Params:
    p = {"up": dense_init(gen, d, d_ff, device=device),
         "down": dense_init(gen, d_ff, d, device=device)}
    if act == "silu":                          # gated (SwiGLU)
        p["gate"] = dense_init(gen, d, d_ff, device=device)
    return p


def mlp_apply(p: Params, x, act: str):
    up = x @ p["up"]
    if act == "silu":
        up = F.silu(x @ p["gate"]) * up
    else:
        up = F.gelu(up, approximate="tanh")    # jax.nn.gelu's default
    return up @ p["down"]
