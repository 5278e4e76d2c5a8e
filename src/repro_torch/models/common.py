"""Shared model building blocks: parameter trees, norms, RoPE, attention
and MLPs — the port of the JAX package's ``models/common.py``.

Parameters are nested dicts of tensors with the reference's names and
layouts: a dense weight is ``[d_in, d_out]`` and applied as ``x @ W``,
and the layers of a model are stacked along a leading axis (``stack_init``),
so a JAX parameter tree converts leaf for leaf (``models.convert``).

``attention`` is the ``flash_attention`` wrapper's call: the kernel K7 on
the card, its plain version on the CPU (the reference's
``common.attention``, whose Pallas twin is K7).
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional

import torch
import torch.nn.functional as F

from .._device import resolve_device
from ..kernels.flash_attention import flash_attention

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# parameter trees and init helpers
# ---------------------------------------------------------------------------

def tree_map(fn: Callable, tree, *rest):
    """Apply ``fn`` to every tensor of a tree of dicts and tuples (and to
    the tensors at the same places of the trees ``rest``), keeping the
    keys and the tuples' order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(tree_map(fn, v, *(r[i] for r in rest))
                     for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The tensors of a tree in the reference's ``jax.tree.leaves`` order:
    dict keys sorted, tuples (named ones by field) in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, tuple):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(template, leaves):
    """A tree of ``template``'s structure (dicts and plain tuples) whose
    tensors are ``leaves``, in :func:`tree_leaves`' order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, tuple):
            return tuple(build(v) for v in t)
        return next(it)

    return build(template)


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
# attention
# ---------------------------------------------------------------------------

def attention(q, k, v, *, causal: bool = True, window: Optional[int] = None):
    """Attention. q [B,H,Lq,D]; k, v [B,Hkv,Lk,D] (H divisible by Hkv;
    queries are right-aligned against keys).  Returns [B,H,Lq,D].  The
    ``flash_attention`` wrapper dispatches: the kernel K7 (forward, and
    its backward under autograd) for CUDA tensors, the dense plain form
    ``attention_ref`` for CPU tensors, which computes the reference's
    chunked running softmax in one block.  A causal call with Lq > Lk
    raises ``ValueError`` on either device."""
    return flash_attention(q, k, v, causal=causal, window=window)


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
