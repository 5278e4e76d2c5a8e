"""Plain-torch version of the flash-attention kernel K7: dense softmax
attention with causal / local-window masks and grouped-query head sharing
(the reference's ``attention_ref`` oracle).  The wrapper runs it for
tensors on the CPU; ``chip_smoke.py`` holds the CUDA kernel against it on
the card."""
from __future__ import annotations

import torch


def attention_ref(q, k, v, *, causal: bool = True, window=None,
                  scale=None):
    """q [B, H, Lq, D]; k, v [B, Hkv, Lk, D] with H a multiple of Hkv (GQA).

    ``window``: if set, position i attends to j ∈ (i−window, i].  Query
    positions are right-aligned with the keys (q position i is key position
    Lk − Lq + i), so the same function covers decode (Lq=1 against a long
    cache).  Computed in float32 (bf16 inputs are widened, as the kernel
    accumulates in float32); the result has q's dtype.
    """
    B, H, Lq, D = q.shape
    Hkv, Lk = k.shape[1], k.shape[2]
    rep = H // Hkv
    qf, kf, vf = (t.float() for t in (q, k, v))
    kf = kf.repeat_interleave(rep, dim=1)
    vf = vf.repeat_interleave(rep, dim=1)
    scale = scale if scale is not None else D ** -0.5
    logits = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    q_pos = torch.arange(Lq, device=q.device)[:, None] + (Lk - Lq)
    k_pos = torch.arange(Lk, device=q.device)[None, :]
    mask = torch.ones((Lq, Lk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    probs = probs / probs.sum(dim=-1, keepdim=True)
    return torch.einsum("bhqk,bhkd->bhqd", probs, vf).to(q.dtype)
