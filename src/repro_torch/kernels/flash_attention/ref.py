"""Plain-torch version of the flash-attention kernel K7: dense softmax
attention with causal / local-window masks and grouped-query head sharing
(the reference's ``attention_ref`` oracle).  The wrapper runs it for
tensors on the CPU; ``chip_smoke.py`` holds the CUDA kernel against it on
the card.  ``attention_bwd_ref`` is the plain version of its backward:
the tests and ``chip_smoke.py`` hold the CUDA backward against it, and
``attention_lse_ref`` is the plain version of the log2-sum-exp the
kernel's forward writes for it."""
from __future__ import annotations

import math

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
    probs, vf = _probs(q, k, v, causal, window, scale)
    return torch.einsum("bhqk,bhkd->bhqd", probs, vf).to(q.dtype)


def _mask(Lq: int, Lk: int, causal: bool, window, device):
    """[Lq, Lk]: True where query i (position Lk − Lq + i) sees key j."""
    q_pos = torch.arange(Lq, device=device)[:, None] + (Lk - Lq)
    k_pos = torch.arange(Lk, device=device)[None, :]
    mask = torch.ones((Lq, Lk), dtype=torch.bool, device=device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    return mask


def _logits(q, k, causal, window, scale):
    """The masked logits [B, H, Lq, Lk] in float32 (−inf where masked)."""
    rep = q.shape[1] // k.shape[1]
    kf = k.float().repeat_interleave(rep, dim=1)
    scale = scale if scale is not None else q.shape[3] ** -0.5
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * scale
    mask = _mask(q.shape[2], k.shape[2], causal, window, q.device)
    return logits.masked_fill(~mask, float("-inf"))


def attention_lse_ref(q, k, *, causal: bool = True, window=None,
                      scale=None):
    """Each query row's log-sum-exp of its visible logits, in log2 units:
    log₂ Σⱼ 2^(q·kⱼ·scale·log₂ e) = logsumexp(q·k·scale) / ln 2, float32
    [B, H, Lq] — what K7's forward writes under grad for the backward."""
    lse = torch.logsumexp(_logits(q, k, causal, window, scale), dim=-1)
    return lse / math.log(2.0)


def _probs(q, k, v, causal, window, scale):
    """The softmax P [B, H, Lq, Lk] in float32 and v widened and repeated
    over each group's heads [B, H, Lk, D]."""
    rep = q.shape[1] // k.shape[1]
    vf = v.float().repeat_interleave(rep, dim=1)
    logits = _logits(q, k, causal, window, scale)
    probs = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    return probs / probs.sum(dim=-1, keepdim=True), vf


def attention_bwd_ref(q, k, v, do, *, causal: bool = True, window=None,
                      scale=None):
    """The gradients (dq, dk, dv) of ``attention_ref`` for the output
    gradient ``do`` [B, H, Lq, D], written out rather than taken by
    autograd, in float32: with P the softmax and O = P·V,

        dV = Pᵀ·dO,   dP = dO·Vᵀ,   Δ = rowsum(dO ∘ O),
        dS = P ∘ (dP − Δ),   dQ = scale·dS·K,   dK = scale·dSᵀ·Q,

    dK and dV summed over the query heads that share each key/value head
    (GQA).  dq has q's shape, dk and dv k's, all float32."""
    B, H, Lq, D = q.shape
    Hkv, Lk = k.shape[1], k.shape[2]
    rep = H // Hkv
    scale = scale if scale is not None else D ** -0.5
    probs, vf = _probs(q, k, v, causal, window, scale)
    kf = k.float().repeat_interleave(rep, dim=1)
    dof = do.float()
    out = torch.einsum("bhqk,bhkd->bhqd", probs, vf)
    dv = torch.einsum("bhqk,bhqd->bhkd", probs, dof)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    delta = (dof * out).sum(dim=-1, keepdim=True)
    ds = probs * (dp - delta)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float()) * scale
    group = lambda t: t.reshape(B, Hkv, rep, Lk, D).sum(dim=2)  # noqa: E731
    return dq, group(dk), group(dv)
