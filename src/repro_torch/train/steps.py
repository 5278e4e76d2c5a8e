"""Step functions shared by the trainer and the server — the port of the
JAX package's ``train/steps.py``.

The cross-entropy is **chunked over the sequence**: the unembed product
and the log-softmax run per chunk of 512 positions, so only [B, chunk, V]
logits are formed at a time in the forward pass (autograd keeps each
chunk's for the backward, as the reference's scan keeps its residuals).

Gradients come from ``torch.autograd`` through the port's forward: on the
card every attention layer's forward is K7 and its backward the
hand-written backward kernels (``kernels.flash_attention``), and every
Mamba-2 mixer's intra-chunk block K8 with its hand-written backward
(``kernels.ssd_chunk``).  Under ``precision.options(dtype=bf16)`` the
transformer families (dense, MoE, VLM) train in bf16 with K7's bf16
backward (head widths 32–128); mamba2, recurrentgemma and whisper
ignore the compute dtype, as the reference's do.  With ``remat`` every
family checkpoints the units the reference wraps in ``jax.checkpoint``.
``abstract_train_state`` gives the state's shapes and dtypes on the
``meta`` device, with no storage, for the dry-run.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..configs.base import ModelConfig
from ..models import registry
from ..optim import adamw_init, adamw_update
from ..models.common import tree_leaves, tree_map, tree_unflatten


def chunked_ce_loss(cfg: ModelConfig, params, hidden: torch.Tensor,
                    labels: torch.Tensor, chunk: int = 512) -> torch.Tensor:
    """hidden [B, L, d] (pre-unembed), labels [B, L] (−1: ignored) → mean
    CE over the valid labels, float32.

    The unembed weight is the tied embedding or lm_head; each chunk's
    logits are formed, reduced and dropped in turn."""
    if cfg.tie_embeddings or "lm_head" not in params:
        w = params["embed"].T                      # [d, V]
    else:
        w = params["lm_head"]
    labels = torch.as_tensor(labels, device=hidden.device).long()
    L = hidden.shape[1]
    chunk = min(chunk, L)
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, L, chunk):
        h, y = hidden[:, c0:c0 + chunk], labels[:, c0:c0 + chunk]
        logits = (h.to(w.dtype) @ w).float()       # [B, chunk, V]
        lse = torch.logsumexp(logits, dim=-1)
        tgt = logits.gather(-1, y.clamp(min=0)[..., None])[..., 0]
        valid = (y >= 0).float()
        tot = tot + ((lse - tgt) * valid).sum()
        cnt = cnt + valid.sum()
    return tot / torch.clamp(cnt, min=1.0)


def loss_and_grads(cfg: ModelConfig, params, batch, *,
                   aux_weight: float = 0.01, remat: bool = True):
    """(total, ce, grads): the train step's loss ``CE + aux_weight ·
    moe_aux`` (the VLM's CE on the text tail only) and its gradients by
    autograd, a tree shaped as ``params`` (zeros for a leaf the loss does
    not reach, as ``jax.grad`` gives)."""
    labels = batch["labels"]
    with torch.enable_grad():
        p = tree_map(lambda a: a.detach().requires_grad_(True), params)
        hidden, aux = registry.forward(cfg, p, batch, remat=remat,
                                       unembed=False)
        hidden = hidden[:, -labels.shape[1]:]          # vlm: text tail only
        ce = chunked_ce_loss(cfg, p, hidden, labels)
        total = ce + aux_weight * aux.get("moe_aux", 0.0)
        leaves = tree_leaves(p)
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
    grads = tree_unflatten(params, [torch.zeros_like(x) if g is None else g
                                    for g, x in zip(grads, leaves)])
    return total.detach(), ce.detach(), grads


def make_train_step(cfg: ModelConfig, lr=3e-4, *, aux_weight: float = 0.01,
                    remat: bool = True) -> Callable:
    """(params, opt_state, batch) → (params', opt_state', metrics): the
    loss and gradients of ``loss_and_grads``, then AdamW.  ``metrics``
    holds the CE (``loss``) and the total (``total``) as 0-d tensors."""

    def train_step(params, opt_state, batch):
        total, ce, grads = loss_and_grads(cfg, params, batch,
                                          aux_weight=aux_weight, remat=remat)
        params, opt_state = adamw_update(grads, opt_state, params, lr=lr)
        return params, opt_state, {"loss": ce, "total": total}

    return train_step


def make_prefill_step(cfg: ModelConfig) -> Callable:
    """(params, batch) → logits of the last position (inference prefill)."""

    @torch.no_grad()
    def prefill_step(params, batch):
        hidden, _ = registry.forward(cfg, params, batch, remat=False,
                                     unembed=False)
        last = hidden[:, -1:]
        if cfg.tie_embeddings or "lm_head" not in params:
            return last @ params["embed"].T
        return last @ params["lm_head"]

    return prefill_step


def make_serve_step(cfg: ModelConfig, *, greedy: bool = True) -> Callable:
    """(params, cache, token) → (next_token int32 [B, 1], cache') — one
    greedy decode step."""

    @torch.no_grad()
    def serve_step(params, cache, token):
        logits, cache = registry.decode_step(cfg, params, cache, token)
        nxt = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        return nxt, cache

    return serve_step


def init_train_state(cfg: ModelConfig, seed=0, *, device=None):
    """(params, AdamW state) from a seed, on the card unless the caller
    passes ``device="cpu"``."""
    params = registry.init_params(cfg, seed, device=device)
    return params, adamw_init(params)


def abstract_train_state(cfg: ModelConfig):
    """(params, AdamW state) on the ``meta`` device: the reference's
    shapes and dtypes, with no storage (the dry-run's path)."""
    params = registry.abstract_params(cfg)
    return params, adamw_init(params)
