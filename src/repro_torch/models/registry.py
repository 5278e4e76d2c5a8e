"""Family dispatch — the single entry point to the port's models, as the
reference's ``models/registry.py`` is to its.

Every family of the reference is ported: ``dense``, ``moe`` (with the MoE
layer's ``topk`` and ``dodoor`` routers) and ``vlm`` (the transformer),
``ssm`` (Mamba-2), ``hybrid`` (RecurrentGemma's RG-LRU) and ``audio``
(Whisper, whose ``prime_cache`` this module also exposes).  An unknown
family raises ``NotImplementedError``.  ``abstract_*`` and
``make_inputs`` (XLA dry-run tooling) are not ported (ROADMAP §1 item 7).

Entry points run on the card unless the caller passes ``device="cpu"``
(``init_params``, ``init_cache``); ``forward``, ``decode_step`` and
``prime_cache`` run where their parameters lie.
"""
from __future__ import annotations

from typing import Any, Dict

from ..configs.base import ModelConfig
from . import mamba2, rglru, transformer, whisper

Params = Dict[str, Any]

_FAMILY = {"dense": transformer, "moe": transformer, "vlm": transformer,
           "ssm": mamba2, "hybrid": rglru, "audio": whisper}


def module(cfg: ModelConfig):
    mod = _FAMILY.get(cfg.family)
    if mod is None:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} has no model in the port")
    return mod


def init_params(cfg: ModelConfig, seed=0, *, device=None) -> Params:
    return module(cfg).init_params(cfg, seed, device=device)


def forward(cfg: ModelConfig, params, batch, **kw):
    return module(cfg).forward(cfg, params, batch, **kw)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, **kw):
    return module(cfg).init_cache(cfg, batch, max_len, **kw)


def decode_step(cfg: ModelConfig, params, cache, token):
    return module(cfg).decode_step(cfg, params, cache, token)


def prime_cache(cfg: ModelConfig, params, cache, frames):
    """Whisper's cross-attention keys and values from the encoder, once a
    request (``whisper.prime_cache``); other families have none."""
    if cfg.family != "audio":
        raise ValueError(f"{cfg.name}: prime_cache is Whisper's (the audio "
                         f"family), not {cfg.family!r}'s")
    return whisper.prime_cache(cfg, params, cache, frames)
