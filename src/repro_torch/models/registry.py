"""Family dispatch — the single entry point to the port's models, as the
reference's ``models/registry.py`` is to its.

Ported: the ``dense`` and ``moe`` families (the transformer, with the MoE
layer's ``topk`` and ``dodoor`` routers) and ``ssm`` (Mamba-2).  The other
families raise ``NotImplementedError`` naming the ROADMAP item that ports
them.  ``abstract_*`` and ``make_inputs`` (XLA
dry-run tooling) are not ported (ROADMAP §1 item 10).

Entry points run on the card unless the caller passes ``device="cpu"``
(``init_params``, ``init_cache``); ``forward`` and ``decode_step`` run
where their parameters lie.
"""
from __future__ import annotations

from typing import Any, Dict

from ..configs.base import ModelConfig
from . import mamba2, transformer

Params = Dict[str, Any]

_FAMILY = {"dense": transformer, "moe": transformer, "ssm": mamba2}

_NOT_PORTED = {
    "vlm": "the VLM backbone (M-RoPE)",
    "hybrid": "the RG-LRU hybrid",
    "audio": "Whisper",
}


def module(cfg: ModelConfig):
    mod = _FAMILY.get(cfg.family)
    if mod is None:
        what = _NOT_PORTED.get(cfg.family, f"family {cfg.family!r}")
        raise NotImplementedError(
            f"{cfg.name}: {what} is not ported yet (ROADMAP §1 item 10)")
    return mod


def init_params(cfg: ModelConfig, seed=0, *, device=None) -> Params:
    return module(cfg).init_params(cfg, seed, device=device)


def forward(cfg: ModelConfig, params, batch, **kw):
    return module(cfg).forward(cfg, params, batch, **kw)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, **kw):
    return module(cfg).init_cache(cfg, batch, max_len, **kw)


def decode_step(cfg: ModelConfig, params, cache, token):
    return module(cfg).decode_step(cfg, params, cache, token)
