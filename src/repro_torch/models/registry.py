"""Family dispatch — the single entry point to the port's models, as the
reference's ``models/registry.py`` is to its.

Every family of the reference is ported: ``dense``, ``moe`` (with the MoE
layer's ``topk`` and ``dodoor`` routers) and ``vlm`` (the transformer),
``ssm`` (Mamba-2), ``hybrid`` (RecurrentGemma's RG-LRU) and ``audio``
(Whisper, whose ``prime_cache`` this module also exposes).  An unknown
family raises ``NotImplementedError``.

Entry points run on the card unless the caller passes ``device="cpu"``
(``init_params``, ``init_cache``, ``make_inputs(concrete=True)``);
``forward``, ``decode_step`` and ``prime_cache`` run where their
parameters lie.

The abstract forms (``abstract_params``, ``abstract_cache``,
``train_batch_specs``, ``decode_specs``, ``make_inputs``) are tensors on
the ``meta`` device: the reference's ``ShapeDtypeStruct``s, with shapes
and dtypes and no storage, so that a run is sized before anything is
allocated (``launch/dryrun.py``).  A cache's write position ``idx`` is a
0-d int32 tensor there, as the reference's is; ``init_cache`` keeps it
a host int.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .._device import resolve_device
from ..configs.base import ModelConfig
from ..configs.shapes import ShapeSpec
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


def abstract_params(cfg: ModelConfig) -> Params:
    """The parameter tree on the ``meta`` device: the reference's shapes,
    keys and dtypes, with no storage (the dry-run's path)."""
    return module(cfg).init_params(cfg, torch.Generator(), device="meta")


def forward(cfg: ModelConfig, params, batch, **kw):
    return module(cfg).forward(cfg, params, batch, **kw)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, **kw):
    return module(cfg).init_cache(cfg, batch, max_len, **kw)


def abstract_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None):
    """``init_cache`` on the ``meta`` device (``dtype``: the cache's, e.g.
    bf16 or int8; the family's default when None), ``idx`` a 0-d int32
    meta tensor."""
    kw = {"dtype": dtype} if dtype is not None else {}
    cache = init_cache(cfg, batch, max_len, device="meta", **kw)
    cache["idx"] = torch.empty((), dtype=torch.int32, device="meta")
    return cache


def decode_step(cfg: ModelConfig, params, cache, token):
    return module(cfg).decode_step(cfg, params, cache, token)


def prime_cache(cfg: ModelConfig, params, cache, frames):
    """Whisper's cross-attention keys and values from the encoder, once a
    request (``whisper.prime_cache``); other families have none."""
    if cfg.family != "audio":
        raise ValueError(f"{cfg.name}: prime_cache is Whisper's (the audio "
                         f"family), not {cfg.family!r}'s")
    return whisper.prime_cache(cfg, params, cache, frames)


# ---------------------------------------------------------------------------
# per-cell input specs
# ---------------------------------------------------------------------------

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_batch_specs(cfg: ModelConfig, B: int, L: int) -> Dict[str, Any]:
    """Inputs of a train step or a prefill as meta tensors: tokens and
    labels (+ the VLM's bf16 patches and M-RoPE streams, the audio
    family's bf16 frames), as the reference's."""
    specs: Dict[str, Any] = {}
    if cfg.family == "vlm":
        n_p = min(cfg.vision_patches, max(1, L // 4))
        specs["patches"] = _meta((B, n_p, cfg.d_model), torch.bfloat16)
        specs["tokens"] = _meta((B, L - n_p), torch.int32)
        specs["positions3"] = _meta((B, 3, L), torch.int32)
        specs["labels"] = _meta((B, L - n_p), torch.int32)
    elif cfg.family == "audio":
        specs["frames"] = _meta((B, cfg.encoder_frames, cfg.d_model),
                                torch.bfloat16)
        specs["tokens"] = _meta((B, L), torch.int32)
        specs["labels"] = _meta((B, L), torch.int32)
    else:
        specs["tokens"] = _meta((B, L), torch.int32)
        specs["labels"] = _meta((B, L), torch.int32)
    return specs


def decode_specs(cfg: ModelConfig, B: int, L: int, cache_dtype=None):
    """(cache, token) as meta tensors for one decode step against an
    L-token context."""
    return (abstract_cache(cfg, B, L, dtype=cache_dtype),
            _meta((B, 1), torch.int32))


def _sorted_leaves(tree, out):
    """``tree``'s tensors with their parents, in ``jax.tree.leaves``
    order (dict keys sorted), the order the reference draws them in."""
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            _sorted_leaves(tree[k], out)
        else:
            out.append((tree, k))
    return out


def make_inputs(cfg: ModelConfig, shape: ShapeSpec, *, concrete: bool = False,
                seed: int = 0, cache_dtype=None, device=None):
    """Inputs of a shape cell.  Abstract (the default): meta tensors.
    Concrete: what the reference's ``make_inputs(concrete=True, seed=)``
    draws, value for value — ``np.random.RandomState(seed)`` over the
    leaves in sorted-key order, integers ``randint(0, max(2, vocab //
    2))``, floats ``randn`` rounded to the leaf's dtype and times 0.02 in
    that dtype — on ``device`` (the card unless the caller asks for the
    CPU).  Concrete inputs at a full shape allocate it: smoke shapes
    only."""
    B, L = shape.global_batch, shape.seq_len
    if shape.kind in ("train", "prefill"):
        specs = train_batch_specs(cfg, B, L)
    else:
        cache, token = decode_specs(cfg, B, L, cache_dtype=cache_dtype)
        specs = {"cache": cache, "token": token}
    if not concrete:
        return specs
    device = resolve_device(device)
    rng = np.random.RandomState(seed)
    for parent, key in _sorted_leaves(specs, []):
        s = parent[key]
        if not s.dtype.is_floating_point:
            v = torch.from_numpy(rng.randint(0, max(2, cfg.vocab // 2),
                                             size=tuple(s.shape)))
            parent[key] = v.to(s.dtype).to(device)
        else:
            v = torch.from_numpy(np.asarray(rng.randn(*s.shape))).to(s.dtype)
            parent[key] = (v * torch.tensor(0.02, dtype=s.dtype)).to(device)
    return specs
