"""repro_torch.configs — the 10 assigned architectures (exact published
numbers), selectable by id.

A data-only copy of the JAX package's ``repro.configs`` (schema, shapes and
the ten config files), so that the port imports nothing of ``repro``; the
tests hold every field equal to the reference's."""
from .base import ModelConfig
from .shapes import SHAPES, ShapeSpec, applicable, cells

from . import (dbrx_132b, granite_3_8b, mamba2_1_3b, qwen2_7b, qwen2_vl_2b,
               qwen3_moe_235b_a22b, recurrentgemma_2b, smollm_135m,
               tinyllama_1_1b, whisper_base)

ARCHS = {
    "dbrx-132b": dbrx_132b.CONFIG,
    "qwen3-moe-235b-a22b": qwen3_moe_235b_a22b.CONFIG,
    "mamba2-1.3b": mamba2_1_3b.CONFIG,
    "qwen2-7b": qwen2_7b.CONFIG,
    "granite-3-8b": granite_3_8b.CONFIG,
    "smollm-135m": smollm_135m.CONFIG,
    "tinyllama-1.1b": tinyllama_1_1b.CONFIG,
    "qwen2-vl-2b": qwen2_vl_2b.CONFIG,
    "whisper-base": whisper_base.CONFIG,
    "recurrentgemma-2b": recurrentgemma_2b.CONFIG,
}

def get(name: str) -> ModelConfig:
    return ARCHS[name]

__all__ = ["ModelConfig", "SHAPES", "ShapeSpec", "applicable", "cells",
           "ARCHS", "get"]
