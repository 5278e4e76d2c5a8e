"""The four assigned input shapes and per-(arch × shape) applicability.

LM transformer shapes are seq_len × global_batch. ``decode_*`` / ``long_*``
lower ``serve_step`` (one new token against a seq_len KV cache/state), NOT
``train_step``. ``long_500k`` needs sub-quadratic attention — it runs for
SSM/hybrid archs and is *skipped* for pure full-attention archs (noted in
DESIGN.md §4).
"""
from __future__ import annotations

from dataclasses import dataclass

from .base import ModelConfig


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def applicable(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """(runs?, reason-if-skipped) for an (arch, shape) cell."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("full-attention KV at 524,288 tokens is the quadratic "
                       "regime the brief excludes; runs only for ssm/hybrid")
    return True, ""


def cells(configs: dict) -> list:
    """All 40 (arch, shape) cells with applicability flags."""
    out = []
    for name, cfg in configs.items():
        for sname, shape in SHAPES.items():
            ok, why = applicable(cfg, shape)
            out.append((name, sname, ok, why))
    return out
