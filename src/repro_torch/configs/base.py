"""Model configuration schema shared by all 10 assigned architectures."""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int

    # attention
    head_dim: Optional[int] = None       # default d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 1e4
    window: Optional[int] = None         # local-attention window
    mrope: bool = False                  # Qwen2-VL multimodal RoPE

    # mixture of experts
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    router: str = "topk"                 # topk | dodoor

    # state-space (mamba2)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_groups: int = 1
    conv_kernel: int = 4

    # hybrid (recurrentgemma): repeating block pattern, e.g. ("rglru",
    # "rglru", "attn"); trailing layers that don't fill a block are cut from
    # the same pattern.
    block_pattern: tuple = ()
    lru_width: int = 0

    # encoder-decoder (whisper)
    encoder_layers: int = 0
    encoder_frames: int = 0

    # vlm stub frontend
    vision_patches: int = 0

    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    act: str = "silu"                    # silu | gelu

    def __post_init__(self):
        if self.head_dim is None and self.n_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch decode at 500k context (bounded per-token state)?"""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decode(self) -> bool:
        return True          # all 10 archs are decoders or enc-dec

    def param_count(self) -> int:
        """Analytic parameter count (used for 6·N·D model-FLOPs roofline)."""
        d, v = self.d_model, self.vocab
        emb = v * d * (1 if self.tie_embeddings else 2)
        n = emb
        hd = self.head_dim or 0
        attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv * hd) \
            + (self.n_heads * hd) * d
        if self.family == "ssm":
            d_in = self.ssm_expand * d
            H = d_in // self.ssm_headdim
            per = (d * (2 * d_in + 2 * self.ssm_groups * self.ssm_state + H)
                   + d_in * d + self.conv_kernel *
                   (d_in + 2 * self.ssm_groups * self.ssm_state))
            return n + self.n_layers * (per + 2 * d)
        if self.family == "hybrid":
            pat = self._layer_kinds()
            n_attn = sum(1 for k in pat if k == "attn")
            n_rec = len(pat) - n_attn
            w = self.lru_width or d
            rec = d * w * 2 + w * d + w * (3 * w) // 1 + 2 * w  # proj + gates
            mlp = 3 * d * self.d_ff
            return n + n_attn * (attn + mlp + 3 * d) \
                + n_rec * (rec + mlp + 3 * d)
        mlp = (3 if self.act == "silu" else 2) * d * self.d_ff
        if self.is_moe:
            moe = self.n_experts * 3 * d * self.moe_d_ff + d * self.n_experts
            per = attn + moe + 2 * d
        else:
            per = attn + mlp + 2 * d
        layers = self.n_layers * per
        if self.family == "audio":
            layers += self.encoder_layers * (attn + 2 * d * self.d_ff + 2 * d)
            layers += self.n_layers * attn            # cross-attention
        return n + layers

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k of n_experts)."""
        if not self.is_moe:
            return self.param_count()
        d = self.d_model
        full = self.param_count()
        moe_all = self.n_layers * self.n_experts * 3 * d * self.moe_d_ff
        moe_act = self.n_layers * self.top_k * 3 * d * self.moe_d_ff
        return full - moe_all + moe_act

    def _layer_kinds(self) -> tuple:
        """Per-layer kind sequence for hybrid archs."""
        if not self.block_pattern:
            return tuple(["attn"] * self.n_layers)
        pat = []
        while len(pat) < self.n_layers:
            pat.extend(self.block_pattern)
        return tuple(pat[: self.n_layers])

    def smoke(self) -> "ModelConfig":
        """A reduced same-family config for CPU smoke tests."""
        kw = dict(
            name=self.name + "-smoke",
            n_layers=min(self.n_layers, 3 if not self.block_pattern
                         else len(self.block_pattern)),
            d_model=128,
            n_heads=4,
            n_kv=max(1, min(self.n_kv, 2)),
            d_ff=256,
            vocab=512,
            head_dim=32,
        )
        if self.is_moe:
            kw.update(n_experts=4, top_k=2, moe_d_ff=128)
        if self.family == "ssm":
            kw.update(ssm_state=32, ssm_headdim=32, ssm_groups=1)
        if self.family == "hybrid":
            kw.update(lru_width=128, window=min(self.window or 64, 64))
        if self.family == "audio":
            kw.update(encoder_layers=2, encoder_frames=64)
        if self.family == "vlm":
            kw.update(vision_patches=16)
        if self.window is not None and "window" not in kw:
            kw.update(window=min(self.window, 64))
        return replace(self, **kw)
