"""Analytic per-cell cost model: flops / HBM bytes / collective bytes — the
port of the JAX package's ``launch/costmodel.py``.

The three per-device costs (``flops_per_device``, ``bytes_per_device``,
``collective_bytes_per_device``) are hardware-free: they are the
reference's, term for term and in the same order, so that they equal its
numbers exactly (``tests/test_torch_costmodel.py``).  What the port
changes is the one hardware fact in the file, ``PerfOpts.peak_scale``:
the share of the card's bf16 peak that a float32 run gets.

Conventions / assumptions (stated once, used everywhere):

* flops count multiply-adds as 2 ops; softmax/norms ≈ 5 ops/element.
* train = fwd + backward(2×fwd) + per-layer full remat (+1×fwd of the
  layer stack) — the port's train step checkpoints each transformer
  layer (``torch.utils.checkpoint``) under ``remat=True``.
* HBM bytes assume perfect fusion within a layer: weights read once per
  traversal, activations written once per layer boundary (the remat
  checkpoint), optimizer state read+written once per step. bf16 weights /
  f32 optimizer.
* collective bytes per device follow the sharding rules in
  repro_torch.sharding: FSDP all-gather of the layer weights (fwd, bwd,
  remat) + reduce-scatter of gradients over the data axes; TP all-reduce
  of the residual stream (2×/layer fwd, 2×/layer bwd); MoE all-to-all
  (dispatch + return) over the expert axis; a ring all-reduce/all-gather
  of n bytes moves ≈ 2·n (reduce + broadcast phases) / 1·n respectively
  on the wire per device.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..configs.base import ModelConfig
from ..configs.shapes import ShapeSpec
from .mesh import PEAK_FLOPS_BF16, PEAK_FLOPS_FP32

BF16 = 2
F32 = 4


@dataclass(frozen=True)
class MeshDims:
    data: int        # data-parallel shards (pod × data)
    model: int       # tensor/expert-parallel shards
    chips: int


@dataclass(frozen=True)
class PerfOpts:
    """The §Perf levers, mirroring the real code knobs.

    * bf16: compute/collective dtype 2 B, and the card's full bf16 peak
      (``peak_scale`` 1); without it the products run in float32 (see
      ``peak_scale``);
    * sp:   Megatron sequence parallelism — each TP all-reduce pair becomes
      reduce-scatter + all-gather (wire bytes 1·n instead of 2·n);
    * layout: "fsdp" | "inference" | "dp" (see repro_torch.sharding.LAYOUTS).
    """

    bf16: bool = False
    sp: bool = False
    layout: str = "fsdp"
    kv_int8: bool = False
    remat: bool = True

    @property
    def act_bytes(self) -> int:
        return BF16 if self.bf16 else F32

    @property
    def peak_scale(self) -> float:
        """The run's peak as a share of ``mesh.PEAK_FLOPS_BF16``.  bf16:
        1, the tensor cores' bf16 rate, as in the reference.  float32: the
        H100's FP32 rate over its bf16 rate (67 / 989 T op/s), because the
        port's float32 products are cuBLAS FP32 ``torch.matmul``s —
        TF32 stays off (``torch.backends.cuda.matmul.allow_tf32`` is
        False, PyTorch's default) — while K7's 3×TF32 products (165 T op/s
        effective) are a few per cent of a step's flops.  The reference's
        0.5 is a TPU fact: its float32 products run the MXU at half
        rate."""
        return 1.0 if self.bf16 else PEAK_FLOPS_FP32 / PEAK_FLOPS_BF16

    @property
    def ar_factor(self) -> float:
        return 1.0 if self.sp else 2.0


def _layer_flops_per_token(cfg: ModelConfig, kv_len: float) -> float:
    """Forward flops per token for ONE layer of each family."""
    d = cfg.d_model
    if cfg.family == "ssm":
        d_in = cfg.ssm_expand * d
        G, S, P = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_headdim
        H = d_in // P
        Q = 64                                   # ssd chunk length
        proj = 2 * d * (2 * d_in + 2 * G * S + H) + 2 * d_in * d
        conv = 2 * cfg.conv_kernel * (d_in + 2 * G * S)
        ssd = 2 * Q * G * S + H * (2 * Q * P + 4 * S * P)
        return proj + conv + ssd
    hd = cfg.head_dim or 0
    attn_proj = 2 * d * (cfg.n_heads * hd) * 2 \
        + 2 * d * (cfg.n_kv * hd) * 2
    attn_math = 2 * cfg.n_heads * hd * kv_len * 2      # qk + pv
    if cfg.act == "silu":
        mlp = 3 * 2 * d * cfg.d_ff
    else:
        mlp = 2 * 2 * d * cfg.d_ff
    if cfg.is_moe:
        mlp = 2 * d * cfg.n_experts \
            + cfg.top_k * cfg.capacity_factor * 3 * 2 * d * cfg.moe_d_ff
    if cfg.family == "hybrid":
        # average over the block pattern
        pat = cfg._layer_kinds()
        n_attn = sum(1 for k in pat if k == "attn")
        w = cfg.lru_width or d
        rec = 2 * d * w * 2 + 2 * cfg.conv_kernel * w + 2 * w * w * 2 \
            + 10 * w + 2 * w * d
        att = attn_proj + 2 * cfg.n_heads * hd * min(kv_len, cfg.window
                                                     or kv_len) * 2
        frac_a = n_attn / len(pat)
        return frac_a * att + (1 - frac_a) * rec + mlp
    return attn_proj + attn_math + mlp


def _params_per_layer(cfg: ModelConfig) -> float:
    per_model = cfg.param_count() - cfg.vocab * cfg.d_model * \
        (1 if cfg.tie_embeddings else 2)
    n_units = cfg.n_layers
    return per_model / max(n_units, 1)


def flops_per_device(cfg: ModelConfig, shape: ShapeSpec, mesh: MeshDims,
                     opts: "PerfOpts" = None, *, remat: bool = None) -> float:
    """Per-step per-device flops for the cell's step function."""
    opts = opts or PerfOpts()
    remat = opts.remat if remat is None else remat
    d, V = cfg.d_model, cfg.vocab
    if shape.kind == "train":
        tokens_dev = shape.seq_len * shape.global_batch / mesh.data
        tp = mesh.model
        if opts.layout == "dp":
            tokens_dev = shape.seq_len * shape.global_batch / mesh.chips
            tp = 1
        kv_avg = shape.seq_len / 2                    # causal average
        layer = _layer_flops_per_token(cfg, kv_avg) / tp
        fwd = cfg.n_layers * layer * tokens_dev
        factor = 4.0 if remat else 3.0                # fwd+bwd(2)+remat(1)
        ce = (2 * d * (V / tp) + 5 * V / tp) * tokens_dev
        enc = 0.0
        if cfg.family == "audio":
            enc_tok = cfg.encoder_frames * shape.global_batch / mesh.data
            enc = cfg.encoder_layers * _layer_flops_per_token(
                cfg, cfg.encoder_frames) / mesh.model * enc_tok * factor
        return fwd * factor + ce * 3.0 + enc
    if shape.kind == "prefill":
        tokens_dev = shape.seq_len * shape.global_batch / mesh.data
        kv_avg = shape.seq_len / 2
        layer = _layer_flops_per_token(cfg, kv_avg) / mesh.model
        ce = 2 * d * (V / mesh.model) * shape.global_batch / mesh.data
        return cfg.n_layers * layer * tokens_dev + ce
    # decode: one token per sequence; batch may not shard (long_500k B=1).
    bdev = max(1.0, shape.global_batch / mesh.data)
    layer = _layer_flops_per_token(cfg, shape.seq_len) / mesh.model
    ce = 2 * d * (V / mesh.model) * bdev
    return cfg.n_layers * layer * bdev + ce


def bytes_per_device(cfg: ModelConfig, shape: ShapeSpec, mesh: MeshDims,
                     opts: "PerfOpts" = None) -> float:
    """Per-step per-device HBM traffic (perfect-fusion lower bound)."""
    opts = opts or PerfOpts()
    N = cfg.param_count()
    d = cfg.d_model
    wdt = opts.act_bytes                              # weight-at-use dtype
    if opts.layout == "dp":
        p_dev = N                                     # replicated
    else:
        p_dev = N / mesh.chips                        # fully sharded
    if shape.kind == "train":
        tokens_dev = shape.seq_len * shape.global_batch / mesh.data
        if opts.layout == "dp":
            tokens_dev = shape.seq_len * shape.global_batch / mesh.chips
        # weights: fwd + remat + bwd reads, grad write.
        w = p_dev * wdt * 3 + p_dev * F32
        opt = p_dev * F32 * 4                         # m,v read+write
        acts = cfg.n_layers * tokens_dev * d * wdt * 3   # ckpt w + 2 reads
        ce = tokens_dev * d * wdt * 2
        return w + opt + acts + ce
    if shape.kind == "prefill":
        tokens_dev = shape.seq_len * shape.global_batch / mesh.data
        w = p_dev * BF16
        acts = cfg.n_layers * tokens_dev * d * BF16 * 2
        kv_write = (cfg.n_layers * tokens_dev *
                    2 * (cfg.n_kv * (cfg.head_dim or 0)) * BF16)
        return w + acts + kv_write
    # decode: weights (active) + full cache read + cache write slice.
    bdev = max(1.0, shape.global_batch / mesh.data)
    w = cfg.active_param_count() / mesh.chips * wdt * \
        min(bdev, 8)                                  # weight reuse à la 8
    cache = _cache_bytes_per_device(cfg, shape, mesh)
    if opts.kv_int8:
        cache *= 0.5                                  # int8 vs bf16 KV
    return w + cache


def _cache_bytes_per_device(cfg: ModelConfig, shape: ShapeSpec,
                            mesh: MeshDims) -> float:
    bdev = max(1.0, shape.global_batch / mesh.data)
    if cfg.family == "ssm":
        d_in = cfg.ssm_expand * cfg.d_model
        H = d_in // cfg.ssm_headdim
        st = cfg.n_layers * bdev * H * cfg.ssm_state * cfg.ssm_headdim * F32
        return 2 * st / (mesh.model if shape.global_batch < mesh.data else 1)
    if cfg.family == "hybrid":
        pat = cfg._layer_kinds()
        n_attn = sum(1 for k in pat if k == "attn")
        w = cfg.lru_width or cfg.d_model
        kv = n_attn * bdev * cfg.n_kv * (cfg.window or shape.seq_len) \
            * (cfg.head_dim or 0) * 2 * BF16
        st = (len(pat) - n_attn) * bdev * w * F32 * 2
        return kv + st
    L = shape.seq_len
    kv = cfg.n_layers * bdev * cfg.n_kv * L * (cfg.head_dim or 0) * 2 * BF16
    return kv / (mesh.model if shape.global_batch < mesh.data else 1)


def collective_bytes_per_device(cfg: ModelConfig, shape: ShapeSpec,
                                mesh: MeshDims,
                                opts: PerfOpts = PerfOpts()) -> float:
    """Per-step per-device wire bytes from the sharding layout."""
    d = cfg.d_model
    N = cfg.param_count()
    fsdp = mesh.data > 1 and opts.layout == "fsdp"
    out = 0.0
    dt = opts.act_bytes
    if shape.kind == "train":
        tokens_dev = shape.seq_len * shape.global_batch / mesh.data
        if opts.layout == "dp":
            # pure DP: replicated params, one grad all-reduce over all chips.
            return N * dt * 2
        if fsdp:
            # all-gather weights fwd + remat-bwd, reduce-scatter grads ≈ 2n.
            out += (N / mesh.model) * dt * (1 + 1) + (N / mesh.model) * dt * 2
        if mesh.model > 1:
            # 2 residual AR per layer fwd, 2 bwd (ring ≈ 2n; SP halves).
            out += cfg.n_layers * 4 * tokens_dev * d * dt * opts.ar_factor
            if cfg.is_moe:
                cap_tok = tokens_dev * cfg.top_k * cfg.capacity_factor
                out += cfg.n_layers * 2 * cap_tok * d * dt  # a2a there+back
        return out
    if shape.kind == "prefill":
        tokens_dev = shape.seq_len * shape.global_batch / mesh.data
        if opts.layout == "dp":
            return 0.0
        if fsdp:
            out += (N / mesh.model) * BF16           # weight all-gather
        if mesh.model > 1:
            out += cfg.n_layers * 2 * tokens_dev * d * BF16 * opts.ar_factor
            if cfg.is_moe:
                cap_tok = tokens_dev * cfg.top_k * cfg.capacity_factor
                out += cfg.n_layers * 2 * cap_tok * d * BF16
        return out
    bdev = max(1.0, shape.global_batch / mesh.data)
    if opts.layout == "dp":
        return 0.0
    if fsdp:
        # decode under the fsdp layout gathers the (active) layer weights —
        # as the reference's compiled HLO census shows (all-gather
        # dominated).
        out += (cfg.active_param_count() / mesh.model) * BF16
    if mesh.model > 1:
        # partial-sum ARs of the one-token residual over the data axis +
        # TP combine over model: tiny [bdev, d] tensors per sublayer.
        out += cfg.n_layers * 4 * bdev * d * BF16 * opts.ar_factor
        if cfg.is_moe:
            out += cfg.n_layers * 2 * bdev * cfg.top_k * d * BF16
    return out
