"""Per-architecture request cost model for the serving router — a copy of
``repro.serving.costs``, which imports only numpy.

A request (prompt_len, gen_len) against a model replica costs:

* prefill: 2·N_active·prompt_len flops (compute-bound);
* decode:  gen_len steps, each bounded by reading the active weights + the
  KV/state bytes (memory-bound) — the classic serving roofline;
* KV/state residency: bytes held for the request's lifetime.

Replica types model heterogeneous accelerator fleets (the serving analogue
of Table 2's four node types): different peak flops, HBM bandwidth and
capacity. ``request_cost`` returns the per-type duration vector d_ij and the
resource vector r_i = [decode slots, KV bytes] — exactly the inputs of
Algorithm 1.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..configs.base import ModelConfig

BF16 = 2


@dataclass(frozen=True)
class ReplicaType:
    name: str
    peak_flops: float          # effective, per replica
    hbm_bw: float              # bytes/s
    hbm_bytes: float           # capacity for KV after weights
    slots: int                 # concurrent decode lanes
    count: int = 1


# A heterogeneous 4-type fleet (mirrors the paper's testbed diversity):
# flagship / previous-gen / bandwidth-poor / small accelerators.
REPLICA_TYPES = (
    ReplicaType("v5p-like", 459e12, 2765e9, 60e9, slots=16, count=4),
    ReplicaType("v5e-like", 197e12, 819e9, 12e9, slots=8, count=10),
    ReplicaType("v4-like", 275e12, 1228e9, 24e9, slots=8, count=6),
    ReplicaType("edge-like", 90e12, 400e9, 8e9, slots=4, count=12),
)


def kv_bytes_per_token(cfg: ModelConfig) -> float:
    if cfg.family == "ssm":
        return 0.0                         # constant state, not per-token
    if cfg.family == "hybrid":
        pat = cfg._layer_kinds()
        n_attn = sum(1 for k in pat if k == "attn")
        return n_attn * cfg.n_kv * (cfg.head_dim or 0) * 2 * BF16
    return cfg.n_layers * cfg.n_kv * (cfg.head_dim or 0) * 2 * BF16


def state_bytes(cfg: ModelConfig) -> float:
    """Per-sequence constant state (SSM/hybrid)."""
    if cfg.family == "ssm":
        d_in = cfg.ssm_expand * cfg.d_model
        H = d_in // cfg.ssm_headdim
        return cfg.n_layers * H * cfg.ssm_state * cfg.ssm_headdim * 4
    if cfg.family == "hybrid":
        pat = cfg._layer_kinds()
        n_rec = sum(1 for k in pat if k != "attn")
        return n_rec * (cfg.lru_width or cfg.d_model) * 4
    return 0.0


def request_cost(cfg: ModelConfig, prompt_len: int, gen_len: int,
                 types=REPLICA_TYPES):
    """→ (r [2] = [slots, kv_mb], d [T] ms per replica type)."""
    n_act = cfg.active_param_count()
    kv_tok = kv_bytes_per_token(cfg)
    kv_total = kv_tok * (prompt_len + gen_len) + state_bytes(cfg)
    weights = n_act * BF16
    d = []
    for t in types:
        prefill_s = 2.0 * n_act * prompt_len / t.peak_flops
        # one decode step reads weights (amortized over slots) + this
        # request's KV; gen_len steps.
        step_s = (weights / t.slots + kv_total / 2) / t.hbm_bw
        d.append((prefill_s + gen_len * step_s) * 1e3)
    r = np.array([1.0, kv_total / 1e6], np.float32)      # [slot, MB]
    return r, np.array(d, np.float32)
