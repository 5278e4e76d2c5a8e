"""Replica pools and request traces as engine inputs — a copy of
``repro.serving.pool``, which imports only numpy.

The serving problem maps onto the §6 simulation engine exactly: replicas
are servers (bins), requests are tasks (balls), decode slots are "cores",
KV HBM is "memory", and the per-type duration vector comes from the request
cost model. This reuse means every scheduling policy, the b-batched data
store, the message accounting and the latency model are shared — Dodoor as
a serving router is the same validated code path as the paper reproduction.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..configs.base import ModelConfig
from ..sim.cluster import ClusterSpec
from .costs import REPLICA_TYPES, request_cost


def make_replica_pool(types=REPLICA_TYPES, interleave: bool = True
                      ) -> ClusterSpec:
    """ClusterSpec over replicas: C = [decode slots, KV-HBM MB]."""
    rows, tids = [], []
    for i, t in enumerate(types):
        for _ in range(t.count):
            rows.append((t.slots, t.hbm_bytes / 1e6))
            tids.append(i)
    C = np.asarray(rows, np.float32)
    tid = np.asarray(tids, np.int32)
    if interleave:
        rng = np.random.RandomState(0)
        perm = rng.permutation(len(tids))
        C, tid = C[perm], tid[perm]
    return ClusterSpec(C=C, node_type=tid,
                       type_names=tuple(t.name for t in types))


@dataclass(frozen=True)
class RequestTrace:
    r_submit: np.ndarray     # [m, 2]
    r_exec: np.ndarray       # [m, T, 2]
    d_est: np.ndarray        # [m, T]
    d_act: np.ndarray        # [m, T]
    task_type: np.ndarray    # [m] bucket id (for reporting)
    submit_ms: np.ndarray    # [m]
    prompt_len: np.ndarray   # [m]
    gen_len: np.ndarray      # [m]


# (prompt, gen) buckets — chat / RAG / summarize / code-complete mixtures.
_BUCKETS = ((256, 128), (1024, 256), (4096, 256), (8192, 128),
            (512, 1024), (2048, 64))


def synthesize_requests(cfg: ModelConfig, m: int, qps: float, *,
                        types=REPLICA_TYPES, seed: int = 0,
                        noise: float = 0.25) -> RequestTrace:
    rng = np.random.RandomState(seed)
    bucket = rng.randint(0, len(_BUCKETS), size=m)
    plen = np.array([_BUCKETS[b][0] for b in bucket], np.int32)
    glen = np.array([_BUCKETS[b][1] for b in bucket], np.int32)
    plen = (plen * np.exp(rng.normal(0, 0.3, m))).astype(np.int32) + 16
    glen = (glen * np.exp(rng.normal(0, 0.3, m))).astype(np.int32) + 4

    T = len(types)
    r = np.zeros((m, 2), np.float32)
    d = np.zeros((m, T), np.float32)
    for i in range(m):
        r[i], d[i] = request_cost(cfg, int(plen[i]), int(glen[i]), types)
    d_act = d * np.exp(rng.normal(0, noise, size=(m, 1))).astype(np.float32)
    submit = np.cumsum(rng.exponential(1000.0 / qps, size=m)
                       ).astype(np.float32)
    return RequestTrace(
        r_submit=r, r_exec=np.repeat(r[:, None, :], T, axis=1),
        d_est=d, d_act=d_act.astype(np.float32),
        task_type=bucket.astype(np.int32), submit_ms=submit,
        prompt_len=plen, gen_len=glen)
