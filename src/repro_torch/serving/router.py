"""Online Dodoor request router — the gateway-side API, counterpart of
``repro.serving.router``.

Stateful wrapper around the core Algorithm-1 policy for a live serving
gateway: keeps the scheduler-local cached view, accumulates addNewLoad
deltas, and applies data-store pushes. The fleet-wide simulation
(pool.py + sim.engine) validates the policy; this class is what a real
frontend calls per request.

The view and the store stay numpy arrays on the host; each ``place``
uploads the view and the request to ``device`` (the card unless the caller
passes ``device="cpu"``) and scores it with the port's ``dodoor_select``
under the request's task-id-seeded key, so the placements equal the
reference router's.

Failure behaviour inherits the paper's §4.3 soft-pin-out: a dead replica
stops sending overrides, its cached load only rises with new placements,
and the two-choice rule routes around it without any health-check protocol.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .._device import resolve_device
from ..core import DodoorParams, SchedulerView, dodoor_select, task_key
from ..random import PRNGKey
from ..sim.cluster import ClusterSpec
from .costs import REPLICA_TYPES, request_cost


@dataclass
class DodoorRouter:
    pool: ClusterSpec
    alpha: float = 0.5
    b: Optional[int] = None            # default n/2 (§3.2)
    seed: int = 0
    device: Optional[str] = None       # the card unless "cpu" is asked for

    def __post_init__(self):
        n = self.pool.num_servers
        self.b = self.b or max(1, n // 2)
        self._dev = resolve_device(self.device)
        self._params = DodoorParams(alpha=self.alpha, b=self.b)
        self._key = PRNGKey(self.seed, device=self._dev)
        self._C = torch.as_tensor(self.pool.C, device=self._dev)
        self._rif = torch.zeros((n,), device=self._dev)
        # scheduler-local cached view (stale by ≤ b decisions)
        self._view_L = np.zeros((n, 2), np.float32)
        self._view_D = np.zeros((n,), np.float32)
        # data-store accumulators
        self._store_L = np.zeros((n, 2), np.float32)
        self._store_D = np.zeros((n,), np.float32)
        self._p = 0
        self._req = 0

    # -- scheduling hot path (no store read, §4.1) -------------------------
    def place(self, cfg, prompt_len: int, gen_len: int) -> int:
        r, d = request_cost(cfg, prompt_len, gen_len, types=REPLICA_TYPES)
        d_full = d[self.pool.node_type]
        dev = self._dev
        view = SchedulerView(L=torch.as_tensor(self._view_L, device=dev),
                             D=torch.as_tensor(self._view_D, device=dev),
                             rif=self._rif, C=self._C)
        j = int(dodoor_select(task_key(self._key, self._req),
                              torch.as_tensor(r, device=dev),
                              torch.as_tensor(d_full, device=dev), view,
                              self._params))
        self._req += 1
        # addNewLoad delta (scheduler-side, §4.1)
        self._store_L[j] += r
        self._store_D[j] += d_full[j]
        self._p += 1
        if self._p >= self.b:                    # batch boundary → push
            self._view_L = self._store_L.copy()
            self._view_D = self._store_D.copy()
            self._p = 0
        return j

    # -- server-side override (on request completion) ----------------------
    def complete(self, j: int, r: np.ndarray, d_ms: float):
        self._store_L[j] = np.maximum(0.0, self._store_L[j] - r)
        self._store_D[j] = max(0.0, self._store_D[j] - d_ms)
