"""Straggler mitigation via the paper's own machinery — a copy of the JAX
package's ``ft/stragglers.py`` (numpy only).

The Dodoor data-store/load-cache pattern is reused verbatim for training-
time straggler detection: every host reports its per-step wall time as a
"load" to a (simulated) store, pushed in batches of ``b`` steps. A host
whose cached duration signal drifts above ``threshold ×`` the cluster median
is flagged; the runner's response is configurable — re-balance input shards
away from it (data-pipeline skip-ahead) or trigger the elastic path. This
is the paper's anti-affinity idea with one resource dimension = step time.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class StragglerMonitor:
    num_hosts: int
    b: int = 8                    # cache push batch (steps)
    threshold: float = 1.5
    _window: list = field(default_factory=list)
    _cached: np.ndarray = None    # the stale view (pushed per batch)

    def __post_init__(self):
        self._cached = np.zeros((self.num_hosts,))

    def report(self, step: int, per_host_seconds: np.ndarray):
        """Record one step's per-host durations; push cache each b steps."""
        self._window.append(np.asarray(per_host_seconds))
        if len(self._window) >= self.b:
            self._cached = np.mean(self._window, axis=0)
            self._window.clear()

    def stragglers(self):
        """Host ids whose cached step time exceeds threshold × median."""
        if not np.any(self._cached > 0):
            return np.array([], np.int64)
        med = np.median(self._cached[self._cached > 0])
        return np.where(self._cached > self.threshold * med)[0]

    def weights(self):
        """Data-shard weights ∝ 1/cached-duration (skip-ahead rebalance)."""
        c = np.where(self._cached > 0, self._cached, np.median(
            self._cached[self._cached > 0]) if np.any(self._cached > 0)
            else 1.0)
        w = 1.0 / c
        return w / w.sum()
