"""Latency accounting for the decision service — a copy of
``repro.serve.latency``, which imports only numpy.

One :class:`LatencyRecorder` per metric (per-decision scheduling latency,
per-step wall clock): raw samples in milliseconds, summarized as
p50/p95/p99 and bucketed into a log-spaced histogram — the shape the
reference's serving benchmark persists.

Pure numpy: recording happens on the host, on the serving hot path's
timing side.
"""
from __future__ import annotations

import numpy as np


class LatencyRecorder:
    """Append-only sample store with percentile + histogram views."""

    def __init__(self):
        self._chunks: list[np.ndarray] = []

    def record(self, samples_ms) -> None:
        a = np.atleast_1d(np.asarray(samples_ms, np.float64))
        if a.size:
            self._chunks.append(a)

    @property
    def count(self) -> int:
        return int(sum(c.size for c in self._chunks))

    def samples(self) -> np.ndarray:
        if not self._chunks:
            return np.zeros((0,), np.float64)
        return np.concatenate(self._chunks)

    def percentile(self, q: float) -> float:
        s = self.samples()
        return float(np.percentile(s, q)) if s.size else float("nan")

    def summary(self) -> dict:
        """``count`` plus mean/p50/p95/p99/max in ms (rounded for the
        bench artifact)."""
        s = self.samples()
        if not s.size:
            return {"count": 0}
        return {
            "count": int(s.size),
            "mean_ms": round(float(np.mean(s)), 4),
            "p50_ms": round(float(np.percentile(s, 50.0)), 4),
            "p95_ms": round(float(np.percentile(s, 95.0)), 4),
            "p99_ms": round(float(np.percentile(s, 99.0)), 4),
            "max_ms": round(float(np.max(s)), 4),
        }

    def histogram(self, nbins: int = 24) -> dict:
        """Log-spaced buckets over the observed range: ``edges_ms`` has
        ``nbins + 1`` entries, ``counts`` has ``nbins``.  Degenerate
        ranges (all samples equal) widen to a ±10% band so the buckets
        stay well-formed."""
        s = self.samples()
        if not s.size:
            return {"edges_ms": [], "counts": []}
        lo = max(float(np.min(s)), 1e-6)
        hi = max(float(np.max(s)), lo)
        if hi <= lo:
            lo, hi = lo * 0.9, hi * 1.1
        edges = np.logspace(np.log10(lo), np.log10(hi), nbins + 1)
        # 10**log10(x) can round below x: pin the ends to the observed
        # range, so the largest sample is counted.
        edges[0], edges[-1] = lo, hi
        counts, _ = np.histogram(s, bins=edges)
        return {"edges_ms": [round(float(e), 6) for e in edges],
                "counts": [int(c) for c in counts]}
