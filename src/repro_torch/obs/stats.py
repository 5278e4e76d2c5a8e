"""Numpy roll-ups of the per-decision telemetry planes.

The engine (``EngineConfig.trace``) records raw per-decision planes; this
module reduces them to the scalar summary a bench row or dashboard cell
wants.  Pure numpy — no torch import — so host-side tooling can consume
committed artifacts without a device runtime.
"""
from __future__ import annotations

import numpy as np

#: The scalar fields :func:`decision_stats` emits, in order — the bench
#: artifact schema (``BENCH_obs.json`` rows) and the dashboard both key on
#: these names.
TRACE_STAT_FIELDS = (
    "decisions",
    "staleness_mean_ms",
    "staleness_p99_ms",
    "view_err_mean",
    "misplacement_rate",
    "cache_pushes",
    "sched_p50_ms",
    "sched_p95_ms",
    "sched_p99_ms",
)


def latency_stats(res) -> dict:
    """Per-decision scheduling-latency percentiles from ``sched_ms``.

    Works on any :class:`~repro_torch.sim.SimResult` — the latency plane has
    always existed; ``trace`` is not required.
    """
    s = np.asarray(res.sched_ms, np.float64)
    if s.size == 0:
        return {"sched_p50_ms": 0.0, "sched_p95_ms": 0.0,
                "sched_p99_ms": 0.0}
    p50, p95, p99 = np.percentile(s, (50.0, 95.0, 99.0))
    return {"sched_p50_ms": float(p50), "sched_p95_ms": float(p95),
            "sched_p99_ms": float(p99)}


def decision_stats(res) -> dict:
    """Roll one traced run up to the staleness/misplacement scalars.

    Requires a run made with ``EngineConfig(trace=True)`` — raises
    ``ValueError`` otherwise (the planes are ``None``).  For the probing
    policies (random/pot/prequal) the engine records all-zero planes:
    there is no cached snapshot to be stale, so staleness, view error,
    and misplacement legitimately read 0.

    Returns a dict with exactly the :data:`TRACE_STAT_FIELDS` keys:

    * ``decisions`` — number of per-decision records (``m``);
    * ``staleness_mean_ms`` / ``staleness_p99_ms`` — cache-snapshot age
      at the decision (ms since the content timestamp of the last push
      *delivered to the deciding scheduler*; CacheFaults loss keeps the
      old timestamp, delay backdates it);
    * ``view_err_mean`` — mean L1 gap between the cached rif column and
      ground truth over each decision's sampled candidates;
    * ``misplacement_rate`` — fraction of decisions where ground truth
      would have picked the other candidate;
    * ``cache_pushes`` — store pushes that fired during the run;
    * ``sched_p50/95/99_ms`` — scheduling-latency percentiles (same
      numbers as :func:`latency_stats`).
    """
    if res.view_age_ms is None:
        raise ValueError(
            "decision_stats needs a traced run — simulate with "
            "EngineConfig(trace=True)")
    age = np.asarray(res.view_age_ms, np.float64)
    out = {
        "decisions": int(age.size),
        "staleness_mean_ms": float(age.mean()) if age.size else 0.0,
        "staleness_p99_ms": (float(np.percentile(age, 99.0))
                             if age.size else 0.0),
        "view_err_mean": float(np.asarray(res.view_err,
                                          np.float64).mean())
                         if age.size else 0.0,
        "misplacement_rate": float(np.asarray(res.misplaced,
                                              np.float64).mean())
                             if age.size else 0.0,
        "cache_pushes": int(np.asarray(res.cache_push).sum()),
    }
    out.update(latency_stats(res))
    return out
