"""repro_torch.obs — decision-trace observability, a copy of ``repro.obs``
(see docs/OBSERVABILITY.md).

Three pillars:

* in-engine decision telemetry (``EngineConfig.trace``): per-decision
  cache-snapshot age, view error, misplacement, and push planes on
  :class:`repro_torch.sim.SimResult`;
* :func:`repro_torch.obs.stats.decision_stats` — numpy roll-up into staleness /
  misplacement / scheduling-latency percentiles;
* :func:`repro_torch.obs.trace.to_chrome_trace` — Chrome trace-event JSON
  (viewable in Perfetto / ``chrome://tracing``) of task lifecycles, one
  track per server plus scheduler tracks.

Everything here is numpy-only post-processing: importing ``repro_torch.obs``
never imports torch, so it is safe from host-side tooling (the bench
dashboard, CI scripts) without pulling in a device runtime.
"""
from .stats import TRACE_STAT_FIELDS, decision_stats, latency_stats
from .trace import to_chrome_trace

__all__ = [
    "TRACE_STAT_FIELDS",
    "decision_stats",
    "latency_stats",
    "to_chrome_trace",
]
