"""repro_torch.serve — the streaming decision service, counterpart of
``repro.serve``.

Arrival chunks flow through a host-side ring buffer, are re-blocked into
``b``-task decision blocks, and drive one call of the batched driver's
block step per block on a carry that stays on the device, so replaying
the same arrival plane through the service is bit-exact with
``simulate(mode="batched")`` for every policy — the offline engine is the
online engine's correctness oracle.
"""
from .latency import LatencyRecorder
from .ring import ArrivalRing, ArrivalRows
from .service import DecisionService, serve_workload

__all__ = ["ArrivalRing", "ArrivalRows", "DecisionService",
           "LatencyRecorder", "serve_workload"]
