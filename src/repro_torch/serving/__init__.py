"""repro_torch.serving — Dodoor as a request router over a heterogeneous
replica fleet, counterpart of ``repro.serving``: the per-architecture
request cost model, replica pools and request traces as engine inputs
(numpy copies), and the online router ``DodoorRouter`` over the port's
``dodoor_select``."""
from .costs import ReplicaType, REPLICA_TYPES, request_cost
from .pool import make_replica_pool, synthesize_requests
from .router import DodoorRouter

__all__ = ["ReplicaType", "REPLICA_TYPES", "request_cost",
           "make_replica_pool", "synthesize_requests", "DodoorRouter"]
