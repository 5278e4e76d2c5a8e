"""repro_torch.sim — cluster models, the batched decision-block engine,
message accounting, metrics and carry conversion.  Counterpart of
``repro.sim`` for the ported slice."""
from .cluster import (CMAX, NODE_TYPES, TESTBED_TYPES, ClusterSpec,
                      make_homogeneous, make_scaled, make_testbed)
from .engine import EngineConfig, SimResult, simulate
from .messages import (RpcModel, cache_messages_per_decision,
                       expected_messages_per_task, per_decision_messages)
from .metrics import Summary, resource_violations, summarize
from .state import carry_from_numpy, carry_to_numpy

__all__ = ["CMAX", "NODE_TYPES", "TESTBED_TYPES", "ClusterSpec",
           "make_homogeneous", "make_scaled", "make_testbed",
           "EngineConfig", "SimResult", "simulate", "RpcModel",
           "cache_messages_per_decision", "expected_messages_per_task",
           "per_decision_messages", "Summary", "resource_violations",
           "summarize", "carry_from_numpy", "carry_to_numpy"]
