"""repro_torch.sim — cluster models, the batched decision-block engine
and the sequential oracle with server dynamics, task graphs and retries,
the scenario engine,
message accounting, metrics and carry conversion.  Counterpart of
``repro.sim`` for the ported slices."""
from .cluster import (CMAX, NODE_TYPES, TESTBED_TYPES, ClusterSpec,
                      make_homogeneous, make_scaled, make_testbed)
from .engine import (CacheFaults, Dynamics, EngineConfig, LocalityModel,
                     RetryPolicy, SimResult, simulate)
from .messages import (RpcModel, cache_messages_per_decision,
                       expected_messages_per_task, per_decision_messages)
from .metrics import (Summary, dag_stats, fault_stats, mean_in_system,
                      phase_summaries, resource_violations, summarize,
                      summarize_dag, summarize_window, time_to_recover_ms,
                      utilization_stats)
from .scenarios import (Scenario, random_churn, random_outages,
                        random_stragglers, rolling_restart, run_scenario,
                        run_scenario_grid, scenario_workload)
from .state import carry_from_numpy, carry_to_numpy

__all__ = ["CMAX", "NODE_TYPES", "TESTBED_TYPES", "ClusterSpec",
           "make_homogeneous", "make_scaled", "make_testbed",
           "CacheFaults", "Dynamics", "EngineConfig", "LocalityModel",
           "RetryPolicy", "SimResult", "simulate", "RpcModel",
           "cache_messages_per_decision", "expected_messages_per_task",
           "per_decision_messages", "Summary", "dag_stats", "fault_stats",
           "mean_in_system", "phase_summaries", "resource_violations",
           "summarize", "summarize_dag", "summarize_window",
           "time_to_recover_ms", "utilization_stats", "Scenario",
           "random_churn", "random_outages", "random_stragglers",
           "rolling_restart", "run_scenario", "run_scenario_grid",
           "scenario_workload", "carry_from_numpy", "carry_to_numpy"]
