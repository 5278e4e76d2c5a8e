"""repro_torch.sim — cluster models (the Table-2 testbed and scaled
fleets), the batched decision-block engine and the sequential oracle with
server dynamics, cache faults, task graphs, retries and decision-trace
telemetry, message accounting, metrics, the study planner (seeds ×
configs × scenarios) with its sweep and scenario wrappers, hierarchical
mini-clusters, the mean-field predictor and carry conversion.
Counterpart of ``repro.sim``; it exports the same names except
``resolve_use_kernel``, which has no meaning in the port."""
from .cluster import (CMAX, NODE_TYPES, TESTBED_TYPES, ClusterSpec,
                      make_homogeneous, make_scaled, make_testbed)
from .engine import (CacheFaults, Dynamics, EngineConfig, LocalityModel,
                     RetryPolicy, SimResult, simulate)
from .hierarchy import simulate_hierarchical, split_cluster
from .meanfield import (MeanFieldPrediction, het_pod_equilibrium,
                        make_service_workload, measured_mean_queue,
                        one_plus_beta_mean_queue, one_plus_beta_tail,
                        pod_mean_queue, pod_tail, predict_pod,
                        tolerance_band)
from .messages import (RpcModel, cache_messages_per_decision,
                       expected_messages_per_task, per_decision_messages,
                       sync_hops)
from .metrics import (Summary, dag_stats, fault_stats, mean_in_system,
                      phase_summaries, resource_violations, summarize,
                      summarize_dag, summarize_window, time_to_recover_ms,
                      utilization_stats, utilization_timeline)
from .scenarios import (Scenario, ScenarioSweep, random_churn,
                        random_outages, random_stragglers, rolling_restart,
                        run_scenario, run_scenario_grid, scenario_workload)
from .state import carry_from_numpy, carry_to_numpy
from .study import Study, StudyResult, run_study, summarize_study
from .sweep import (SummaryCI, SweepResult, aggregate_summaries,
                    simulate_many, summarize_sweep)

__all__ = [
    "CMAX", "NODE_TYPES", "TESTBED_TYPES", "ClusterSpec", "make_homogeneous",
    "make_scaled", "make_testbed", "CacheFaults", "Dynamics", "EngineConfig",
    "LocalityModel", "RetryPolicy", "SimResult", "simulate",
    "simulate_hierarchical", "split_cluster", "RpcModel",
    "cache_messages_per_decision", "expected_messages_per_task",
    "per_decision_messages", "sync_hops", "Summary", "dag_stats",
    "fault_stats", "mean_in_system", "phase_summaries",
    "resource_violations", "summarize", "summarize_dag", "summarize_window",
    "time_to_recover_ms", "utilization_stats", "utilization_timeline",
    "SummaryCI", "SweepResult", "aggregate_summaries", "simulate_many",
    "summarize_sweep", "MeanFieldPrediction", "het_pod_equilibrium",
    "make_service_workload", "measured_mean_queue",
    "one_plus_beta_mean_queue", "one_plus_beta_tail", "pod_mean_queue",
    "pod_tail", "predict_pod", "tolerance_band", "Scenario",
    "ScenarioSweep", "random_churn", "random_outages", "random_stragglers",
    "rolling_restart", "run_scenario", "run_scenario_grid",
    "scenario_workload", "Study", "StudyResult", "run_study",
    "summarize_study", "carry_from_numpy", "carry_to_numpy",
]
