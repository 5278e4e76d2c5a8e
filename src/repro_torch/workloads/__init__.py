"""repro_torch.workloads — the Azure VM trace (§6.2) and FunctionBench
(§6.3) synthesizers and the task-graph specs (numpy-only copies of the
reference's), and the arrival processes of the scenario engine."""
from . import azure, dags, functionbench
from .arrivals import (BatchArrivals, DiurnalArrivals, OnOffArrivals,
                       PoissonArrivals, arrival_times, arrival_times_grid,
                       mean_qps, poisson_arrivals, round_robin_scheduler)
from .dags import (DAG_SPECS, ChainDAG, DagPlan, ExplicitDAG, FanOutDAG,
                   LayeredDAG, MapReduceDAG, dag_edges, dag_plan)

__all__ = ["azure", "dags", "functionbench", "poisson_arrivals",
           "round_robin_scheduler", "PoissonArrivals", "OnOffArrivals",
           "DiurnalArrivals", "BatchArrivals", "arrival_times",
           "arrival_times_grid", "mean_qps", "DAG_SPECS", "ChainDAG",
           "DagPlan", "ExplicitDAG", "FanOutDAG", "LayeredDAG",
           "MapReduceDAG", "dag_edges", "dag_plan"]
