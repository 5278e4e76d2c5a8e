"""repro_torch.core — Dodoor scheduling (Algorithm 1), the capacity
prefilter, the RL load score, the b-batched cache protocol and the
balls-into-bins theory, on torch tensors.  Counterpart of ``repro.core``."""
from .types import (CPU, MEM, RESOURCE_DIMS, DataStoreState, DodoorParams,
                    PrequalParams, PrequalPool, SchedulerView, ServerState,
                    TaskSpec, make_datastore, make_prequal_pool,
                    make_server_state, make_view)
from .rl_score import (load_score_batched, load_score_pair, rl,
                       rl_score_matrix)
from .prefilter import feasible_mask, sample_feasible, sample_feasible_batch
from .policies import (POLICIES, POLICY_VIEW, dodoor_choice_batch,
                       dodoor_select, dodoor_select_batch,
                       one_plus_beta_select, pot_select,
                       prequal_probe_update, prequal_select, random_select,
                       task_key)
from . import balls_bins, cache

__all__ = [
    "CPU", "MEM", "RESOURCE_DIMS",
    "DataStoreState", "DodoorParams", "PrequalParams", "PrequalPool",
    "SchedulerView", "ServerState", "TaskSpec",
    "make_datastore", "make_prequal_pool", "make_server_state", "make_view",
    "load_score_batched", "load_score_pair", "rl", "rl_score_matrix",
    "feasible_mask", "sample_feasible", "sample_feasible_batch",
    "POLICIES", "POLICY_VIEW",
    "dodoor_choice_batch", "dodoor_select", "dodoor_select_batch",
    "one_plus_beta_select",
    "pot_select", "prequal_probe_update", "prequal_select", "random_select",
    "task_key", "balls_bins", "cache",
]
