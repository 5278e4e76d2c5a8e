"""repro_torch.core — Dodoor scheduling (Algorithm 1), the capacity
prefilter, the RL load score and the b-batched cache protocol, on torch
tensors.  Counterpart of ``repro.core``."""
from .types import (CPU, MEM, RESOURCE_DIMS, DataStoreState, DodoorParams,
                    PrequalParams, SchedulerView)
from .rl_score import (load_score_batched, load_score_pair, rl,
                       rl_score_matrix)
from .prefilter import feasible_mask, sample_feasible, sample_feasible_batch
from .policies import (dodoor_choice_batch, dodoor_select,
                       dodoor_select_batch, one_plus_beta_select,
                       random_select, task_key)
from . import cache

__all__ = ["CPU", "MEM", "RESOURCE_DIMS", "DataStoreState", "DodoorParams",
           "PrequalParams", "SchedulerView", "load_score_batched",
           "load_score_pair", "rl", "rl_score_matrix", "feasible_mask",
           "sample_feasible", "sample_feasible_batch", "dodoor_choice_batch",
           "dodoor_select", "dodoor_select_batch", "one_plus_beta_select",
           "random_select", "task_key", "cache"]
