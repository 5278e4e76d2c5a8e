"""The b-batched load-cache protocol (§3.1, §4.1) — counterpart of
``repro.core.cache``.

Schedulers report placements to the data store (``add_new_load``),
servers override their stored vector on completion
(``override_node_state``), and every ``b`` decisions the store pushes its
whole view to every scheduler (``tick`` / ``snapshot`` / ``push_if``).
These are the per-decision helpers whose block form the batched engine's
flush-and-push step implements.  They return new states and leave their
inputs untouched, as the reference's do.
"""
from __future__ import annotations

import torch

from .types import DataStoreState, SchedulerView, ServerState


def add_new_load(store: DataStoreState, j, r, d_ij) -> DataStoreState:
    """Scheduler-side delta: a task with demand r and duration d_ij
    placed on server j."""
    L, D, rif = store.L.clone(), store.D.clone(), store.rif.clone()
    L[j] += r
    D[j] += d_ij
    rif[j] += 1.0
    return store._replace(L=L, D=D, rif=rif)


def override_node_state(store: DataStoreState, j, L_j, D_j,
                        rif_j) -> DataStoreState:
    """Server-side override: replace the stored vector with the server's
    own (sent when tasks complete)."""
    L, D, rif = store.L.clone(), store.D.clone(), store.rif.clone()
    L[j], D[j], rif[j] = L_j, D_j, rif_j
    return store._replace(L=L, D=D, rif=rif)


def tick(store: DataStoreState, b: int):
    """Count one decision; p ≡ (p+1) mod b.  Returns (store, push?)."""
    p = store.p + 1
    push = p >= b
    return store._replace(p=torch.where(push, torch.zeros_like(p), p)), push


def snapshot(store: DataStoreState, C: torch.Tensor) -> SchedulerView:
    """The view pushed to schedulers at a batch boundary."""
    return SchedulerView(L=store.L, D=store.D, rif=store.rif, C=C)


def push_if(push, store: DataStoreState,
            view: SchedulerView) -> SchedulerView:
    """Refresh a scheduler's cache when a push fired (Algorithm 1,
    lines 13-15)."""
    return SchedulerView(L=torch.where(push, store.L, view.L),
                         D=torch.where(push, store.D, view.D),
                         rif=torch.where(push, store.rif, view.rif),
                         C=view.C)


def store_from_truth(state: ServerState) -> DataStoreState:
    """A store rebuilt from the servers' overrides (recovery, §4.3)."""
    return DataStoreState(L=state.L, D=state.D, rif=state.rif,
                          p=torch.zeros((), dtype=torch.int32,
                                        device=state.L.device))


def default_batch_size(n_servers: int) -> int:
    """Paper default: b = n/2 (§3.2)."""
    return max(1, n_servers // 2)


def scheduler_minibatch(b: int, num_schedulers: int) -> int:
    """addNewLoad mini-batch bound: ≤ b / num_schedulers · 2 (§4.1)."""
    return max(1, (b // max(num_schedulers, 1)) * 2)
