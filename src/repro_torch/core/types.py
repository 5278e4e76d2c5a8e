"""State containers of the ported slice (counterpart of ``repro.core.types``).

NamedTuples of tensors.  Conventions as in the reference: ``n`` servers,
``K`` resource dimensions (CPU cores, memory MB), durations in ms, float32.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .._device import resolve_device

RESOURCE_DIMS = 2
CPU, MEM = 0, 1


class TaskSpec(NamedTuple):
    """A batch of tasks (balls); the leading axis is the task axis."""

    r: torch.Tensor          # [m, K] demand vectors (cores, MB)
    d: torch.Tensor          # [m, n] per-server estimated durations (ms)
    submit_ms: torch.Tensor  # [m]    submission times (ms)
    task_id: torch.Tensor    # [m]    integer ids, the per-task seed (§5)

    @property
    def num_tasks(self) -> int:
        return self.r.shape[0]


class ServerState(NamedTuple):
    """Ground-truth server state: what the servers themselves know."""

    L: torch.Tensor      # [n, K] load: Σ r over uncompleted tasks (§3.1)
    D: torch.Tensor      # [n]    Σ estimated duration of uncompleted tasks
    rif: torch.Tensor    # [n]    requests in flight
    C: torch.Tensor      # [n, K] capacities (static; Table 2)

    @property
    def num_servers(self) -> int:
        return self.C.shape[0]


class SchedulerView(NamedTuple):
    """What a scheduler sees when deciding: Dodoor's cached (possibly
    stale) snapshot, pushed by the data store once per batch of ``b``."""

    L: torch.Tensor      # [n, K] cached resource loads
    D: torch.Tensor      # [n]    cached total durations
    rif: torch.Tensor    # [n]    cached requests-in-flight
    C: torch.Tensor      # [n, K] capacities (static, always fresh)


class DataStoreState(NamedTuple):
    """The central data store (§4.1): the store's view plus ``p``, the
    decisions counted in the current batch."""

    L: torch.Tensor
    D: torch.Tensor
    rif: torch.Tensor
    p: torch.Tensor      # scalar int32


class PrequalPool(NamedTuple):
    """One scheduler's Prequal probe pool (§5): ``s_pool`` fixed slots
    with a validity mask."""

    server: torch.Tensor     # [s_pool] int32 probed server
    rif: torch.Tensor        # [s_pool] float32 probed RIF
    latency: torch.Tensor    # [s_pool] float32 probed latency estimate (ms)
    age: torch.Tensor        # [s_pool] float32 probe time (oldest-first)
    valid: torch.Tensor      # [s_pool] bool


class DodoorParams(NamedTuple):
    """Tunable cluster parameters (Require line of Algorithm 1)."""

    alpha: float = 0.5      # duration weight in loadScore (§3.2)
    b: int = 50             # cache batch size (default n/2; §3.2)
    d_choices: int = 2      # power-of-d; the paper fixes d=2


class PrequalParams(NamedTuple):
    """Prequal baseline parameters — the paper's §5 settings."""

    r_probe: int = 3
    s_pool: int = 16
    q_rif: float = 0.84
    b_reuse: int = 1
    r_remove: int = 1


def make_server_state(C: torch.Tensor) -> ServerState:
    """Fresh, empty server state for capacities ``C`` [n, K] (on C's
    device)."""
    n, K = C.shape
    f32 = dict(dtype=torch.float32, device=C.device)
    return ServerState(L=torch.zeros((n, K), **f32),
                       D=torch.zeros((n,), **f32),
                       rif=torch.zeros((n,), **f32),
                       C=C.to(torch.float32))


def make_datastore(C: torch.Tensor) -> DataStoreState:
    """An empty data store for capacities ``C`` [n, K]."""
    n, K = C.shape
    f32 = dict(dtype=torch.float32, device=C.device)
    return DataStoreState(L=torch.zeros((n, K), **f32),
                          D=torch.zeros((n,), **f32),
                          rif=torch.zeros((n,), **f32),
                          p=torch.zeros((), dtype=torch.int32,
                                        device=C.device))


def make_view(state: ServerState) -> SchedulerView:
    """A view equal to the ground truth (what fresh probing returns)."""
    return SchedulerView(L=state.L, D=state.D, rif=state.rif, C=state.C)


def make_prequal_pool(s_pool: int, device=None) -> PrequalPool:
    """An empty pool of ``s_pool`` slots: +inf RIF and latency, −inf
    ages, none valid.  ``device`` defaults to the GPU."""
    dev = resolve_device(device)
    f32 = dict(dtype=torch.float32, device=dev)
    return PrequalPool(
        server=torch.zeros((s_pool,), dtype=torch.int32, device=dev),
        rif=torch.full((s_pool,), float("inf"), **f32),
        latency=torch.full((s_pool,), float("inf"), **f32),
        age=torch.full((s_pool,), float("-inf"), **f32),
        valid=torch.zeros((s_pool,), dtype=torch.bool, device=dev))
