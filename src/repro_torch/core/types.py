"""State containers of the ported slice (counterpart of ``repro.core.types``).

NamedTuples of tensors.  Conventions as in the reference: ``n`` servers,
``K`` resource dimensions (CPU cores, memory MB), durations in ms, float32.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

RESOURCE_DIMS = 2
CPU, MEM = 0, 1


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


class DodoorParams(NamedTuple):
    """Tunable cluster parameters (Require line of Algorithm 1)."""

    alpha: float = 0.5      # duration weight in loadScore (§3.2)
    b: int = 50             # cache batch size (default n/2; §3.2)
    d_choices: int = 2      # power-of-d; the paper fixes d=2


class PrequalParams(NamedTuple):
    """Prequal baseline parameters — the paper's §5 settings.  The port
    carries them for the engine config; the Prequal policy itself is not
    ported yet."""

    r_probe: int = 3
    s_pool: int = 16
    q_rif: float = 0.84
    b_reuse: int = 1
    r_remove: int = 1
