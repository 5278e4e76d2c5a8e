"""Failure injection for the training loop — a copy of the JAX package's
``ft/failures.py``, which imports nothing of JAX.

Deterministic schedule of simulated host failures; the trainer consults
``should_fail(step)`` and exercises the full recovery path: abort step →
checkpoint restore → survivor mesh → reshard → resume. The paper's §4.3
soft-pin-out observation carries over: a failed *serving* replica is never
unregistered explicitly — its cached load only grows, so the Dodoor router
stops selecting it (see repro_torch.serving)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple


@dataclass
class FailureInjector:
    """fail_at: [(step, n_data_slices_lost)], applied once each."""

    fail_at: List[Tuple[int, int]] = field(default_factory=list)
    _fired: set = field(default_factory=set)

    def should_fail(self, step: int):
        for s, n in self.fail_at:
            if s == step and s not in self._fired:
                self._fired.add(s)
                return n
        return 0
