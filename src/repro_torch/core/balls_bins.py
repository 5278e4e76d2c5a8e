"""Balls-into-bins processes (§2.1), the theory behind Dodoor —
counterpart of ``repro.core.balls_bins``.

* single choice                      — gap Θ(√(m·log n / n))
* power-of-d choices (d = 2 default) — gap Θ(log log n / log d)
* (1+β) process                      — gap Θ(log n / β) (weighted)
* weighted variants of all the above
* b-batched variants                 — the chooser's view of the loads
  refreshes once per batch of b placements (Los & Sauerwald, SPAA'23:
  gap Θ(b/n) for b = Θ(n log n); (1+β) improves it to O(√(b/n · log n)))

Dodoor itself is the weighted b-batched power-of-two process with the RL
score as the load measure.  The draws are the reference's, from
:mod:`repro_torch.random`, so the final loads equal its bit for bit.
"""
from __future__ import annotations

import math

import torch

from ..random import fold_in, randint, split, uniform


def gap(loads: torch.Tensor) -> torch.Tensor:
    """max load − mean load (the quantity every §2.1 bound speaks about).
    The mean's summation order is torch's, so it may differ from the
    reference's in the last bit."""
    return loads.max() - loads.mean()


def run_balls_into_bins(key: torch.Tensor, weights, n: int, d: int = 2,
                        beta: float = 1.0, batch: int = 1) -> torch.Tensor:
    """Throw m (possibly weighted) balls into n bins; returns the final
    float32 loads [n] on the key's device.

    Ball ``i`` draws ``d`` bins with ``randint(split(fold_in(key, i))[0])``
    and, with probability ``beta`` (a uniform from the second half of the
    split), takes the least loaded of them in the chooser's *stale* view
    (the first on ties), else the first.  The view refreshes to the true
    loads every ``batch`` balls (``batch = 1``: always fresh).  The draws
    are made for all balls at once; the placements then run in order on
    the key's device in float32, as the reference's scan adds them, with
    one-element index tensors so that the loop never reads the device."""
    dev = key.device
    w = torch.as_tensor(weights, dtype=torch.float32).to(dev)
    m = w.shape[0]
    keys = fold_in(key, torch.arange(m, device=dev))
    kk = split(keys)
    cand = randint(kk[:, 0, :], (d,), 0, n).long()                # [m, d]
    use_multi = uniform(kk[:, 1, :]) < torch.tensor(
        beta, dtype=torch.float32, device=dev)
    loads = torch.zeros(n, dtype=torch.float32, device=dev)
    stale = torch.zeros_like(loads)
    batch = max(int(batch), 1)
    for i in range(m):
        c = cand[i]
        least = c.gather(0, stale[c].argmin().view(1))
        j = torch.where(use_multi[i], least, c[:1])
        loads.index_add_(0, j, w[i:i + 1])
        if (i + 1) % batch == 0:
            stale.copy_(loads)
    return loads


def single_choice_gap_bound(m: int, n: int) -> float:
    """Θ(√(m log n / n)) — the single-choice high-probability gap scale."""
    return math.sqrt(m * math.log(max(n, 2)) / n)


def power_of_d_gap_bound(n: int, d: int = 2) -> float:
    """Θ(log log n / log d) — the power-of-d gap scale (m-independent)."""
    return math.log(math.log(max(n, 3))) / math.log(max(d, 2))


def batched_gap_bound(b: int, n: int) -> float:
    """Θ(b/n) for b = Ω(n log n) (Los & Sauerwald 2023)."""
    return b / n


def one_plus_beta_batched_gap_bound(b: int, n: int) -> float:
    """O(√(b/n · log n)) for the (1+β) process with tuned β."""
    return math.sqrt(b / n * math.log(max(n, 2)))


def tuned_beta(b: int, n: int) -> float:
    """β on the order of √(n/b · log n), clipped into (0, 1]."""
    return float(min(1.0, math.sqrt(n / b * math.log(max(n, 2)))))
