"""repro_torch.sim.meanfield — a copy of ``repro.sim.meanfield``: power-of-d mean-field (balls-into-bins)
equilibrium predictions for validating the simulator at n = 10³–10⁴.

The ROADMAP's scale item asks that `make_scaled` fleets reproduce the
mean-field predictions for heterogeneous power-of-d systems (Mukhopadhyay
et al., arXiv:1502.05786; Moaddeli et al., arXiv:1904.00447).  This module
computes those predictions and the tolerance band a finite-n, b-batched
simulation is expected to land in:

* **Homogeneous JSQ(d)** (classic Mitzenmacher/Vvedenskaya): the
  stationary tail of a single queue under Poisson-λ arrivals per server,
  Exp(1) service, d uniform choices, join-shortest-queue is

      s_k = P(Q ≥ k) = λ^((dᵏ − 1)/(d − 1)),

  so the mean queue length is Σ_{k≥1} s_k — a doubly-exponential tail,
  the "power of two choices" effect.

* **Heterogeneous JSQ(d)** (Mukhopadhyay et al.): with server classes c
  (fraction γ_c, service rate μ_c) sampled uniformly, the per-class tails
  x_{c,k} = P(Q_c ≥ k) solve the coupled mean-field ODE

      ẋ_{c,k} = λ·g_k·(x_{c,k−1} − x_{c,k}) − μ_c·(x_{c,k} − x_{c,k+1}),
      g_k = (y_{k−1}^d − y_k^d)/(y_{k−1} − y_k),   y_k = Σ_c γ_c x_{c,k}

  (an arrival lands on a *specific* server with queue exactly k−1 with
  probability proportional to the chance all d samples have ≥ k−1 but not
  all ≥ k; uniform sampling splits that flow across classes by their
  share of level-(k−1) servers).  :func:`het_pod_equilibrium` integrates
  this to its fixed point; with one class it collapses to the closed form
  (a property pinned in ``tests/test_meanfield.py``).

* **(1+β)-choices** (Mitzenmacher; tail bounds for the heterogeneous
  case in Moaddeli et al.): one sample w.p. 1−β, two w.p. β — the
  fractional interpolation the engine's ``one_plus_beta`` policy ablates.
  :func:`one_plus_beta_tail` solves the interpolated fixed point
  s_k = λ·s_{k−1}·((1−β) + β·s_{k−1}), collapsing to M/M/1 at β=0 and to
  JSQ(2) at β=1.

The matching simulation setup is built by :func:`make_service_workload`:
full-capacity demands (one task in service per server → per-server FCFS
queues), Exp durations, Poisson arrivals — under which the engine's PoT
policy *is* JSQ(2) on queue length, and dodoor is JSQ(2) on a b-batched
stale view (the staleness widens the band — :func:`tolerance_band`).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from .cluster import ClusterSpec
from .metrics import mean_in_system

# NOTE: repro_torch.workloads.functionbench imports repro_torch.sim.cluster,
# and this module is imported by repro_torch.sim/__init__ — importing
# workloads at module level would close an import cycle (breaking `import
# repro_torch.workloads` as an entrypoint), so the workload types are
# imported inside the builder.


def pod_tail(lam: float, d: int = 2, kmax: int = 64) -> np.ndarray:
    """[kmax+1] homogeneous JSQ(d) stationary tail, s_k = P(Q ≥ k)."""
    if not 0.0 < lam < 1.0:
        raise ValueError(f"lam={lam} must be in (0, 1)")
    if d < 1:
        raise ValueError(f"d={d} must be ≥ 1")
    k = np.arange(kmax + 1, dtype=np.float64)
    expo = k if d == 1 else (np.power(float(d), k) - 1.0) / (d - 1)
    return np.exp(expo * np.log(lam))


def pod_mean_queue(lam: float, d: int = 2, kmax: int = 64) -> float:
    """Mean queue length (incl. in service) per server, homogeneous JSQ(d)."""
    return float(pod_tail(lam, d, kmax)[1:].sum())


def one_plus_beta_tail(lam: float, beta: float,
                       kmax: int = 512) -> np.ndarray:
    """[kmax+1] stationary tail of the ``(1+β)``-choices system
    (Mitzenmacher's (1+β) process; the fractional-d interpolation whose
    heterogeneous-server tail bounds Moaddeli et al., arXiv:1904.00447,
    analyze): each arrival samples one queue w.p. 1−β and two w.p. β,
    joining the shorter.  The mean-field fixed point interpolates the
    d=1/d=2 flow balances:

        s_k = λ · s_{k−1} · ((1−β) + β · s_{k−1}),   s_0 = 1,

    collapsing to the M/M/1 geometric tail λᵏ at β=0 and to the JSQ(2)
    doubly-exponential tail λ^(2ᵏ−1) at β=1 (both pinned in
    ``tests/test_meanfield.py``).  The tail is a *lower bound on the
    improvement* of full d=2: doubly-exponential decay kicks in only past
    the level where βs_{k−1} dominates 1−β, so the asymptotic ratio is
    geometric with rate λ(1−β) — the qualitative claim the engine's
    ``one_plus_beta`` policy ablates."""
    if not 0.0 < lam < 1.0:
        raise ValueError(f"lam={lam} must be in (0, 1)")
    if not 0.0 <= beta <= 1.0:
        raise ValueError(f"beta={beta} must be in [0, 1]")
    s = np.empty(kmax + 1, np.float64)
    s[0] = 1.0
    for k in range(1, kmax + 1):
        s[k] = lam * s[k - 1] * ((1.0 - beta) + beta * s[k - 1])
    return s


def one_plus_beta_mean_queue(lam: float, beta: float,
                             kmax: int = 4096) -> float:
    """Mean queue length per server under ``(1+β)``-choices: the sum of
    the :func:`one_plus_beta_tail`, continued past ``kmax`` until the
    remaining geometric-rate-λ(1−β) tail is negligible — so the value is
    accurate even at loads near saturation (e.g. β=0, λ=0.999, where a
    fixed truncation would silently drop percent-level mass)."""
    s = one_plus_beta_tail(lam, beta, kmax)
    total = float(s[1:].sum())
    last = float(s[-1])
    # Continue the recursion scalar-wise; the ratio is ≤ λ, so this
    # terminates quickly except exactly at the unreachable λ=1 boundary.
    while last > 1e-15 * max(total, 1.0):
        last = lam * last * ((1.0 - beta) + beta * last)
        total += last
    return total


def het_pod_equilibrium(gammas, mus, lam: float, d: int = 2,
                        kmax: int = 48, dt: float = 0.02,
                        tol: float = 1e-10,
                        max_steps: int = 400_000) -> np.ndarray:
    """Fixed point of the heterogeneous JSQ(d) mean-field ODE.

    gammas: [C] class fractions (sum 1); mus: [C] service rates; lam:
    arrival rate per server — all in the same time unit.  Returns
    ``x[C, kmax+1]`` with ``x[c, k] = P(Q_c ≥ k)`` (``x[:, 0] = 1``).
    """
    gam = np.asarray(gammas, np.float64)
    mu = np.asarray(mus, np.float64)
    if gam.ndim != 1 or gam.shape != mu.shape or (gam < 0).any():
        raise ValueError("gammas/mus must be matching 1-D non-negative")
    gam = gam / gam.sum()
    cap = float(gam @ mu)
    if not 0.0 < lam < cap:
        raise ValueError(f"unstable: lam={lam} ≥ fleet capacity {cap}")

    C = gam.shape[0]
    x = np.zeros((C, kmax + 2), np.float64)
    x[:, 0] = 1.0
    x[:, 1] = lam / cap          # warm start near the offered load
    for _ in range(max_steps):
        y = gam @ x                                       # [kmax+2]
        ydiff = y[:-1] - y[1:]                            # y_{k-1} − y_k
        gk = np.where(ydiff > 1e-14,
                      (y[:-1] ** d - y[1:] ** d) / np.maximum(ydiff, 1e-300),
                      d * y[:-1] ** (d - 1))              # [kmax+1]
        xdiff = x[:, :-1] - x[:, 1:]                      # [C, kmax+1]
        arr = lam * gk[None, :] * xdiff                   # flow into ≥ k
        srv = mu[:, None] * xdiff                         # flow out of ≥ k
        drift = arr[:, :-1] - srv[:, 1:]                  # levels 1..kmax
        x[:, 1:-1] += dt * drift
        np.clip(x, 0.0, 1.0, out=x)
        x[:, 0] = 1.0
        x[:, -1] = 0.0
        # keep tails monotone against round-off
        np.minimum.accumulate(x, axis=1, out=x)
        if np.abs(drift).max() < tol:
            break
    return x[:, :-1]


class MeanFieldPrediction(NamedTuple):
    """An equilibrium prediction plus the inputs that produced it."""

    mean_queue: float          # fleet-mean tasks per server (incl. service)
    per_class_mean: np.ndarray
    tails: np.ndarray          # [C, kmax+1]
    gammas: np.ndarray
    mus: np.ndarray
    lam: float
    d: int


def predict_pod(gammas, mus, lam: float, d: int = 2,
                kmax: int = 48) -> MeanFieldPrediction:
    """Heterogeneous (or, with one class, classical) JSQ(d) prediction."""
    gam = np.asarray(gammas, np.float64)
    gam = gam / gam.sum()
    x = het_pod_equilibrium(gam, mus, lam, d=d, kmax=kmax)
    per_class = x[:, 1:].sum(axis=1)
    return MeanFieldPrediction(
        mean_queue=float(gam @ per_class), per_class_mean=per_class,
        tails=x, gammas=gam, mus=np.asarray(mus, np.float64),
        lam=float(lam), d=int(d))


def tolerance_band(pred_mean: float, n: int, *, b: int | None = None,
                   rel: float = 0.08) -> tuple:
    """(lo, hi) acceptance band around a mean-field prediction.

    ``rel`` covers the model mismatches the engine adds on purpose (RPC
    scheduling latency, FCFS vs preemptive service, measurement window);
    finite-n fluctuations add O(1/√n); a cached-view policy's b-batched
    staleness adds O(b/n) (the batched balls-into-bins gap scale —
    Berenbrink et al. / Los & Sauerwald).
    """
    slack = rel + 1.0 / np.sqrt(max(n, 1))
    if b is not None:
        slack += 0.5 * b / max(n, 1)
    return (pred_mean * (1.0 - slack), pred_mean * (1.0 + slack))


def make_service_workload(cluster: ClusterSpec, lam: float, m: int,
                          mean_service_ms: float = 1000.0,
                          service_scale_by_type=None,
                          seed: int = 0) -> FBWorkload:
    """The mean-field validation trace for ``cluster``.

    Each task demands the *full capacity* of whichever server runs it
    (``r_exec[·, t] = C_t``), so exactly one task is in service per server
    — per-server FCFS single-server queues, the queueing model the
    mean-field limit speaks about.  Durations are Exp(``mean_service_ms``)
    scaled per node type (``service_scale_by_type`` — service rate
    μ_t ∝ 1/scale_t; default 1.0 everywhere); arrivals are Poisson at
    ``lam`` per server per mean-service-time (total rate
    ``lam · n · 1000/mean_service_ms`` tasks/s).  The submission demand is
    (1, 1) so the capacity prefilter passes every server and placement is
    purely the policy's choice.
    """
    from ..workloads.arrivals import poisson_arrivals
    from ..workloads.functionbench import FBWorkload

    if not 0.0 < lam < 1.0:
        raise ValueError(f"lam={lam} must be in (0, 1)")
    T = cluster.num_types
    scale = np.ones(T, np.float64) if service_scale_by_type is None \
        else np.asarray(service_scale_by_type, np.float64)
    if scale.shape != (T,) or (scale <= 0).any():
        raise ValueError(f"service_scale_by_type must be {T} positives")
    rng = np.random.RandomState(seed ^ 0x5EED)
    e = rng.exponential(1.0, size=m).astype(np.float64)
    d = (e[:, None] * (mean_service_ms * scale)[None, :]).astype(np.float32)
    cap = cluster.type_capacity()                       # [T, 2]
    r_exec = np.broadcast_to(cap[None, :, :], (m, T, 2)).astype(np.float32)
    qps = lam * cluster.num_servers * 1000.0 / mean_service_ms
    return FBWorkload(
        r_submit=np.ones((m, 2), np.float32),
        r_exec=np.ascontiguousarray(r_exec),
        d_est=d, d_act=d,
        task_type=np.zeros(m, np.int32),
        submit_ms=poisson_arrivals(m, qps, seed=seed),
    )


def measured_mean_queue(res, n: int, t0_ms: float, t1_ms: float) -> float:
    """Time-averaged per-server tasks in system over [t0, t1) — the
    simulation-side quantity :func:`predict_pod` predicts."""
    return mean_in_system(res, t0_ms, t1_ms) / n
