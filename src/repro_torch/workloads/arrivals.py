"""Arrival processes (§5 + the scenario engine's arrival axis) —
counterpart of ``repro.workloads.arrivals``.

Every process is a hashable NamedTuple spec with a pure
``arrival_times(spec, m, seed)`` sampler.  The randomness (unit-exponential
gaps, batch sizes, modulating-chain dwells) is drawn with the port's
threefry (:mod:`repro_torch.random`), keyed exactly as the reference keys
its JAX draws, and is bit-exact with them; the *time-rescaling* that turns
unit-rate arrivals into the target process runs in **float64** numpy (a
float32 cumsum loses inter-arrival precision once timestamps reach ~10⁷
ms) and casts to float32 only at the end.  The draws run on the CPU: the
samplers return host numpy planes, as the trace synthesizers do.

Rescaling is the exact inversion method for inhomogeneous Poisson
processes: with ``S_k`` the cumsum of unit exponentials, the k-th arrival
is ``Λ⁻¹(S_k)`` for cumulative intensity ``Λ``.  For piecewise-constant
rates (MMPP on-off) ``Λ⁻¹`` is a vectorized searchsorted; for the diurnal
sinusoid it is a fixed-iteration bisection; both are deterministic given
(spec, m, seed).

All samplers return nondecreasing float32 millisecond timestamps of
length exactly ``m``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..random import PRNGKey, exponential, fold_in, uniform


def poisson_arrivals(m: int, qps: float, seed: int = 0) -> np.ndarray:
    """[m] float32 arrival timestamps (ms) of a Poisson process at ``qps``.

    Timestamps are accumulated in float64 and cast once at the end: at
    m ≫ 10⁵ a float32 running sum drifts by whole inter-arrival gaps
    (absorption: adding ~1 ms steps to a ~10⁷ ms accumulator).
    """
    rng = np.random.RandomState(seed)
    gaps = rng.exponential(1000.0 / qps, size=m)
    return np.cumsum(gaps, dtype=np.float64).astype(np.float32)


def round_robin_scheduler(m: int, num_schedulers: int) -> np.ndarray:
    """[m] int32: which scheduler instance handles task i (§6.2: round-robin)."""
    return (np.arange(m) % num_schedulers).astype(np.int32)


# --------------------------------------------------------------------------
# Declarative arrival-process specs (hashable NamedTuples — usable as cache
# and jit-static keys, and as fields of a Scenario).
# --------------------------------------------------------------------------

class PoissonArrivals(NamedTuple):
    """Homogeneous Poisson at ``qps`` — the paper's §5 baseline process."""

    qps: float = 60.0


class OnOffArrivals(NamedTuple):
    """Bursty MMPP: a two-state Markov-modulated Poisson source.

    The modulating chain dwells ~Exp(``mean_on_s``) in the ON state
    (rate ``qps_on``) and ~Exp(``mean_off_s``) in OFF (rate ``qps_off``),
    starting in ON.  ``qps_off=0`` gives pure on-off silence between
    bursts.
    """

    qps_on: float = 200.0
    qps_off: float = 10.0
    mean_on_s: float = 2.0
    mean_off_s: float = 8.0


class DiurnalArrivals(NamedTuple):
    """Sinusoid-modulated inhomogeneous Poisson (a scaled "day"):

        rate(t) = qps_mean · (1 + amplitude · sin(2πt/period + phase)).

    ``amplitude`` < 1 keeps the rate strictly positive (required by the
    exact inversion sampler).
    """

    qps_mean: float = 60.0
    amplitude: float = 0.8
    period_s: float = 60.0
    phase: float = -1.5707963  # trough-first: the run starts off-peak


class BatchArrivals(NamedTuple):
    """Heavy-tailed batch submissions: batch epochs form a Poisson process
    at ``batch_qps``; each epoch submits ``min(⌊Pareto(α)⌋, max_batch)``
    tasks simultaneously (gang/array jobs — the skewed-arrival stress the
    ROADMAP's scenario item names)."""

    batch_qps: float = 10.0
    pareto_alpha: float = 1.5
    max_batch: int = 64


ArrivalSpec = (PoissonArrivals, OnOffArrivals, DiurnalArrivals, BatchArrivals)


def mean_qps(spec) -> float:
    """Long-run average arrival rate of ``spec`` (tasks/s)."""
    if isinstance(spec, PoissonArrivals):
        return float(spec.qps)
    if isinstance(spec, OnOffArrivals):
        tot = spec.mean_on_s + spec.mean_off_s
        return float((spec.qps_on * spec.mean_on_s
                      + spec.qps_off * spec.mean_off_s) / tot)
    if isinstance(spec, DiurnalArrivals):
        return float(spec.qps_mean)
    if isinstance(spec, BatchArrivals):
        # E[min(⌊X⌋, B)] for Pareto(α, x_min=1): Σ_{k=1..B} P(X ≥ k) = Σ k^-α.
        ks = np.arange(1, spec.max_batch + 1, dtype=np.float64)
        return float(spec.batch_qps * np.sum(ks ** -spec.pareto_alpha))
    raise TypeError(f"unknown arrival spec {type(spec).__name__}")


# --------------------------------------------------------------------------
# Draw layer (the per-task randomness; rescaling is host f64).
# --------------------------------------------------------------------------

# Family tags folded into the key so a scenario's arrival draws never
# collide with the engine's task-id-folded decision draws at the same seed.
_TAG_GAPS, _TAG_SIZES, _TAG_DWELL = 0x0A21, 0x0A22, 0x0A23


def _key(seed: int, tag: int):
    return fold_in(PRNGKey(seed, device="cpu"), tag)


def _exp_gaps(seed: int, m: int) -> np.ndarray:
    return exponential(_key(seed, _TAG_GAPS), (m,)).numpy()


def _uniforms(seed: int, m: int) -> np.ndarray:
    return uniform(_key(seed, _TAG_SIZES), (m,)).numpy()


def _dwell_gaps(seed: int, k: int) -> np.ndarray:
    """[k, 2] unit exponentials, row-major as the reference draws them."""
    return exponential(_key(seed, _TAG_DWELL), (k, 2)).numpy()


def _unit_poisson(m: int, seed: int) -> np.ndarray:
    """[m] float64 cumsum of unit-exponential gaps (the S_k of the
    inversion method)."""
    return np.cumsum(_exp_gaps(seed, m), dtype=np.float64)


def _onoff_times(spec: OnOffArrivals, m: int, seed: int) -> np.ndarray:
    S = _unit_poisson(m, seed)
    per_cycle = (spec.qps_on * spec.mean_on_s
                 + spec.qps_off * spec.mean_off_s)
    if per_cycle <= 0:
        raise ValueError("OnOffArrivals needs a positive mean rate")
    k = max(8, int(2 * m / per_cycle) + 8)
    while True:
        dw = np.asarray(_dwell_gaps(seed, k), np.float64)   # [k, 2] unit exp
        dwell = dw * np.array([spec.mean_on_s, spec.mean_off_s])
        segs = dwell.reshape(-1)                           # on, off, on, ...
        rates = np.tile([spec.qps_on, spec.qps_off], k).astype(np.float64)
        bounds = np.concatenate([[0.0], np.cumsum(segs)])  # [2k+1] s
        lam = np.concatenate([[0.0], np.cumsum(segs * rates)])
        if lam[-1] >= S[-1]:
            break
        k *= 2                                             # rare: extend
    seg = np.searchsorted(lam, S, side="right") - 1
    seg = np.clip(seg, 0, len(segs) - 1)
    # Inside an OFF segment with rate 0 the searchsorted lands at the ON
    # segment whose cumulative intensity first covers S (rate>0) — division
    # is safe for every selected segment.
    t_s = bounds[seg] + (S - lam[seg]) / np.maximum(rates[seg], 1e-300)
    return t_s * 1000.0


def _diurnal_times(spec: DiurnalArrivals, m: int, seed: int) -> np.ndarray:
    if not 0.0 <= spec.amplitude < 1.0:
        raise ValueError(f"amplitude={spec.amplitude} must be in [0, 1)")
    S = _unit_poisson(m, seed)
    q, A, P, ph = (float(spec.qps_mean), float(spec.amplitude),
                   float(spec.period_s), float(spec.phase))
    w = 2.0 * np.pi / P

    def big_lambda(t):
        return q * (t + (A / w) * (np.cos(ph) - np.cos(w * t + ph)))

    lo = np.zeros_like(S)
    hi = S / (q * (1.0 - A)) + P          # Λ(hi) ≥ S by construction
    for _ in range(64):                   # bisection: exact to f64 round-off
        mid = 0.5 * (lo + hi)
        below = big_lambda(mid) < S
        lo = np.where(below, mid, lo)
        hi = np.where(below, hi, mid)
    return 0.5 * (lo + hi) * 1000.0


def _batch_times(spec: BatchArrivals, m: int, seed: int) -> np.ndarray:
    if spec.pareto_alpha <= 0 or spec.max_batch < 1:
        raise ValueError("BatchArrivals needs pareto_alpha > 0, max_batch ≥ 1")
    S = _unit_poisson(m, seed)            # epoch S_k (more than enough:
    epochs_s = S / spec.batch_qps         # every batch has ≥ 1 task)
    u = np.asarray(_uniforms(seed, m), np.float64)
    x = np.clip(1.0 - u, 1e-12, 1.0) ** (-1.0 / spec.pareto_alpha)
    sizes = np.minimum(np.floor(x), spec.max_batch).astype(np.int64)
    cum = np.cumsum(sizes)
    nb = int(np.searchsorted(cum, m, side="left")) + 1
    t_s = np.repeat(epochs_s[:nb], sizes[:nb])[:m]
    return t_s * 1000.0


#: Sampled-plane cache: the scenario grid and the per-run parity path must
#: hand the engine the *same* float32 plane, so samples are memoized per
#: (spec, m, seed).
_TIMES_CACHE: dict = {}
_TIMES_CACHE_MAX = 512


def arrival_times(spec, m: int, seed: int = 0) -> np.ndarray:
    """[m] nondecreasing float32 timestamps (ms) for arrival process
    ``spec`` — deterministic in (spec, m, seed) and cached."""
    key = (spec, int(m), int(seed))
    hit = _TIMES_CACHE.get(key)
    if hit is not None:
        return hit
    if isinstance(spec, PoissonArrivals):
        t = _unit_poisson(m, seed) * (1000.0 / spec.qps)
    elif isinstance(spec, OnOffArrivals):
        t = _onoff_times(spec, m, seed)
    elif isinstance(spec, DiurnalArrivals):
        t = _diurnal_times(spec, m, seed)
    elif isinstance(spec, BatchArrivals):
        t = _batch_times(spec, m, seed)
    else:
        raise TypeError(f"unknown arrival spec {type(spec).__name__}")
    out = np.asarray(t, np.float64).astype(np.float32)
    out = np.maximum.accumulate(out)      # monotone even after f32 rounding
    out.setflags(write=False)
    if len(_TIMES_CACHE) >= _TIMES_CACHE_MAX:
        _TIMES_CACHE.clear()
    _TIMES_CACHE[key] = out
    return out


def arrival_times_grid(spec, m: int, seeds) -> np.ndarray:
    """[len(seeds), m] float32 — the sampler's seed axis, plane-per-seed
    identical to :func:`arrival_times` (the grid stacks these)."""
    return np.stack([arrival_times(spec, m, int(s)) for s in seeds])
