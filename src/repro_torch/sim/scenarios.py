"""repro_torch.sim.scenarios — the declarative scenario engine, counterpart
of ``repro.sim.scenarios``.

* a :class:`Scenario` is a hashable spec composing an **arrival process**
  (:mod:`repro_torch.workloads.arrivals` — Poisson, MMPP on-off bursts,
  diurnal sinusoid, heavy-tailed batches) with a **server-dynamics
  timeline** (:class:`repro_torch.sim.engine.Dynamics` — per-server outage
  windows, churn joins/leaves, straggler slowdowns, data-store outages);
* :func:`run_scenario` runs one (scenario, seed) point through
  :func:`~repro_torch.sim.engine.simulate` on the batched driver;
* :func:`run_scenario_grid` runs a (seeds × scenarios) grid through the
  study planner (:func:`repro_torch.sim.study.run_study`) with a
  singleton config axis, every point equal to its standalone
  :func:`run_scenario` run;
* the timeline generators below are the reference's, numpy ``RandomState``
  draws copied as they are.
"""
from __future__ import annotations

from dataclasses import replace as dc_replace
from typing import NamedTuple, Sequence

import numpy as np

from ..workloads.arrivals import arrival_times
from .cluster import ClusterSpec
from .engine import Dynamics, EngineConfig, SimResult, simulate


class Scenario(NamedTuple):
    """One named experiment condition.

    arrivals:
        an arrival-process spec whose sampled timestamps replace the base
        workload's ``submit_ms`` — per seed, so the seed axis redraws both
        the arrival times and the engine's decisions.  ``None`` keeps the
        base workload's trace.
    dynamics:
        the server/store timeline (:class:`Dynamics`).
    dag:
        optional task-graph spec (:mod:`repro_torch.workloads.dags`) run
        through the frontier loop.
    """

    name: str = "steady"
    arrivals: object = None
    dynamics: Dynamics = Dynamics()
    dag: object = None


def scenario_workload(base, scenario: Scenario, seed: int = 0):
    """The base workload with ``submit_ms`` replaced by the scenario's
    sampled arrival plane (identity-cached, so repeated runs share one
    frozen object)."""
    if scenario.arrivals is None:
        return base
    m = base.submit_ms.shape[0]
    key = (id(base), scenario.arrivals, int(seed))
    hit = _WL_CACHE.get(key)
    if hit is not None:
        return hit[1]
    wl = dc_replace(base,
                    submit_ms=arrival_times(scenario.arrivals, m, seed))
    if len(_WL_CACHE) >= _WL_CACHE_MAX:
        _WL_CACHE.clear()
    _WL_CACHE[key] = (base, wl)        # pin base so its id stays unique
    return wl


_WL_CACHE: dict = {}
_WL_CACHE_MAX = 256


def run_scenario(base, cluster: ClusterSpec, scenario: Scenario,
                 cfg: EngineConfig, seed: int = 0, *,
                 mode: str = "batched", device=None) -> SimResult:
    """One (scenario, seed) point = ``simulate`` on the scenario workload
    with the scenario's dynamics lowered to window planes.  ``device``
    defaults to the GPU, as :func:`simulate`'s."""
    wl = scenario_workload(base, scenario, seed)
    return simulate(wl, cluster, cfg, seed, mode=mode, device=device,
                    dynamics=scenario.dynamics, dag=scenario.dag)


class ScenarioSweep(NamedTuple):
    """Stacked per-task outcomes over a (seeds × scenarios) grid.

    Array fields are ``[S, K, m]`` (seed-major); ``submit_ms`` is per-point
    (scenarios resample arrivals); ``msgs`` is ``[S, K, 4]``.
    """

    server: np.ndarray
    enqueue_ms: np.ndarray
    start_ms: np.ndarray
    finish_ms: np.ndarray
    sched_ms: np.ndarray
    cores: np.ndarray
    mem_mb: np.ndarray
    submit_ms: np.ndarray     # [S, K, m]
    msgs: np.ndarray          # [S, K, 4] int32
    policy: str
    seeds: tuple
    scenarios: tuple          # length K, Scenario per grid column
    config: EngineConfig
    #: recovery planes — present only when ``config`` carries a RetryPolicy.
    attempts: np.ndarray | None = None
    failed: np.ndarray | None = None
    wasted_ms: np.ndarray | None = None

    @property
    def num_seeds(self) -> int:
        return len(self.seeds)

    @property
    def num_scenarios(self) -> int:
        return len(self.scenarios)

    def point(self, si: int, ki: int) -> SimResult:
        """The (seed ``si``, scenario ``ki``) point as a plain
        :class:`SimResult` — interchangeable with a ``run_scenario``
        return."""
        return SimResult(
            server=self.server[si, ki],
            submit_ms=self.submit_ms[si, ki],
            enqueue_ms=self.enqueue_ms[si, ki],
            start_ms=self.start_ms[si, ki],
            finish_ms=self.finish_ms[si, ki],
            sched_ms=self.sched_ms[si, ki],
            cores=self.cores[si, ki],
            mem_mb=self.mem_mb[si, ki],
            msgs_base=int(self.msgs[si, ki, 0]),
            msgs_probe=int(self.msgs[si, ki, 1]),
            msgs_push=int(self.msgs[si, ki, 2]),
            msgs_flush=int(self.msgs[si, ki, 3]),
            policy=self.policy,
            attempts=None if self.attempts is None else self.attempts[si, ki],
            failed=None if self.failed is None else self.failed[si, ki],
            wasted_ms=(None if self.wasted_ms is None
                       else self.wasted_ms[si, ki]),
        )


def run_scenario_grid(base, cluster: ClusterSpec,
                      scenarios: Sequence[Scenario] | Scenario,
                      cfg: EngineConfig, seeds: Sequence[int] = (0,), *,
                      point_chunk: int | None = None, shard: bool = True,
                      device=None) -> ScenarioSweep:
    """Run a (seeds × scenarios) grid of batched-driver simulations — the
    study planner (:func:`repro_torch.sim.study.run_study`) with a
    singleton config axis.  Every point equals its standalone
    :func:`run_scenario` run bit for bit; ``point_chunk`` and ``shard``
    keep the reference's signature and change no value.  ``device``
    defaults to the GPU."""
    from .study import Study, run_study

    if isinstance(scenarios, Scenario):
        scenarios = (scenarios,)
    scenarios = tuple(scenarios)
    seeds = tuple(int(s) for s in seeds)
    if not scenarios or not seeds:
        raise ValueError("run_scenario_grid needs ≥ 1 scenario and ≥ 1 seed")
    st = run_study(base, cluster,
                   Study(seeds=seeds, configs=(cfg,), scenarios=scenarios),
                   point_chunk=point_chunk, shard=shard, device=device)
    return ScenarioSweep(
        server=st.server[:, 0],
        enqueue_ms=st.enqueue_ms[:, 0], start_ms=st.start_ms[:, 0],
        finish_ms=st.finish_ms[:, 0], sched_ms=st.sched_ms[:, 0],
        cores=st.cores[:, 0], mem_mb=st.mem_mb[:, 0],
        # A writable plane even when no scenario resamples arrivals (the
        # planner then returns a broadcast view of the base trace).
        submit_ms=np.ascontiguousarray(st.submit_ms), msgs=st.msgs[:, 0],
        policy=st.policy, seeds=seeds, scenarios=scenarios, config=cfg,
        attempts=None if st.attempts is None else st.attempts[:, 0],
        failed=None if st.failed is None else st.failed[:, 0],
        wasted_ms=None if st.wasted_ms is None else st.wasted_ms[:, 0],
    )


# --------------------------------------------------------------------------
# Timelines — deterministic Dynamics generators.  All return a
# complete Dynamics; compose them with ``a.merge(b, ...)``.
# --------------------------------------------------------------------------

def _union_per_server(draws):
    """Union-merge per-server ``(srv, t0, t1)`` draws so no server carries
    overlapping windows.  Safe on engine output: start gating already
    resolves overlapping windows to the same gated start, and a running
    task is killed at the *earliest* opening inside its span — which the
    union preserves (a later overlapping opening can only strike a task
    the earlier window already struck)."""
    per: dict = {}
    for s, t0, t1 in draws:
        per.setdefault(int(s), []).append((float(t0), float(t1)))
    out = []
    for s in sorted(per):
        merged: list = []
        for t0, t1 in sorted(per[s]):
            if merged and t0 <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], t1))
            else:
                merged.append((t0, t1))
        out.extend((s, t0, t1) for t0, t1 in merged)
    return tuple(out)


def random_outages(n: int, count: int, horizon_ms: float,
                   mean_down_ms: float = 5_000.0, seed: int = 0) -> Dynamics:
    """``count`` outage windows on uniformly drawn servers, exponential
    durations (mean ``mean_down_ms``), starts uniform in the horizon —
    the §4.3 "servers fail at random" grid axis.

    Windows drawn on the same server are union-merged, so the returned
    spec always satisfies the per-server non-overlap property (the
    failure layer's kill/retry accounting attributes each kill to exactly
    one window); fewer than ``count`` windows come back iff draws
    collided on a server.
    """
    rng = np.random.RandomState(seed)
    srv = rng.randint(0, n, size=count)
    t0 = rng.uniform(0.0, horizon_ms, size=count)
    dur = rng.exponential(mean_down_ms, size=count)
    return Dynamics(outages=_union_per_server(zip(srv, t0, t0 + dur)))


def rolling_restart(n: int, down_ms: float, stagger_ms: float,
                    start_ms: float = 0.0, stride: int = 1) -> Dynamics:
    """A maintenance wave: every ``stride``-th server goes down for
    ``down_ms``, waves offset by ``stagger_ms`` (server 0 first)."""
    out = []
    for i, srv in enumerate(range(0, n, stride)):
        t0 = start_ms + i * stagger_ms
        out.append((srv, float(t0), float(t0 + down_ms)))
    return Dynamics(outages=tuple(out))


def random_churn(n: int, leave_frac: float, join_frac: float,
                 horizon_ms: float, seed: int = 0) -> Dynamics:
    """Node churn: disjoint random subsets of the fleet leave (down from a
    uniform time onward) and join late (down until a uniform time)."""
    rng = np.random.RandomState(seed)
    k_leave = int(round(leave_frac * n))
    k_join = int(round(join_frac * n))
    perm = rng.permutation(n)
    leavers = perm[:k_leave]
    joiners = perm[k_leave:k_leave + k_join]
    leaves = tuple((int(s), float(rng.uniform(0.3, 1.0) * horizon_ms))
                   for s in leavers)
    joins = tuple((int(s), float(rng.uniform(0.0, 0.7) * horizon_ms))
                  for s in joiners)
    return Dynamics(joins=joins, leaves=leaves)


def random_stragglers(n: int, count: int, horizon_ms: float,
                      mean_slow_ms: float = 10_000.0, mult: float = 4.0,
                      seed: int = 0) -> Dynamics:
    """``count`` transient slowdown windows (tasks starting inside run
    ``mult``× longer) on uniform servers/starts.

    Same-server windows are truncated at the next window's start (never
    union-merged: overlapping slowdowns *compound* multiplicatively in the
    engine, so a union would change the stretch), keeping the per-server
    non-overlap property without altering the single-window multiplier.
    """
    rng = np.random.RandomState(seed)
    srv = rng.randint(0, n, size=count)
    t0 = rng.uniform(0.0, horizon_ms, size=count)
    dur = rng.exponential(mean_slow_ms, size=count)
    per: dict = {}
    for s, a, d in zip(srv, t0, dur):
        per.setdefault(int(s), []).append((float(a), float(a + d)))
    wins = []
    for s in sorted(per):
        spans = sorted(per[s])
        for i, (a, b) in enumerate(spans):
            end = min(b, spans[i + 1][0]) if i + 1 < len(spans) else b
            if end > a:
                wins.append((s, a, end, float(mult)))
    return Dynamics(slowdowns=tuple(wins))
