"""repro_torch.sim.study — the unified grid planner over a (seeds × configs
× scenarios) study, counterpart of ``repro.sim.study``.

* a :class:`Study` is a declarative spec of the three grid axes — seeds,
  :class:`~repro_torch.sim.engine.EngineConfig` columns (traced scalars
  may vary; program-shaping knobs must be shared, the reference's rule)
  and :class:`~repro_torch.sim.scenarios.Scenario` columns (arrival
  processes × server-dynamics timelines);

* :func:`run_study` validates the spec as the reference does and runs
  the grid's P = S·G·K points **one by one** through the port's per-run
  program (:func:`~repro_torch.sim.engine.simulate` on the batched
  driver, or :func:`~repro_torch.sim.hierarchy.simulate_hierarchical`
  under ``server_shards``).  That is the reference's ``point_chunk=1``
  strategy, its default for grids of at most 24 points: one card has no
  pmap axis, and the reference's chunked vmap over points has no
  counterpart yet (a leading point dimension in the block step is queued
  in ROADMAP.md).  ``point_chunk`` and ``shard`` keep the reference's
  signature and change no value;

* :meth:`StudyResult.point` recovers any (seed, config, scenario) cell as
  a plain :class:`~repro_torch.sim.engine.SimResult`, bit-identical to
  ``run_scenario(base, cluster, scenarios[ki], configs[gi], seeds[si],
  mode="batched")`` on the same device, and on the CPU to the
  reference's ``run_study(..., use_kernel=False, point_chunk=1)``
  (``tests/test_torch_study.py``).

Every point of a study launches the decision kernel once a block on the
card (K1, K2 under down windows, K3 on the waves of a task graph under a
``LocalityModel``), except under cache faults, whose per-scheduler views
the block step scores in torch ops, as the reference's faulted path does.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np

from .cluster import ClusterSpec
from .engine import (CacheFaults, EngineConfig, LocalityModel, RetryPolicy,
                     SimResult, _validate_config, simulate)
from .hierarchy import simulate_hierarchical
from .messages import RpcModel
from .metrics import summarize
from .scenarios import Scenario, scenario_workload

#: The per-task planes a study stacks, as :class:`SimResult` names them.
_PLANES = ("server", "enqueue_ms", "start_ms", "finish_ms", "sched_ms",
           "cores", "mem_mb")
_TRACE_FIELDS = ("view_age_ms", "view_err", "misplaced", "cache_push",
                 "sched_id", "decision_ms")


class Study(NamedTuple):
    """The declarative (seeds × configs × scenarios) grid spec.

    seeds:
        the seed axis (python ints, as ``simulate(seed=...)``).
    configs:
        one :class:`EngineConfig` or a sequence — the config axis.  All
        must share the program-shaping knobs (policy, ``b``,
        ``num_schedulers``, buffer shapes, ``trace``); the scalars (α, β,
        interference, the RPC model, ``outage_ms``, q_rif,
        ``flush_every``) may vary per column.
    scenarios:
        one :class:`Scenario` or a sequence — the scenario axis (arrival
        process × :class:`~repro_torch.sim.engine.Dynamics` timeline per
        column).

    All three components are hashable, so a ``Study`` is usable as a
    cache key and comparable across runs.
    """

    seeds: tuple = (0,)
    configs: object = EngineConfig()
    scenarios: object = Scenario()


class StudyResult(NamedTuple):
    """Stacked per-task outcomes over a (seeds × configs × scenarios)
    grid.  Array fields are ``[S, G, K, m]`` (seed-major, config, then
    scenario); ``submit_ms`` is ``[S, K, m]`` (configs share each
    scenario's arrival plane; when no scenario resamples arrivals it is
    a read-only broadcast view of the base trace — copy before
    mutating) — except DAG studies, which store per-config *effective*
    submit planes ``[S, G, K, m]`` (readiness depends on placements);
    ``msgs`` is ``[S, G, K, 4]``."""

    server: np.ndarray
    enqueue_ms: np.ndarray
    start_ms: np.ndarray
    finish_ms: np.ndarray
    sched_ms: np.ndarray
    cores: np.ndarray
    mem_mb: np.ndarray
    submit_ms: np.ndarray     # [S, K, m] ([S, G, K, m] on the DAG path)
    msgs: np.ndarray          # [S, G, K, 4] int32
    policy: str
    seeds: tuple              # length S
    configs: tuple            # length G
    scenarios: tuple          # length K
    #: recovery planes — present only when the configs carry a RetryPolicy;
    #: ``[S, G, K, m]``.
    attempts: np.ndarray | None = None
    failed: np.ndarray | None = None
    wasted_ms: np.ndarray | None = None
    #: decision-trace planes — present only when the configs set ``trace``
    #: (program-shaping, so the grid agrees); ``[S, G, K, m]``.
    view_age_ms: np.ndarray | None = None
    view_err: np.ndarray | None = None
    misplaced: np.ndarray | None = None
    cache_push: np.ndarray | None = None
    sched_id: np.ndarray | None = None
    decision_ms: np.ndarray | None = None

    @property
    def num_seeds(self) -> int:
        return len(self.seeds)

    @property
    def num_configs(self) -> int:
        return len(self.configs)

    @property
    def num_scenarios(self) -> int:
        return len(self.scenarios)

    def point(self, si: int, gi: int, ki: int) -> SimResult:
        """The (seed ``si``, config ``gi``, scenario ``ki``) cell as a
        plain :class:`SimResult` — interchangeable with the per-run
        ``run_scenario(base, cluster, scenarios[ki], configs[gi],
        seeds[si], mode="batched")`` return."""
        return SimResult(
            server=self.server[si, gi, ki],
            submit_ms=(self.submit_ms[si, gi, ki]
                       if self.submit_ms.ndim == 4
                       else self.submit_ms[si, ki]),
            enqueue_ms=self.enqueue_ms[si, gi, ki],
            start_ms=self.start_ms[si, gi, ki],
            finish_ms=self.finish_ms[si, gi, ki],
            sched_ms=self.sched_ms[si, gi, ki],
            cores=self.cores[si, gi, ki],
            mem_mb=self.mem_mb[si, gi, ki],
            msgs_base=int(self.msgs[si, gi, ki, 0]),
            msgs_probe=int(self.msgs[si, gi, ki, 1]),
            msgs_push=int(self.msgs[si, gi, ki, 2]),
            msgs_flush=int(self.msgs[si, gi, ki, 3]),
            policy=self.policy,
            attempts=(None if self.attempts is None
                      else self.attempts[si, gi, ki]),
            failed=None if self.failed is None else self.failed[si, gi, ki],
            wasted_ms=(None if self.wasted_ms is None
                       else self.wasted_ms[si, gi, ki]),
            **({f: getattr(self, f)[si, gi, ki] for f in _TRACE_FIELDS}
               if self.view_age_ms is not None else {}),
        )


def _static_cfg(cfg: EngineConfig) -> EngineConfig:
    """``cfg`` with every scalar the reference traces collapsed to a
    canonical value: what is left is the program-shaping knobs (policy,
    ``b``, ``num_schedulers``, ``rbuf_slots``, ``mem_units``, Prequal's
    pool shapes, ``trace``, and the presence of a RetryPolicy or a
    LocalityModel), as the reference's ``_static_cfg(keep_b=True)`` on its
    two-stage path."""
    return cfg._replace(
        alpha=0.5, beta=0.5, interference=0.3, flush_every=2, outage_ms=(),
        rpc=RpcModel(), prequal=cfg.prequal._replace(q_rif=0.84),
        retry=None if cfg.retry is None else RetryPolicy(),
        locality=None if cfg.locality is None else LocalityModel())


def _grid_static(configs: Sequence[EngineConfig]) -> EngineConfig:
    """The single static (program-shaping) config of the grid; raises if
    the configs disagree on any program-shaping knob."""
    statics = {_static_cfg(c) for c in configs}
    policies = {c.policy for c in configs}
    if len(statics) > 1 or len(policies) > 1:
        raise ValueError(
            "study configs must share every program-shaping knob "
            "(policy, b, num_schedulers, rbuf_slots, mem_units, prequal pool "
            "shapes, block_t/interpret); traced scalars (alpha, beta, "
            "interference, rpc, outage_ms, q_rif, flush_every) may vary. "
            f"Got {len(statics)} distinct programs over {len(configs)} "
            "configs — split the study by program, or align the knobs.")
    return statics.pop()


def run_study(base, cluster: ClusterSpec, study: Study, *,
              point_chunk: int | None = None, shard: bool = True,
              server_shards: int | None = None,
              device=None) -> StudyResult:
    """Run a (seeds × configs × scenarios) study, point by point.

    Parameters
    ----------
    base:
        the base workload; scenarios with an arrival process replace its
        ``submit_ms`` per (scenario, seed) — identity-cached, so the grid
        and the per-run path consume the same frozen planes.
    study:
        the :class:`Study` spec (singleton configs/scenarios allowed).
    point_chunk, shard:
        the reference's execution knobs (points a vmap dispatch, pmap
        fan-out); kept for its signature.  The port runs every point
        through its per-run program, the reference's ``point_chunk=1``,
        on one device: neither knob changes a value.
    server_shards:
        split the fleet into ``k`` round-robin mini-clusters per point:
        each point is ``simulate_hierarchical(workload, cluster, cfg, k,
        seed, mode="batched", b=cfg.b, dynamics=sc.dynamics)`` (§4.2:
        ``cfg.b`` per mini-cluster, per-part seeds ``seed + c``).
        Requires ``k | num_servers``, as the reference's sharded planner.
    device:
        where every point runs (default: the GPU; ``"cpu"`` to run on the
        CPU).

    A scenario axis mixing cache-faulted and unfaulted scenarios pads the
    unfaulted ones with an inert ``CacheFaults()`` (bit-identical to no
    spec), as the reference does.  A DAG scenario runs every point
    through the frontier loop, and a RetryPolicy through the re-entry
    loop; both may vary their locality or retry spec per config column.
    """
    seeds = tuple(int(s) for s in study.seeds)
    configs = study.configs
    if isinstance(configs, EngineConfig):
        configs = (configs,)
    configs = tuple(configs)
    scenarios = study.scenarios
    if isinstance(scenarios, Scenario):
        scenarios = (scenarios,)
    scenarios = tuple(scenarios)
    if not seeds or not configs or not scenarios:
        raise ValueError("run_study needs ≥ 1 seed, ≥ 1 config and "
                         "≥ 1 scenario")
    for c in configs:
        if not isinstance(c, EngineConfig):
            raise TypeError(f"expected EngineConfig, got {type(c).__name__}")
        _validate_config(c)
    for sc in scenarios:
        if not isinstance(sc, Scenario):
            raise TypeError(f"expected Scenario, got {type(sc).__name__}")

    # Cache faults shape the reference's program on the scenario axis, so
    # a mixed axis is normalized as there: unfaulted scenarios get an
    # inert CacheFaults(), which changes no value.
    faulted_axis = [sc.dynamics.cache_faults is not None for sc in scenarios]
    if any(faulted_axis) and not all(faulted_axis):
        scenarios = tuple(
            sc if f else sc._replace(
                dynamics=sc.dynamics._replace(cache_faults=CacheFaults()))
            for sc, f in zip(scenarios, faulted_axis))

    shards = (int(server_shards)
              if server_shards is not None and int(server_shards) > 1
              else None)
    if any(sc.dag is not None for sc in scenarios):
        if shards is not None:
            raise NotImplementedError(
                "server_shards on a DAG study: the frontier loop re-forms "
                "decision blocks per wave, which does not compose with the "
                "round-robin task split — shard DAG-free studies only.")
        if any(c.retry is not None for c in configs):
            raise NotImplementedError(
                "dag scenarios with a RetryPolicy: both own the host-side "
                "wave loop — run task-graph studies without retries.")
        static_cfg = _grid_static(
            tuple(c._replace(locality=None) for c in configs))
        return _run_points(base, cluster, seeds, configs, scenarios,
                           static_cfg, device, dag=True)
    if any(c.locality is not None for c in configs):
        raise ValueError(
            "study configs carry a LocalityModel but no scenario has a "
            "dag: the penalty reads parent placements, which only "
            "task-graph scenarios carry.")
    if any(c.retry is not None for c in configs):
        static_cfg = _grid_static(
            tuple(c._replace(retry=None) for c in configs))
        return _run_points(base, cluster, seeds, configs, scenarios,
                           static_cfg, device, shards=shards, retry=True)
    static_cfg = _grid_static(configs)
    if shards is not None:
        n = cluster.num_servers
        if n % shards:
            raise ValueError(
                f"server_shards={shards} must divide num_servers={n}: "
                "equal-size mini-clusters keep the part axis one compiled "
                "program")
        for sc in scenarios:
            for field in ("outages", "joins", "leaves", "slowdowns"):
                for e in getattr(sc.dynamics, field):
                    if not 0 <= int(e[0]) < n:
                        raise ValueError(
                            f"dynamics server {int(e[0])} outside fleet "
                            f"of {n}")
    return _run_points(base, cluster, seeds, configs, scenarios, static_cfg,
                       device, shards=shards)


def _arrival_planes(base, seeds, scenarios) -> np.ndarray:
    """``[S, K, m]`` arrival planes: per (seed, scenario) when a scenario
    resamples arrivals, else a read-only broadcast of the base trace."""
    m = base.r_submit.shape[0]
    if any(sc.arrivals is not None for sc in scenarios):
        return np.stack([
            np.stack([np.asarray(scenario_workload(base, sc, sd).submit_ms)
                      for sc in scenarios])
            for sd in seeds])
    return np.broadcast_to(np.asarray(base.submit_ms),
                           (len(seeds), len(scenarios), m))


def _run_points(base, cluster: ClusterSpec, seeds, configs, scenarios,
                static_cfg: EngineConfig, device, *, shards=None,
                retry: bool = False, dag: bool = False) -> StudyResult:
    """Every (seed, config, scenario) point through the port's per-run
    program — ``simulate(mode="batched")``, or ``simulate_hierarchical``
    under ``shards`` — stacked into a :class:`StudyResult` laid out as
    the reference's: recovery planes when ``retry``, per-config effective
    submit planes when ``dag``, trace planes when ``static_cfg.trace``."""
    S, G, K = len(seeds), len(configs), len(scenarios)
    m = base.r_submit.shape[0]
    shape = (S, G, K, m)
    out = {f: np.zeros(shape, np.int32 if f == "server" else np.float32)
           for f in _PLANES + (("submit_ms",) if dag else ())}
    rec = {}
    if retry:
        rec = {"attempts": np.ones(shape, np.int32),
               "failed": np.zeros(shape, bool),
               "wasted_ms": np.zeros(shape, np.float32)}
    if static_cfg.trace:
        rec.update({f: np.zeros(shape, dt) for f, dt in (
            ("view_age_ms", np.float32), ("view_err", np.float32),
            ("misplaced", bool), ("cache_push", bool),
            ("sched_id", np.int32), ("decision_ms", np.float32))})
    msgs = np.zeros((S, G, K, 4), np.int32)
    for si, sd in enumerate(seeds):
        for gi, cfg in enumerate(configs):
            for ki, sc in enumerate(scenarios):
                wl = scenario_workload(base, sc, sd)
                if shards is not None:
                    r = simulate_hierarchical(
                        wl, cluster, cfg, shards, sd, mode="batched",
                        b=cfg.b, dynamics=sc.dynamics, device=device)
                else:
                    r = simulate(wl, cluster, cfg, sd, mode="batched",
                                 device=device, dynamics=sc.dynamics,
                                 dag=sc.dag)
                for f in out:
                    out[f][si, gi, ki] = getattr(r, f)
                for f in rec:
                    v = getattr(r, f)
                    if v is not None:
                        rec[f][si, gi, ki] = v
                msgs[si, gi, ki] = (r.msgs_base, r.msgs_probe, r.msgs_push,
                                    r.msgs_flush)
    submit = out.pop("submit_ms") if dag else _arrival_planes(
        base, seeds, scenarios)
    return StudyResult(**out, submit_ms=submit, msgs=msgs,
                       policy=static_cfg.policy, seeds=tuple(seeds),
                       configs=tuple(configs), scenarios=tuple(scenarios),
                       **rec)


def summarize_study(st: StudyResult) -> list:
    """Cross-seed aggregates for every grid column: a ``[G][K]`` nested
    list of :class:`~repro_torch.sim.sweep.SummaryCI` (mean ± 95% CI over
    the seed axis, the §6.2 metric list)."""
    from .sweep import aggregate_summaries   # sweep wraps this module

    return [[aggregate_summaries([summarize(st.point(si, gi, ki))
                                  for si in range(st.num_seeds)])
             for ki in range(st.num_scenarios)]
            for gi in range(st.num_configs)]
