"""repro_torch.sim.sweep — the (seeds × configs) sweep, counterpart of
``repro.sim.sweep``.

* :func:`simulate_many` runs the (seeds × configs) grid through the study
  planner (:func:`repro_torch.sim.study.run_study`) with a singleton
  scenario axis.  The scalars the reference traces (α, β, interference,
  the RPC model, the outage window, Prequal's q_rif, ``flush_every``) may
  vary across the grid; the program-shaping knobs (``b``, policy,
  ``num_schedulers``, ``rbuf_slots``, ``mem_units``, Prequal pool
  shapes, ``trace``) must be shared, as in the reference.  The points run
  one by one through the port's per-run program (see the study module).

* Exactness: ``point(si, gi)`` is bit-identical to ``simulate(workload,
  cluster, configs[gi], seeds[si], mode="batched")`` on the same device
  (``tests/test_torch_study.py``).

Cross-seed aggregation (:func:`summarize_sweep`,
:func:`aggregate_summaries`) is the reference's numpy arithmetic: mean ±
95% CI per metric.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np

from .cluster import ClusterSpec
from .engine import EngineConfig, SimResult
from .metrics import Summary, summarize

# Two-sided 95% t critical values for df = 1..30 (normal beyond).
_T95 = (12.706, 4.303, 3.182, 2.776, 2.571, 2.447, 2.365, 2.306, 2.262,
        2.228, 2.201, 2.179, 2.160, 2.145, 2.131, 2.120, 2.110, 2.101,
        2.093, 2.086, 2.080, 2.074, 2.069, 2.064, 2.060, 2.056, 2.052,
        2.048, 2.045, 2.042)


def _t95(df: int) -> float:
    if df < 1:
        return 0.0
    return _T95[df - 1] if df <= len(_T95) else 1.96


class SweepResult(NamedTuple):
    """Stacked per-task outcomes over a (seeds × configs) grid.

    Array fields are ``[S, G, m]`` (seed-major); ``submit_ms`` is the shared
    ``[m]`` trace; ``msgs`` is ``[S, G, 4]`` (base, probe, push, flush).
    """

    server: np.ndarray
    enqueue_ms: np.ndarray
    start_ms: np.ndarray
    finish_ms: np.ndarray
    sched_ms: np.ndarray
    cores: np.ndarray
    mem_mb: np.ndarray
    submit_ms: np.ndarray     # [m]
    msgs: np.ndarray          # [S, G, 4] int32
    policy: str
    seeds: tuple              # length S
    configs: tuple            # length G, EngineConfig per grid column
    #: recovery planes — present only when configs carry a RetryPolicy.
    attempts: np.ndarray | None = None
    failed: np.ndarray | None = None
    wasted_ms: np.ndarray | None = None
    #: decision-trace planes — present only when configs set ``trace``.
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

    def point(self, si: int, gi: int) -> SimResult:
        """The (seed ``si``, config ``gi``) grid point as a plain
        :class:`SimResult` — interchangeable with a ``simulate()`` return."""
        return SimResult(
            server=self.server[si, gi],
            submit_ms=self.submit_ms,
            enqueue_ms=self.enqueue_ms[si, gi],
            start_ms=self.start_ms[si, gi],
            finish_ms=self.finish_ms[si, gi],
            sched_ms=self.sched_ms[si, gi],
            cores=self.cores[si, gi],
            mem_mb=self.mem_mb[si, gi],
            msgs_base=int(self.msgs[si, gi, 0]),
            msgs_probe=int(self.msgs[si, gi, 1]),
            msgs_push=int(self.msgs[si, gi, 2]),
            msgs_flush=int(self.msgs[si, gi, 3]),
            policy=self.policy,
            attempts=None if self.attempts is None else self.attempts[si, gi],
            failed=None if self.failed is None else self.failed[si, gi],
            wasted_ms=(None if self.wasted_ms is None
                       else self.wasted_ms[si, gi]),
            **({f: getattr(self, f)[si, gi]
                for f in ("view_age_ms", "view_err", "misplaced",
                          "cache_push", "sched_id", "decision_ms")}
               if self.view_age_ms is not None else {}),
        )


class SummaryCI(NamedTuple):
    """Cross-seed aggregate of one grid column.  The metric fields carry the
    same names (and units) as :class:`repro_torch.sim.metrics.Summary` but hold
    **means over seeds**; ``ci95`` maps each metric name to its two-sided
    95% confidence half-width (Student t over the seed sample; 0.0 when a
    single seed ran)."""

    policy: str
    num_tasks: int
    num_seeds: int
    msgs_total: float
    msgs_per_task: float
    throughput_tps: float
    makespan_mean_ms: float
    makespan_p95_ms: float
    sched_mean_ms: float
    sched_p95_ms: float
    wait_mean_ms: float
    wall_time_s: float
    goodput_tps: float
    retries_per_task: float
    wasted_ms_total: float
    failure_rate: float
    #: message-ledger breakdown (means over seeds, same categories as
    #: ``SimResult.msgs_*``) — decomposes ``msgs_total`` so the paper's
    #: 55–66% reduction claim can be attributed to probe vs push traffic.
    msgs_base: float
    msgs_probe: float
    msgs_push: float
    msgs_flush: float
    ci95: dict

    def row(self) -> str:
        ci = self.ci95.get("makespan_mean_ms", 0.0)
        return (f"{self.policy:>14s}  seeds={self.num_seeds:<2d} "
                f"msgs/task={self.msgs_per_task:6.2f}  "
                f"tput={self.throughput_tps:8.2f}/s  "
                f"mk_mean={self.makespan_mean_ms:9.1f}±{ci:.1f}ms  "
                f"mk_p95={self.makespan_p95_ms:9.1f}ms  "
                f"sched_mean={self.sched_mean_ms:6.2f}ms")


_CI_METRICS = ("msgs_total", "msgs_per_task", "throughput_tps",
               "makespan_mean_ms", "makespan_p95_ms", "sched_mean_ms",
               "sched_p95_ms", "wait_mean_ms", "wall_time_s",
               "goodput_tps", "retries_per_task", "wasted_ms_total",
               "failure_rate", "msgs_base", "msgs_probe", "msgs_push",
               "msgs_flush")


def aggregate_summaries(per_seed: Sequence[Summary]) -> SummaryCI:
    """Mean ± 95% CI over one config column's per-seed summaries."""
    S = len(per_seed)
    t = _t95(S - 1)
    means, ci = {}, {}
    for f in _CI_METRICS:
        vals = np.asarray([getattr(s, f) for s in per_seed], np.float64)
        means[f] = float(vals.mean())
        ci[f] = float(t * vals.std(ddof=1) / np.sqrt(S)) if S > 1 else 0.0
    return SummaryCI(policy=per_seed[0].policy,
                     num_tasks=per_seed[0].num_tasks,
                     num_seeds=S, ci95=ci, **means)


def summarize_sweep(sw: SweepResult) -> list:
    """One :class:`SummaryCI` per grid column (config), aggregating the
    §6.2 metric list across the seed axis."""
    out = []
    for gi in range(sw.num_configs):
        out.append(aggregate_summaries(
            [summarize(sw.point(si, gi)) for si in range(sw.num_seeds)]))
    return out


def simulate_many(workload, cluster: ClusterSpec,
                  configs: Sequence[EngineConfig] | EngineConfig,
                  seeds: Sequence[int] = (0,), *,
                  seed_chunk: int | None = None,
                  shard: bool = True, dynamics=None,
                  server_shards: int | None = None,
                  device=None) -> SweepResult:
    """Run a (seeds × configs) grid of batched-driver simulations — the
    study planner (:func:`repro_torch.sim.study.run_study`) with a
    singleton scenario axis.

    Parameters
    ----------
    configs:
        One :class:`EngineConfig` or a sequence of them (the grid's config
        axis), sharing the program-shaping knobs; the scalars may vary.
    seeds:
        The grid's seed axis (python ints, as ``simulate(seed=...)``).
    seed_chunk, shard:
        the reference's execution knobs, kept for its signature; they
        change no value (every point runs through the per-run program).
    dynamics:
        optional :class:`repro_torch.sim.engine.Dynamics` timeline applied
        to *every* grid point.  To sweep the scenario axis itself use
        :func:`repro_torch.sim.scenarios.run_scenario_grid` or
        :func:`repro_torch.sim.study.run_study`.
    server_shards:
        run every point as ``simulate_hierarchical(..., k, mode="batched",
        b=cfg.b)``; requires ``k | num_servers``.
    device:
        where the points run (default: the GPU).

    Returns a :class:`SweepResult`; ``point(si, gi)`` recovers any single
    run bit-identically to ``simulate(workload, cluster, configs[gi],
    seeds[si], mode="batched")``.
    """
    from .scenarios import Scenario
    from .study import Study, run_study

    if isinstance(configs, EngineConfig):
        configs = (configs,)
    configs = tuple(configs)
    seeds = tuple(int(s) for s in seeds)
    if not configs or not seeds:
        raise ValueError("simulate_many needs ≥ 1 config and ≥ 1 seed")
    scen = Scenario("sweep", dynamics=dynamics) if dynamics is not None \
        else Scenario("sweep")
    point_chunk = None if seed_chunk is None \
        else max(1, int(seed_chunk)) * len(configs)
    st = run_study(workload, cluster,
                   Study(seeds=seeds, configs=configs, scenarios=(scen,)),
                   point_chunk=point_chunk, shard=shard,
                   server_shards=server_shards, device=device)
    return SweepResult(
        server=st.server[:, :, 0],
        enqueue_ms=st.enqueue_ms[:, :, 0], start_ms=st.start_ms[:, :, 0],
        finish_ms=st.finish_ms[:, :, 0], sched_ms=st.sched_ms[:, :, 0],
        cores=st.cores[:, :, 0], mem_mb=st.mem_mb[:, :, 0],
        submit_ms=np.asarray(workload.submit_ms),
        msgs=st.msgs[:, :, 0], policy=st.policy, seeds=seeds,
        configs=configs,
        attempts=None if st.attempts is None else st.attempts[:, :, 0],
        failed=None if st.failed is None else st.failed[:, :, 0],
        wasted_ms=None if st.wasted_ms is None else st.wasted_ms[:, :, 0],
        **({f: getattr(st, f)[:, :, 0]
            for f in ("view_age_ms", "view_err", "misplaced",
                      "cache_push", "sched_id", "decision_ms")}
           if st.view_age_ms is not None else {}),
    )
