"""Metric aggregation for simulation results (the paper's §6.2 metrics) —
the part of ``repro.sim.metrics`` the ported slices need: :class:`Summary`,
:func:`summarize`, the per-phase views of the scenario engine
(:func:`summarize_window`, :func:`phase_summaries`,
:func:`mean_in_system`), :func:`utilization_stats`, the capacity
invariant :func:`resource_violations`, the failure layer's
:func:`fault_stats` and :func:`time_to_recover_ms`, and the task-graph
:func:`dag_stats` and :func:`summarize_dag`.  Numpy only; the bodies are
the reference's.

1) RPC counts processed by all schedulers;
2) cluster throughput = processed requests / experiment wall time;
3) mean and p95 end-to-end task makespan;
4) mean and p95 scheduling latency (scheduler-added overhead).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from .cluster import ClusterSpec
from .engine import SimResult


class Summary(NamedTuple):
    policy: str
    num_tasks: int
    msgs_total: int
    msgs_per_task: float
    throughput_tps: float        # tasks per second of wall time
    makespan_mean_ms: float
    makespan_p95_ms: float
    sched_mean_ms: float
    sched_p95_ms: float
    wait_mean_ms: float
    wall_time_s: float
    #: recovery metrics (failure layer): goodput counts *first-attempt*
    #: completions per wall second (== throughput_tps when the run carried
    #: no RetryPolicy — nothing can fail), retries_per_task is mean
    #: (attempts − 1), wasted is total killed-execution milliseconds,
    #: failure_rate the permanently-failed fraction.
    goodput_tps: float = 0.0
    retries_per_task: float = 0.0
    wasted_ms_total: float = 0.0
    failure_rate: float = 0.0
    #: message-ledger breakdown (mirrors SimResult's four categories) —
    #: the 55–66% reduction claim decomposed: base enqueue RPCs, probe
    #: traffic, store pushes, addNewLoad flushes.
    msgs_base: int = 0
    msgs_probe: int = 0
    msgs_push: int = 0
    msgs_flush: int = 0

    def row(self) -> str:
        return (f"{self.policy:>14s}  msgs/task={self.msgs_per_task:6.2f}  "
                f"tput={self.throughput_tps:8.2f}/s  "
                f"mk_mean={self.makespan_mean_ms:9.1f}ms  "
                f"mk_p95={self.makespan_p95_ms:9.1f}ms  "
                f"sched_mean={self.sched_mean_ms:6.2f}ms  "
                f"sched_p95={self.sched_p95_ms:6.2f}ms")


def _recovery_metrics(res: SimResult, wall_s: float, sel=None) -> dict:
    """The failure-layer Summary fields from a result's recovery arrays
    (a run without a RetryPolicy: goodput is throughput, the rest zero).
    Goodput counts tasks that completed on their *first* attempt."""
    if res.attempts is None:
        m = res.server.shape[0] if sel is None else int(np.sum(sel))
        return dict(goodput_tps=m / max(wall_s, 1e-9),
                    retries_per_task=0.0, wasted_ms_total=0.0,
                    failure_rate=0.0)
    att = res.attempts if sel is None else res.attempts[sel]
    fail = res.failed if sel is None else res.failed[sel]
    waste = res.wasted_ms if sel is None else res.wasted_ms[sel]
    m = att.shape[0]
    first_try = int(((att == 1) & ~fail).sum())
    return dict(
        goodput_tps=first_try / max(wall_s, 1e-9),
        retries_per_task=float((att - 1).mean()) if m else 0.0,
        wasted_ms_total=float(waste.sum(dtype=np.float64)),
        failure_rate=float(fail.mean()) if m else 0.0,
    )


def summarize(res: SimResult) -> Summary:
    mk = res.makespan_ms
    wall_s = float(res.finish_ms.max() - res.submit_ms.min()) / 1e3
    return Summary(
        policy=res.policy,
        num_tasks=int(res.server.shape[0]),
        msgs_total=res.msgs_total,
        msgs_per_task=res.msgs_per_task,
        throughput_tps=res.server.shape[0] / max(wall_s, 1e-9),
        makespan_mean_ms=float(mk.mean()),
        makespan_p95_ms=float(np.percentile(mk, 95)),
        sched_mean_ms=float(res.sched_ms.mean()),
        sched_p95_ms=float(np.percentile(res.sched_ms, 95)),
        wait_mean_ms=float(res.wait_ms.mean()),
        wall_time_s=wall_s,
        **_recovery_metrics(res, wall_s),
        msgs_base=res.msgs_base, msgs_probe=res.msgs_probe,
        msgs_push=res.msgs_push, msgs_flush=res.msgs_flush,
    )


def utilization_timeline(res: SimResult, cluster: ClusterSpec,
                         dt_ms: float = 10_000.0, *,
                         chunk_cells: int = 8_000_000):
    """Per-server CPU/memory utilization sampled every ``dt_ms`` (paper: 10 s).

    Returns (times_s [T], cpu_util [T, n], mem_util [T, n]) where util is the
    fraction of the server's capacity in use by *running* tasks.

    Vectorized with sample-chunking: a chunk of ``Tc`` sample times builds
    one ``[Tc, m]`` running mask and scatters both resource planes with a
    single flattened ``bincount`` per plane, keeping peak memory under
    ``chunk_cells`` mask cells regardless of T × m.
    """
    t0 = float(res.submit_ms.min())
    t1 = float(res.finish_ms.max())
    times = np.arange(t0, t1 + dt_ms, dt_ms)
    n = cluster.num_servers
    T = times.shape[0]
    m = res.start_ms.shape[0]
    cpu = np.zeros((T, n), np.float64)
    mem = np.zeros((T, n), np.float64)
    chunk = max(1, chunk_cells // max(m, 1))
    for lo in range(0, T, chunk):
        tc = times[lo:lo + chunk, None]                    # [Tc, 1]
        running = (res.start_ms[None, :] <= tc) & (tc < res.finish_ms[None, :])
        si, tj = np.nonzero(running)
        if si.size == 0:
            continue
        flat = si * n + res.server[tj]
        Tc = tc.shape[0]
        cpu[lo:lo + Tc] += np.bincount(
            flat, weights=res.cores[tj], minlength=Tc * n).reshape(Tc, n)
        mem[lo:lo + Tc] += np.bincount(
            flat, weights=res.mem_mb[tj], minlength=Tc * n).reshape(Tc, n)
    cpu /= cluster.C[None, :, 0]
    mem /= cluster.C[None, :, 1]
    return times / 1e3, cpu, mem


def summarize_window(res: SimResult, t0_ms: float, t1_ms: float) -> Summary:
    """:func:`summarize` restricted to tasks *submitted* in [t0, t1) — the
    per-phase view the scenario engine needs (burst vs lull, during vs
    after an outage).  Throughput uses the window length; an empty window
    returns a zero Summary (num_tasks=0)."""
    sel = (res.submit_ms >= t0_ms) & (res.submit_ms < t1_ms)
    cnt = int(sel.sum())
    wall_s = max((t1_ms - t0_ms) / 1e3, 1e-9)
    if cnt == 0:
        return Summary(policy=res.policy, num_tasks=0, msgs_total=0,
                       msgs_per_task=0.0, throughput_tps=0.0,
                       makespan_mean_ms=0.0, makespan_p95_ms=0.0,
                       sched_mean_ms=0.0, sched_p95_ms=0.0,
                       wait_mean_ms=0.0, wall_time_s=wall_s,
                       goodput_tps=0.0, retries_per_task=0.0,
                       wasted_ms_total=0.0, failure_rate=0.0)
    mk = res.makespan_ms[sel]
    sched = res.sched_ms[sel]
    wait = res.wait_ms[sel]
    # The ledger is aggregate-only; attribute it uniformly per task so
    # msgs_per_task stays comparable across phases of one run.
    m_all = max(1, res.server.shape[0])
    per_task = res.msgs_total / m_all
    return Summary(
        policy=res.policy, num_tasks=cnt,
        msgs_total=int(round(per_task * cnt)), msgs_per_task=per_task,
        throughput_tps=cnt / wall_s,
        makespan_mean_ms=float(mk.mean()),
        makespan_p95_ms=float(np.percentile(mk, 95)),
        sched_mean_ms=float(sched.mean()),
        sched_p95_ms=float(np.percentile(sched, 95)),
        wait_mean_ms=float(wait.mean()),
        wall_time_s=wall_s,
        **_recovery_metrics(res, wall_s, sel),
        msgs_base=int(round(res.msgs_base / m_all * cnt)),
        msgs_probe=int(round(res.msgs_probe / m_all * cnt)),
        msgs_push=int(round(res.msgs_push / m_all * cnt)),
        msgs_flush=int(round(res.msgs_flush / m_all * cnt)),
    )


def phase_summaries(res: SimResult, edges_ms) -> list:
    """[(t0, t1, Summary), ...] over consecutive windows between
    ``edges_ms`` — e.g. ``[0, outage_start, outage_end, horizon]`` gives
    before/during/after summaries of an outage scenario."""
    edges = [float(e) for e in edges_ms]
    if len(edges) < 2 or any(b <= a for a, b in zip(edges, edges[1:])):
        raise ValueError("edges_ms must be ≥ 2 strictly increasing times")
    return [(a, b, summarize_window(res, a, b))
            for a, b in zip(edges, edges[1:])]


def fault_stats(res: SimResult) -> dict:
    """The failure layer's scalar accounting for one run: retry counts,
    wasted (killed-execution) work, permanent failures, and goodput
    (degenerate zeros when the run carried no RetryPolicy)."""
    wall_s = float(res.finish_ms.max() - res.submit_ms.min()) / 1e3
    out = _recovery_metrics(res, wall_s)
    if res.attempts is None:
        out.update(num_retried=0, num_failed=0, max_attempts=1)
    else:
        out.update(num_retried=int((res.attempts > 1).sum()),
                   num_failed=int(res.failed.sum()),
                   max_attempts=int(res.attempts.max()))
    return out


def dag_stats(res: SimResult, plan) -> dict:
    """Task-graph accounting for one run against its :class:`DagPlan`.

    critical_path_ms — the realized longest chain: ``cp[v] = (finish[v] −
    start[v]) + max_p(cp[p] + edge_delay)``, maximized over sinks.
    dag_makespan_ms — last finish minus first (effective) submit.
    frontier_width_mean/max — tasks per topological level.
    bytes_moved_mb — Σ edge payload over edges whose endpoints landed on
    *different* servers (what the LocalityModel charges for);
    locality_frac — the fraction of edge payload that stayed local
    (1.0 for an edgeless plan).
    """
    m = res.server.shape[0]
    if plan.m != m:
        raise ValueError(f"plan built for m={plan.m}, result has {m}")
    dur = (res.finish_ms - res.start_ms).astype(np.float64)
    cp = np.zeros(m, np.float64)
    # level order: parents are always in strictly lower levels.
    for t in np.argsort(plan.level, kind="stable"):
        lo, hi = plan.par_indptr[t], plan.par_indptr[t + 1]
        best = 0.0
        if hi > lo:
            best = float(
                (cp[plan.par_idx[lo:hi]] + plan.par_delay[lo:hi]).max())
        cp[t] = dur[t] + best
    widths = np.bincount(plan.level, minlength=plan.num_levels)
    if plan.num_edges:
        u = plan.par_idx
        v = np.repeat(np.arange(m), np.diff(plan.par_indptr))
        remote = res.server[u] != res.server[v]
        total = float(plan.par_bytes.sum(dtype=np.float64))
        moved = float(plan.par_bytes[remote].sum(dtype=np.float64))
    else:
        total = moved = 0.0
    return dict(
        critical_path_ms=float(cp.max()) if m else 0.0,
        dag_makespan_ms=float(res.finish_ms.max() - res.submit_ms.min()),
        frontier_width_mean=float(widths.mean()) if plan.num_levels else 0.0,
        frontier_width_max=int(widths.max()) if plan.num_levels else 0,
        num_levels=int(plan.num_levels),
        num_edges=int(plan.num_edges),
        bytes_moved_mb=moved,
        bytes_total_mb=total,
        locality_frac=1.0 - (moved / total if total > 0.0 else 0.0),
    )


def summarize_dag(res: SimResult, plan) -> dict:
    """:func:`summarize` as a dict, widened with :func:`dag_stats`."""
    out = summarize(res)._asdict()
    out.update(dag_stats(res, plan))
    return out


def time_to_recover_ms(res: SimResult, dynamics) -> float:
    """Time from the last finite outage-window end until the last
    *retried* task completes — how long the cluster takes to drain the
    re-entry backlog an outage created.  0.0 when nothing was retried, no
    window ended, or the backlog drained before the window closed."""
    ends = [float(t1) for _, _, t1 in getattr(dynamics, "outages", ())
            if np.isfinite(t1)]
    if not ends or res.attempts is None:
        return 0.0
    retried = (res.attempts > 1) & ~res.failed
    if not retried.any():
        return 0.0
    last_end = max(ends)
    return float(max(0.0, res.finish_ms[retried].max() - last_end))


def mean_in_system(res: SimResult, t0_ms: float, t1_ms: float) -> float:
    """Time-averaged number of tasks in the system (enqueued, not yet
    finished) over [t0, t1) — cluster-wide; divide by n for the per-server
    queue length."""
    if t1_ms <= t0_ms:
        raise ValueError("need t1_ms > t0_ms")
    lo = np.maximum(res.enqueue_ms, t0_ms)
    hi = np.minimum(res.finish_ms, t1_ms)
    return float(np.clip(hi - lo, 0.0, None).sum(dtype=np.float64)
                 / (t1_ms - t0_ms))


def utilization_stats(res: SimResult, cluster: ClusterSpec,
                      dt_ms: float = 10_000.0):
    """The Fig. 5/7 quantities: cluster-wide mean and variance of per-server
    utilization at each sample, averaged over the busy portion of the run."""
    times, cpu, mem = utilization_timeline(res, cluster, dt_ms)
    busy = cpu.mean(axis=1) > 1e-6
    if not busy.any():
        return dict(cpu_mean=0.0, cpu_var=0.0, mem_mean=0.0, mem_var=0.0)
    return dict(
        cpu_mean=float(cpu[busy].mean()),
        cpu_var=float(cpu[busy].var(axis=1).mean()),
        mem_mean=float(mem[busy].mean()),
        mem_var=float(mem[busy].var(axis=1).mean()),
    )


def resource_violations(res: SimResult, cluster: ClusterSpec,
                        dt_ms: float = 1_000.0) -> int:
    """Sanity invariant: running tasks never exceed server capacity.

    Returns the number of (sample, server) cells violating capacity — must be
    0 for a correct FCFS engine (tolerance for float rounding).
    """
    _, cpu, mem = utilization_timeline(res, cluster, dt_ms)
    return int(((cpu > 1.0 + 1e-6) | (mem > 1.0 + 1e-6)).sum())
