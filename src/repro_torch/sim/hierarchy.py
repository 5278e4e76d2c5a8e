"""Hierarchical mini-clusters (§4.2) — counterpart of
``repro.sim.hierarchy``.

"Dodoor is designed to natively support hierarchical mini-clusters ...
each server can be mapped to different schedulers and data stores within
its own mini-cluster." Operators split the fleet into k independent
mini-clusters — each with its own scheduler set, data store, and batch
counter — and route submissions round-robin across them. No cross-cluster
state exists, so mini-clusters fail, scale, and recover independently
(the reliability argument of §4.2/§4.3).

Implementation: partition the fleet round-robin by node index (preserving
the type mix per mini-cluster), split the task trace round-robin, run the
port's engine per mini-cluster, and merge results in submission order.
"""
from __future__ import annotations

from dataclasses import replace as dc_replace

import numpy as np

from .cluster import ClusterSpec
from .engine import Dynamics, EngineConfig, SimResult, simulate


def _restrict_dynamics(dynamics: Dynamics, idx: np.ndarray) -> Dynamics:
    """Project a fleet-global :class:`Dynamics` timeline onto one
    mini-cluster: per-server windows on servers inside ``idx`` are kept
    with their ids remapped to the part's local numbering; windows on
    servers outside the part are dropped.  Store outages and the cache
    fault spec apply to every part unchanged (each part's store and
    scheduler link degrade under the one global spec)."""
    local = {int(g): li for li, g in enumerate(np.asarray(idx))}

    def remap(entries):
        return tuple((local[int(e[0])],) + tuple(e[1:])
                     for e in entries if int(e[0]) in local)

    return Dynamics(outages=remap(dynamics.outages),
                    joins=remap(dynamics.joins),
                    leaves=remap(dynamics.leaves),
                    slowdowns=remap(dynamics.slowdowns),
                    store_outages=dynamics.store_outages,
                    cache_faults=dynamics.cache_faults)


def _take_tasks(workload, sel: np.ndarray):
    """The sub-workload of the tasks at indices ``sel`` (submission order
    preserved)."""
    return dc_replace(
        workload,
        r_submit=workload.r_submit[sel],
        r_exec=workload.r_exec[sel],
        d_est=workload.d_est[sel],
        d_act=workload.d_act[sel],
        task_type=workload.task_type[sel],
        submit_ms=workload.submit_ms[sel],
    )


def split_cluster(cluster: ClusterSpec, k: int):
    """k mini-clusters with interleaved membership (type mix preserved).
    Returns list of (spec, global_server_indices)."""
    out = []
    for c in range(k):
        idx = np.arange(c, cluster.num_servers, k)
        out.append((ClusterSpec(C=cluster.C[idx],
                                node_type=cluster.node_type[idx],
                                type_names=cluster.type_names), idx))
    return out


def simulate_hierarchical(workload, cluster: ClusterSpec, cfg: EngineConfig,
                          k: int, seed: int = 0, mode: str = "batched",
                          b: int | None = None,
                          dynamics: Dynamics | None = None,
                          device=None) -> SimResult:
    """Run k independent mini-clusters; tasks round-robin across them,
    mini-cluster ``c`` with seed ``seed + c``.

    ``mode`` selects the engine driver per mini-cluster (see
    :func:`repro_torch.sim.simulate`; the port's default is
    ``"batched"``, the reference's ``"sequential"``).  ``b=None`` derives
    the paper's n/2 batch from each mini-cluster's own fleet size; an int
    applies that batch size to every mini-cluster (``b=cfg.b`` keeps the
    caller's).  ``dynamics`` is a fleet-global timeline in the full
    cluster's server numbering (see :func:`_restrict_dynamics`).
    ``device`` is passed to every :func:`simulate` call (default: the
    GPU).  ``run_study(..., server_shards=k)`` runs this per grid point.
    """
    m = workload.r_submit.shape[0]
    parts = split_cluster(cluster, k)
    assign = np.arange(m) % k
    if dynamics is not None:
        for field in ("outages", "joins", "leaves", "slowdowns"):
            for e in getattr(dynamics, field):
                if not 0 <= int(e[0]) < cluster.num_servers:
                    raise ValueError(
                        f"dynamics server {int(e[0])} outside fleet of "
                        f"{cluster.num_servers}")

    results = []
    for c, (spec, idx) in enumerate(parts):
        sel = np.where(assign == c)[0]
        sub = _take_tasks(workload, sel)
        sub_b = max(1, spec.num_servers // 2) if b is None else int(b)
        part_dyn = None if dynamics is None \
            else _restrict_dynamics(dynamics, idx)
        res = simulate(sub, spec, cfg._replace(b=sub_b), seed=seed + c,
                       mode=mode, dynamics=part_dyn, device=device)
        results.append((res, sel, idx))

    policies = {res.policy for res, _, _ in results}
    assert policies == {cfg.policy}, policies
    server = np.zeros(m, np.int32)
    arrays = {f: np.zeros(m, np.float32) for f in
              ("submit_ms", "enqueue_ms", "start_ms", "finish_ms",
               "sched_ms", "cores", "mem_mb")}
    msgs = np.zeros(4, np.int64)
    # Failure and trace planes interleave like the rest: each mini-cluster
    # runs its own wave loop and traces its own share (part-local
    # scheduler round robin).
    retry = cfg.retry is not None
    attempts = np.ones(m, np.int32) if retry else None
    failed = np.zeros(m, bool) if retry else None
    wasted = np.zeros(m, np.float32) if retry else None
    tr = ({"view_age_ms": np.zeros(m, np.float32),
           "view_err": np.zeros(m, np.float32),
           "misplaced": np.zeros(m, bool),
           "cache_push": np.zeros(m, bool),
           "sched_id": np.zeros(m, np.int32),
           "decision_ms": np.zeros(m, np.float32)} if cfg.trace else {})
    for res, sel, idx in results:
        server[sel] = idx[res.server]
        for f in arrays:
            arrays[f][sel] = getattr(res, f)
        if retry:
            attempts[sel] = res.attempts
            failed[sel] = res.failed
            wasted[sel] = res.wasted_ms
        for f in tr:
            tr[f][sel] = getattr(res, f)
        msgs += [res.msgs_base, res.msgs_probe, res.msgs_push,
                 res.msgs_flush]
    return SimResult(server=server, msgs_base=int(msgs[0]),
                     msgs_probe=int(msgs[1]), msgs_push=int(msgs[2]),
                     msgs_flush=int(msgs[3]), policy=policies.pop(),
                     attempts=attempts, failed=failed, wasted_ms=wasted,
                     **arrays, **tr)
