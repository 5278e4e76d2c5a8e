"""Task-graph workloads: dependency structure over a task trace.

Every workload the engine consumed before this module was a *bag* of
independent tasks — the easiest case for a b-batched balls-into-bins
scheduler.  A DAG spec attaches a precedence graph to the first ``m``
tasks of any trace: edge ``(u, v)`` means task ``v`` cannot be submitted
before ``finish[u] + edge_delay_ms`` (data transfer / trigger latency),
and carries ``edge_bytes_mb`` of parent output that the locality term in
Algorithm 1 charges for when ``v`` lands on a different server than
``u`` (see :class:`repro_torch.sim.LocalityModel`).

Specs follow the ``arrivals`` pattern: small hashable NamedTuples
(cache/equality keys, usable inside :class:`repro_torch.sim.Scenario`), with
the expensive per-``m`` lowering — topological levels, parent/child CSR
planes, padded parent gather planes — memoized in :func:`dag_plan`.

Generated graphs number tasks in topological order (every edge has
``u < v``), so submission order and precedence order agree the way a
real trace's would; :class:`ExplicitDAG` accepts arbitrary edges and is
validated for acyclicity (Kahn), raising ``ValueError`` on a cycle.

A numpy-only copy of ``repro.workloads.dags``, kept array-equal to it by
the port's tests (the port imports nothing of the JAX package).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class ChainDAG(NamedTuple):
    """A serverless chain: task i → task i+1 for the whole trace (the
    FunctionBench pipeline shape).  Collapses the engine to sequential
    FCFS — exactly one task is ever ready."""

    edge_delay_ms: float = 0.0
    edge_bytes_mb: float = 0.0


class FanOutDAG(NamedTuple):
    """Fork-join blocks of ``width + 2`` tasks: a root fans out to
    ``width`` children which fan back into a sink.  A trailing partial
    block leaves its tasks independent (a ragged trace tail)."""

    width: int = 8
    edge_delay_ms: float = 0.0
    edge_bytes_mb: float = 0.0


class MapReduceDAG(NamedTuple):
    """Chained map-reduce stages of ``mappers + reducers`` tasks: every
    reducer of a stage depends on all of that stage's mappers, and every
    mapper of the next stage depends on all previous-stage reducers (the
    shuffle barrier).  A trailing partial stage keeps whatever edges its
    present tasks support."""

    mappers: int = 8
    reducers: int = 2
    edge_delay_ms: float = 0.0
    edge_bytes_mb: float = 0.0


class LayeredDAG(NamedTuple):
    """Random layered DAG: consecutive layers of ``width`` tasks, each
    (layer l, layer l+1) pair connected independently with probability
    ``density`` (seeded, so the spec is a reproducible key)."""

    width: int = 8
    density: float = 0.25
    edge_delay_ms: float = 0.0
    edge_bytes_mb: float = 0.0
    seed: int = 0


class ExplicitDAG(NamedTuple):
    """An explicit edge list ``((u, v[, delay_ms[, bytes_mb]]), ...)``.
    The only spec that can encode a cycle — :func:`dag_plan` validates
    and raises ``ValueError``.  ``ExplicitDAG()`` is the edgeless DAG,
    pinned bit-identical to the independent-task engine."""

    edges: tuple = ()


DAG_SPECS = (ChainDAG, FanOutDAG, MapReduceDAG, LayeredDAG, ExplicitDAG)


class DagPlan(NamedTuple):
    """The lowered, memoized form of a DAG spec at trace length ``m``.

    ``level`` assigns each task its longest-path depth (Kahn order): the
    engine's wave loop schedules level 0, then level 1, … so every
    task's parents have finished (and their placements are known to the
    locality gather) before it is submitted.  ``parents_pad`` and its
    delay/bytes planes are ``[m, P]`` gather operands (−1 / 0.0 padded,
    ``P = max(1, max_parents)``) — the per-candidate locality stream the
    fused megakernel consumes.  CSR planes serve host-side metrics
    (critical path, bytes moved).  All arrays are write-protected."""

    m: int
    num_edges: int
    num_levels: int
    max_parents: int
    level: np.ndarray         # [m] int32 longest-path level
    parents_pad: np.ndarray   # [m, P] int32, -1 where absent
    pdelay_pad: np.ndarray    # [m, P] float32, 0 where absent
    pbytes_pad: np.ndarray    # [m, P] float32, 0 where absent
    par_indptr: np.ndarray    # [m+1] int64 CSR over parents
    par_idx: np.ndarray       # [E] int32 parent ids
    par_delay: np.ndarray     # [E] float32 edge delays (ms)
    par_bytes: np.ndarray     # [E] float32 edge payloads (MB)
    child_indptr: np.ndarray  # [m+1] int64 CSR over children
    child_idx: np.ndarray     # [E] int32 child ids


def dag_edges(spec, m: int) -> np.ndarray:
    """The spec's edge list at trace length ``m`` as a float64
    ``[E, 4]`` array of (u, v, delay_ms, bytes_mb) rows."""
    d, y = (float(getattr(spec, "edge_delay_ms", 0.0)),
            float(getattr(spec, "edge_bytes_mb", 0.0)))
    edges: list = []
    if isinstance(spec, ChainDAG):
        edges = [(i, i + 1, d, y) for i in range(m - 1)]
    elif isinstance(spec, FanOutDAG):
        w = int(spec.width)
        if w < 1:
            raise ValueError("FanOutDAG.width must be ≥ 1")
        blk = w + 2
        for base in range(0, m - blk + 1, blk):
            root, sink = base, base + w + 1
            for c in range(base + 1, base + w + 1):
                edges.append((root, c, d, y))
                edges.append((c, sink, d, y))
    elif isinstance(spec, MapReduceDAG):
        M, R = int(spec.mappers), int(spec.reducers)
        if M < 1 or R < 1:
            raise ValueError("MapReduceDAG needs mappers ≥ 1, reducers ≥ 1")
        blk = M + R
        prev_reducers: list = []
        for base in range(0, m, blk):
            mappers = [t for t in range(base, min(base + M, m))]
            reducers = [t for t in range(base + M, min(base + blk, m))]
            for mt in mappers:
                for pr in prev_reducers:
                    edges.append((pr, mt, d, y))
            for rt in reducers:
                for mt in mappers:
                    edges.append((mt, rt, d, y))
            prev_reducers = reducers
    elif isinstance(spec, LayeredDAG):
        w = int(spec.width)
        if w < 1:
            raise ValueError("LayeredDAG.width must be ≥ 1")
        if not 0.0 <= float(spec.density) <= 1.0:
            raise ValueError("LayeredDAG.density must be in [0, 1]")
        rng = np.random.RandomState(int(spec.seed))
        layers = [list(range(s, min(s + w, m))) for s in range(0, m, w)]
        for lo, hi in zip(layers[:-1], layers[1:]):
            draw = rng.rand(len(lo), len(hi)) < float(spec.density)
            for i, u in enumerate(lo):
                for k, v in enumerate(hi):
                    if draw[i, k]:
                        edges.append((u, v, d, y))
    elif isinstance(spec, ExplicitDAG):
        for e in spec.edges:
            u, v = int(e[0]), int(e[1])
            ed = float(e[2]) if len(e) > 2 else 0.0
            eb = float(e[3]) if len(e) > 3 else 0.0
            if not (0 <= u < m and 0 <= v < m):
                raise ValueError(f"edge ({u}, {v}) outside trace of {m}")
            if u == v:
                raise ValueError(f"self-edge on task {u}")
            edges.append((u, v, ed, eb))
    else:
        raise TypeError(f"unknown DAG spec {type(spec).__name__}")
    out = np.asarray(edges, np.float64).reshape(len(edges), 4)
    if len(edges) and (out[:, 2] < 0).any():
        raise ValueError("edge_delay_ms must be ≥ 0")
    if len(edges) and (out[:, 3] < 0).any():
        raise ValueError("edge_bytes_mb must be ≥ 0")
    return out


#: Plan cache, keyed (spec, m) — the `arrivals._TIMES_CACHE` idiom:
#: bounded, cleared wholesale when full, values write-protected.
_PLAN_CACHE: dict = {}
_PLAN_CACHE_MAX = 128


def dag_plan(spec, m: int) -> DagPlan:
    """Lower ``spec`` at trace length ``m`` to a :class:`DagPlan`
    (memoized).  Passing an existing plan returns it unchanged when its
    ``m`` matches — the engine accepts either form."""
    if isinstance(spec, DagPlan):
        if spec.m != int(m):
            raise ValueError(f"plan built for m={spec.m}, workload has {m}")
        return spec
    m = int(m)
    if m < 1:
        raise ValueError("dag_plan needs m ≥ 1")
    key = (spec, m)
    hit = _PLAN_CACHE.get(key)
    if hit is not None:
        return hit

    edges = dag_edges(spec, m)
    E = edges.shape[0]
    u = edges[:, 0].astype(np.int64)
    v = edges[:, 1].astype(np.int64)

    # Kahn levels (longest path): also the acyclicity proof — any task
    # left unprocessed sits on a cycle.
    indeg = np.bincount(v, minlength=m).astype(np.int64)
    children = [[] for _ in range(m)]
    for ei in range(E):
        children[u[ei]].append(ei)
    level = np.zeros(m, np.int64)
    frontier = list(np.flatnonzero(indeg == 0))
    done = 0
    while frontier:
        nxt: list = []
        for t in frontier:
            done += 1
            for ei in children[t]:
                c = int(v[ei])
                level[c] = max(level[c], level[t] + 1)
                indeg[c] -= 1
                if indeg[c] == 0:
                    nxt.append(c)
        frontier = nxt
    if done != m:
        raise ValueError(
            f"DAG spec {type(spec).__name__} has a cycle: "
            f"{m - done} of {m} tasks unreachable in topological order")

    # Parent/child CSR planes.
    order_p = np.lexsort((u, v))              # group by child, parents asc
    par_idx = u[order_p].astype(np.int32)
    par_delay = edges[order_p, 2].astype(np.float32)
    par_bytes = edges[order_p, 3].astype(np.float32)
    par_counts = np.bincount(v, minlength=m)
    par_indptr = np.zeros(m + 1, np.int64)
    np.cumsum(par_counts, out=par_indptr[1:])
    order_c = np.lexsort((v, u))
    child_idx = v[order_c].astype(np.int32)
    child_indptr = np.zeros(m + 1, np.int64)
    np.cumsum(np.bincount(u, minlength=m), out=child_indptr[1:])

    max_parents = int(par_counts.max()) if m else 0
    P = max(1, max_parents)
    parents_pad = np.full((m, P), -1, np.int32)
    pdelay_pad = np.zeros((m, P), np.float32)
    pbytes_pad = np.zeros((m, P), np.float32)
    for t in range(m):
        lo, hi = par_indptr[t], par_indptr[t + 1]
        k = hi - lo
        if k:
            parents_pad[t, :k] = par_idx[lo:hi]
            pdelay_pad[t, :k] = par_delay[lo:hi]
            pbytes_pad[t, :k] = par_bytes[lo:hi]

    plan = DagPlan(
        m=m, num_edges=int(E), num_levels=int(level.max()) + 1 if m else 0,
        max_parents=max_parents, level=level.astype(np.int32),
        parents_pad=parents_pad, pdelay_pad=pdelay_pad,
        pbytes_pad=pbytes_pad, par_indptr=par_indptr, par_idx=par_idx,
        par_delay=par_delay, par_bytes=par_bytes,
        child_indptr=child_indptr, child_idx=child_idx)
    for a in plan[4:]:
        a.setflags(write=False)
    if len(_PLAN_CACHE) >= _PLAN_CACHE_MAX:
        _PLAN_CACHE.clear()
    _PLAN_CACHE[key] = plan
    return plan
