"""Chrome trace-event export of a simulation run.

:func:`to_chrome_trace` renders a :class:`~repro_torch.sim.SimResult` as the
Chrome trace-event JSON object format — load the file in Perfetto
(https://ui.perfetto.dev) or ``chrome://tracing`` to scrub through task
lifecycles on a timeline.

Track layout:

* pid 1 ``servers`` — one thread track per server (``srv 3 (large)``),
  holding each task's execution slice (``X``: start → finish, with
  enqueue/cores/mem in args) plus instant markers for killed work and
  permanent failures (from the retry planes);
* pid 2 ``schedulers`` — one thread track per scheduler, holding each
  decision's scheduling slice (``X``: submit → enqueue, i.e. the
  ``sched_ms`` latency), retry re-entry markers, per-scheduler
  ``view_age_ms`` counter tracks (``C``; traced runs only — a CacheFaults
  loss shows up as the sawtooth ramping past the batch period), and
  global cache-push instants.

All timestamps are microseconds (the format's unit); ``displayTimeUnit``
is ms so the UI matches the simulator's clock.
"""
from __future__ import annotations

import json

import numpy as np

_SERVERS_PID = 1
_SCHED_PID = 2


def _lifecycle_events(res, cluster) -> list:
    m = int(res.server.shape[0])
    server = np.asarray(res.server)
    submit = np.asarray(res.submit_ms, np.float64)
    enq = np.asarray(res.enqueue_ms, np.float64)
    start = np.asarray(res.start_ms, np.float64)
    finish = np.asarray(res.finish_ms, np.float64)
    if res.sched_id is not None:
        sched = np.asarray(res.sched_id)
    else:
        # Cadence of the plain (non-wave) drivers: round-robin by
        # submission order.  Wave-loop runs always carry sched_id.
        sched = np.arange(m) % 5
    attempts = (np.asarray(res.attempts) if res.attempts is not None
                else np.ones(m, np.int32))
    failed = (np.asarray(res.failed) if res.failed is not None
              else np.zeros(m, bool))
    wasted = (np.asarray(res.wasted_ms, np.float64)
              if res.wasted_ms is not None else np.zeros(m))

    ev = []
    for i in range(m):
        j = int(server[i])
        s = int(sched[i])
        ev.append({"ph": "X", "pid": _SCHED_PID, "tid": s,
                   "ts": submit[i] * 1e3,
                   "dur": max(0.0, (enq[i] - submit[i]) * 1e3),
                   "name": f"sched task {i}", "cat": "sched"})
        ev.append({"ph": "X", "pid": _SERVERS_PID, "tid": j,
                   "ts": start[i] * 1e3,
                   "dur": max(0.0, (finish[i] - start[i]) * 1e3),
                   "name": f"task {i}", "cat": "exec",
                   "args": {"enqueue_ms": float(enq[i]),
                            "cores": float(res.cores[i]),
                            "mem_mb": float(res.mem_mb[i]),
                            "attempts": int(attempts[i])}})
        if attempts[i] > 1:
            ev.append({"ph": "i", "pid": _SCHED_PID, "tid": s,
                       "ts": submit[i] * 1e3, "s": "t",
                       "name": f"retry ×{int(attempts[i]) - 1}",
                       "cat": "retry"})
        if wasted[i] > 0.0:
            ev.append({"ph": "i", "pid": _SERVERS_PID, "tid": j,
                       "ts": start[i] * 1e3, "s": "t",
                       "name": f"killed work ({wasted[i]:.1f} ms)",
                       "cat": "kill"})
        if failed[i]:
            ev.append({"ph": "i", "pid": _SERVERS_PID, "tid": j,
                       "ts": finish[i] * 1e3, "s": "t",
                       "name": f"task {i} failed", "cat": "fail"})
    return ev


def _telemetry_events(res) -> list:
    """Traced runs only: staleness counters + cache-push instants."""
    ev = []
    if res.view_age_ms is None:
        return ev
    dms = np.asarray(res.decision_ms, np.float64)
    age = np.asarray(res.view_age_ms, np.float64)
    sched = np.asarray(res.sched_id)
    push = np.asarray(res.cache_push)
    for i in range(age.shape[0]):
        ev.append({"ph": "C", "pid": _SCHED_PID,
                   "ts": dms[i] * 1e3,
                   "name": f"view_age_s{int(sched[i])}",
                   "args": {"ms": float(age[i])}})
        if push[i]:
            ev.append({"ph": "i", "pid": _SCHED_PID, "tid": 0,
                       "ts": dms[i] * 1e3, "s": "g",
                       "name": "cache push", "cat": "push"})
    return ev


def to_chrome_trace(res, cluster, path=None) -> dict:
    """Render ``res`` (tasks placed on ``cluster``) as a Chrome trace.

    Returns the trace dict (``{"traceEvents": [...], ...}``) and, when
    ``path`` is given, writes it there as JSON.  Works on any SimResult;
    a traced run (``EngineConfig(trace=True)``) additionally gets the
    per-scheduler staleness counter tracks and cache-push instants, and
    exact scheduler-track attribution (untraced runs fall back to the
    round-robin cadence of the plain drivers).

    Output is deterministic: events are sorted by (pid, tid, ts, name),
    so equal inputs produce byte-equal files (round-trip pinned by
    ``tests/test_obs.py``).
    """
    names = list(getattr(cluster, "type_names", ()))
    node_type = np.asarray(cluster.node_type)
    n = int(cluster.num_servers)

    meta = [{"ph": "M", "pid": _SERVERS_PID, "name": "process_name",
             "args": {"name": "servers"}},
            {"ph": "M", "pid": _SCHED_PID, "name": "process_name",
             "args": {"name": "schedulers"}}]
    for j in sorted(set(np.asarray(res.server).tolist())):
        t = int(node_type[j]) if j < n else -1
        tname = names[t] if 0 <= t < len(names) else "?"
        meta.append({"ph": "M", "pid": _SERVERS_PID, "tid": int(j),
                     "name": "thread_name",
                     "args": {"name": f"srv {int(j)} ({tname})"}})

    body = _lifecycle_events(res, cluster) + _telemetry_events(res)
    body.sort(key=lambda e: (e["pid"], e.get("tid", -1), e.get("ts", 0.0),
                             e.get("name", "")))
    doc = {"traceEvents": meta + body, "displayTimeUnit": "ms",
           "otherData": {"policy": res.policy,
                         "tasks": int(res.server.shape[0]),
                         "servers": n}}
    if path is not None:
        with open(path, "w") as f:
            json.dump(doc, f, separators=(",", ":"))
    return doc
