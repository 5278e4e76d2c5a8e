"""FunctionBench workload (§6.3) — the paper's Tables 3 + 4, embedded exactly.

Eight Python serverless tasks with per-node-type cores / memory / duration
profiles (Appendix A, Table 4). Durations vary up to ~4x across node types —
exactly the heterogeneity Dodoor's duration vector d_i targets.

A numpy-only copy of ``repro.workloads.functionbench``, kept array-equal to it by the port's
tests (the port imports nothing of the JAX package).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..sim.cluster import NODE_TYPES

TASK_NAMES = (
    "float_op", "pyaes", "linpack", "matmul",
    "chameleon", "rnn_name_gen", "lr_predict", "lr_train",
)

# Table 4: {task: {node_type: (cores, mem_mb, time_ms)}}
TABLE4 = {
    "float_op": {
        "c6525-25g": (1, 8, 219), "c6620": (2, 8, 275),
        "m510": (2, 8, 349), "xl170": (2, 8, 239),
    },
    "pyaes": {
        "c6525-25g": (1, 9, 222), "c6620": (2, 11, 288),
        "m510": (2, 11, 362), "xl170": (1, 11, 251),
    },
    "linpack": {
        "c6525-25g": (8, 29, 372), "c6620": (14, 34, 504),
        "m510": (4, 35, 595), "xl170": (5, 31, 431),
    },
    "matmul": {
        "c6525-25g": (8, 41, 456), "c6620": (14, 38, 547),
        "m510": (4, 39, 699), "xl170": (5, 37, 473),
    },
    "chameleon": {
        "c6525-25g": (2, 38, 585), "c6620": (2, 37, 569),
        "m510": (2, 38, 966), "xl170": (2, 38, 612),
    },
    "rnn_name_gen": {
        "c6525-25g": (8, 468, 2084), "c6620": (14, 470, 1738),
        "m510": (4, 468, 3132), "xl170": (5, 467, 2068),
    },
    "lr_predict": {
        "c6525-25g": (8, 210, 2937), "c6620": (14, 209, 2462),
        "m510": (4, 210, 4341), "xl170": (5, 210, 3144),
    },
    "lr_train": {
        "c6525-25g": (8, 212, 4744), "c6620": (14, 213, 3532),
        "m510": (4, 212, 16201), "xl170": (5, 212, 7852),
    },
}


def profiles() -> tuple[np.ndarray, np.ndarray]:
    """Returns (res [tasks, T, 2], dur [tasks, T]) in Table-4 node-type order
    aligned with :data:`repro_torch.sim.cluster.NODE_TYPES`."""
    n_tasks, n_types = len(TASK_NAMES), len(NODE_TYPES)
    res = np.zeros((n_tasks, n_types, 2), np.float32)
    dur = np.zeros((n_tasks, n_types), np.float32)
    for i, task in enumerate(TASK_NAMES):
        for j, nt in enumerate(NODE_TYPES):
            cores, mem, ms = TABLE4[task][nt]
            res[i, j] = (cores, mem)
            dur[i, j] = ms
    return res, dur


@dataclass(frozen=True)
class FBWorkload:
    """A synthesized FunctionBench trace.

    r_submit:  [m, 2]    demand declared at submission (mean across types —
                         the static requirement the scheduler sees, §4.1).
    r_exec:    [m, T, 2] actual per-node-type consumption (Table 4).
    d_est:     [m, T]    per-node-type *profiled* duration (ms) — what the
                         scheduler sees (offline profiles, §6.3).
    d_act:     [m, T]    per-node-type *actual* execution duration (ms) —
                         profile × lognormal noise ("actual runtime can
                         differ from profiled averages").
    task_type: [m]       index into TASK_NAMES.
    submit_ms: [m]       Poisson arrival times.
    """

    r_submit: np.ndarray
    r_exec: np.ndarray
    d_est: np.ndarray
    d_act: np.ndarray
    task_type: np.ndarray
    submit_ms: np.ndarray


def synthesize(m: int, qps: float, seed: int = 0,
               duration_noise: float = 0.1) -> FBWorkload:
    """Generate the §6.3 trace: ``m`` tasks, types drawn uniformly, Poisson
    arrivals at ``qps``; executed duration gets lognormal noise around the
    profiled mean ("actual runtime can differ from profiled averages").

    Scales to m ≫ 10⁵ without host-side bottlenecks: everything is O(m)
    vectorized NumPy (profile gathers + one noise multiply), no per-task
    Python and no redundant float32 round-trips."""
    rng = np.random.RandomState(seed)
    res, dur = profiles()
    task_type = rng.randint(0, len(TASK_NAMES), size=m).astype(np.int32)
    inter = rng.exponential(1000.0 / qps, size=m)
    submit = np.cumsum(inter).astype(np.float32)

    noise = np.exp(rng.normal(0.0, duration_noise, size=(m, 1))).astype(np.float32)
    d_est = dur[task_type]                           # [m, T] profile means
    d_act = d_est * noise                            # [m, T] noised actuals
    r_exec = res[task_type]                          # [m, T, 2]
    r_submit = r_exec.mean(axis=1, dtype=np.float32)  # [m, 2]
    return FBWorkload(r_submit=r_submit, r_exec=r_exec, d_est=d_est,
                      d_act=d_act, task_type=task_type, submit_ms=submit)
