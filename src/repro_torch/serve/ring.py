"""Host-side arrival ring buffer — a copy of ``repro.serve.ring``, which
imports only numpy.

Bounded, preallocated numpy storage for in-flight arrivals: ``push``
appends a chunk (any size), ``pop`` removes exactly the rows a decision
block consumes.  Alongside the five workload planes each task carries
its host enqueue timestamp (``time.perf_counter`` seconds, recorded by
the service at submit), which is what per-decision scheduling latency —
enqueue → placement — is measured from.

Pure numpy: the ring is the host side of the service loop and does not
touch the device (uploads happen once per block, in the service).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class ArrivalRows(NamedTuple):
    """A contiguous batch popped from the ring (copies — the ring slots
    are immediately reusable)."""
    r_submit: np.ndarray    # [k, K]
    r_exec: np.ndarray      # [k, TT, K]
    d_est: np.ndarray       # [k, TT]
    d_act: np.ndarray       # [k, TT]
    submit_ms: np.ndarray   # [k]  virtual trace time
    t_enq: np.ndarray       # [k]  host perf_counter at submit (seconds)


class ArrivalRing:
    """Fixed-capacity FIFO over the workload planes.

    ``capacity`` bounds the number of buffered (submitted but not yet
    scheduled) tasks; pushing past it raises — open-loop callers size it
    to their stream, closed-loop callers need only ``b``.
    """

    def __init__(self, capacity: int, num_types: int, k: int = 2):
        if capacity < 1:
            raise ValueError(f"capacity must be ≥ 1, got {capacity}")
        self.capacity = int(capacity)
        c = self.capacity
        self._r_submit = np.zeros((c, k), np.float32)
        self._r_exec = np.zeros((c, num_types, k), np.float32)
        self._d_est = np.zeros((c, num_types), np.float32)
        self._d_act = np.zeros((c, num_types), np.float32)
        self._submit_ms = np.zeros((c,), np.float32)
        self._t_enq = np.zeros((c,), np.float64)
        self._head = 0          # next row to pop
        self._count = 0

    def __len__(self) -> int:
        return self._count

    @property
    def count(self) -> int:
        return self._count

    @property
    def free(self) -> int:
        return self.capacity - self._count

    def push(self, r_submit, r_exec, d_est, d_act, submit_ms,
             t_enq: float) -> int:
        """Append a chunk; every plane must agree on the chunk length.
        ``t_enq`` (one host timestamp for the whole chunk) is recorded
        per task.  Returns the number of tasks accepted."""
        r_submit = np.asarray(r_submit, np.float32)
        k = r_submit.shape[0]
        if k == 0:
            return 0
        if k > self.free:
            raise RuntimeError(
                f"arrival ring full: {self._count}/{self.capacity} held, "
                f"chunk of {k} rejected — step()/flush() the service, or "
                f"raise DecisionService(capacity=...)")
        rows = (self._head + self._count + np.arange(k)) % self.capacity
        for buf, arr in ((self._r_submit, r_submit),
                         (self._r_exec, np.asarray(r_exec, np.float32)),
                         (self._d_est, np.asarray(d_est, np.float32)),
                         (self._d_act, np.asarray(d_act, np.float32)),
                         (self._submit_ms,
                          np.asarray(submit_ms, np.float32))):
            if arr.shape[0] != k or arr.shape[1:] != buf.shape[1:]:
                raise ValueError(
                    f"chunk plane shape {arr.shape} does not match ring "
                    f"slot {(k,) + buf.shape[1:]}")
            buf[rows] = arr
        self._t_enq[rows] = float(t_enq)
        self._count += k
        return k

    def pop(self, k: int) -> ArrivalRows:
        """Remove and return the oldest ``k`` rows (copies)."""
        if k < 1 or k > self._count:
            raise ValueError(f"pop({k}) from ring holding {self._count}")
        rows = (self._head + np.arange(k)) % self.capacity
        out = ArrivalRows(
            r_submit=self._r_submit[rows],
            r_exec=self._r_exec[rows],
            d_est=self._d_est[rows],
            d_act=self._d_act[rows],
            submit_ms=self._submit_ms[rows],
            t_enq=self._t_enq[rows],
        )
        self._head = (self._head + k) % self.capacity
        self._count -= k
        return out
