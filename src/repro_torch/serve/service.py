"""The streaming decision service — counterpart of ``repro.serve.service``.

:class:`DecisionService` ingests arrival chunks through a host-side ring
buffer (:class:`~repro_torch.serve.ring.ArrivalRing`), re-blocks them into
``b``-task decision blocks, and runs one call of the batched driver's
block step (:func:`repro_torch.sim.engine._block_step`) per block on a
carry that stays on the device: ring buffers, unit clocks, cached views,
Prequal's pools and the message ledger are updated there, block after
block.  The block's planes are uploaded per step, and its draws come from
the task ids (:func:`~repro_torch.sim.engine._task_draws`), as the offline
driver makes them.  On the card the dodoor and (1+β) decisions launch the
decision kernel once per block (K1, or K2 under down windows); PoT and
Prequal launch none, and neither does a service under cache faults,
whose per-scheduler views the block step scores in torch ops.

Bit-exactness contract: feeding the service the same arrival plane as
``simulate(mode="batched")`` — same order, any chunking — yields
bit-identical placements, timestamps and message ledger for all five
policies.  The service replicates the offline driver's block
decomposition exactly: global decision indices are a running ``arange``,
full blocks carry an all-true validity mask, the push is decided on the
host from the block's last row, and :meth:`DecisionService.flush`
edge-pads the ragged tail with the last task's row and advances the index
past the pad, so the scheduler round robin and the flush cadence stay
those of the offline run.

Cache snapshots are double-buffered per §3.2: each block boundary
publishes the post-push cached view into the non-live host buffer and
flips the pointer, so :meth:`DecisionService.snapshot` readers always see
a complete snapshot while the next block writes the other one.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .._device import resolve_device
from ..sim.cluster import ClusterSpec
from ..sim.engine import (Dynamics, EngineConfig, SimResult, _Carry,
                          _block_step, _check_mode, _init_carry, _make_ctx,
                          _suppress_push, _task_draws, _validate_config)
from ..sim.state import carry_from_numpy
from .latency import LatencyRecorder
from .ring import ArrivalRing, ArrivalRows


class DecisionService:
    """Online scheduling over the offline engine's exact arithmetic.

    Usage::

        svc = DecisionService(cluster, EngineConfig(policy="dodoor", b=50))
        svc.submit_workload(wl)          # or submit(...) per chunk
        svc.drain()                      # run every full decision block
        svc.flush()                      # edge-padded ragged tail
        res = svc.result()               # SimResult, bit-exact vs offline

    Supported knobs mirror ``simulate(mode="batched")`` for independent
    tasks: all five policies and ``dynamics`` timelines including
    ``cache_faults``.  ``cfg.retry``, ``cfg.trace``, ``cfg.locality`` and
    DAG workloads run host-side wave loops or post-passes around the
    block loop and are not streamable — they raise
    ``NotImplementedError``, as in the reference.  ``device`` defaults to
    the GPU and raises without one; pass ``device="cpu"`` to serve on the
    CPU.  The reference's ``compiles`` count (its jitted step's cache
    size) has no meaning in eager PyTorch and is left out.
    """

    def __init__(self, cluster: ClusterSpec, cfg: EngineConfig, *,
                 seed: int = 0, dynamics=None, capacity: int = 1 << 16,
                 publish_snapshots: bool = True, device=None):
        _validate_config(cfg)
        if cfg.retry is not None:
            raise NotImplementedError(
                "DecisionService with a RetryPolicy: the re-entry queue "
                "is a host-side wave loop over the whole stream — run "
                "retries offline via simulate().")
        if cfg.trace:
            raise NotImplementedError(
                "DecisionService with cfg.trace: the decision-trace "
                "ground truth is an offline post-pass — trace via "
                "simulate(mode='batched').")
        if cfg.locality is not None:
            raise NotImplementedError(
                "DecisionService with a LocalityModel: the locality "
                "gather needs parent placements, which only the offline "
                "DAG frontier loop carries.")
        if cfg.outage_ms:
            raise ValueError(
                "EngineConfig.outage_ms is deprecated — pass "
                "Dynamics(store_outages=...) as dynamics.")
        if dynamics is not None and not isinstance(dynamics, Dynamics):
            raise TypeError(f"dynamics must be a Dynamics spec, got "
                            f"{type(dynamics).__name__}")
        _check_mode(cfg, "batched")

        self.cluster = cluster
        self.cfg = cfg
        self._dev = resolve_device(device)
        self._b = cfg.b
        self._seed = int(seed)
        self._ctx = _make_ctx(cluster, cfg, self._seed, self._dev, dynamics)
        win = self._ctx.win
        # The push plan is decided on the host: keep the store windows there.
        self._win_host = win._replace(store0=win.store0.cpu(),
                                      store1=win.store1.cpu())
        self._faulted = self._ctx.faulted
        self._carry = _init_carry(cfg, cluster.num_servers,
                                  self._ctx.cores_per, self._faulted)

        self._ring = ArrivalRing(capacity, cluster.num_types)
        self._next_idx = 0
        self._ring_pad = 0    # pad decisions consumed by flush() tails
        self._steps = 0
        self._outs: list[list[np.ndarray]] = [[] for _ in range(8)]
        self.decision_latency = LatencyRecorder()
        self.step_wall = LatencyRecorder()
        self._publish = publish_snapshots
        self._snaps: list[dict | None] = [None, None]
        self._live = -1           # index of the published snapshot buffer

    # -- ingestion --------------------------------------------------------

    @property
    def available(self) -> int:
        """Buffered (submitted, not yet scheduled) tasks."""
        return self._ring.count

    @property
    def scheduled(self) -> int:
        """Decisions made so far (valid tasks through step/flush)."""
        return self._next_idx - self._ring_pad

    def submit(self, r_submit, r_exec, d_est, d_act, submit_ms) -> int:
        """Enqueue an arrival chunk (numpy planes, any length ≥ 0).
        Records one host enqueue timestamp for the chunk — the start of
        each task's enqueue→placement latency."""
        return self._ring.push(r_submit, r_exec, d_est, d_act, submit_ms,
                               time.perf_counter())

    def submit_workload(self, workload, start: int = 0,
                        stop: int | None = None) -> int:
        """Enqueue a slice of a workload trace (``FBWorkload``-shaped:
        r_submit/r_exec/d_est/d_act/submit_ms)."""
        sl = slice(start, stop)
        return self.submit(workload.r_submit[sl], workload.r_exec[sl],
                           workload.d_est[sl], workload.d_act[sl],
                           workload.submit_ms[sl])

    # -- the step ---------------------------------------------------------

    def step(self) -> int:
        """Run one full decision block (requires ``available ≥ b``).
        Returns the number of tasks placed (= b)."""
        b = self._b
        if self._ring.count < b:
            raise ValueError(
                f"step() needs a full block: {self._ring.count} buffered "
                f"< b={b}; submit more, or flush() the ragged tail")
        return self._run_block(self._ring.pop(b), b)

    def drain(self) -> int:
        """Step every full block currently buffered; returns tasks
        placed."""
        done = 0
        while self._ring.count >= self._b:
            done += self.step()
        return done

    def flush(self) -> int:
        """Drain, then run the ragged tail (< b tasks) as one edge-padded
        block — identical to the offline driver's ``np.pad(mode="edge")``
        tail, so placements and ledger stay bit-exact.  Returns tasks
        placed."""
        done = self.drain()
        k = self._ring.count
        if k == 0:
            return done
        rows = self._ring.pop(k)
        pad = self._b - k

        def edge(a):
            return np.concatenate(
                [a, np.repeat(a[-1:], pad, axis=0)], axis=0)

        padded = ArrivalRows(*(edge(np.asarray(p)) for p in rows))
        self._ring_pad += pad
        return done + self._run_block(padded, k)

    def _run_block(self, rows: ArrivalRows, valid_count: int) -> int:
        b, dev, ctx = self._b, self._dev, self._ctx
        t0 = time.perf_counter()
        ids = torch.arange(self._next_idx, self._next_idx + b, device=dev)
        r_sub, r_exec, d_est, d_act, submit = (
            torch.from_numpy(np.ascontiguousarray(p)).to(dev)
            for p in rows[:5])
        valid = torch.arange(b, device=dev) < valid_count
        blk = (ids, r_sub, r_exec, d_est, d_act, submit, ids, valid)
        # Only a full block pushes, and not inside a store outage.
        push = valid_count == b and not bool(_suppress_push(
            self._win_host, torch.from_numpy(rows.submit_ms[-1:]))[0])
        self._carry, out = _block_step(
            self._carry, blk, _task_draws(ctx, ids, r_sub, submit), ctx,
            push)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        self.step_wall.record((t1 - t0) * 1e3)
        self.decision_latency.record(
            (t1 - rows.t_enq[:valid_count]) * 1e3)
        for acc, plane in zip(self._outs[:7], out):
            acc.append(plane[:valid_count].cpu().numpy())
        self._outs[7].append(rows.submit_ms[:valid_count])
        self._next_idx += b
        self._steps += 1
        if self._publish:
            idx = self._steps % 2
            self._snaps[idx] = {
                "step": self._steps,
                "virtual_ms": float(rows.submit_ms[valid_count - 1]),
                **{f: getattr(self._carry, f).cpu().numpy().copy()
                   for f in ("view_L", "view_D", "view_rif")},
            }
            self._live = idx
        return valid_count

    # -- results ----------------------------------------------------------

    def snapshot(self) -> dict | None:
        """The most recently *published* cache snapshot (double-buffered:
        never the one the in-flight block is writing), or ``None`` before
        the first step."""
        return self._snaps[self._live] if self._live >= 0 else None

    def result(self) -> SimResult:
        """Everything scheduled so far as a :class:`SimResult` —
        bit-exact vs ``simulate(mode="batched")`` over the same stream.
        Requires an empty ring (``flush()`` first)."""
        if self._ring.count:
            raise ValueError(
                f"{self._ring.count} buffered arrivals not yet scheduled "
                f"— flush() before result()")
        if not self._outs[0]:
            raise ValueError("no decisions yet")
        j, start, finish, enq, sched_ms, cores, mem_mb, submit = (
            np.concatenate(acc) for acc in self._outs)
        msgs = self._carry.msgs.cpu().numpy()
        return SimResult(
            server=j.astype(np.int32), submit_ms=submit,
            enqueue_ms=enq, start_ms=start, finish_ms=finish,
            sched_ms=sched_ms, cores=cores, mem_mb=mem_mb,
            msgs_base=int(msgs[0]), msgs_probe=int(msgs[1]),
            msgs_push=int(msgs[2]), msgs_flush=int(msgs[3]),
            policy=self.cfg.policy)

    def latency_summary(self) -> dict:
        """Histograms + percentiles for both instrumented clocks."""
        return {
            "decision": {**self.decision_latency.summary(),
                         "histogram": self.decision_latency.histogram()},
            "step": {**self.step_wall.summary(),
                     "histogram": self.step_wall.histogram()},
        }

    # -- checkpoint / resume ----------------------------------------------

    def export_checkpoint(self) -> dict:
        """Snapshot the full scheduling state at a block boundary, in the
        reference service's form (numpy leaves, the same keys).  The ring
        must be empty (buffered arrivals belong to the client — they are
        not part of cluster state); resuming a fresh service from the
        returned dict and replaying the remaining stream is bit-exact
        with never having stopped."""
        if self._ring.count:
            raise ValueError(
                f"{self._ring.count} buffered arrivals — drain()/flush() "
                f"before checkpointing (the ring is client state)")
        carry = {f: (None if leaf is None else leaf.cpu().numpy().copy())
                 for f, leaf in zip(_Carry._fields, self._carry)}
        return {"carry": carry, "next_idx": int(self._next_idx),
                "ring_pad": int(self._ring_pad), "steps": int(self._steps),
                "seed": self._seed, "policy": self.cfg.policy,
                "b": self._b, "faulted": self._faulted}

    @classmethod
    def from_checkpoint(cls, cluster: ClusterSpec, cfg: EngineConfig,
                        ckpt: dict, **kwargs) -> "DecisionService":
        """Rebuild a service mid-stream from :meth:`export_checkpoint`'s
        dict, or from the reference service's (its batched carry keeps
        the unit rows ascending, as the port's does), so that a stream
        checkpointed by either continues here; a service under cache
        faults carries its per-scheduler views ``[S, n, ...]`` both ways.
        ``cluster``/``cfg``/``dynamics`` must match the exporting service
        (the checkpoint pins the identity-shaping ones, and the seed)."""
        svc = cls(cluster, cfg, seed=ckpt["seed"], **kwargs)
        for key, have in (("policy", cfg.policy), ("b", cfg.b),
                          ("faulted", svc._faulted)):
            if ckpt[key] != have:
                raise ValueError(
                    f"checkpoint {key}={ckpt[key]!r} does not match the "
                    f"restoring service's {have!r}")
        svc._carry = carry_from_numpy(ckpt["carry"], device=svc._dev)
        svc._next_idx = int(ckpt["next_idx"])
        svc._ring_pad = int(ckpt["ring_pad"])
        svc._steps = int(ckpt["steps"])
        return svc


def serve_workload(workload, cluster: ClusterSpec, cfg: EngineConfig, *,
                   seed: int = 0, dynamics=None, chunk: int | None = None,
                   open_loop: bool = False, publish_snapshots: bool = True,
                   device=None):
    """Stream a whole workload trace through a fresh service and return
    ``(service, SimResult)``.

    ``open_loop`` submits every chunk up front and then drains (queueing
    pressure: later tasks wait on earlier blocks — tail latency grows);
    the default closed loop alternates submit/step so each block is
    scheduled as soon as it forms.  ``chunk`` is the submission chunk
    size (default ``cfg.b``).  Placements are independent of both knobs
    — only the measured latencies differ."""
    m = workload.r_submit.shape[0]
    chunk = chunk or cfg.b
    svc = DecisionService(cluster, cfg, seed=seed, dynamics=dynamics,
                          capacity=max(m, cfg.b),
                          publish_snapshots=publish_snapshots, device=device)
    for lo in range(0, m, chunk):
        svc.submit_workload(workload, lo, min(lo + chunk, m))
        if not open_loop:
            svc.drain()
    svc.flush()
    return svc, svc.result()
