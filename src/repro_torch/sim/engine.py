"""Cluster simulation on torch — counterpart of ``repro.sim.engine``: the
batched decision-block driver, and the sequential oracle.

The batched driver walks the trace in *decision blocks* of ``b`` tasks,
one cache snapshot per block (the paper's b-batched push boundary,
§3.2/§4.1).  For each block it

1. derives per-task keys, ``fold_in(PRNGKey(seed), task_id)``, then
   ``split`` (for dodoor and (1+β); ``split(key, 3)`` for Prequal) — for
   the whole trace at once, since they depend only on the task ids;
2. draws candidates and picks servers: Random draws one feasible server;
   Dodoor and (1+β) go through the sparse-gather decision kernel
   (:func:`repro_torch.kernels.dodoor_choice.dodoor_fused_sparse` — the CUDA
   kernel on the card, its plain version on the CPU), in its masked form
   (K2) when the run's :class:`Dynamics` has down windows, and in its
   locality form (K3) on the waves of a task graph under a
   :class:`LocalityModel`;
3. commits the placements in server-parallel FCFS rounds
   (:func:`_commit_rounds`): round ``k`` commits the k-th task of every
   server at once;
4. applies the scheduler flushes and, at a full block's end, the data-store
   push (unless a store outage covers it), and keeps the four-field
   message ledger.

The probing baselines read state that every commit changes, so they
select and commit together, on the rows of the servers they touch
(:func:`_commit_servers`).  PoT commits speculatively
(:func:`_pot_block`): every pending task is scored against the live ring
buffers, and the prefix up to the first task whose candidates an earlier
pending placement hits commits in one round; the rest is scored again.
Prequal runs a segment scan (:func:`_prequal_block`): ``S`` consecutive
tasks belong to ``S`` distinct schedulers, so a chunk of ``S`` picks from
independent pools at once, commits, and reads each task's probes as of
its own decision point by reverting the slots that same-chunk commits at
or after it wrote.  Neither keeps a data store: no flush, no push.

Server dynamics (the scenario engine's cluster axis) lower to ``[n, W]``
float32 window planes (:class:`_Win`, ``+inf`` pads): down windows
(outages, joins, leaves) mask candidate sampling, outage and join windows
freeze FCFS starts to the window end, straggler windows stretch durations,
and store-outage windows suppress the push.  A predicate whose planes hold
no window is skipped: it would be the identity (``_gate_start``) or a
product with exactly 1.0 (``_slow_stretch``).

Two host wave loops run the block loop more than once over one carry: the
task-graph frontier loop (:func:`_simulate_dag`, one wave per topological
level) and the retry re-entry loop (:func:`_simulate_with_retries`, one
wave per attempt).  Each wave restarts the scheduler round robin, the
flush cadence and the push plan.  Placements, timestamps and the message
ledger match the reference's ``use_kernel=False`` batched driver exactly
on the CPU; see ``tests/test_torch_engine.py``,
``tests/test_torch_scenarios.py``, ``tests/test_torch_dags.py`` and
``tests/test_torch_faults.py``.

Cache faults (:class:`CacheFaults`) give every scheduler its own view
planes ``[S, n, ...]``: a push is delivered per scheduler, and a seeded
Bernoulli draw keyed on the push ordinal (:func:`_cache_lost`) or a loss
window drops a delivery, so that scheduler keeps its old view.  A faulted
run scores dodoor and (1+β) in torch ops on each task's own scheduler's
row, as the reference's two-stage path does: the decision kernel reads
one shared view, so a faulted run launches no kernel.

Decision telemetry (``EngineConfig(trace=True)``) consumes no random
draw and changes no placement, timestamp or ledger entry.  The block
step and the oracle record, per decision, the snapshot's age, the two
cached RIF reads, the two candidates (K1's second output), the (1+β)
coin and the push flag; these stay on the device until the run ends,
and the numpy post-pass
:func:`repro_torch.sim.decision_trace.finish_trace` rebuilds the ground
truth from the commit record into the view-error and misplacement
planes (``tests/test_torch_trace.py``).

The sequential oracle (``mode="sequential"``, :func:`_seq_wave`) is the
reference's per-task scan: every decision against the live carry, then
one commit (:func:`_commit_one`), the flush and the push.  It runs all
five policies — the probing baselines PoT (two synchronous probes of the
ring buffers) and Prequal (per-scheduler probe pools, ``r_probe``
asynchronous probes a decision) too — with dynamics, task graphs,
locality and retries, through the same wave loops.  It launches no
kernel, as the reference's scan calls no Pallas kernel, and matches the
reference's ``mode="sequential"`` bit for bit on the CPU
(``tests/test_torch_sequential.py``).

The server execution model (per-core and per-memory-unit free-at times,
the in-flight ring buffer, channel contention, co-location interference)
and the data-store staleness model are the reference's, described in its
module docstring.  The port updates the ring buffer and the per-round
unit planes in place.  Each block reads its number of commit rounds once
with ``.item()`` (a host sync) and loops in Python; PoT reads once a
speculative iteration, Prequal once a chunk.
"""
from __future__ import annotations

import warnings
from typing import NamedTuple

import numpy as np
import torch

from .._arith import fma, row_sum
from .._device import resolve_device
from ..core.policies import dodoor_choice_batch
from ..core.prefilter import (avail_rows, feasible_mask, inverse_cdf_draws,
                              sample_feasible_batch)
from ..core.types import PrequalParams, SchedulerView
from ..kernels.dodoor_choice import dodoor_fused_sparse
from ..random import PRNGKey, fold_in, randint, split, uniform
from ..workloads.dags import dag_plan
from .cluster import CMAX, ClusterSpec
from .decision_trace import finish_trace
from .messages import RpcModel

POLICIES = ("random", "pot", "dodoor", "one_plus_beta", "prequal")
#: Trace rows a traced wave's outputs end with (see :func:`_block_step`).
_TRACE_ROWS = 7


class RetryPolicy(NamedTuple):
    """Failure-and-recovery knobs (the re-entry layer), as the
    reference's.

    With a policy set on :class:`EngineConfig`, two failure paths open up:

    * **kill** — a task still running on a server when a freeze window
      (outage/join gate) *opens* is killed at the window start and
      resubmitted;
    * **rejection** — when ``reject_queue_factor > 0``, a server whose
      in-flight count has reached ``factor × cores`` rejects the placement
      outright (hard capacity) instead of queueing it.

    A killed or rejected task re-enters the decision stream as a fresh
    submission at ``fail_time + backoff_ms · backoff_mult^(k-1)`` after its
    k-th failure, until ``max_attempts`` total submissions have been spent —
    then it fails permanently.  Retried decisions pay the full scheduling
    path again (messages, cache reads)."""

    max_attempts: int = 3           # total submissions (first try included)
    backoff_ms: float = 250.0       # delay before the first resubmission
    backoff_mult: float = 2.0       # exponential backoff factor
    reject_queue_factor: float = 0.0  # reject when rif ≥ factor·cores;
                                      # ≤ 0 disables hard-capacity rejection


class LocalityModel(NamedTuple):
    """Data-locality term for Algorithm 1 (task-graph runs only), as the
    reference's.

    With a model set on :class:`EngineConfig`, the dodoor/(1+β) score of
    a candidate server ``j`` gains

        + gamma · bytes_remote(task, j) / bandwidth_mb_per_ms

    where ``bytes_remote`` sums the task's parent-output MB held on
    servers other than ``j``.  ``gamma = 0`` is bit-identical to no model
    (the penalty term is ``+0.0``).  ``simulate`` requires a ``dag``
    whenever a model is set."""

    gamma: float = 1.0              # penalty weight (score units per ms)
    bandwidth_mb_per_ms: float = 1.0  # effective network bandwidth

    @property
    def gamma_bw(self) -> float:
        """The fused per-MB coefficient the score actually uses."""
        return float(self.gamma) / float(self.bandwidth_mb_per_ms)


class EngineConfig(NamedTuple):
    """Cluster-level knobs (Require line of Algorithm 1 + §6.1 RPC setup),
    named as the reference's.  ``trace`` adds the per-decision telemetry
    planes to the result; ``outage_ms`` is deprecated and routed into
    ``Dynamics(store_outages=...)``; ``prequal`` holds Prequal's probe
    count, pool size and cold quantile."""

    policy: str = "dodoor"          # random | pot | dodoor | prequal |
                                    # one_plus_beta
    num_schedulers: int = 5         # §6.1: 5 scheduler services
    b: int = 50                     # cache batch size (default n/2, §3.2)
    flush_every: int = 2            # addNewLoad cadence (per-scheduler
                                    # decisions); must be ≤ 2b/num_schedulers
    alpha: float = 0.5              # duration weight (§3.2 default)
    beta: float = 0.5               # (1+β) ablation only
    rbuf_slots: int = 256           # in-flight ring buffer per server
    mem_units: int = 64             # memory discretization per server
    interference: float = 0.3       # co-location slowdown factor
    outage_ms: tuple = ()           # deprecated: a data-store outage window
    rpc: RpcModel = RpcModel()
    prequal: PrequalParams = PrequalParams()
    retry: RetryPolicy | None = None      # kill/reject-and-retry waves
    locality: LocalityModel | None = None  # parent-locality score term
    trace: bool = False


class SimResult(NamedTuple):
    """Per-task outcomes (numpy, ms) + aggregate message ledger."""

    server: np.ndarray        # [m] int32 chosen server
    submit_ms: np.ndarray     # [m]
    enqueue_ms: np.ndarray    # [m] submit + scheduling latency
    start_ms: np.ndarray      # [m] execution start on the server
    finish_ms: np.ndarray     # [m] start + actual duration
    sched_ms: np.ndarray      # [m] scheduling latency (enqueue − submit)
    cores: np.ndarray         # [m] cores actually consumed (per node type)
    mem_mb: np.ndarray        # [m]
    msgs_base: int
    msgs_probe: int
    msgs_push: int
    msgs_flush: int
    policy: str
    # Recovery accounting — populated only by runs with cfg.retry set
    # (None otherwise, so retry-disabled results are unchanged).
    attempts: np.ndarray | None = None   # [m] int32 submissions per task
    failed: np.ndarray | None = None     # [m] bool: permanently failed
    wasted_ms: np.ndarray | None = None  # [m] killed-attempt execution ms
    # Decision-trace telemetry — populated only by runs with cfg.trace set
    # (None otherwise; see docs/OBSERVABILITY.md for definitions).
    view_age_ms: np.ndarray | None = None  # [m] cache-snapshot age at the
                                           # decision (CacheFaults-aware)
    view_err: np.ndarray | None = None     # [m] L1 gap between the cached
                                           # rif column and ground truth,
                                           # averaged over the candidates
    misplaced: np.ndarray | None = None    # [m] bool: ground truth would
                                           # have picked a different server
    cache_push: np.ndarray | None = None   # [m] bool: a store push fired
                                           # at this decision's step
    sched_id: np.ndarray | None = None     # [m] int32 deciding scheduler
    decision_ms: np.ndarray | None = None  # [m] decision wall time (the
                                           # attempt's submit instant)

    @property
    def makespan_ms(self) -> np.ndarray:
        return self.finish_ms - self.submit_ms

    @property
    def wait_ms(self) -> np.ndarray:
        return self.start_ms - self.enqueue_ms

    @property
    def msgs_total(self) -> int:
        return int(self.msgs_base + self.msgs_probe + self.msgs_push
                   + self.msgs_flush)

    @property
    def msgs_per_task(self) -> float:
        return self.msgs_total / max(1, self.server.shape[0])


class CacheFaults(NamedTuple):
    """Cache-degradation injection for the data-store push channel
    (attached to :class:`Dynamics` via ``cache_faults``), as the
    reference's spec.

    Each batch push is delivered *per scheduler*; a delivery is lost with
    probability ``loss_rate`` (iid per scheduler per push, seeded stream)
    and lost for every scheduler while ``now`` is inside a
    ``loss_windows`` entry.  A scheduler whose delivery is lost keeps its
    previous view, while probing policies (PoT/Prequal) keep ground
    truth.  ``delay_ms`` lags the snapshot itself: the push carries truth
    as of ``now − delay_ms``.  Unlike ``store_outages`` (which suppress
    the push), a lost delivery was sent and is paid for in the ledger.
    ``CacheFaults()`` (no loss, no delay) is bit-identical to no spec."""

    loss_rate: float = 0.0          # per-scheduler iid delivery-loss prob
    loss_windows: tuple = ()        # ((t0, t1), ...): all pushes lost inside
    delay_ms: float = 0.0           # snapshot lag (truth as of now − delay)
    seed: int = 0                   # loss-draw stream


class Dynamics(NamedTuple):
    """Declarative server-dynamics timelines — all times in ms, all fields
    tuples so the spec is hashable.

    outages:       ``((server, t0, t1), ...)`` — server unavailable on
                   [t0, t1): masked out of candidate sampling, and a task
                   whose FCFS start falls inside the window starts at t1.
    joins:         ``((server, t_join), ...)`` — unavailable on
                   [0, t_join) (inert when ``t_join <= 0``).
    leaves:        ``((server, t_leave), ...)`` — unavailable on
                   [t_leave, ∞): masked from sampling but not start-gated
                   (queued work drains).
    slowdowns:     ``((server, t0, t1, mult), ...)`` — a task *starting*
                   inside [t0, t1) runs ``mult``× its interference-stretched
                   duration.
    store_outages: ``((t0, t1), ...)`` — data-store outage windows: a push
                   inside one is suppressed (no messages, views go stale).
    cache_faults:  optional :class:`CacheFaults` — per-scheduler push-loss
                   rate/windows and snapshot delay.

    When every feasible server is down the draw falls back to uniform over
    the whole fleet, as for an all-infeasible task."""

    outages: tuple = ()
    joins: tuple = ()
    leaves: tuple = ()
    slowdowns: tuple = ()
    store_outages: tuple = ()
    cache_faults: CacheFaults | None = None

    @property
    def has_down_windows(self) -> bool:
        return bool(self.outages or self.joins or self.leaves)

    def merge(self, *others: "Dynamics") -> "Dynamics":
        """Concatenate timelines; ``cache_faults`` is not a timeline: the
        first non-None spec wins, and two distinct specs raise."""
        ds = (self,) + others
        vals = {}
        for f in self._fields:
            if f == "cache_faults":
                cfs = [d.cache_faults for d in ds
                       if d.cache_faults is not None]
                if len(set(cfs)) > 1:
                    raise ValueError(
                        "merge() saw two distinct cache_faults specs — "
                        "compose loss windows inside one CacheFaults")
                vals[f] = cfs[0] if cfs else None
            else:
                vals[f] = tuple(w for d in ds for w in getattr(d, f))
        return Dynamics(**vals)


class _Win(NamedTuple):
    """The window planes a :class:`Dynamics` spec lowers to, leaf for leaf
    the reference's.  Empty slots hold ``+inf`` starts (a window
    [+inf, +inf) matches no timestamp) and 1.0 multipliers.  ``down*``
    masks candidate sampling (outages ∪ joins ∪ leaves); ``gate*`` also
    freezes FCFS starts (outages ∪ joins)."""

    down0: torch.Tensor      # [n, Wd] unavailability window starts
    down1: torch.Tensor      # [n, Wd] window ends
    gate0: torch.Tensor      # [n, Wg] start-freezing window starts
    gate1: torch.Tensor      # [n, Wg] ends
    slow0: torch.Tensor      # [n, Ws] straggler window starts
    slow1: torch.Tensor      # [n, Ws] ends
    slow_mult: torch.Tensor  # [n, Ws] duration multipliers
    store0: torch.Tensor     # [Wo] data-store outage starts
    store1: torch.Tensor     # [Wo] ends
    closs0: torch.Tensor     # [Wc] cache-delivery loss window starts
    closs1: torch.Tensor     # [Wc] ends
    cache_rate: torch.Tensor   # [] per-scheduler iid push-loss probability
    cache_delay: torch.Tensor  # [] push snapshot lag (ms)
    cache_seed: torch.Tensor   # [] int32 loss-draw stream

    @property
    def widths(self) -> tuple:
        return (self.down0.shape[1], self.gate0.shape[1],
                self.slow0.shape[1], self.store0.shape[0],
                self.closs0.shape[0])


def _pack_windows(rows: dict, n: int, width: int, fill):
    """[n, width] start/end (+ optional payload) planes from per-server
    window lists, sorted by start so :func:`_gate_start`'s chained
    resolution is exact for non-overlapping windows."""
    out = [np.full((n, width), f, np.float32) for f in fill]
    for srv, wins in rows.items():
        for wi, entry in enumerate(sorted(wins)):
            for a, v in zip(out, entry):
                a[srv, wi] = v
    return out


def _lower_dynamics(dynamics, n: int, widths: tuple | None = None,
                    device="cpu") -> _Win:
    """Lower a :class:`Dynamics` spec to :class:`_Win` planes on
    ``device``, with the reference's validation.  ``widths=(Wd, Wg, Ws,
    Wo, Wc)`` overrides the minimal pad widths; padding never changes
    results (empty windows are inert)."""
    dynamics = dynamics if dynamics is not None else Dynamics()
    if not isinstance(dynamics, Dynamics):
        raise TypeError(f"dynamics must be a Dynamics spec, "
                        f"got {type(dynamics).__name__}")
    servers = [int(e[0]) for field in ("outages", "joins", "leaves",
                                       "slowdowns")
               for e in getattr(dynamics, field)]
    for srv in servers:
        if not 0 <= srv < n:
            raise ValueError(f"dynamics server {srv} outside fleet of {n}")
    down: dict = {}
    gate: dict = {}
    for srv, t0, t1 in dynamics.outages:
        down.setdefault(int(srv), []).append((float(t0), float(t1)))
        gate.setdefault(int(srv), []).append((float(t0), float(t1)))
    for srv, t in dynamics.joins:
        if float(t) <= 0.0:
            continue                  # present from the start: inert
        down.setdefault(int(srv), []).append((0.0, float(t)))
        gate.setdefault(int(srv), []).append((0.0, float(t)))
    for srv, t in dynamics.leaves:
        # sampling mask only: a leaver drains, so no start gate
        down.setdefault(int(srv), []).append((float(t), np.inf))
    slow: dict = {}
    for srv, t0, t1, mult in dynamics.slowdowns:
        slow.setdefault(int(srv), []).append(
            (float(t0), float(t1), float(mult)))
    for wins in down.values():
        if any(t1 <= t0 for t0, t1 in wins):
            raise ValueError("dynamics window needs t1 > t0")
    for wins in slow.values():
        if any(t1 <= t0 or mult <= 0 for t0, t1, mult in wins):
            raise ValueError("slowdown needs t1 > t0 and mult > 0")
    if any(t1 <= t0 for t0, t1 in dynamics.store_outages):
        raise ValueError("store outage needs t1 > t0")
    cfault = dynamics.cache_faults
    if cfault is not None:
        if not isinstance(cfault, CacheFaults):
            raise TypeError("cache_faults must be a CacheFaults spec")
        if not 0.0 <= cfault.loss_rate <= 1.0:
            raise ValueError("cache_faults.loss_rate must be in [0, 1]")
        if cfault.delay_ms < 0.0:
            raise ValueError("cache_faults.delay_ms must be ≥ 0")
        if any(t1 <= t0 for t0, t1 in cfault.loss_windows):
            raise ValueError("cache loss window needs t1 > t0")

    wd = max(1, max((len(v) for v in down.values()), default=0))
    wg = max(1, max((len(v) for v in gate.values()), default=0))
    ws = max(1, max((len(v) for v in slow.values()), default=0))
    wo = max(1, len(dynamics.store_outages))
    wc = max(1, len(cfault.loss_windows) if cfault is not None else 0)
    if widths is not None:
        need = (wd, wg, ws, wo, wc)
        if any(w < r for w, r in zip(widths, need)):
            raise ValueError(f"widths {widths} < required {need}")
        wd, wg, ws, wo, wc = widths

    d0, d1 = _pack_windows(down, n, wd, (np.inf, np.inf))
    g0, g1 = _pack_windows(gate, n, wg, (np.inf, np.inf))
    s0, s1, sm = _pack_windows(slow, n, ws, (np.inf, np.inf, 1.0))
    o0 = np.full((wo,), np.inf, np.float32)
    o1 = np.full((wo,), np.inf, np.float32)
    for wi, (t0, t1) in enumerate(sorted(dynamics.store_outages)):
        o0[wi], o1[wi] = t0, t1
    c0 = np.full((wc,), np.inf, np.float32)
    c1 = np.full((wc,), np.inf, np.float32)
    rate, delay, cseed = 0.0, 0.0, 0
    if cfault is not None:
        for wi, (t0, t1) in enumerate(sorted(cfault.loss_windows)):
            c0[wi], c1[wi] = t0, t1
        rate, delay, cseed = (cfault.loss_rate, cfault.delay_ms,
                              int(cfault.seed))
    planes = (d0, d1, g0, g1, s0, s1, sm, o0, o1, c0, c1)
    return _Win(*(torch.from_numpy(a).to(device) for a in planes),
                cache_rate=torch.tensor(np.float32(rate), device=device),
                cache_delay=torch.tensor(np.float32(delay), device=device),
                cache_seed=torch.tensor(np.int32(cseed), device=device))


def _gate_start(win: _Win, start: torch.Tensor, j=None) -> torch.Tensor:
    """Push a start time landing inside a gate window to the window's end:
    ``start`` [n] holds one time per server row, or with a server index
    ``j`` it is that server's 0-d time.  The unrolled loop resolves chains
    of non-overlapping sorted windows, in the reference's order."""
    g0, g1 = ((win.gate0, win.gate1) if j is None
              else (win.gate0[j], win.gate1[j]))          # [n, Wg] / [Wg]
    for _ in range(g0.shape[-1]):
        s = start[..., None]
        inwin = (g0 <= s) & (s < g1)
        start = torch.where(inwin, g1, s).max(dim=-1).values
    return start


def _slow_stretch(win: _Win, start: torch.Tensor, j=None) -> torch.Tensor:
    """Straggler multiplier for a start time per server row ([n]), or for
    server ``j``'s 0-d time — the product of the matching windows'
    factors, in window order."""
    s0, s1, sm = ((win.slow0, win.slow1, win.slow_mult) if j is None
                  else (win.slow0[j], win.slow1[j], win.slow_mult[j]))
    stretch = torch.ones_like(start)
    for w in range(s0.shape[-1]):
        inwin = (s0[..., w] <= start) & (start < s1[..., w])
        stretch = stretch * torch.where(inwin, sm[..., w], 1.0)
    return stretch


def _suppress_push(win: _Win, now: torch.Tensor) -> torch.Tensor:
    """Whether a data-store push firing at ``now`` [k] is suppressed: a
    store-outage window covers it.  (The reference ORs in the legacy
    ``EngineConfig.outage_ms`` window; :func:`simulate` routes that window
    into ``store_outages``, so here it is always empty.)"""
    t = now[:, None]
    store0, store1 = win.store0.to(now.device), win.store1.to(now.device)
    return ((store0 <= t) & (t < store1)).any(dim=-1)


class _Carry(NamedTuple):
    """The driver's state between blocks, leaf for leaf the reference's
    batched carry.  Invariant: every row of ``core_free`` and ``mem_free``
    is ascending (the +inf padding past a server's cores last), in both
    modes: the commits read the c-th smallest entry and update with
    :func:`_sorted_fill`.  The reference's sequential carry keeps the same
    values in another order; only the multiset of a row matters to a
    commit, and :func:`repro_torch.sim.state.carry_from_numpy` sorts the
    rows it is given."""

    core_free: torch.Tensor    # [n, CMAX] per-core free-at, rows ascending
    mem_free: torch.Tensor     # [n, MU]   per-memory-unit free-at, ascending
    prev_start: torch.Tensor   # [n]
    rb_release: torch.Tensor   # [n, R] in-flight ring buffer
    rb_cpu: torch.Tensor       # [n, R]
    rb_mem: torch.Tensor       # [n, R]
    rb_dur: torch.Tensor       # [n, R]
    view_L: torch.Tensor       # [n, 2] scheduler cached load vectors
                               # ([S, n, 2] under cache faults)
    view_D: torch.Tensor       # [n] ([S, n])
    view_rif: torch.Tensor     # [n] ([S, n])
    pending: torch.Tensor      # [S, n, 4] unflushed scheduler deltas
    chan_free: torch.Tensor    # [n] per-server RPC channel next-free
    push_end: torch.Tensor     # [] wall time the in-progress push ends
    pool_server: torch.Tensor  # [S, s_pool] Prequal probe pools
    pool_rif: torch.Tensor
    pool_lat: torch.Tensor
    pool_age: torch.Tensor
    pool_valid: torch.Tensor
    msgs: torch.Tensor         # [4] int32: base, probe, push, flush
    push_at: torch.Tensor | None = None  # [S] content time of each
                                         # scheduler's view (trace only)


class _Dyn(NamedTuple):
    """The reference's traced float32 scalars, as 0-d float32 tensors
    (α and γ/bandwidth reach the decision kernel as floats, like the
    reference's kernel takes them)."""

    beta: torch.Tensor
    interference: torch.Tensor
    hop_ms: torch.Tensor
    chan_ms: torch.Tensor
    push_block_ms: torch.Tensor
    compute_ms: torch.Tensor
    reject_cap: torch.Tensor   # rif ≥ cap·cores rejects (+inf: never)
    gamma_bw: torch.Tensor     # locality penalty per remote MB
    q_rif: torch.Tensor        # Prequal's cold-RIF quantile
    alpha: torch.Tensor        # duration weight of the two-stage score


class _Ctx(NamedTuple):
    """Per-run constants of the block step."""

    cfg: EngineConfig
    dyn: _Dyn
    C: torch.Tensor            # [n, 2] float32 capacities
    node_type: torch.Tensor    # [n] int32
    cores_per: torch.Tensor    # [n] int32
    mem_unit: torch.Tensor     # [n] float32 MB per memory unit
    base_key: torch.Tensor     # [2] PRNGKey(seed)
    stretch: torch.Tensor      # [(CMAX+1)²] interference stretch table
    win: _Win                  # the dynamics' window planes
    down_t: tuple | None       # (down0.T, down1.T) [Wd, n] for K2, or None
    masked: bool               # down windows: masked sampling (K2)
    gated: bool                # some gate window exists
    slowed: bool               # some straggler window exists
    faulted: bool              # cache faults: per-scheduler views
    cache_key: torch.Tensor    # [2] PRNGKey(CacheFaults.seed)
    cluster: ClusterSpec       # the host arrays, for the trace post-pass


def _reject_cap(cfg: EngineConfig) -> float:
    rp = cfg.retry
    return (rp.reject_queue_factor
            if rp is not None and rp.reject_queue_factor > 0 else np.inf)


def _gamma_bw(cfg: EngineConfig) -> float:
    """γ/bandwidth rounded once to float32, as the reference packs it."""
    lm = cfg.locality
    return float(np.float32(lm.gamma_bw if lm is not None else 0.0))


def _make_dyn(cfg: EngineConfig, device) -> _Dyn:
    vals = (cfg.beta, cfg.interference, cfg.rpc.hop_ms,
            cfg.rpc.chan_ms, cfg.rpc.push_block_ms, cfg.rpc.compute_ms,
            _reject_cap(cfg), _gamma_bw(cfg), cfg.prequal.q_rif, cfg.alpha)
    return _Dyn(*(torch.tensor(np.float32(v), device=device) for v in vals))


def _stretch_table(dyn: _Dyn) -> torch.Tensor:
    """The commit's interference stretch ``1 + interference·clip(busy /
    cores, 0, 1)`` — one fused multiply-add in the reference — for every
    (cores, busy) pair in [0, CMAX]², flattened cores-major.  Tabulated
    once per run, it is one gather per commit round instead of the
    float64 emulation of a fused multiply-add."""
    g = torch.arange(CMAX + 1, dtype=torch.float32,
                     device=dyn.interference.device)
    frac = (g[None, :] / g[:, None]).clamp(0.0, 1.0)
    return fma(dyn.interference, frac, torch.ones_like(frac)).reshape(-1)


def _cluster_arrays(cluster: ClusterSpec, mem_units: int, device):
    C = np.asarray(cluster.C, np.float32)
    return (torch.from_numpy(C.copy()).to(device),
            torch.from_numpy(np.asarray(cluster.node_type, np.int32)).to(
                device),
            torch.from_numpy(C[:, 0].astype(np.int32)).to(device),
            torch.from_numpy(np.asarray(C[:, 1] / mem_units,
                                        np.float32)).to(device))


def _make_ctx(cluster: ClusterSpec, cfg: EngineConfig, seed: int,
              device, dynamics: Dynamics | None = None) -> _Ctx:
    """``masked`` follows the spec, as the reference's kernel choice does:
    a spec with down windows launches the masked kernel even where they
    are inert (a join at t=0).  Under it ``down_t`` holds the window-major
    copies of the down planes that K2 reads, made here once per run."""
    C, node_type, cores_per, mem_unit = _cluster_arrays(
        cluster, cfg.mem_units, device)
    win = _lower_dynamics(dynamics, cluster.num_servers, device=device)
    dyn = _make_dyn(cfg, device)
    masked = dynamics is not None and dynamics.has_down_windows
    faulted = dynamics is not None and dynamics.cache_faults is not None
    down_t = ((win.down0.t().contiguous(), win.down1.t().contiguous())
              if masked else None)
    return _Ctx(cfg=cfg, dyn=dyn, C=C, node_type=node_type,
                cores_per=cores_per, mem_unit=mem_unit,
                base_key=PRNGKey(seed, device=device),
                stretch=_stretch_table(dyn), win=win, down_t=down_t,
                masked=masked,
                gated=bool(torch.isfinite(win.gate0).any()),
                slowed=bool(torch.isfinite(win.slow0).any()),
                faulted=faulted,
                cache_key=PRNGKey(dynamics.cache_faults.seed if faulted
                                  else 0, device=device),
                cluster=cluster)


def _init_carry(cfg: EngineConfig, n: int, cores_per: torch.Tensor,
                faulted: bool = False) -> _Carry:
    """The t=0 carry.  Core slots beyond a server's core count hold +inf
    (never free), so heterogeneous core counts share one [n, CMAX] plane.
    Under cache faults (``faulted``) the view planes grow a leading
    scheduler axis, ``[S, n, ...]``: each scheduler holds its own copy of
    the store's pushes.  ``push_at`` [S], each scheduler's view content
    time, exists when ``cfg.trace`` is set, as in the reference."""
    dev = cores_per.device
    S, R, MU, P = (cfg.num_schedulers, cfg.rbuf_slots, cfg.mem_units,
                   cfg.prequal.s_pool)
    vs = (S, n) if faulted else (n,)
    f32 = dict(dtype=torch.float32, device=dev)
    core_init = torch.where(
        torch.arange(CMAX, device=dev)[None, :] < cores_per[:, None],
        torch.zeros((), **f32), torch.full((), float("inf"), **f32))
    return _Carry(
        core_free=core_init,
        mem_free=torch.zeros((n, MU), **f32),
        prev_start=torch.zeros((n,), **f32),
        rb_release=torch.zeros((n, R), **f32),
        rb_cpu=torch.zeros((n, R), **f32),
        rb_mem=torch.zeros((n, R), **f32),
        rb_dur=torch.zeros((n, R), **f32),
        view_L=torch.zeros(vs + (2,), **f32),
        view_D=torch.zeros(vs, **f32),
        view_rif=torch.zeros(vs, **f32),
        pending=torch.zeros((S, n, 4), **f32),
        chan_free=torch.zeros((n,), **f32),
        push_end=torch.zeros((), **f32),
        pool_server=torch.zeros((S, P), dtype=torch.int32, device=dev),
        pool_rif=torch.full((S, P), float("inf"), **f32),
        pool_lat=torch.full((S, P), float("inf"), **f32),
        pool_age=torch.full((S, P), float("-inf"), **f32),
        pool_valid=torch.zeros((S, P), dtype=torch.bool, device=dev),
        msgs=torch.zeros((4,), dtype=torch.int32, device=dev),
        push_at=torch.zeros((S,), **f32) if cfg.trace else None,
    )


def _truth_rows(carry: _Carry, now: torch.Tensor):
    """Ground truth (L [n, 2], D [n], rif [n]) from the ring buffers at
    ``now``: the tasks whose release time is still ahead of it, each sum
    in the reference's order (:func:`repro_torch._arith.row_sum`)."""
    act = (carry.rb_release > now).to(torch.float32)
    cpu, mem, dur = row_sum(torch.stack(
        [carry.rb_cpu, carry.rb_mem, carry.rb_dur]) * act)
    return torch.stack([cpu, mem], dim=-1), dur, act.sum(dim=-1)


def _probe_truth(release: torch.Tensor, dur: torch.Tensor, now):
    """What a probe of ring-buffer rows (``release``, ``dur`` [..., R])
    reads at ``now``: the in-flight count and the summed estimated
    duration, the latter in the reference's order."""
    act = (release > now).to(torch.float32)
    return act.sum(dim=-1), row_sum(dur * act)


def _cache_lost(win: _Win, now: torch.Tensor, push_ord: torch.Tensor,
                S: int, key: torch.Tensor) -> torch.Tensor:
    """Per-scheduler delivery-loss mask [S] for the push with cluster-wide
    ordinal ``push_ord`` (a device integer): ``S`` uniforms from
    ``fold_in(key, push_ord)``, ``key = PRNGKey(CacheFaults.seed)``, below
    the loss rate, OR-ed with the loss windows (inside which every
    scheduler loses the delivery).  Keyed on the push ordinal, not wall
    time, so the sequential and batched drivers draw identically."""
    u = uniform(fold_in(key, push_ord), (S,))
    in_win = ((win.closs0 <= now) & (now < win.closs1)).any()
    return (u < win.cache_rate) | in_win


def _apply_push(carry: _Carry, now: torch.Tensor, ctx: _Ctx,
                push_ord: torch.Tensor | None = None) -> _Carry:
    """One data-store push: the store's view is truth(now) minus the deltas
    the schedulers have not flushed yet (the staleness model).

    Under cache faults (per-scheduler views, ``push_ord`` the push's
    ordinal) the snapshot is taken at ``now − delay_ms`` and each
    scheduler's delivery may be lost (:func:`_cache_lost`): a loser keeps
    its old view and ``push_at``.  A traced run's ``push_at`` is the
    delivered content's time."""
    win = ctx.win
    faulted = carry.view_L.dim() == 3
    t_snap = now - win.cache_delay if faulted else now
    L, D, rif = _truth_rows(carry, t_snap)
    unflushed = carry.pending[0]
    for s in range(1, carry.pending.shape[0]):
        unflushed = unflushed + carry.pending[s]                 # [n, 4]
    view_L = torch.clamp_min(L - unflushed[:, :2], 0.0)
    view_D = torch.clamp_min(D - unflushed[:, 2], 0.0)
    view_rif = torch.clamp_min(rif - unflushed[:, 3], 0.0)
    push_at = carry.push_at
    if faulted:
        lost = _cache_lost(win, now, push_ord, carry.view_L.shape[0],
                           ctx.cache_key)
        view_L = torch.where(lost[:, None, None], carry.view_L, view_L)
        view_D = torch.where(lost[:, None], carry.view_D, view_D)
        view_rif = torch.where(lost[:, None], carry.view_rif, view_rif)
        if push_at is not None:
            push_at = torch.where(lost, push_at, t_snap)
    elif push_at is not None:
        push_at = now.expand(push_at.shape).clone()
    return carry._replace(view_L=view_L, view_D=view_D, view_rif=view_rif,
                          push_end=now + ctx.dyn.push_block_ms,
                          push_at=push_at)


def _sorted_fill(arr: torch.Tensor, k: torch.Tensor,
                 value: torch.Tensor) -> torch.Tensor:
    """Replace the ``k`` smallest entries of each ascending row of ``arr``
    [n, W] by ``value`` [n] (≥ the k-th smallest), keeping rows sorted:
    drop the first ``k`` entries and splice ``k`` copies of ``value`` at
    its rank among the survivors."""
    W = arr.shape[1]
    iota = torch.arange(W, device=arr.device)[None, :]
    kk = k[:, None]
    idx = ((iota >= kk) & (arr < value[:, None])).sum(dim=1, keepdim=True)
    src = torch.where(iota < idx, iota + kk, iota)
    gathered = arr.gather(1, src.clamp(max=W - 1))
    in_win = (iota >= idx) & (iota < idx + kk)
    return torch.where(in_win, value[:, None], gathered)


def _queue_ranks(j: torch.Tensor, valid: torch.Tensor):
    """Each task's FCFS rank among the block's valid tasks on its server,
    and the number of commit rounds (read to the host once per block)."""
    bsz = j.shape[0]
    tt = torch.arange(bsz, device=j.device)
    same_before = ((j[None, :] == j[:, None]) & valid[None, :]
                   & (tt[None, :] < tt[:, None]))
    occ = same_before.sum(dim=1)
    rounds = int(torch.where(valid, occ, -1).max().item()) + 1
    return occ, rounds


def _commit_rounds(carry: _Carry, valid, now, j, cores, mem_mb, dur_raw,
                   d_est_j, extra_lat, ctx: _Ctx, occ, rounds: int):
    """Server-parallel FCFS commit of the block's valid tasks.

    Every row a commit reads or writes belongs to the task's own server,
    so the per-server chains are independent and round ``k`` commits the
    k-th task of every server at once.  Unit rows stay sorted ascending:
    the c-th earliest free core is a gather and the update a shift-merge
    (:func:`_sorted_fill`).  A start inside a gate window moves to the
    window's end, and a straggler window stretches the duration after the
    interference stretch.  Returns ``(carry, outs)``, ``outs`` [7, b]
    with rows start, finish, enqueue, sched_ms, the overwritten ring slot's
    old release and old duration, and the slot index.  The ring buffer is
    updated in place.

    Under a :class:`RetryPolicy` the commit has the reference's failure
    paths: a server whose in-flight count has reached ``reject_cap ×
    cores`` rejects the task (it writes no unit, ring slot or start), and
    a gate window opening strictly inside (start, finish) kills the task
    at the window's start (its units and ring slot are released then).
    ``outs`` is then [9, b]: start and finish are the enqueue time for a
    rejected task and finish is the kill time for a killed one, and rows
    7 and 8 flag killed and rejected tasks (0/1)."""
    dyn, cores_per, mem_unit = ctx.dyn, ctx.cores_per, ctx.mem_unit
    MU = ctx.cfg.mem_units
    n = cores_per.shape[0]
    bsz = j.shape[0]
    dev = j.device
    tt = torch.arange(bsz, device=dev)
    rows = torch.arange(n, device=dev)
    cores_f = cores_per.to(torch.float32)
    pad = CMAX - cores_per
    stretch_row = cores_per.long() * (CMAX + 1)
    R = carry.rb_release.shape[1]
    slot_iota = torch.arange(R, device=dev)[None, :]
    rb_rel, rb_cpu, rb_mem, rb_dur = (carry.rb_release, carry.rb_cpu,
                                      carry.rb_mem, carry.rb_dur)
    cf, mf = carry.core_free, carry.mem_free
    prev_start, chan_free = carry.prev_start, carry.chan_free
    retry = ctx.cfg.retry is not None
    outs = torch.zeros((9 if retry else 7, bsz + 1), dtype=torch.float32,
                       device=dev)
    j = j.long()
    for k in range(rounds):
        # This round's task on every server (index n is a dump slot).
        tgt = torch.where(valid & (occ == k), j, n)
        sel = torch.full((n + 1,), -1, dtype=torch.long, device=dev)
        sel[tgt] = tt
        sel = sel[:n]
        has = sel >= 0
        t = sel.clamp(0, bsz - 1)

        now_s, cores_s, mem_s = now[t], cores[t], mem_mb[t]
        dur_s, dest_s, xlat_s = dur_raw[t], d_est_j[t], extra_lat[t]

        act = (rb_rel > now_s[:, None]).to(torch.float32)
        rif = act.sum(dim=-1)
        occupancy = dyn.chan_ms * (1.0 + rif / cores_per)
        chan_wait = torch.clamp_min(chan_free - now_s, 0.0)
        sched_ms = (dyn.compute_ms + xlat_s + chan_wait + occupancy
                    + dyn.hop_ms)
        new_chan = torch.maximum(chan_free, now_s) + occupancy
        chan_free = torch.where(has, new_chan, chan_free)
        enqueue_t = now_s + sched_ms
        if retry:
            # Hard capacity: the channel above was paid, but a full
            # server queues nothing.
            rejected = has & (rif >= dyn.reject_cap * cores_f)
            has_w = has & ~rejected
        else:
            has_w = has

        c_eff = torch.minimum(torch.clamp_min(cores_s, 1.0),
                              cores_f).to(torch.long)
        mu_need = torch.ceil(mem_s / mem_unit).clamp(1, MU).to(torch.long)
        core_gate = cf.gather(1, (c_eff - 1)[:, None])[:, 0]
        mem_gate = mf.gather(1, (mu_need - 1)[:, None])[:, 0]
        start = torch.maximum(torch.maximum(enqueue_t, prev_start),
                              torch.maximum(core_gate, mem_gate))
        if ctx.gated:
            start = _gate_start(ctx.win, start)         # down-window freeze
        busy = (cf > start[:, None]).sum(dim=-1) - pad
        dur = dur_s * ctx.stretch[stretch_row + busy]
        if ctx.slowed:
            dur = dur * _slow_stretch(ctx.win, start)   # straggler windows
        finish = start + dur
        killed = torch.zeros_like(has)
        rel = finish
        if retry and ctx.gated:
            # Kill at the first gate window that opens inside (start,
            # finish); the kill time exceeds start, so rows stay sorted.
            g0 = ctx.win.gate0
            kt = torch.full_like(finish, float("inf"))
            for wi in range(g0.shape[1]):
                opens = (g0[:, wi] > start) & (g0[:, wi] < finish)
                kt = torch.minimum(kt, torch.where(opens, g0[:, wi],
                                                   float("inf")))
            killed = has_w & torch.isfinite(kt)
            rel = torch.where(killed, kt, finish)

        has_c = has_w[:, None]
        cf = torch.where(has_c, _sorted_fill(cf, c_eff, rel), cf)
        mf = torch.where(has_c, _sorted_fill(mf, mu_need, rel), mf)
        prev_start = torch.where(has_w, start, prev_start)

        # Ring slot: first index of the row minimum (the earliest release).
        rb_min = rb_rel.min(dim=-1, keepdim=True).values
        slot = torch.where(rb_rel == rb_min, slot_iota, R).min(dim=-1).values
        old_rel = rb_rel[rows, slot]
        old_dur = rb_dur[rows, slot]
        rb_rel[rows, slot] = torch.where(has_w, rel, old_rel)
        rb_cpu[rows, slot] = torch.where(has_w, cores_s, rb_cpu[rows, slot])
        rb_mem[rows, slot] = torch.where(has_w, mem_s, rb_mem[rows, slot])
        rb_dur[rows, slot] = torch.where(has_w, dest_s, old_dur)

        t_out = torch.where(has, t, bsz)                 # bsz is a dump
        plane = [start, finish, enqueue_t, sched_ms, old_rel, old_dur,
                 slot.to(torch.float32)]
        if retry:
            plane[0] = torch.where(rejected, enqueue_t, start)
            plane[1] = torch.where(rejected, enqueue_t, rel)
            plane += [killed.to(torch.float32), rejected.to(torch.float32)]
        outs[:, t_out] = torch.stack(plane)
    carry = carry._replace(core_free=cf, mem_free=mf, prev_start=prev_start,
                           chan_free=chan_free)
    return carry, outs[:, :bsz]


#: The carry planes a commit reads and writes, one row per server.
_SERVER_ROWS = ("core_free", "mem_free", "prev_start", "rb_release",
                "rb_cpu", "rb_mem", "rb_dur", "chan_free")


def _commit_servers(carry: _Carry, valid, now, j, cores, mem_mb, dur_raw,
                    d_est_j, extra_lat, ctx: _Ctx, occ, rounds: int):
    """:func:`_commit_rounds` over the servers the tasks name instead of
    the whole fleet: their rows are gathered into a fleet of ``k = len(j)``
    rows (the tasks on one server share the row of its first task),
    committed there, and written back.  A commit reads and writes only its
    own server's rows, so the arithmetic is the full-fleet commit's; a PoT
    prefix or a Prequal chunk costs its own size, not the fleet's.  Every
    row of a server ends with the same values, so writing the duplicates
    back is deterministic."""
    k = j.shape[0]
    tt = torch.arange(k, device=j.device)
    rep = torch.where(j[None, :] == j[:, None], tt[None, :], k).min(
        dim=1).values
    sub = carry._replace(**{f: getattr(carry, f)[j] for f in _SERVER_ROWS})
    win = ctx.win
    planes = ((("gate0", "gate1") if ctx.gated else ())
              + (("slow0", "slow1", "slow_mult") if ctx.slowed else ()))
    sub_ctx = ctx._replace(
        cores_per=ctx.cores_per[j], mem_unit=ctx.mem_unit[j],
        win=win._replace(**{f: getattr(win, f)[j] for f in planes}))
    sub, outs = _commit_rounds(sub, valid, now, rep, cores, mem_mb, dur_raw,
                               d_est_j, extra_lat, sub_ctx, occ, rounds)
    for f in _SERVER_ROWS:
        getattr(carry, f)[j] = getattr(sub, f)[rep]
    return carry, outs


def _add_in_task_order(like, sched, j, vals, sel, occ, rounds: int):
    """A zero tensor shaped ``like`` [S, n, ...] plus ``vals[t]`` at
    ``[sched[t], j[t]]`` for the ``sel`` tasks, each cell's contributions
    added in task order — the order of the reference's scatter-add — with
    no atomics: round ``k`` adds the tasks of FCFS rank ``k``, whose
    servers are distinct.  Column ``n`` is a dump for the others."""
    n = like.shape[1]
    acc = like.new_zeros((like.shape[0], n + 1) + like.shape[2:])
    for k in range(rounds):
        col = torch.where(sel & (occ == k), j, n)
        acc[sched, col] = acc[sched, col] + vals
    return acc[:, :n]


def _task_draws(ctx: _Ctx, task_id: torch.Tensor, r_sub: torch.Tensor,
                now: torch.Tensor) -> tuple:
    """Per-task randomness for a whole trace, or one block, at once: it
    depends only on the task ids, demands and times (``task_id`` and
    ``now`` [...], ``r_sub`` [..., K]), never on the carry.  From ``key =
    fold_in(PRNGKey(seed), task_id)``: Random's one uniform per task; for
    dodoor and (1+β) the candidate keys ``split(key)[0]`` and (1+β)'s
    uniforms from ``split(key)[1]``; for PoT and Prequal the sequential
    oracle's draws (:func:`_seq_draws`): PoT's two candidates [..., 2],
    Prequal's fallback server [...] and probed servers [..., r_probe], and
    under down windows which probes reach a server that is up."""
    policy = ctx.cfg.policy
    if policy in ("pot", "prequal"):
        lead = tuple(task_id.shape)
        d = _seq_draws(ctx, r_sub.reshape(-1, r_sub.shape[-1]),
                       now.reshape(-1), task_id.reshape(-1))
        names = (("cand",) if policy == "pot" else
                 ("rand_j", "probes") + (("probe_ok",) if ctx.masked else ()))
        return tuple(d[k].reshape(lead + tuple(d[k].shape[1:]))
                     for k in names)
    keys = fold_in(ctx.base_key, task_id)
    if ctx.cfg.policy == "random":
        return (uniform(keys, (1,)),)
    kk = split(keys)
    k_cand = kk[..., 0, :].contiguous()
    if ctx.cfg.policy == "one_plus_beta":
        return k_cand, uniform(kk[..., 1, :])
    return (k_cand,)


#: Prequal's per-scheduler probe-pool planes of the carry, [S, s_pool].
_POOLS = ("pool_server", "pool_rif", "pool_lat", "pool_age", "pool_valid")


def _probe_msgs(cfg: EngineConfig) -> int:
    """Probe messages a decision: PoT's two synchronous probes (request and
    reply each), Prequal's ``r_probe`` asynchronous ones."""
    return {"pot": 4, "prequal": 2 * cfg.prequal.r_probe}.get(cfg.policy, 0)


def _pool_pick(pool: tuple, now, rand_j, ctx: _Ctx):
    """Prequal's decision for ``k`` tasks at ``now`` [k], each from its own
    scheduler's probe pool, ``pool`` = the :data:`_POOLS` rows [k, P]: among
    the entries not on a down server, threshold at the ``q_rif`` quantile
    of the sorted RIFs (``q_rif · n`` truncated in float32), take the cold
    entry of least latency, or else the entry of least RIF; with no usable
    entry fall back to ``rand_j`` [k].  The used entry is consumed (b_reuse
    = 1); entries on down servers stay in the pool.  Returns (j [k],
    pool_valid [k, P] after the consumption)."""
    ps, pr, plat, _, pv = pool
    P = pv.shape[-1]
    ok = pv
    if ctx.masked:
        t = now[:, None, None]
        srv = ps.long()
        ok = pv & ~((ctx.win.down0[srv] <= t)
                    & (t < ctx.win.down1[srv])).any(dim=-1)
    inf = torch.full_like(pr, float("inf"))
    rifs = torch.where(ok, pr, inf)
    any_ok = ok.any(dim=-1)
    n_ok = torch.clamp_min(ok.sum(dim=-1), 1).to(torch.float32)
    q_idx = (ctx.dyn.q_rif * n_ok).to(torch.long).clamp(0, P - 1)
    threshold = torch.sort(rifs, dim=-1).values.gather(-1, q_idx[:, None])
    cold = ok & (pr <= threshold)
    entry = torch.where(cold.any(dim=-1),
                        torch.argmin(torch.where(cold, plat, inf), dim=-1),
                        torch.argmin(rifs, dim=-1))
    j = torch.where(any_ok, ps.gather(-1, entry[:, None])[:, 0].long(),
                    rand_j)
    used = any_ok[:, None] & (torch.arange(P, device=pv.device)
                              == entry[:, None])
    return j, pv & ~used


def _pool_update(pool: tuple, probes, prif, pD, now, probe_ok) -> tuple:
    """Insert ``k`` tasks' probe replies into their pools (the
    :data:`_POOLS` rows [k, P]) in probe order: each into the first empty
    entry, or else the oldest, with age ``now + float32(i)·1e-3`` for the
    i-th probe; a probe to a down server (``probe_ok`` false; None: all
    up) gets no entry.  Then a full pool evicts its highest-RIF entry
    (r_remove = 1).  ``probes``, ``prif``, ``pD`` [k, r_probe]."""
    ps, pr, plat, page, pv = pool
    P = pv.shape[-1]
    iota = torch.arange(P, device=pv.device)
    for i in range(probes.shape[-1]):
        slot = torch.argmin(torch.where(pv, page, float("-inf")), dim=-1)
        one = iota == slot[:, None]
        if probe_ok is not None:
            one = one & probe_ok[:, i:i + 1]
        # The reference's age now + float32(i)·1e-3, exact for the three
        # probes of r_probe = 3 with or without contraction.
        age = now + np.float32(i) * np.float32(1e-3)
        ps = torch.where(one, probes[:, i:i + 1].to(ps.dtype), ps)
        pr = torch.where(one, prif[:, i:i + 1], pr)
        plat = torch.where(one, pD[:, i:i + 1], plat)
        page = torch.where(one, age[:, None], page)
        pv = pv | one
    worst = torch.argmax(torch.where(pv, pr, float("-inf")), dim=-1)
    full = pv.sum(dim=-1) >= P
    pv = pv & ~(full[:, None] & (iota == worst[:, None]))
    return ps, pr, plat, page, pv


def _pot_block(carry: _Carry, blk, draws, ctx: _Ctx):
    """PoT's speculative commit over one block (the reference's
    ``_make_block_step``, PoT branch).  Each iteration scores every pending
    task against the *current* ring buffers (the RIF of each of its two
    candidates, ties to candidate 0) and finds the first unsafe task ``q``:
    one whose candidates an earlier pending task's speculative placement
    hits.  Up to ``q`` every probe reads what the sequential oracle reads,
    and the placements are pairwise distinct, so the prefix commits in one
    server-parallel round.  Reading ``q`` is the iteration's one host sync.
    Returns (carry, j [b], outs [rows, b])."""
    _, _, r_exec_t, d_est_t, d_act_t, now, _, valid = blk[:8]
    cand = draws[0]                                           # [b, 2]
    bsz = cand.shape[0]
    dev = cand.device
    tt = torch.arange(bsz, device=dev)
    n = ctx.C.shape[0]
    nt_c = ctx.node_type[cand].long()
    rows = tt[:, None]
    per_cand = (r_exec_t[rows, nt_c, 0], r_exec_t[rows, nt_c, 1],
                d_act_t[rows, nt_c], d_est_t[rows, nt_c])     # each [b, 2]
    lat = (2.0 * ctx.dyn.hop_ms).expand(bsz)
    occ = torch.zeros((bsz,), dtype=torch.long, device=dev)
    j = torch.zeros((bsz,), dtype=torch.long, device=dev)
    outs = torch.zeros((9 if ctx.cfg.retry is not None else 7, bsz),
                       dtype=torch.float32, device=dev)
    p = 0
    while p < bsz:
        pending = (tt >= p) & valid
        rif = (carry.rb_release[cand] > now[:, None, None]).to(
            torch.float32).sum(dim=-1)                        # [b, 2]
        pick_b = rif[:, 1] < rif[:, 0]
        j_spec = torch.where(pick_b, cand[:, 1], cand[:, 0])
        j_eff = torch.where(pending, j_spec, n)
        hit = (j_eff[None, :] == cand[:, :1]) | (j_eff[None, :] == cand[:, 1:])
        unsafe = (hit & (tt[None, :] < tt[:, None])).any(dim=1) & pending
        q = int(torch.where(unsafe, tt, bsz).min())
        c = slice(p, q)
        vals = [torch.where(pick_b[c], v[c, 1], v[c, 0]) for v in per_cand]
        carry, o = _commit_servers(carry, valid[c], now[c], j_spec[c],
                                   *vals, lat[c], ctx, occ[c], 1)
        outs[:, c] = o
        j[c] = torch.where(valid[c], j_spec[c], 0)
        p = q
    return carry, j, outs


def _prequal_block(carry: _Carry, blk, draws, ctx: _Ctx):
    """Prequal's segment scan over one block (the reference's
    ``_make_block_step``, Prequal branch).  ``S`` consecutive decisions
    belong to ``S`` distinct schedulers, so a chunk of ``S`` tasks picks
    from independent pools at once (:func:`_pool_pick`), then commits in
    server-parallel rounds with FCFS order within the chunk (reading the
    round count is the chunk's one host sync).  Each task's probes must
    read the ring buffers as of its own decision point: the chunk has
    already committed, so the slots that same-chunk commits at or after it
    wrote are reverted to their old (release, duration), newest commit
    first, so that two commits on one slot telescope.  The replies go into
    the pools (:func:`_pool_update`).  Padded tail tasks neither commit,
    probe nor touch a pool.  Returns (carry, j [b], outs [rows, b])."""
    idx, _, r_exec_t, d_est_t, d_act_t, now, _, valid = blk[:8]
    rand_j, probes = draws[:2]
    probe_ok = draws[2] if ctx.masked else None
    S = ctx.cfg.num_schedulers
    bsz = idx.shape[0]
    dev = idx.device
    sched = idx % S
    j = torch.zeros((bsz,), dtype=torch.long, device=dev)
    outs = torch.zeros((9 if ctx.cfg.retry is not None else 7, bsz),
                       dtype=torch.float32, device=dev)
    no_lat = torch.zeros((S,), dtype=torch.float32, device=dev)
    iota_r = torch.arange(carry.rb_release.shape[1], device=dev)
    for a in range(0, bsz, S):
        c = slice(a, min(a + S, bsz))
        k = c.stop - a
        ar = torch.arange(k, device=dev)
        m_c, s_c, now_c = valid[c], sched[c], now[c]
        pool = tuple(getattr(carry, f)[s_c] for f in _POOLS)   # [k, P]
        j_c, pv = _pool_pick(pool, now_c, rand_j[c], ctx)
        nt = ctx.node_type[j_c].long()
        occ, rounds = _queue_ranks(j_c, m_c)
        carry, o = _commit_servers(
            carry, m_c, now_c, j_c, r_exec_t[c][ar, nt, 0],
            r_exec_t[c][ar, nt, 1], d_act_t[c][ar, nt], d_est_t[c][ar, nt],
            no_lat[:k], ctx, occ, rounds)
        outs[:, c] = o
        j[c] = torch.where(m_c, j_c, 0)

        pr_c = probes[c]                                        # [k, rp]
        rel, dur = carry.rb_release[pr_c], carry.rb_dur[pr_c]   # [k, rp, R]
        for t in reversed(range(k)):
            hit = ((m_c[t] & (ar <= t)[:, None] & (pr_c == j_c[t]))[..., None]
                   & (iota_r == o[6, t].long()))
            rel = torch.where(hit, o[4, t], rel)
            dur = torch.where(hit, o[5, t], dur)
        prif, pD = _probe_truth(rel, dur, now_c[:, None, None])
        new = _pool_update(pool[:4] + (pv,), pr_c, prif, pD, now_c,
                           None if probe_ok is None else probe_ok[c])
        for f, old, v in zip(_POOLS, pool, new):
            getattr(carry, f)[s_c] = torch.where(m_c[:, None], v, old)
    return carry, j, outs


def _block_step(carry: _Carry, blk, draws, ctx: _Ctx, push: bool):
    """One decision block: select, commit, flush, and (``push``) the
    data-store push at the block's end.  ``draws`` is the block's slice of
    :func:`_task_draws`; ``push`` is known on the host: only a full block
    reaches the b-th decision, and a store outage suppresses it.  PoT and
    Prequal decide against state that every commit changes, so they
    select and commit together (:func:`_pot_block`,
    :func:`_prequal_block`); they keep no data store, so they neither
    flush nor push.  On a task-graph wave under a :class:`LocalityModel`,
    ``blk`` ends with the parent planes (psrv [b, P], pbytes [b, P]),
    which dodoor and (1+β) pass to the decision kernel (K3); the other
    policies ignore them, as the reference's branches do.

    Under cache faults dodoor and (1+β) draw their candidates and score
    them in torch ops against each task's own scheduler's view row
    (:func:`repro_torch.core.policies.dodoor_choice_batch`), as the
    reference's faulted path does, and launch no kernel; the push's
    ordinal ``(idx[-1] + 1) // b`` keys the delivery-loss draw.  With
    ``cfg.trace`` the output gains seven rows (:data:`_TRACE_ROWS`),
    captured before the push: the snapshot's age ``now − push_at[sched]``,
    the cached RIF of both candidates, the candidates, the (1+β) coin
    (ones for dodoor) and the push flag on the block's last row; zeros
    for the other policies."""
    idx, r_sub, r_exec_t, d_est_t, d_act_t, submit, task_id, valid = blk[:8]
    cfg, dyn = ctx.cfg, ctx.dyn
    S = cfg.num_schedulers
    bsz = idx.shape[0]
    dev = idx.device
    tt = torch.arange(bsz, device=dev)
    now = submit
    sched = idx % S
    cached = cfg.policy in ("dodoor", "one_plus_beta")

    if cfg.policy in ("pot", "prequal"):
        probing = _pot_block if cfg.policy == "pot" else _prequal_block
        carry, j, outs = probing(carry, blk, draws, ctx)
        nt_j = ctx.node_type[j].long()
        cores_t = r_exec_t[tt, nt_j, 0]
        mem_t = r_exec_t[tt, nt_j, 1]
    else:
        extra_lat = torch.zeros((bsz,), dtype=torch.float32, device=dev)
        win = ctx.win
        if cfg.policy == "random":
            mask = feasible_mask(r_sub, ctx.C)
            if ctx.masked:
                mask = mask & avail_rows(win.down0, win.down1, now)
            j = inverse_cdf_draws(mask, draws[0])[:, 0]
        elif ctx.faulted:
            mask = feasible_mask(r_sub, ctx.C)
            if ctx.masked:
                mask = mask & avail_rows(win.down0, win.down1, now)
            cand2 = sample_feasible_batch(draws[0], mask, 2).long()
            loc = (dict(psrv=blk[8], pbytes=blk[9], gamma_bw=dyn.gamma_bw)
                   if len(blk) > 8 else {})
            view = SchedulerView(carry.view_L, carry.view_D,
                                 carry.view_rif, ctx.C)
            two = dodoor_choice_batch(
                r_sub, cand2,
                d_est_t[tt[:, None], ctx.node_type[cand2].long()],
                view, dyn.alpha, sched=sched, **loc)
        else:
            extra = (dict(down0=win.down0, down1=win.down1, now=now,
                          down_t=ctx.down_t) if ctx.masked else {})
            if len(blk) > 8:
                extra.update(psrv=blk[8], pbytes=blk[9],
                             gamma_bw=_gamma_bw(cfg))
            two, cand2, _ = dodoor_fused_sparse(
                draws[0], r_sub, d_est_t, ctx.node_type, carry.view_L,
                carry.view_D, ctx.C, alpha=cfg.alpha, **extra)
            cand2 = cand2.long()
        if cached:
            if cfg.policy == "one_plus_beta":
                coin = draws[1] < dyn.beta
                j = torch.where(coin, two, cand2[:, 0])
            else:
                j = two
            extra_lat = torch.clamp_min(carry.push_end - now, 0.0)
            if cfg.trace:
                vrows = ((sched[:, None], cand2) if ctx.faulted
                         else (cand2,))
                v_rif = carry.view_rif[vrows]                    # [b, 2]
                coin_f = (coin.to(torch.float32)
                          if cfg.policy == "one_plus_beta"
                          else torch.ones((bsz,), device=dev))
                trace = [now - carry.push_at[sched], v_rif[:, 0],
                         v_rif[:, 1], cand2[:, 0].to(torch.float32),
                         cand2[:, 1].to(torch.float32), coin_f]
        j = j.long()

        # ---- commit
        nt_j = ctx.node_type[j].long()
        cores_t = r_exec_t[tt, nt_j, 0]
        mem_t = r_exec_t[tt, nt_j, 1]
        dur_t = d_act_t[tt, nt_j]
        dest_t = d_est_t[tt, nt_j]
        occ, rounds = _queue_ranks(j, valid)
        carry, outs = _commit_rounds(carry, valid, now, j, cores_t, mem_t,
                                     dur_t, dest_t, extra_lat, ctx, occ,
                                     rounds)

    n_valid = valid.sum()
    zero = torch.zeros_like(n_valid)
    n_flush = zero
    # ---- data-store protocol, once per block (cached-view policies)
    if cached:
        delta = torch.stack([cores_t, mem_t, dest_t,
                             torch.ones_like(cores_t)], dim=1)   # [b, 4]
        do_flush = (((idx // S) + 1) % cfg.flush_every == 0) & valid
        # A delta survives into the carried accumulator iff its scheduler
        # does not flush at or after it within this block.
        flushed_after = ((sched[None, :] == sched[:, None])
                         & (tt[None, :] >= tt[:, None])
                         & do_flush[None, :]).any(dim=1)
        survives = valid & ~flushed_after
        if cfg.retry is not None:
            # A rejected placement queued nothing, so reports no delta.
            survives = survives & ~(outs[8] > 0.5)
        add = _add_in_task_order(carry.pending, sched, j, delta, survives,
                                 occ, rounds)
        sched_flushed = torch.zeros((S + 1,), dtype=torch.bool, device=dev)
        sched_flushed[torch.where(do_flush, sched, S)] = True
        pending = torch.where(sched_flushed[:S, None, None],
                              torch.zeros((), device=dev),
                              carry.pending) + add
        carry = carry._replace(pending=pending)
        n_flush = do_flush.sum()
        if push:
            carry = _apply_push(carry, now[-1], ctx, (idx[-1] + 1) // cfg.b)
    n_push = S if push and cached else 0
    msgs = carry.msgs + torch.stack(
        [2 * n_valid, _probe_msgs(cfg) * n_valid, zero + n_push,
         n_flush]).to(torch.int32)
    carry = carry._replace(msgs=msgs)
    out = (j.to(torch.int32), outs[0], outs[1], outs[2], outs[3], cores_t,
           mem_t) + tuple(outs[7:])              # (killed, rejected)
    if cfg.trace:
        if not cached:
            trace = [torch.zeros((bsz,), device=dev)] * 6
        # The flag on the block's last row, made without writing a Python
        # number into a device tensor (that would sync the card).
        push_row = (tt == bsz - 1) & (push and cached)
        out = out + tuple(trace) + (push_row.to(torch.float32),)
    return carry, out


def _simulate_batched(xs, ctx: _Ctx, carry0: _Carry | None = None,
                      return_carry: bool = False):
    """The block loop over ``xs`` = (idx, r_sub, r_exec, d_est, d_act,
    submit, task_id, valid), each [nb, b, ...], and on a locality wave
    (psrv, pbytes) [nb, b, P].  Returns ``(carry, outs)`` when
    ``return_carry``, else ``(msgs, outs)``; ``outs`` is the tuple
    (server, start, finish, enqueue, sched_ms, cores, mem), each [nb, b],
    under a :class:`RetryPolicy` also (killed, rejected), and with
    ``cfg.trace`` the :data:`_TRACE_ROWS` trace rows.  The wave loops pass
    the previous wave's carry as ``carry0``."""
    cfg = ctx.cfg
    carry = carry0 if carry0 is not None else _init_carry(
        cfg, ctx.C.shape[0], ctx.cores_per, ctx.faulted)
    # Only full blocks push, and not inside a store outage.
    push_at = (xs[7][:, -1].cpu()
               & ~_suppress_push(ctx.win, xs[5][:, -1].cpu())).numpy()
    draws = _task_draws(ctx, xs[6], xs[1], xs[5])
    nb = xs[0].shape[0]
    per_block = []
    for i in range(nb):
        blk = tuple(x[i] for x in xs)
        carry, out = _block_step(carry, blk, tuple(d[i] for d in draws),
                                 ctx, bool(push_at[i]))
        per_block.append(out)
    outs = tuple(torch.stack(col) for col in zip(*per_block))
    if return_carry:
        return carry, outs
    return carry.msgs, outs


def _blocked_inputs(workload, b: int, device):
    """The workload as [nb, b, ...] decision blocks: the ragged tail is
    edge-padded and masked by ``valid``.  Azure's per-type planes are
    broadcast views and arrival planes are read-only, so every field is
    made a contiguous writable array before it reaches torch."""
    m = workload.r_submit.shape[0]
    nb = -(-m // b)
    pad = nb * b - m

    def prep(a):
        a = np.require(a, requirements=("C", "W"))   # sampled planes are
                                                     # read-only: copy them
        if pad:
            a = np.pad(a, ((0, pad),) + ((0, 0),) * (a.ndim - 1), mode="edge")
        return torch.from_numpy(a.reshape((nb, b) + a.shape[1:])).to(device)

    ids = torch.arange(nb * b, dtype=torch.int64).reshape(nb, b)
    ids = ids.to(device)
    valid = torch.from_numpy((np.arange(nb * b) < m).reshape(nb, b))
    return (ids, prep(workload.r_submit), prep(workload.r_exec),
            prep(workload.d_est), prep(workload.d_act),
            prep(workload.submit_ms), ids, valid.to(device))


def _validate_config(cfg: EngineConfig) -> None:
    if cfg.rbuf_slots < 1:
        raise ValueError(f"rbuf_slots={cfg.rbuf_slots} must be ≥ 1")
    if cfg.b < 1 or cfg.flush_every < 1:
        raise ValueError(
            f"b={cfg.b} and flush_every={cfg.flush_every} must be ≥ 1")
    if cfg.policy == "dodoor":
        bound = max(1, 2 * cfg.b // max(1, cfg.num_schedulers))
        if cfg.flush_every > bound:
            raise ValueError(
                f"flush_every={cfg.flush_every} violates the §4.1 mini-batch "
                f"bound 2b/num_schedulers = {bound}")
    if cfg.retry is not None:
        rp = cfg.retry
        if not isinstance(rp, RetryPolicy):
            raise TypeError("EngineConfig.retry must be a RetryPolicy")
        if rp.max_attempts < 1:
            raise ValueError("retry.max_attempts must be ≥ 1")
        if rp.backoff_ms < 0.0 or rp.backoff_mult <= 0.0:
            raise ValueError(
                "retry needs backoff_ms ≥ 0 and backoff_mult > 0")
    if cfg.locality is not None:
        lm = cfg.locality
        if not isinstance(lm, LocalityModel):
            raise TypeError("EngineConfig.locality must be a LocalityModel")
        if lm.gamma < 0.0:
            raise ValueError("locality.gamma must be ≥ 0")
        if lm.bandwidth_mb_per_ms <= 0.0:
            raise ValueError("locality.bandwidth_mb_per_ms must be > 0")


def _check_mode(cfg: EngineConfig, mode: str) -> None:
    if mode not in ("batched", "sequential"):
        raise ValueError(f"unknown mode {mode!r}")
    if cfg.policy not in POLICIES:
        raise ValueError(f"unknown policy {cfg.policy!r}")


_TASK_FIELDS = ("r_submit", "r_exec", "d_est", "d_act")
#: Rows of :func:`_run_wave`'s float outputs, after the server column.
_START, _FINISH, _ENQ, _SCHED, _CORES, _MEM, _KILLED, _REJECTED = range(8)


def _task_planes(workload, device) -> tuple:
    """The workload's per-task planes (r_submit, r_exec, d_est, d_act) on
    ``device``, uploaded once per run; each wave gathers its rows."""
    return tuple(
        torch.from_numpy(np.require(getattr(workload, f),
                                    requirements=("C", "W"))).to(device)
        for f in _TASK_FIELDS)


def _wave_inputs(planes, idx, submit_w, task_id, b: int, device,
                 parents=()):
    """One wave as the block loop's ``xs``, built as the reference's wave
    loops build it: the tasks ``idx`` (original indices, in decision
    order) with their submit times ``submit_w`` and task ids, edge-padded
    to whole blocks of ``b`` and masked by ``valid``.  The wave-local
    index ``arange`` restarts the scheduler round robin and the flush
    cadence.  ``parents`` is the locality pair (psrv, pbytes) [w, P]."""
    mw = idx.shape[0]
    nb = -(-mw // b)
    pad = nb * b - mw

    def edge(a):
        a = np.ascontiguousarray(a)
        if pad:
            a = np.pad(a, ((0, pad),) + ((0, 0),) * (a.ndim - 1),
                       mode="edge")
        return torch.from_numpy(a).to(device)

    def blocks(t):
        return t.reshape((nb, b) + tuple(t.shape[1:]))

    rows = edge(idx.astype(np.int64))
    ids = torch.arange(nb * b, device=device)
    return ((blocks(ids),) + tuple(blocks(p[rows]) for p in planes)
            + (blocks(edge(submit_w)), blocks(edge(task_id.astype(np.int64))),
               blocks(ids < mw))
            + tuple(blocks(edge(p)) for p in parents))


def _run_wave(xs, ctx: _Ctx, carry: _Carry | None, mw: int):
    """The block loop over one wave from ``carry`` (None: the t=0 carry).
    Returns the carry, the wave's servers [mw] and its float outputs
    [rows, mw] on the host (rows indexed by ``_START`` … ``_REJECTED``)."""
    carry, outs = _simulate_batched(xs, ctx, carry0=carry,
                                    return_carry=True)
    j = outs[0].reshape(-1)[:mw].cpu().numpy()
    rest = torch.stack(outs[1:]).reshape(len(outs) - 1, -1)[:, :mw]
    return carry, j, rest.cpu().numpy()


# ---------------------------------------------------------------- sequential

def _commit_one(carry: _Carry, now, j, cores, mem_mb, dur_raw, d_est_j,
                extra_lat, ctx: _Ctx):
    """Commit one placed task to server ``j``: channel contention, FCFS
    start, interference and straggler stretch, unit allocation and the
    ring-buffer insert, as the reference's sequential commit computes
    them.  ``j`` is a one-element index tensor and the task's values
    one-element tensors (``now`` 0-d): indexing with a 0-d tensor reads it
    to the host, which on the card is a sync.  The task takes the ``c``
    earliest-free units of the server's ascending rows, which stay
    ascending (:func:`_sorted_fill`); the reference's ``argsort(argsort(·))``
    replaces the same values in an unsorted row.
    Updates the carry's planes in place and returns (start, finish,
    enqueue, sched_ms) or, under a :class:`RetryPolicy`, those and
    (killed, rejected), with the reference's failure paths (see
    :func:`_commit_rounds`)."""
    dyn = ctx.dyn
    retry = ctx.cfg.retry is not None
    cp = ctx.cores_per[j]
    rif_j = (carry.rb_release[j] > now).to(torch.float32).sum(dim=-1)
    occupancy = dyn.chan_ms * (1.0 + rif_j / cp)
    chan_j = carry.chan_free[j]
    chan_wait = torch.clamp_min(chan_j - now, 0.0)
    sched_ms = dyn.compute_ms + extra_lat + chan_wait + occupancy + dyn.hop_ms
    carry.chan_free[j] = torch.maximum(chan_j, now) + occupancy
    enqueue_t = now + sched_ms
    if retry:
        rejected = rif_j >= dyn.reject_cap * cp.to(torch.float32)
        w = ~rejected

    c_eff = torch.minimum(torch.clamp_min(cores, 1.0), cp).to(torch.long)
    mu_need = torch.ceil(mem_mb / ctx.mem_unit[j]).clamp(
        1, ctx.cfg.mem_units).to(torch.long)
    cf, mf = carry.core_free[j], carry.mem_free[j]           # [1, CMAX/MU]
    start = torch.maximum(
        torch.maximum(enqueue_t, carry.prev_start[j]),
        torch.maximum(cf.gather(1, c_eff[:, None] - 1)[:, 0],
                      mf.gather(1, mu_need[:, None] - 1)[:, 0]))
    if ctx.gated:
        start = _gate_start(ctx.win, start, j)
    busy = (cf > start[:, None]).sum(dim=-1) - (CMAX - cp)
    dur = dur_raw * ctx.stretch[cp.long() * (CMAX + 1) + busy]
    if ctx.slowed:
        dur = dur * _slow_stretch(ctx.win, start, j)
    finish = start + dur
    rel = finish
    if retry:
        killed = torch.zeros_like(w)
        if ctx.gated:
            g0 = ctx.win.gate0[j]
            opens = (g0 > start[:, None]) & (g0 < finish[:, None])
            kt = torch.where(opens, g0, float("inf")).min(dim=-1).values
            killed = w & torch.isfinite(kt)
            rel = torch.where(killed, kt, finish)

    cf_new = _sorted_fill(cf, c_eff, rel)
    mf_new = _sorted_fill(mf, mu_need, rel)
    slot = torch.argmin(carry.rb_release[j], dim=-1)
    new = torch.stack([rel, cores, mem_mb, d_est_j])          # [4, 1]
    if retry:
        cf_new = torch.where(w[:, None], cf_new, cf)
        mf_new = torch.where(w[:, None], mf_new, mf)
        start_w = torch.where(w, start, carry.prev_start[j])
        new = torch.where(w, new, torch.stack(
            [carry.rb_release[j, slot], carry.rb_cpu[j, slot],
             carry.rb_mem[j, slot], carry.rb_dur[j, slot]]))
    else:
        start_w = start
    carry.core_free[j] = cf_new
    carry.mem_free[j] = mf_new
    carry.prev_start[j] = start_w
    for plane, v in zip((carry.rb_release, carry.rb_cpu, carry.rb_mem,
                         carry.rb_dur), new):
        plane[j, slot] = v
    if not retry:
        return start, finish, enqueue_t, sched_ms
    return (torch.where(rejected, enqueue_t, start),
            torch.where(rejected, enqueue_t, rel), enqueue_t, sched_ms,
            killed.to(torch.float32), rejected.to(torch.float32))


#: Tasks whose candidates one pass of :func:`_seq_draws` draws together
#: (bounds its [tasks, n] masks).
_DRAW_CHUNK = 4096


def _seq_draws(ctx: _Ctx, r_sub, now, task_id):
    """Every draw of a sequential wave, made at once: they depend only on
    the task keys ``fold_in(PRNGKey(seed), task_id)``, the demands and the
    down windows at each task's time, never on the carry.  Returns a dict
    of device tensors: ``cand`` [m, 2] (PoT, dodoor, (1+β); Random [m,
    1]), ``use_two`` [m] ((1+β)), and for Prequal ``rand_j`` [m], the
    probed servers ``probes`` [m, r_probe] and ``probe_ok`` [m, r_probe]
    (not inside a down window at the task's time)."""
    cfg, win = ctx.cfg, ctx.win
    policy = cfg.policy
    n = ctx.C.shape[0]
    out = {}
    keys = fold_in(ctx.base_key, task_id)
    if policy in ("dodoor", "one_plus_beta"):
        kk = split(keys)
        u = uniform(kk[:, 0, :], (2,))
        if policy == "one_plus_beta":
            out["use_two"] = uniform(kk[:, 1, :]) < ctx.dyn.beta
    elif policy == "prequal":
        kk = split(keys, 3)
        u = uniform(kk[:, 1, :], (1,))
        probes = randint(kk[:, 2, :], (cfg.prequal.r_probe,), 0, n).long()
        out["probes"] = probes
        if ctx.masked:
            t = now[:, None, None]
            out["probe_ok"] = ~((win.down0[probes] <= t)
                                & (t < win.down1[probes])).any(dim=-1)
    else:
        u = uniform(keys, (2 if policy == "pot" else 1,))
    cand = []
    for a in range(0, r_sub.shape[0], _DRAW_CHUNK):
        sl = slice(a, a + _DRAW_CHUNK)
        mask = feasible_mask(r_sub[sl], ctx.C)
        if ctx.masked:
            mask = mask & avail_rows(win.down0, win.down1, now[sl])
        cand.append(inverse_cdf_draws(mask, u[sl]).long())
    cand = torch.cat(cand) if cand else u.new_zeros(u.shape, dtype=torch.long)
    if policy == "prequal":
        out["rand_j"] = cand[:, 0]
    else:
        out["cand"] = cand
    return out


def _seq_wave(ctx: _Ctx, carry: _Carry | None, host: dict, dev,
              parents=()):
    """The sequential oracle over one wave: the reference's per-task scan,
    every decision against the live carry.  ``host`` holds the wave's
    numpy planes in decision order (``r_submit``, ``r_exec``, ``d_est``,
    ``d_act``, ``submit`` float32 and ``task_id``); the wave-local index
    ``i`` sets the scheduler (``i mod S``), the flush cadence and the push
    (after the ``i + 1 ≡ 0 (mod b)``-th decision, unless a store outage
    covers it), all decided here on the host.  ``parents`` is the
    locality pair (psrv, pbytes) [m, P] of a task-graph wave.

    Dodoor's and (1+β)'s decisions read only the cached view and the
    push's end, which change only at a push, so each run of ``b``
    decisions between two pushes is scored at once against the live view;
    PoT's probes and Prequal's pools read state that every commit
    changes, so they decide task by task.  Under cache faults each task of
    the run reads its own scheduler's row of the per-scheduler views, and
    the push after decision ``i`` has the ordinal ``(i + 1) // b``.  With
    ``cfg.trace`` the same run of ``b`` decisions records the trace rows
    of :func:`_block_step` at once, and the push row is the host's push
    plan.  Returns ``(carry, j [m], outs [rows, m])`` on the host, as
    :func:`_run_wave`."""
    cfg, dyn = ctx.cfg, ctx.dyn
    policy = cfg.policy
    S, b, fe = cfg.num_schedulers, cfg.b, cfg.flush_every
    retry = cfg.retry is not None
    m = host["submit"].shape[0]
    carry = carry if carry is not None else _init_carry(
        cfg, ctx.C.shape[0], ctx.cores_per, ctx.faulted)
    r_sub, r_exec, d_est, d_act, now_t = (
        torch.from_numpy(np.require(host[k], requirements=("C", "W"))).to(dev)
        for k in ("r_submit", "r_exec", "d_est", "d_act", "submit"))
    draws = _seq_draws(ctx, r_sub, now_t, torch.from_numpy(
        host["task_id"].astype(np.int64)).to(dev))
    psrv, pbytes = (tuple(torch.from_numpy(np.require(
        p, requirements=("C", "W"))).to(dev) for p in parents)
        or (None, None))
    cached = policy in ("dodoor", "one_plus_beta")
    i_host = np.arange(m)
    do_flush = ((i_host // S) + 1) % fe == 0
    store0 = ctx.win.store0.cpu().numpy()
    store1 = ctx.win.store1.cpu().numpy()
    t = host["submit"][:, None]
    do_push = (((i_host + 1) % b == 0)
               & ~((store0 <= t) & (t < store1)).any(axis=1))
    nt = ctx.node_type.long()
    t0 = 8 if retry else 6                  # first trace row
    outs = torch.zeros((t0 + (_TRACE_ROWS if cfg.trace else 0), m),
                       dtype=torch.float32, device=dev)
    js = torch.zeros((m,), dtype=torch.long, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    ones = torch.ones((1,), dtype=torch.float32, device=dev)
    # Decision ordinals and schedulers on the device: an int would be
    # copied there at every use, which syncs the card.
    ords = torch.arange(1, m + 1, device=dev)
    scheds = torch.arange(m, device=dev) % S
    if cfg.trace and cached:
        # The host's push plan, made again on the device (a copy of the
        # host's would sync the card).
        outs[t0 + 6] = (((ords % b) == 0)
                        & ~_suppress_push(ctx.win, now_t)).to(torch.float32)
    for i in range(m):
        now = now_t[i]
        s = i % S
        lat = zero
        if cached and i % b == 0:
            # The block's decisions against the view it sees.
            blk = slice(i, min(m, i + b))
            cand = draws["cand"][blk]
            rows = torch.arange(cand.shape[0], device=dev)[:, None]
            view = SchedulerView(carry.view_L, carry.view_D,
                                 carry.view_rif, ctx.C)
            loc = ({} if psrv is None else
                   dict(psrv=psrv[blk], pbytes=pbytes[blk],
                        gamma_bw=dyn.gamma_bw))
            if ctx.faulted:
                loc["sched"] = scheds[blk]
            pick = dodoor_choice_batch(
                r_sub[blk], cand, d_est[blk][rows, nt[cand]], view,
                dyn.alpha, **loc).long()
            if policy == "one_plus_beta":
                pick = torch.where(draws["use_two"][blk], pick, cand[:, 0])
            blk_lat = torch.clamp_min(carry.push_end - now_t[blk], 0.0)
            if cfg.trace:
                vrows = ((scheds[blk, None], cand) if ctx.faulted
                         else (cand,))
                v_rif = carry.view_rif[vrows]
                coin = (draws["use_two"][blk].to(torch.float32)
                        if policy == "one_plus_beta"
                        else torch.ones_like(v_rif[:, 0]))
                outs[t0:t0 + 6, blk] = torch.stack(
                    [now_t[blk] - carry.push_at[scheds[blk]], v_rif[:, 0],
                     v_rif[:, 1], cand[:, 0].to(torch.float32),
                     cand[:, 1].to(torch.float32), coin])
        # j: a one-element index tensor (a 0-d one would sync the card).
        if cached:
            k = i % b
            j, lat = pick[k:k + 1], blk_lat[k:k + 1]
        elif policy == "random":
            j = draws["cand"][i]
        elif policy == "pot":
            c = draws["cand"][i]
            rif = (carry.rb_release[c] > now).to(torch.float32).sum(dim=-1)
            j = torch.where(rif[1:] < rif[:1], c[1:], c[:1])
            lat = 2.0 * dyn.hop_ms
        else:
            # The pick from the live pool, then the r_probe probes of the
            # ring buffers before the commit, into the pool.
            pool = tuple(getattr(carry, f)[s:s + 1] for f in _POOLS)
            j, pv = _pool_pick(pool, now.view(1), draws["rand_j"][i:i + 1],
                               ctx)
            pr_i = draws["probes"][i:i + 1]
            prif, pD = _probe_truth(carry.rb_release[pr_i],
                                    carry.rb_dur[pr_i], now)
            new = _pool_update(
                pool[:4] + (pv,), pr_i, prif, pD, now.view(1),
                draws["probe_ok"][i:i + 1] if ctx.masked else None)
            for f, v in zip(_POOLS, new):
                getattr(carry, f)[s:s + 1] = v
        nt_j = nt[j]
        res = r_exec[i][nt_j]                                  # [1, 2]
        cores, mem_mb = res[:, 0], res[:, 1]
        d_est_j = d_est[i][nt_j]
        o = _commit_one(carry, now, j, cores, mem_mb, d_act[i][nt_j],
                        d_est_j, lat, ctx)
        outs[:t0, i:i + 1] = torch.stack(o[:4] + (cores, mem_mb) + o[4:])
        js[i:i + 1] = j
        if cached:
            delta = torch.stack([cores, mem_mb, d_est_j, ones], dim=-1)
            if retry:
                delta = delta * torch.where(o[5] > 0.5, 0.0, 1.0)
            carry.pending[s, j] += delta
            if do_flush[i]:
                carry.pending[s] = 0.0
            if do_push[i]:
                carry = _apply_push(carry, now, ctx, ords[i] // b)
    counts = [2 * m, _probe_msgs(cfg) * m, 0, 0]
    if cached:
        counts[2:] = [S * int(do_push.sum()), int(do_flush.sum())]
    carry = carry._replace(msgs=carry.msgs + torch.tensor(
        counts, dtype=torch.int32, device=dev))
    return carry, js.to(torch.int32).cpu().numpy(), outs.cpu().numpy()


def _result(server, planes: dict, submit_ms, carry: _Carry, cfg, **rec):
    msgs = carry.msgs.cpu().numpy()
    return SimResult(
        server=server, submit_ms=submit_ms, enqueue_ms=planes["enq"],
        start_ms=planes["start"], finish_ms=planes["finish"],
        sched_ms=planes["sched"], cores=planes["cores"],
        mem_mb=planes["mem"], msgs_base=int(msgs[0]),
        msgs_probe=int(msgs[1]), msgs_push=int(msgs[2]),
        msgs_flush=int(msgs[3]), policy=cfg.policy, **rec)


def _record(server, planes: dict, idx, j_w, outs_w) -> None:
    server[idx] = j_w
    for k, row in (("start", _START), ("finish", _FINISH), ("enq", _ENQ),
                   ("sched", _SCHED), ("cores", _CORES), ("mem", _MEM)):
        planes[k][idx] = outs_w[row]


def _empty_planes(m: int) -> dict:
    return {k: np.zeros(m, np.float32)
            for k in ("start", "finish", "enq", "sched", "cores", "mem")}


def _empty_trace(m: int) -> dict:
    """The host planes a traced run fills wave by wave; a retried task
    keeps its last attempt's record."""
    tr = {k: np.zeros(m, np.float32)
          for k in ("age", "verr", "misp", "push", "decision")}
    tr["sched"] = np.zeros(m, np.int32)
    return tr


def _ring_on_host(carry: _Carry | None):
    """The wave-entry ring buffers (release, cpu, mem, dur) as host
    copies, or None before the first wave: the wave updates the carry's
    planes in place, so a view would see the wave's own commits."""
    if carry is None:
        return None
    return tuple(getattr(carry, f).cpu().numpy().copy()
                 for f in ("rb_release", "rb_cpu", "rb_mem", "rb_dur"))


def _trace_wave(tr: dict, ctx: _Ctx, workload, idx, j_w, outs_w, submit_w,
                parents=(), init_ring=None) -> None:
    """The trace post-pass of one wave, as the reference's: its captures
    (the last :data:`_TRACE_ROWS` rows of ``outs_w``) and the stripped
    commit record through :func:`finish_trace`, with the wave's demands,
    the cluster, α and ``R = rbuf_slots``; the rejected tasks under a
    :class:`RetryPolicy`, the locality pair on a task-graph wave, and the
    wave-entry ring ``init_ring``.  Records the planes at ``idx``; the
    deciding scheduler is the wave-local index mod ``S``."""
    cfg = ctx.cfg
    age, vr0, vr1, c0, c1, coin, push = outs_w[-_TRACE_ROWS:]
    loc = ({} if not parents else
           dict(gamma_bw=cfg.locality.gamma_bw, psrv=parents[0],
                pbytes=parents[1]))
    verr, misp = finish_trace(
        j=j_w, finish=outs_w[_FINISH], cores=outs_w[_CORES],
        mem=outs_w[_MEM], now=submit_w, v_rif=(vr0, vr1), cand=(c0, c1),
        use_two=coin, r_sub=np.asarray(workload.r_submit)[idx],
        d_est=np.asarray(workload.d_est)[idx],
        node_type=np.asarray(ctx.cluster.node_type),
        C=np.asarray(ctx.cluster.C, np.float32),
        alpha=cfg.alpha, policy=cfg.policy, R=cfg.rbuf_slots,
        rejected=(outs_w[_REJECTED] > 0.5 if cfg.retry is not None
                  else None),
        init_ring=init_ring, **loc)
    for k, v in (("age", age), ("verr", verr), ("misp", misp),
                 ("push", push), ("decision", submit_w)):
        tr[k][idx] = v
    tr["sched"][idx] = np.arange(idx.shape[0]) % cfg.num_schedulers


def _trace_result(tr: dict | None) -> dict:
    """:class:`SimResult`'s trace fields from :func:`_empty_trace`'s
    planes (none for an untraced run)."""
    if tr is None:
        return {}
    return {"view_age_ms": tr["age"], "view_err": tr["verr"],
            "misplaced": tr["misp"] > 0.5, "cache_push": tr["push"] > 0.5,
            "sched_id": tr["sched"], "decision_ms": tr["decision"]}


def _wave_runner(workload, ctx: _Ctx, mode: str, device):
    """``run(carry, idx, submit_w, task_id, parents)`` → ``(carry, j [w],
    outs [rows, w])`` for one wave of the tasks ``idx`` (original
    indices, in decision order): the batched driver edge-padded to whole
    blocks of ``b``, or the sequential oracle at the wave's exact length,
    as the reference's wave loops run each mode."""
    if mode == "sequential":
        host = {f: np.asarray(getattr(workload, f)) for f in _TASK_FIELDS}

        def run(carry, idx, submit_w, task_id, parents=()):
            wave = {f: host[f][idx] for f in _TASK_FIELDS}
            wave.update(submit=np.asarray(submit_w, np.float32),
                        task_id=np.asarray(task_id))
            return _seq_wave(ctx, carry, wave, device, parents)
        return run
    planes = _task_planes(workload, device)

    def run(carry, idx, submit_w, task_id, parents=()):
        xs = _wave_inputs(planes, idx, submit_w, task_id, ctx.cfg.b, device,
                          parents)
        return _run_wave(xs, ctx, carry, idx.shape[0])
    return run


def _simulate_dag(workload, ctx: _Ctx, plan, device,
                  mode: str = "batched") -> SimResult:
    """The frontier loop: run a task graph level by level, one wave per
    longest-path topological level, so every task's parents have finished
    (and their servers are known to the locality term) before it is
    submitted.  A task's *effective* submit time is ``max(trace submit,
    max_p(finish[p] + edge_delay))``, in float64 from the float32
    finishes, and a wave's decisions run in that order (original index
    breaks ties).  The carry threads from wave to wave; wave-local
    cadences restart per wave.  Under a :class:`LocalityModel` each wave
    carries its tasks' parent servers and output MB (−1 / 0 pads) into
    the decision kernel.  The result's ``submit_ms`` holds the effective
    submit times."""
    cfg = ctx.cfg
    m = plan.m
    loc_on = cfg.locality is not None and plan.max_parents > 0
    run = _wave_runner(workload, ctx, mode, device)
    server = np.zeros(m, np.int32)
    fin = _empty_planes(m)
    tr = _empty_trace(m) if cfg.trace else None
    eff_submit = np.zeros(m, np.float32)
    submit0 = np.asarray(workload.submit_ms).astype(np.float64)
    by_level = np.argsort(plan.level, kind="stable")
    ends = np.cumsum(np.bincount(plan.level, minlength=plan.num_levels))
    carry = None
    for lo, hi in zip(np.concatenate([[0], ends[:-1]]), ends):
        sel = by_level[lo:hi]
        par = plan.parents_pad[sel]                          # [w, P]
        fin_par = np.where(
            par >= 0, fin["finish"][np.maximum(par, 0)].astype(np.float64),
            -np.inf)
        ready = np.maximum(
            submit0[sel],
            np.max(fin_par + plan.pdelay_pad[sel], axis=1, initial=-np.inf))
        order = np.lexsort((sel, ready))
        idx = sel[order]
        submit_w = ready[order].astype(np.float32)
        parents = ()
        if loc_on:
            pidx = plan.parents_pad[idx]
            parents = (np.where(pidx >= 0, server[np.maximum(pidx, 0)],
                                -1).astype(np.int32),
                       plan.pbytes_pad[idx])
        ring0 = _ring_on_host(carry) if tr is not None else None
        carry, j_w, outs_w = run(carry, idx, submit_w, idx, parents)
        _record(server, fin, idx, j_w, outs_w)
        eff_submit[idx] = submit_w
        if tr is not None:
            _trace_wave(tr, ctx, workload, idx, j_w, outs_w, submit_w,
                        parents, ring0)
    return _result(server, fin, eff_submit, carry, cfg, **_trace_result(tr))


def _simulate_with_retries(workload, ctx: _Ctx, device,
                           mode: str = "batched") -> SimResult:
    """The re-entry queue: run the decision stream in *waves*.  Wave 1 is
    the whole workload.  Tasks killed by a gate window or rejected at hard
    capacity re-enter as wave k+1 at ``fail_time + backoff_ms ·
    backoff_mult^(k-1)`` (float64, then float32), ordered by that time
    with the original index breaking ties, under task ids ``index +
    (k-1)·m`` (fresh decision randomness).  The carry threads from wave
    to wave; wave-local cadences restart per wave.  A task still failing
    after ``max_attempts`` submissions fails permanently; its recorded
    finish is its last kill or reject time.  ``wasted_ms`` sums the
    killed attempts' execution time in float64."""
    cfg = ctx.cfg
    rp = cfg.retry
    m = workload.r_submit.shape[0]
    run = _wave_runner(workload, ctx, mode, device)
    server = np.zeros(m, np.int32)
    fin = _empty_planes(m)
    attempts = np.zeros(m, np.int32)
    wasted = np.zeros(m, np.float64)
    tr = _empty_trace(m) if cfg.trace else None
    idx = np.arange(m)
    submit_w = np.asarray(workload.submit_ms).astype(np.float32)
    carry = None
    for a in range(1, rp.max_attempts + 1):
        task_id = (idx + (a - 1) * m).astype(np.int32)
        ring0 = _ring_on_host(carry) if tr is not None else None
        carry, j_w, outs_w = run(carry, idx, submit_w, task_id)
        _record(server, fin, idx, j_w, outs_w)
        if tr is not None:
            _trace_wave(tr, ctx, workload, idx, j_w, outs_w, submit_w,
                        init_ring=ring0)
        attempts[idx] = a
        killed = outs_w[_KILLED] > 0.5
        wasted[idx[killed]] += (outs_w[_FINISH] - outs_w[_START])[
            killed].astype(np.float64)
        fail_w = killed | (outs_w[_REJECTED] > 0.5)
        if not fail_w.any():
            idx = idx[:0]
            break
        t_retry = (outs_w[_FINISH][fail_w].astype(np.float64)
                   + rp.backoff_ms * (rp.backoff_mult ** (a - 1)))
        idx = idx[fail_w]
        order = np.lexsort((idx, t_retry))
        idx = idx[order]
        submit_w = t_retry[order].astype(np.float32)
    failed = np.zeros(m, bool)
    failed[idx] = True
    return _result(server, fin, np.asarray(workload.submit_ms), carry, cfg,
                   attempts=attempts, failed=failed,
                   wasted_ms=wasted.astype(np.float32), **_trace_result(tr))


def simulate(workload, cluster: ClusterSpec, cfg: EngineConfig,
             seed: int = 0, *, mode: str = "batched", device=None,
             dynamics=None, dag=None) -> SimResult:
    """Run one workload trace through one policy.

    ``mode="batched"`` (the port's default) runs the decision-block driver
    and ``mode="sequential"`` the per-task oracle (:func:`_seq_wave`), each
    for all five policies.  The reference's default is ``"sequential"``;
    the two modes give the same placements, ledger and timestamps.

    ``device`` defaults to the GPU; pass ``device="cpu"`` to run on the
    CPU.  On ``cuda`` the dodoor and (1+β) decisions launch the CUDA
    decision kernel once per block: its masked form (K2) when
    ``dynamics`` has down windows, K1 otherwise, and on a task graph under
    ``cfg.locality`` the locality form (K3) of either.  ``dynamics`` is a
    :class:`Dynamics` spec (outages, churn, stragglers, store outages).

    ``dag`` is a spec of :mod:`repro_torch.workloads.dags` (or a
    :class:`~repro_torch.workloads.dags.DagPlan`): the tasks then run
    through the frontier loop (:func:`_simulate_dag`) and ``submit_ms``
    holds their effective submit times; an edgeless DAG is the plain run.
    ``cfg.locality`` needs a dag.  ``cfg.retry`` runs the re-entry wave
    loop (:func:`_simulate_with_retries`), and the result carries
    ``attempts``, ``failed`` and ``wasted_ms``; it does not compose with a
    dag, as in the reference.  Both wave loops run either mode.  The
    sequential oracle, and PoT and Prequal in either mode, launch no
    kernel: they score in torch ops, as the reference's scans score in
    ``jnp``.  A ``dynamics`` with ``cache_faults`` gives every scheduler
    its own view (:class:`CacheFaults`); dodoor and (1+β) then score in
    torch ops too, as the reference's faulted path does, and launch no
    kernel.

    ``cfg.trace`` adds the six decision-trace planes to the result
    (``view_age_ms``, ``view_err``, ``misplaced``, ``cache_push``,
    ``sched_id``, ``decision_ms``), resolved by one numpy post-pass per
    wave (:func:`_trace_wave`); placements, timestamps and the ledger are
    the untraced run's."""
    if dynamics is not None and not isinstance(dynamics, Dynamics):
        raise TypeError(f"dynamics must be a Dynamics spec, got "
                        f"{type(dynamics).__name__}")
    _check_mode(cfg, mode)
    _validate_config(cfg)
    m = workload.r_submit.shape[0]
    plan = None
    if dag is not None:
        plan = dag_plan(dag, m)
        if cfg.retry is not None:
            raise NotImplementedError(
                "dag together with a RetryPolicy: both own the host-side "
                "wave loop — run task-graph workloads without retries, or "
                "retries without a dag.")
    elif cfg.locality is not None:
        raise ValueError(
            "EngineConfig.locality needs a dag: the penalty reads parent "
            "placements, which only task-graph workloads carry.")
    if cfg.outage_ms:
        warnings.warn(
            "EngineConfig.outage_ms is deprecated — use "
            "Dynamics(store_outages=((t0, t1),)); simulate() routes the "
            "scalar window through the store-outage timeline.",
            DeprecationWarning, stacklevel=2)
        legacy = Dynamics(store_outages=(
            (float(cfg.outage_ms[0]), float(cfg.outage_ms[1])),))
        dynamics = legacy if dynamics is None else dynamics.merge(legacy)
        cfg = cfg._replace(outage_ms=())
    dev = resolve_device(device)
    if int(np.max(cluster.node_type)) >= workload.d_est.shape[1]:
        raise ValueError("cluster node types exceed the workload's "
                         "per-type duration columns")
    ctx = _make_ctx(cluster, cfg, seed, dev, dynamics)
    if plan is not None and plan.num_edges:
        return _simulate_dag(workload, ctx, plan, dev, mode)
    if cfg.retry is not None:
        return _simulate_with_retries(workload, ctx, dev, mode)
    ids = np.arange(m)
    submit = np.asarray(workload.submit_ms)
    if mode == "sequential":
        carry, j, outs = _wave_runner(workload, ctx, mode, dev)(
            None, ids, submit, ids)
    else:
        carry, j, outs = _run_wave(_blocked_inputs(workload, cfg.b, dev),
                                   ctx, None, m)
    fin = _empty_planes(m)
    server = np.zeros(m, np.int32)
    _record(server, fin, ids, j, outs)
    tr = None
    if cfg.trace:
        tr = _empty_trace(m)
        _trace_wave(tr, ctx, workload, ids, j, outs,
                    submit.astype(np.float32))
    return _result(server, fin, submit, carry, cfg, **_trace_result(tr))
