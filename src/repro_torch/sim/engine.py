"""Batched decision-block cluster simulation on torch — counterpart of the
batched driver in ``repro.sim.engine``.

The driver walks the trace in *decision blocks* of ``b`` tasks, one cache
snapshot per block (the paper's b-batched push boundary, §3.2/§4.1).  For
each block it

1. derives per-task keys, ``fold_in(PRNGKey(seed), task_id)``, then
   ``split`` (for dodoor and (1+β)) — for the whole trace at once, since
   they depend only on the task ids;
2. draws candidates and picks servers: Random draws one feasible server;
   Dodoor and (1+β) go through the sparse-gather decision kernel
   (:func:`repro_torch.kernels.dodoor_choice.dodoor_fused_sparse` — the CUDA
   kernel on the card, its plain version on the CPU);
3. commits the placements in server-parallel FCFS rounds
   (:func:`_commit_rounds`): round ``k`` commits the k-th task of every
   server at once;
4. applies the scheduler flushes and, at a full block's end, the data-store
   push, and keeps the four-field message ledger.

Only the no-dynamics configuration is ported: no outage/churn/straggler
windows, no retries, no DAGs, no tracing.  In the reference those windows
are inert here (the availability plane is all ones, ``_gate_start`` is the
identity and ``_slow_stretch`` multiplies by exactly 1.0), so they are
left out and the remaining arithmetic is unchanged.  Placements and the
message ledger match the reference's ``use_kernel=False`` batched driver
exactly on the CPU; see ``tests/test_torch_engine.py``.

The server execution model (per-core and per-memory-unit free-at times,
the in-flight ring buffer, channel contention, co-location interference)
and the data-store staleness model are the reference's, described in its
module docstring.  The port updates the ring buffer and the per-round
unit planes in place.  Each block reads its number of commit rounds once
with ``.item()`` (a host sync) and loops in Python.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .._arith import fma, row_sum
from .._device import resolve_device
from ..core.prefilter import feasible_mask, inverse_cdf_draws
from ..core.types import PrequalParams
from ..kernels.dodoor_choice import dodoor_fused_sparse
from ..random import PRNGKey, fold_in, split, uniform
from .cluster import CMAX, ClusterSpec
from .messages import RpcModel

POLICIES = ("random", "dodoor", "one_plus_beta")


class EngineConfig(NamedTuple):
    """Cluster-level knobs (Require line of Algorithm 1 + §6.1 RPC setup),
    named as the reference's.  Fields of features the port does not run
    yet (``outage_ms``, ``retry``, ``locality``, ``trace``) must keep their
    defaults; ``prequal.s_pool`` sizes the carry's (unused) probe pools so
    the carry matches the reference's leaf for leaf."""

    policy: str = "dodoor"          # random | dodoor | one_plus_beta
    num_schedulers: int = 5         # §6.1: 5 scheduler services
    b: int = 50                     # cache batch size (default n/2, §3.2)
    flush_every: int = 2            # addNewLoad cadence (per-scheduler
                                    # decisions); must be ≤ 2b/num_schedulers
    alpha: float = 0.5              # duration weight (§3.2 default)
    beta: float = 0.5               # (1+β) ablation only
    rbuf_slots: int = 256           # in-flight ring buffer per server
    mem_units: int = 64             # memory discretization per server
    interference: float = 0.3       # co-location slowdown factor
    outage_ms: tuple = ()
    rpc: RpcModel = RpcModel()
    prequal: PrequalParams = PrequalParams()
    retry: object = None
    locality: object = None
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


class _Carry(NamedTuple):
    """The driver's state between blocks, leaf for leaf the reference's."""

    core_free: torch.Tensor    # [n, CMAX] per-core free-at, rows sorted
    mem_free: torch.Tensor     # [n, MU]   per-memory-unit free-at, sorted
    prev_start: torch.Tensor   # [n]
    rb_release: torch.Tensor   # [n, R] in-flight ring buffer
    rb_cpu: torch.Tensor       # [n, R]
    rb_mem: torch.Tensor       # [n, R]
    rb_dur: torch.Tensor       # [n, R]
    view_L: torch.Tensor       # [n, 2] scheduler cached load vectors
    view_D: torch.Tensor       # [n]
    view_rif: torch.Tensor     # [n]
    pending: torch.Tensor      # [S, n, 4] unflushed scheduler deltas
    chan_free: torch.Tensor    # [n] per-server RPC channel next-free
    push_end: torch.Tensor     # [] wall time the in-progress push ends
    pool_server: torch.Tensor  # [S, s_pool] Prequal pools (unused here)
    pool_rif: torch.Tensor
    pool_lat: torch.Tensor
    pool_age: torch.Tensor
    pool_valid: torch.Tensor
    msgs: torch.Tensor         # [4] int32: base, probe, push, flush
    push_at: torch.Tensor | None = None


class _Dyn(NamedTuple):
    """The reference's traced float32 scalars, as 0-d float32 tensors
    (α reaches the decision kernel as a float, like the reference's
    kernel takes it)."""

    beta: torch.Tensor
    interference: torch.Tensor
    hop_ms: torch.Tensor
    chan_ms: torch.Tensor
    push_block_ms: torch.Tensor
    compute_ms: torch.Tensor


class _Ctx(NamedTuple):
    """Per-run constants of the block step."""

    cfg: EngineConfig
    dyn: _Dyn
    C: torch.Tensor            # [n, 2] float32 capacities
    node_type: torch.Tensor    # [n] int32
    cores_per: torch.Tensor    # [n] int32
    mem_unit: torch.Tensor     # [n] float32 MB per memory unit
    base_key: torch.Tensor     # [2] PRNGKey(seed)


def _make_dyn(cfg: EngineConfig, device) -> _Dyn:
    vals = (cfg.beta, cfg.interference, cfg.rpc.hop_ms,
            cfg.rpc.chan_ms, cfg.rpc.push_block_ms, cfg.rpc.compute_ms)
    return _Dyn(*(torch.tensor(np.float32(v), device=device) for v in vals))


def _cluster_arrays(cluster: ClusterSpec, mem_units: int, device):
    C = np.asarray(cluster.C, np.float32)
    return (torch.from_numpy(C.copy()).to(device),
            torch.from_numpy(np.asarray(cluster.node_type, np.int32)).to(
                device),
            torch.from_numpy(C[:, 0].astype(np.int32)).to(device),
            torch.from_numpy(np.asarray(C[:, 1] / mem_units,
                                        np.float32)).to(device))


def _make_ctx(cluster: ClusterSpec, cfg: EngineConfig, seed: int,
              device) -> _Ctx:
    C, node_type, cores_per, mem_unit = _cluster_arrays(
        cluster, cfg.mem_units, device)
    return _Ctx(cfg=cfg, dyn=_make_dyn(cfg, device), C=C,
                node_type=node_type, cores_per=cores_per, mem_unit=mem_unit,
                base_key=PRNGKey(seed, device=device))


def _init_carry(cfg: EngineConfig, n: int, cores_per: torch.Tensor) -> _Carry:
    """The t=0 carry.  Core slots beyond a server's core count hold +inf
    (never free), so heterogeneous core counts share one [n, CMAX] plane."""
    dev = cores_per.device
    S, R, MU, P = (cfg.num_schedulers, cfg.rbuf_slots, cfg.mem_units,
                   cfg.prequal.s_pool)
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
        view_L=torch.zeros((n, 2), **f32),
        view_D=torch.zeros((n,), **f32),
        view_rif=torch.zeros((n,), **f32),
        pending=torch.zeros((S, n, 4), **f32),
        chan_free=torch.zeros((n,), **f32),
        push_end=torch.zeros((), **f32),
        pool_server=torch.zeros((S, P), dtype=torch.int32, device=dev),
        pool_rif=torch.full((S, P), float("inf"), **f32),
        pool_lat=torch.full((S, P), float("inf"), **f32),
        pool_age=torch.full((S, P), float("-inf"), **f32),
        pool_valid=torch.zeros((S, P), dtype=torch.bool, device=dev),
        msgs=torch.zeros((4,), dtype=torch.int32, device=dev),
    )


def _truth_all(carry: _Carry, now: torch.Tensor):
    """Ground truth (L [n, 2], D [n], rif [n]) from the ring buffer: the
    tasks whose release time is still ahead of ``now``."""
    act = (carry.rb_release > now).to(torch.float32)
    cpu, mem, dur = row_sum(
        torch.stack([carry.rb_cpu, carry.rb_mem, carry.rb_dur]) * act)
    return torch.stack([cpu, mem], dim=-1), dur, act.sum(dim=-1)


def _apply_push(carry: _Carry, now: torch.Tensor, dyn: _Dyn) -> _Carry:
    """One data-store push: the store's view is truth(now) minus the deltas
    the schedulers have not flushed yet (the staleness model)."""
    L, D, rif = _truth_all(carry, now)
    unflushed = carry.pending[0]
    for s in range(1, carry.pending.shape[0]):
        unflushed = unflushed + carry.pending[s]                 # [n, 4]
    return carry._replace(
        view_L=torch.clamp_min(L - unflushed[:, :2], 0.0),
        view_D=torch.clamp_min(D - unflushed[:, 2], 0.0),
        view_rif=torch.clamp_min(rif - unflushed[:, 3], 0.0),
        push_end=now + dyn.push_block_ms)


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
                   d_est_j, extra_lat, dyn: _Dyn, cores_per, mem_unit,
                   MU: int, occ, rounds: int):
    """Server-parallel FCFS commit of the block's valid tasks.

    Every row a commit reads or writes belongs to the task's own server,
    so the per-server chains are independent and round ``k`` commits the
    k-th task of every server at once.  Unit rows stay sorted ascending:
    the c-th earliest free core is a gather and the update a shift-merge
    (:func:`_sorted_fill`).  Returns ``(carry, outs)``, ``outs`` [7, b]
    with rows start, finish, enqueue, sched_ms, the overwritten ring slot's
    old release and old duration, and the slot index.  The ring buffer is
    updated in place."""
    n = cores_per.shape[0]
    bsz = j.shape[0]
    dev = j.device
    tt = torch.arange(bsz, device=dev)
    rows = torch.arange(n, device=dev)
    cores_f = cores_per.to(torch.float32)
    pad = CMAX - cores_per
    R = carry.rb_release.shape[1]
    slot_iota = torch.arange(R, device=dev)[None, :]
    rb_rel, rb_cpu, rb_mem, rb_dur = (carry.rb_release, carry.rb_cpu,
                                      carry.rb_mem, carry.rb_dur)
    cf, mf = carry.core_free, carry.mem_free
    prev_start, chan_free = carry.prev_start, carry.chan_free
    outs = torch.zeros((7, bsz + 1), dtype=torch.float32, device=dev)
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

        c_eff = torch.minimum(torch.clamp_min(cores_s, 1.0),
                              cores_f).to(torch.long)
        mu_need = torch.ceil(mem_s / mem_unit).clamp(1, MU).to(torch.long)
        core_gate = cf.gather(1, (c_eff - 1)[:, None])[:, 0]
        mem_gate = mf.gather(1, (mu_need - 1)[:, None])[:, 0]
        start = torch.maximum(torch.maximum(enqueue_t, prev_start),
                              torch.maximum(core_gate, mem_gate))
        busy = (cf > start[:, None]).sum(dim=-1) - pad
        frac = busy.to(torch.float32) / cores_f
        # 1 + interference·frac is one fused multiply-add in the reference.
        dur = dur_s * fma(dyn.interference, frac.clamp(0.0, 1.0),
                          torch.ones_like(frac))
        finish = start + dur

        has_c = has[:, None]
        cf = torch.where(has_c, _sorted_fill(cf, c_eff, finish), cf)
        mf = torch.where(has_c, _sorted_fill(mf, mu_need, finish), mf)
        prev_start = torch.where(has, start, prev_start)

        # Ring slot: first index of the row minimum (the earliest release).
        rb_min = rb_rel.min(dim=-1, keepdim=True).values
        slot = torch.where(rb_rel == rb_min, slot_iota, R).min(dim=-1).values
        old_rel = rb_rel[rows, slot]
        old_dur = rb_dur[rows, slot]
        rb_rel[rows, slot] = torch.where(has, finish, old_rel)
        rb_cpu[rows, slot] = torch.where(has, cores_s, rb_cpu[rows, slot])
        rb_mem[rows, slot] = torch.where(has, mem_s, rb_mem[rows, slot])
        rb_dur[rows, slot] = torch.where(has, dest_s, old_dur)

        t_out = torch.where(has, t, bsz)                 # bsz is a dump
        outs[:, t_out] = torch.stack([start, finish, enqueue_t, sched_ms,
                                      old_rel, old_dur,
                                      slot.to(torch.float32)])
    carry = carry._replace(core_free=cf, mem_free=mf, prev_start=prev_start,
                           chan_free=chan_free)
    return carry, outs[:, :bsz]


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


def _task_draws(ctx: _Ctx, task_id: torch.Tensor):
    """Per-task randomness for a whole trace at once (it depends only on
    the task ids), from ``key = fold_in(PRNGKey(seed), task_id)``: Random's
    one uniform per task; for dodoor and (1+β) the candidate keys
    ``split(key)[0]`` and (1+β)'s uniforms from ``split(key)[1]``."""
    keys = fold_in(ctx.base_key, task_id)
    if ctx.cfg.policy == "random":
        return (uniform(keys, (1,)),)
    kk = split(keys)
    k_cand = kk[..., 0, :].contiguous()
    if ctx.cfg.policy == "one_plus_beta":
        return k_cand, uniform(kk[..., 1, :])
    return (k_cand,)


def _block_step(carry: _Carry, blk, draws, ctx: _Ctx, push: bool):
    """One decision block: select, commit, flush, and (``push``) the
    data-store push at the block's end.  ``draws`` is the block's slice of
    :func:`_task_draws`; ``push`` is known on the host: only a full block
    reaches the b-th decision."""
    idx, r_sub, r_exec_t, d_est_t, d_act_t, submit, task_id, valid = blk
    cfg, dyn = ctx.cfg, ctx.dyn
    S = cfg.num_schedulers
    bsz = idx.shape[0]
    dev = idx.device
    tt = torch.arange(bsz, device=dev)
    now = submit
    sched = idx % S

    extra_lat = torch.zeros((bsz,), dtype=torch.float32, device=dev)
    if cfg.policy == "random":
        j = inverse_cdf_draws(feasible_mask(r_sub, ctx.C), draws[0])[:, 0]
    else:
        two, cand2, _ = dodoor_fused_sparse(
            draws[0], r_sub, d_est_t, ctx.node_type, carry.view_L,
            carry.view_D, ctx.C, alpha=cfg.alpha)
        if cfg.policy == "one_plus_beta":
            j = torch.where(draws[1] < dyn.beta, two, cand2[:, 0])
        else:
            j = two
        extra_lat = torch.clamp_min(carry.push_end - now, 0.0)
    j = j.long()

    # ---- commit
    nt_j = ctx.node_type[j].long()
    cores_t = r_exec_t[tt, nt_j, 0]
    mem_t = r_exec_t[tt, nt_j, 1]
    dur_t = d_act_t[tt, nt_j]
    dest_t = d_est_t[tt, nt_j]
    occ, rounds = _queue_ranks(j, valid)
    carry, outs = _commit_rounds(carry, valid, now, j, cores_t, mem_t,
                                 dur_t, dest_t, extra_lat, dyn,
                                 ctx.cores_per, ctx.mem_unit, cfg.mem_units,
                                 occ, rounds)

    n_valid = valid.sum()
    zero = torch.zeros_like(n_valid)
    n_flush = zero
    # ---- data-store protocol, once per block (cached-view policies)
    if cfg.policy in ("dodoor", "one_plus_beta"):
        delta = torch.stack([cores_t, mem_t, dest_t,
                             torch.ones_like(cores_t)], dim=1)   # [b, 4]
        do_flush = (((idx // S) + 1) % cfg.flush_every == 0) & valid
        # A delta survives into the carried accumulator iff its scheduler
        # does not flush at or after it within this block.
        flushed_after = ((sched[None, :] == sched[:, None])
                         & (tt[None, :] >= tt[:, None])
                         & do_flush[None, :]).any(dim=1)
        survives = valid & ~flushed_after
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
            carry = _apply_push(carry, now[-1], dyn)
    n_push = (S if push and cfg.policy != "random" else 0)
    msgs = carry.msgs + torch.stack(
        [2 * n_valid, zero, zero + n_push, n_flush]).to(torch.int32)
    carry = carry._replace(msgs=msgs)
    out = (j.to(torch.int32), outs[0], outs[1], outs[2], outs[3], cores_t,
           mem_t)
    return carry, out


def _simulate_batched(xs, ctx: _Ctx, carry0: _Carry | None = None,
                      return_carry: bool = False):
    """The block loop over ``xs`` = (idx, r_sub, r_exec, d_est, d_act,
    submit, task_id, valid), each [nb, b, ...].  Returns ``(carry, outs)``
    when ``return_carry``, else ``(msgs, outs)``; ``outs`` is the tuple
    (server, start, finish, enqueue, sched_ms, cores, mem), each [nb, b]."""
    cfg = ctx.cfg
    carry = carry0 if carry0 is not None else _init_carry(
        cfg, ctx.C.shape[0], ctx.cores_per)
    push_at = xs[7][:, -1].cpu().numpy()      # only full blocks push
    draws = _task_draws(ctx, xs[6])
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
    broadcast views, so every field goes through ``np.ascontiguousarray``
    before it reaches torch."""
    m = workload.r_submit.shape[0]
    nb = -(-m // b)
    pad = nb * b - m

    def prep(a):
        a = np.ascontiguousarray(a)
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
    if cfg.rbuf_slots < 1 or (cfg.rbuf_slots > 64 and cfg.rbuf_slots % 32):
        raise ValueError(f"rbuf_slots={cfg.rbuf_slots}: the ring-buffer sum "
                         "reproduces the reference's order for at most 64 "
                         "slots or a multiple of 32")
    if cfg.b < 1 or cfg.flush_every < 1:
        raise ValueError(
            f"b={cfg.b} and flush_every={cfg.flush_every} must be ≥ 1")
    if cfg.policy == "dodoor":
        bound = max(1, 2 * cfg.b // max(1, cfg.num_schedulers))
        if cfg.flush_every > bound:
            raise ValueError(
                f"flush_every={cfg.flush_every} violates the §4.1 mini-batch "
                f"bound 2b/num_schedulers = {bound}")


def _not_ported(cfg: EngineConfig, mode: str, dynamics, dag) -> None:
    """Raise for every input whose path is not ported yet, naming the
    ROADMAP §1 item that will port it."""
    later = None
    if mode != "batched":
        if mode != "sequential":
            raise ValueError(f"unknown mode {mode!r}")
        later = ("mode='sequential'", 5)
    elif cfg.policy in ("pot", "prequal"):
        later = (f"policy {cfg.policy!r}", 5)
    elif cfg.policy not in POLICIES:
        raise ValueError(f"unknown policy {cfg.policy!r}")
    elif dynamics is not None:
        later = ("dynamics", 6)
    elif cfg.outage_ms:
        later = ("outage_ms", 6)
    elif cfg.retry is not None:
        later = ("retry", 7)
    elif dag is not None:
        later = ("dag", 7)
    elif cfg.locality is not None:
        later = ("locality", 7)
    elif cfg.trace:
        later = ("trace", 7)
    if later is not None:
        raise NotImplementedError(
            f"{later[0]} is not ported to repro_torch yet (ROADMAP.md §1, "
            f"item {later[1]})")


def simulate(workload, cluster: ClusterSpec, cfg: EngineConfig,
             seed: int = 0, *, mode: str = "batched", device=None,
             dynamics=None, dag=None) -> SimResult:
    """Run one workload trace through one policy on the batched driver.

    ``device`` defaults to the GPU; pass ``device="cpu"`` to run on the
    CPU.  On ``cuda`` the dodoor and (1+β) decisions launch the CUDA
    decision kernel once per block.  ``mode``, ``dynamics`` and ``dag``
    exist for signature parity with the reference: only
    ``mode="batched"`` without dynamics or a DAG is ported, and the
    ``random``, ``dodoor`` and ``one_plus_beta`` policies."""
    _not_ported(cfg, mode, dynamics, dag)
    _validate_config(cfg)
    dev = resolve_device(device)
    if int(np.max(cluster.node_type)) >= workload.d_est.shape[1]:
        raise ValueError("cluster node types exceed the workload's "
                         "per-type duration columns")
    ctx = _make_ctx(cluster, cfg, seed, dev)
    m = workload.r_submit.shape[0]
    xs = _blocked_inputs(workload, cfg.b, dev)
    msgs, outs = _simulate_batched(xs, ctx)
    host = [o.reshape(-1)[:m].cpu().numpy() for o in outs]
    msgs = msgs.cpu().numpy()
    j, start, finish, enq, sched_ms, cores, mem_mb = host
    return SimResult(
        server=j.astype(np.int32),
        submit_ms=np.asarray(workload.submit_ms),
        enqueue_ms=enq, start_ms=start, finish_ms=finish, sched_ms=sched_ms,
        cores=cores, mem_mb=mem_mb,
        msgs_base=int(msgs[0]), msgs_probe=int(msgs[1]),
        msgs_push=int(msgs[2]), msgs_flush=int(msgs[3]),
        policy=cfg.policy)
