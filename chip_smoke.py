#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Run it from the root of a checkout on a machine with an NVIDIA H100 (any
``sm_90a`` card) and the CUDA toolkit.  It imports neither JAX nor the JAX
package, and runs four phases; any failure raises and exits non-zero:

1. build — compiles every CUDA kernel of the port from ``src/repro_torch/
   kernels/csrc`` with ``nvcc`` (one process per source, all at once);
2. kernel — holds the sparse-gather decision kernel against its plain
   PyTorch version on the card, at T=50, N=100 and at T=500, N=10 000:
   candidates exact, scores within rtol 1e-6, choices exact except where
   the two scores are within 1e-6; times both with CUDA events;
3. testbed — the batched Dodoor driver on the paper's 100-server testbed
   under the Azure and FunctionBench traces (m=4000, b=50) on the card,
   against the same runs on the CPU: placements exact (or the first
   divergent task picked its other sampled candidate), the four-field
   message ledger exact, no capacity violation, one kernel launch per
   decision block;
4. scale — the 10 000-server Azure point (m=200 000, qps=400, b=500): every
   task on a server whose capacity admits it, the ledger equal to its
   closed form and to the CPU run's, placements as in phase 3, one kernel
   launch per block.

It prints the card's name and power limit, a JSON line of per-kernel
measurements, and as its last line ``{"ok": true, "device": {...}}``.
Without a CUDA device it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# Peak rates of one H100 SXM (NVIDIA data sheet) for the roofline bound.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/dodoor_fused_sparse.cu"
KERNEL_REPLACES = "src/repro/kernels/dodoor_choice/kernel.py:455"


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def event_ms(torch, fn, reps: int = 30, warmup: int = 5) -> float:
    """Median device time of ``fn`` in ms over ``reps`` calls.  Each call
    is queued behind a spin kernel that outlasts the host's enqueueing of
    ``fn`` (measured on the warm-up), so the events time the device work
    and not the host's launch overhead."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    spin_cycles = int(4e9 * host_s) + 2_000_000     # ~2x the host time
    pairs = []
    for _ in range(reps):
        torch.cuda._sleep(spin_cycles)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def kernel_inputs(torch, T: int, N: int, seed: int):
    """A decision block at the main path's shapes: the paper's testbed
    (N=100) or a scaled fleet, task demands that include infeasible rows
    (the uniform fallback), random cached loads and per-type durations."""
    from repro_torch.sim import make_scaled, make_testbed

    cl = make_testbed() if N == 100 else make_scaled(N)
    rng = np.random.RandomState(seed)
    keys = rng.randint(0, 2 ** 32, size=(T, 2), dtype=np.uint64)
    cores = rng.choice([1, 2, 4, 8, 16, 28, 32], size=T).astype(np.float32)
    mem = rng.uniform(1e3, 1.4e5, size=T).astype(np.float32)
    r = np.stack([cores, mem], axis=1)
    r[0] = (64.0, 1e9)                       # feasible nowhere
    L = (rng.uniform(0, 2, size=(N, 2)) * cl.C).astype(np.float32)
    D = rng.uniform(0, 5e5, size=N).astype(np.float32)
    d_types = rng.uniform(100, 2e4, size=(T, 4)).astype(np.float32)
    host = (keys.astype(np.int64), r, d_types,
            np.asarray(cl.node_type, np.int32), L, D,
            np.asarray(cl.C, np.float32))
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).cuda()
                 for a in host)


def kernel_phase(torch, T: int, N: int) -> dict:
    from repro_torch.kernels.dodoor_choice import (dodoor_fused_sparse,
                                                   dodoor_fused_sparse_ref)

    args = kernel_inputs(torch, T, N, seed=T + N)
    choice, cand, scores = dodoor_fused_sparse(*args, alpha=0.5)
    torch.cuda.synchronize()
    p_choice, p_cand, p_scores = dodoor_fused_sparse_ref(*args, alpha=0.5)
    cand, p_cand = cand.cpu().numpy(), p_cand.cpu().numpy()
    scores, p_scores = scores.cpu().numpy(), p_scores.cpu().numpy()
    choice, p_choice = choice.cpu().numpy(), p_choice.cpu().numpy()
    check(np.array_equal(cand, p_cand),
          f"T={T} N={N}: candidates differ in "
          f"{int((cand != p_cand).any(1).sum())} rows")
    check(np.isfinite(scores).all(), f"T={T} N={N}: non-finite scores")
    np.testing.assert_allclose(scores, p_scores, rtol=1e-6, atol=0.0)
    near_tie = np.abs(p_scores[:, 0] - p_scores[:, 1]) <= 1e-6
    check(np.array_equal(choice[~near_tie], p_choice[~near_tie]),
          f"T={T} N={N}: choices differ away from near-ties")
    ms = event_ms(torch, lambda: dodoor_fused_sparse(*args, alpha=0.5))
    plain_ms = event_ms(torch,
                        lambda: dodoor_fused_sparse_ref(*args, alpha=0.5))
    K, TT = 2, args[2].shape[1]
    # Each input read once, each output written once: per task the key
    # (16 B), demand (4K B) and per-type durations (4TT B) in and choice,
    # candidates and scores (20 B) out; per server L, D, C and node_type.
    nbytes = T * (16 + 4 * K + 4 * TT + 20) + N * (4 * K + 4 + 4 * K + 4)
    ops = T * N * (K + 1)          # K capacity compares + one count each
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = ops / FP32_OPS_PER_S * 1e3
    row = dict(T=T, N=N, ms=ms, plain_ms=plain_ms,
               bound_ms=max(byte_ms, op_ms),
               bound_by="bytes" if byte_ms > op_ms else "operations",
               max_abs_err=float(np.abs(scores - p_scores).max()),
               near_ties=int(near_tie.sum()))
    print(f"kernel dodoor_fused_sparse T={T} N={N}: {ms * 1e3:.3f} us, "
          f"plain {plain_ms * 1e3:.3f} us, bound {row['bound_ms'] * 1e3:.4f}"
          f" us ({row['bound_by']}), max |dscore| {row['max_abs_err']:.3g}",
          flush=True)
    return row


def first_divergence_ok(gpu, cpu, wl, cluster, seed: int = 0) -> bool:
    """Placements equal, or the first divergent task picked one of its
    two sampled candidates on both devices (a near-tie flip)."""
    if (gpu.server == cpu.server).all():
        return True
    import torch

    from repro_torch.core.prefilter import feasible_mask, sample_feasible
    from repro_torch.random import PRNGKey, fold_in, split

    i = int(np.argmax(gpu.server != cpu.server))
    key = fold_in(PRNGKey(seed, device="cpu"), torch.tensor(i))
    mask = feasible_mask(torch.from_numpy(wl.r_submit[i]),
                         torch.from_numpy(cluster.C))
    cand = set(sample_feasible(split(key)[0], mask, 2).tolist())
    print(f"  placements diverge first at task {i}: gpu "
          f"{int(gpu.server[i])}, cpu {int(cpu.server[i])}, candidates "
          f"{sorted(cand)}", flush=True)
    return {int(gpu.server[i]), int(cpu.server[i])} <= cand


def ledger(res):
    return (res.msgs_base, res.msgs_probe, res.msgs_push, res.msgs_flush)


def timed_run(torch, wl, cluster, cfg):
    from repro_torch.kernels.dodoor_choice import LAUNCHES
    from repro_torch.sim import simulate

    LAUNCHES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = simulate(wl, cluster, cfg, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return res, wall, LAUNCHES["dodoor_fused_sparse"]


def testbed_phase(torch) -> None:
    from repro_torch.sim import (EngineConfig, make_testbed,
                                 resource_violations, simulate, summarize)
    from repro_torch.workloads import azure, functionbench

    tb = make_testbed()
    cfg = EngineConfig(policy="dodoor", b=50)
    for name, wl in (("azure", azure.synthesize(m=4000, qps=10.0)),
                     ("functionbench",
                      functionbench.synthesize(m=4000, qps=300.0))):
        m = wl.r_submit.shape[0]
        gpu, wall, launches = timed_run(torch, wl, tb, cfg)
        cpu = simulate(wl, tb, cfg, device="cpu")
        blocks = -(-m // cfg.b)
        check(first_divergence_ok(gpu, cpu, wl, tb),
              f"{name}: placements diverge beyond a candidate flip")
        check(ledger(gpu) == ledger(cpu),
              f"{name}: ledger {ledger(gpu)} != cpu {ledger(cpu)}")
        for f in ("start_ms", "finish_ms", "enqueue_ms"):
            check(np.isfinite(getattr(gpu, f)).all(), f"{name}: {f} NaN")
        check(resource_violations(gpu, tb) == 0,
              f"{name}: capacity violated")
        check(launches == blocks,
              f"{name}: {launches} kernel launches for {blocks} blocks")
        same = bool((gpu.server == cpu.server).all())
        s = summarize(gpu)
        print(f"testbed {name}: m={m} b={cfg.b} {m / wall:.1f} decisions/s "
              f"(wall {wall:.3f} s), launches {launches}/{blocks} blocks, "
              f"placements equal to cpu: {same}, msgs/task "
              f"{s.msgs_per_task:.4f}, makespan mean {s.makespan_mean_ms:.1f}"
              f" ms p95 {s.makespan_p95_ms:.1f} ms", flush=True)


def scale_phase(torch) -> int:
    from repro_torch.sim import (EngineConfig, expected_messages_per_task,
                                 make_scaled, simulate)
    from repro_torch.workloads import azure

    cl = make_scaled(10_000)
    wl = azure.synthesize(m=200_000, qps=400.0)
    cfg = EngineConfig(policy="dodoor", b=500)
    m = wl.r_submit.shape[0]
    res, wall, launches = timed_run(torch, wl, cl, cfg)
    blocks = -(-m // cfg.b)
    check(res.server.shape == (m,), "scale: wrong result shape")
    check(((res.server >= 0) & (res.server < cl.num_servers)).all(),
          "scale: server index out of range")
    admits = (wl.r_submit <= cl.C[res.server]).all(axis=1)
    check(admits.all(), f"scale: {int((~admits).sum())} tasks on servers "
          "whose capacity does not admit them")
    want = expected_messages_per_task("dodoor", b=cfg.b,
                                      num_schedulers=cfg.num_schedulers,
                                      flush_every=cfg.flush_every)
    check(abs(res.msgs_per_task - want) < 1e-9,
          f"scale: {res.msgs_per_task} msgs/task, closed form {want}")
    check(np.isfinite(res.finish_ms).all(), "scale: non-finite finish")
    check(launches == blocks,
          f"scale: {launches} kernel launches for {blocks} blocks")
    t0 = time.perf_counter()
    cpu = simulate(wl, cl, cfg, device="cpu")
    cpu_wall = time.perf_counter() - t0
    check(first_divergence_ok(res, cpu, wl, cl),
          "scale: placements diverge from the cpu run beyond a candidate "
          "flip")
    check(ledger(res) == ledger(cpu), "scale: ledger differs from cpu")
    print(f"scale: n={cl.num_servers} m={m} b={cfg.b} "
          f"{m / wall:.1f} decisions/s (wall {wall:.3f} s), launches "
          f"{launches}/{blocks} blocks, msgs/task {res.msgs_per_task:.4f}, "
          f"placements equal to cpu: {bool((res.server == cpu.server).all())}"
          f" (cpu run {cpu_wall:.1f} s)", flush=True)
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    print(card_line(), flush=True)
    t0 = time.perf_counter()
    report = _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s for "
          f"{sorted(report) or 'nothing (cached)'}", flush=True)
    for name, (_, log) in report.items():
        for line in log.splitlines():
            if "ptxas" in line:
                print(f"  {name}: {line.strip()}", flush=True)

    rows = [kernel_phase(torch, 50, 100), kernel_phase(torch, 500, 10_000)]
    testbed_phase(torch)
    launches = scale_phase(torch)

    big = rows[-1]
    print(json.dumps({"kernels": [{
        "name": "dodoor_fused_sparse", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": KERNEL_REPLACES,
        "launches": launches, "max_abs_err": big["max_abs_err"],
        "ms": big["ms"], "plain_ms": big["plain_ms"],
        "bound_ms": big["bound_ms"], "bound_by": big["bound_by"],
        "library_ms": None}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
