#!/usr/bin/env python3
"""Paired timing of the library-API kernels K5 and K6, the launch floor
and the library loops, for two checkouts on one card.

    python3 tools/pair_library_kernels.py OLD_ROOT NEW_ROOT [--out FILE]

Each root is the top of a checkout (its ``chip_smoke.py`` and ``src/``).
As ``tools/pair_decision_kernels.py`` does, it runs one child process per
measurement in the order old, new, new, old, each building its
checkout's kernels.  A child times with CUDA events (``event_ms`` of its
``chip_smoke.py``): an empty launch (the floor under every launch-sized
time); K5 (``dodoor_choice``) at (T, N) = (50, 100), (2048, 100) and
(500, 10⁴) on chip_smoke's ``pair_inputs``; K6 (``rl_score_matrix``) at
(T, N, K) = (2048, 100, 2), (500, 10⁴, 2), (1024, 10⁴, 2), (384, 257, 8)
and (50, 100, 2), the shape of phase 15's loop, on phase 15's operands;
and K6 at the two 10⁴-server shapes once more with the 50 MB L2 flushed
before each call (a 128 MB buffer zeroed between the spin kernel and the
start event).  Then it runs phases 13 and 15's library loops on the
testbed (FunctionBench m = 4000, b = 50: ``dodoor_select_batch(
use_kernel=True)`` through K5, and the loop that records each block's K6
score matrix), once to warm up and three times on the host clock ending
in a sync, for decisions/s.  It prints one JSON line per child and, last,
a JSON summary with every child's numbers beside the card's name and
power limit.  Needs a CUDA device.
"""
from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from pair_decision_kernels import pair_main  # noqa: E402

K5_SHAPES = ((50, 100), (2048, 100), (500, 10_000))
K6_SHAPES = ((2048, 100, 2), (500, 10_000, 2), (1024, 10_000, 2),
             (384, 257, 8), (50, 100, 2))
K6_FLUSHED = ((500, 10_000, 2), (1024, 10_000, 2))


def flushed_ms(torch, fn, reps: int = 30, warmup: int = 5) -> float:
    """``event_ms`` with the L2 cache flushed before each call: the median
    device time in ms of ``fn`` started on a cold L2."""
    import numpy as np

    buf = torch.empty(32 * 2 ** 20, dtype=torch.float32, device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        torch.cuda._sleep(2_000_000)
        buf.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def child(root: str) -> dict:
    """Measure the checkout at ``root`` (run in a process of its own)."""
    sys.path.insert(0, root)
    import chip_smoke as cs          # puts root/src first on sys.path
    import numpy as np
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.dodoor_choice import dodoor_choice
    from repro_torch.kernels.rl_score import rl_score_matrix
    from repro_torch.sim import make_testbed
    from repro_torch.workloads import functionbench

    _build.build(("dodoor_fused_sparse", "rl_score"))
    us = {"launch floor": 1e3 * cs.event_ms(
        torch, lambda: torch.cuda._sleep(0))}
    for T, N in K5_SHAPES:
        args = cs.pair_inputs(torch, T, N, seed=T + N)
        us[f"K5 T={T} N={N}"] = 1e3 * cs.event_ms(
            torch, lambda: dodoor_choice(*args, alpha=0.5))
    for T, N, K in K6_SHAPES:
        rng = np.random.RandomState(T + N + K)
        r, L, C = (torch.from_numpy(a).cuda() for a in (
            (rng.rand(T, K) * 8).astype(np.float32),
            (rng.rand(N, K) * 100).astype(np.float32),
            (1.0 + rng.rand(N, K) * 100).astype(np.float32)))
        us[f"K6 T={T} N={N} K={K}"] = 1e3 * cs.event_ms(
            torch, lambda: rl_score_matrix(r, L, C))
        if (T, N, K) in K6_FLUSHED:
            us[f"K6 T={T} N={N} K={K} L2 flushed"] = 1e3 * flushed_ms(
                torch, lambda: rl_score_matrix(r, L, C))

    cl = make_testbed()
    wl = functionbench.synthesize(m=4000, qps=60.0)
    m = wl.r_submit.shape[0]
    rates = {}
    for route, label in (("select", "phase 13 loop (K5)"),
                         ("rl", "phase 15 loop (K6)")):
        cs.library_loop(torch, "cuda", route, wl, cl, 50)       # warm-up
        for i in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cs.library_loop(torch, "cuda", route, wl, cl, 50)
            torch.cuda.synchronize()
            rates[f"{label} run {i + 1}"] = m / (time.perf_counter() - t0)
    return {"root": root, "us": us, "decisions_per_s": rates}


if __name__ == "__main__":
    sys.exit(pair_main(child, __doc__.splitlines()[0], __file__))
