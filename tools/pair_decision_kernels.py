#!/usr/bin/env python3
"""Paired timing of the port's decision kernels (K1–K4) and the driver's
10⁴-server runs, for two checkouts on one card.

    python3 tools/pair_decision_kernels.py OLD_ROOT NEW_ROOT [--out FILE]

Each root is the top of a checkout (its ``chip_smoke.py`` and ``src/``).
The script runs one child process per measurement in the order old, new,
new, old, so that drift of the card or its host shows as a spread within
each version, not as a difference between them; each child builds its
checkout's kernels.  A child times, with CUDA events (``event_ms`` of its
``chip_smoke.py``), each decision kernel at the main path's shapes — K1,
K2 (Wd = 5), K3 in both forms (P = 8) at (T, N) = (50, 100) and (500,
10⁴), K4 in both forms at (50, 100), (500, 10⁴) and (1024, 10⁴) — and
runs ``simulate`` on the card at chip_smoke's phases 4 and 7 (Azure
m = 200 000 at 10⁴ servers, b = 500; phase 7 under churn and n/5
outages), three times each after a warm-up run, on the host clock ending
in a sync; then phase 7 once more under ``torch.profiler`` (device
activity only), for the decision kernel's total device time and the
device's busy time, which the host's noise does not reach.  It prints one
JSON line per child and, last, a JSON summary with every child's numbers
beside the card's name and power limit.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys
import time

KERNEL_SHAPES = ((50, 100), (500, 10_000))
DENSE_SHAPES = ((50, 100), (500, 10_000), (1024, 10_000))


def child(root: str) -> dict:
    """Measure the checkout at ``root`` (run in a process of its own)."""
    sys.path.insert(0, root)
    import chip_smoke as cs          # puts root/src first on sys.path
    import torch

    from repro_torch.core.prefilter import avail_rows
    from repro_torch.kernels import _build
    from repro_torch.kernels.dodoor_choice import (dodoor_fused,
                                                   dodoor_fused_sparse)
    from repro_torch.sim import (EngineConfig, make_scaled, random_churn,
                                 random_outages, simulate)
    from repro_torch.workloads import azure

    _build.build()
    takes_down_t = "down_t" in inspect.signature(
        dodoor_fused_sparse).parameters
    us = {}
    for T, N in KERNEL_SHAPES:
        args = cs.kernel_inputs(torch, T, N, seed=T + N)
        down0, down1, now = cs.kernel_windows(torch, T, N, seed=N)
        win = dict(down0=down0, down1=down1, now=now)
        if takes_down_t:          # the window-major pair, made once
            win["down_t"] = (down0.t().contiguous(),
                             down1.t().contiguous())
        psrv, pbytes = cs.kernel_parents(torch, T, N, 8, seed=T + N + 8)
        par = dict(psrv=psrv, pbytes=pbytes, gamma_bw=cs.GAMMA_BW)
        for name, kw in (("K1", {}), ("K2", win), ("K3", par),
                         ("K3 masked", dict(win, **par))):
            us[f"{name} T={T} N={N}"] = 1e3 * cs.event_ms(
                torch, lambda: dodoor_fused_sparse(*args, alpha=0.5, **kw))
    for T, N in DENSE_SHAPES:
        keys, r, d_types, nt, L, D, C = cs.kernel_inputs(torch, T, N,
                                                         seed=T + N)
        d = d_types[:, nt.long()].contiguous()
        down0, down1, now = cs.kernel_windows(torch, T, N, seed=N)
        avail = avail_rows(down0, down1, now).float()
        for name, kw in (("K4", {}), ("K4 masked", dict(avail=avail))):
            us[f"{name} T={T} N={N}"] = 1e3 * cs.event_ms(
                torch, lambda: dodoor_fused(keys, r, d, L, D, C, 0.5, **kw))

    cl = make_scaled(10_000)
    n = cl.num_servers
    wl = azure.synthesize(m=200_000, qps=400.0)
    H = float(wl.submit_ms[-1])
    dyn = random_churn(n, 0.15, 0.15, H).merge(
        random_outages(n, n // 5, 0.6 * H, mean_down_ms=0.2 * H))
    cfg = EngineConfig(policy="dodoor", b=500)
    warm = azure.synthesize(m=5_000, qps=400.0)
    simulate(warm, cl, cfg, device="cuda", dynamics=dyn)
    walls = {}
    for name, dynamics in (("phase 4 scale", None),
                           ("phase 7 scale with dynamics", dyn)):
        for i in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            simulate(wl, cl, cfg, device="cuda", dynamics=dynamics)
            torch.cuda.synchronize()
            walls[f"{name} run {i + 1}"] = time.perf_counter() - t0
    return {"root": root, "kernel_us": us, "wall_s": walls,
            "decisions_per_s": {k: wl.r_submit.shape[0] / v
                                for k, v in walls.items()},
            "profiled_phase_7": profiled(torch, simulate, wl, cl, cfg, dyn)}


def profiled(torch, simulate, wl, cl, cfg, dyn) -> dict:
    """One run under ``torch.profiler`` (device activity only): the
    decision kernel's device time and launches, the device's busy time
    (the union of all kernel spans) and the (profiled) wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        simulate(wl, cl, cfg, device="cuda", dynamics=dyn)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    kern = [e.time_range.elapsed_us() for e in prof.events()
            if e.device_type == DeviceType.CUDA
            and "dodoor_fused_sparse_kernel" in e.name]
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return {"wall_s": wall, "device_busy_ms": busy / 1e3,
            "decision_kernel_ms": sum(kern) / 1e3,
            "decision_launches": len(kern)}


def pair_main(child_fn, description: str, script: str,
              flags: dict = None) -> int:
    """Run ``script OLD NEW [--out FILE]``: one child process of
    ``script`` per measurement, in the order old, new, new, old, each
    printing ``child_fn(root)`` as a ``RESULT`` JSON line; print each
    child's line and, last, a summary beside the card's name and power
    limit.  ``flags``: {name: help} of on/off options, each passed on to
    the children and to ``child_fn`` as a keyword."""
    flags = flags or {}
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("old")
    ap.add_argument("new")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None,
                    help="also write the summary JSON to this file")
    for name, text in flags.items():
        ap.add_argument(f"--{name}", action="store_true", help=text)
    a = ap.parse_args()
    on = {name: getattr(a, name) for name in flags}
    if a.child:
        print("RESULT " + json.dumps(child_fn(a.old, **on)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print(f"{os.path.basename(script)}: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    runs = []
    for label in ("old", "new", "new", "old"):
        root = os.path.abspath(getattr(a, label))
        out = subprocess.run(
            [sys.executable, os.path.abspath(script), root, root, "--child",
             *(f"--{name}" for name, v in on.items() if v)],
            capture_output=True, text=True, check=True)
        line = next(x for x in out.stdout.splitlines()
                    if x.startswith("RESULT "))
        res = dict(json.loads(line[len("RESULT "):]), version=label)
        print(json.dumps(res), flush=True)
        runs.append(res)
    summary = {"card": card, "order": "old, new, new, old", "runs": runs,
               **{name: v for name, v in on.items() if v}}
    if a.out:
        with open(a.out, "w") as f:
            json.dump(summary, f, indent=1)
    print(json.dumps(summary), flush=True)
    return 0


def main() -> int:
    return pair_main(child, __doc__.splitlines()[0], __file__)


if __name__ == "__main__":
    sys.exit(main())
