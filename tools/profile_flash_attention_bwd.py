#!/usr/bin/env python3
"""Where K7's backward spends its time: each of its kernels (Δ, dk/dv,
the sum of the dk/dv runs, dq) timed on the card under
``torch.profiler``, and the whole call with CUDA events, given the
forward's lse and output (``flash_attention_lse``, as a train step runs
it), at
tinyllama-1.1b's prefill (B, H, Hkv, L, D) = (4, 32, 4, 1024, 64),
qwen3-moe's (4, 64, 4, 1024, 128) and recurrentgemma-2b's (2, 10, 1,
4096, 256) with its 2048-key window (the D = 256 passes), causal.

    python3 tools/profile_flash_attention_bwd.py [--bf16] [--out FILE]

With ``--bf16`` the operands are rounded to bf16 and the bf16 passes run
(tinyllama-1.1b's and qwen3-moe's shapes; the bound as
``chip_smoke.k7_bwd_bf16_case`` counts it: 22·D bf16 flops an unmasked
pair at 989 T op/s).

Prints the card's name and power limit, then per shape the device time
of each kernel (mean of ``REPS`` calls), the event time of the whole
call (``chip_smoke.event_ms``), the bound as ``chip_smoke.k7_bwd_case``
counts it (10·D flops an unmasked pair, each product float32-accurate as
three TF32 MMAs at 495 T op/s) beside the bound on the CUDA cores' 67 T
op/s float32, and the achieved rate on the 10·D count; writes the same as
JSON to ``--out`` if given.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

#: (B, H, Hkv, L, D, window), causal.
SHAPES = [(4, 32, 4, 1024, 64, None), (4, 64, 4, 1024, 128, None),
          (2, 10, 1, 4096, 256, 2048)]
REPS = 10


def main(argv=None) -> int:
    import torch

    import chip_smoke as cs
    from repro_torch.kernels.flash_attention import (flash_attention_bwd,
                                                     flash_attention_lse)

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--bf16", action="store_true",
                    help="the bf16 backward on bf16 operands (D <= 128)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_flash_attention_bwd: no CUDA device", file=sys.stderr)
        return 2
    print(cs.card_line(), flush=True)
    cs.no_tf32(torch)
    out = []
    for B, H, Hkv, L, D, window in SHAPES:
        if args.bf16 and D > 128:
            continue
        q, k, v, do = cs.k7_bwd_inputs(torch, B, H, Hkv, L, L, D)
        if args.bf16:
            q, k, v, do = (t.to(torch.bfloat16) for t in (q, k, v, do))
        o, lse = flash_attention_lse(q, k, v, window=window)

        def call():
            return flash_attention_bwd(q, k, v, do, window=window, lse=lse,
                                       o=o)

        ms = cs.event_ms(torch, call, reps=20)
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                call()
            torch.cuda.synchronize()
        kernels = {}
        for ev in prof.key_averages():
            if "attn_bwd" in ev.key:
                name = ev.key.split("attn_bwd_")[1].split("_kernel")[0]
                t = getattr(ev, "device_time_total",
                            getattr(ev, "cuda_time_total", 0.0))
                kernels[name] = t / REPS / 1e3          # ms a call
        w = window or L                  # keys a row sees: min(i + 1, w)
        pairs = B * H * (w * (w + 1) // 2 + (L - w) * w)
        ops = 10 * D * pairs
        row = {"shape": [B, H, Hkv, L, D], "window": window, "ms": ms,
               "kernels_ms": kernels,
               "bound_ms": 3 * ops / cs.TF32_OPS_PER_S * 1e3,
               "bound_fp32_ms": ops / cs.FP32_OPS_PER_S * 1e3,
               "tops": ops / ms / 1e9}
        if args.bf16:
            row.update(dtype="bfloat16",
                       bound_ms=22 * D * pairs / cs.BF16_OPS_PER_S * 1e3)
            del row["bound_fp32_ms"]
        out.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": cs.card_line(), "rows": out}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
