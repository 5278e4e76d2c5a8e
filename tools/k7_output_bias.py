#!/usr/bin/env python3
"""How far K7's forward output and its backward's gradients sit from the
exact values, and in which direction: a float32 tensor-core accumulation
that drops low bits towards zero shrinks what it sums, and a backward
that takes Δ = rowsum(dO ∘ o) from a shrunk output carries the error into
dQ.

    python3 tools/k7_output_bias.py [--out FILE]

At each of ``chip_smoke.K7_BIAS_SHAPES`` (whisper-base's cross-attention:
64 queries over 1 500 frames, non-causal; tinyllama-1.1b's and
recurrentgemma-2b's causal prefills), on inputs from a seed, it runs on
the card:

- K7's forward (``flash_attention``, the serving forward, whose output
  the grad forward's equals bit for bit) and the plain version
  (``attention_ref``, float32), against attention in float64
  (``chip_smoke.k7_bias_rows``): o and Δ = rowsum(dO ∘ o);
- K7's backward (``flash_attention_bwd`` given the forward's lse and
  output, as a train step runs it) and the plain version
  (``attention_bwd_ref``, float32), against float64 autograd of the same
  attention, a head at a time: dq, dk and dv.

For each it prints the largest |error| over the largest |exact| and the
mean signed error along the exact value's sign over the mean |exact|
(negative: shrunk towards zero), beside the card's name and power limit,
and checks K7's output against ``chip_smoke.K7_BIAS_MAX``; writes the
rows as JSON to ``--out`` if given.  Needs a CUDA device.

    python3 tools/k7_output_bias.py --bf16 [--out FILE]

does the same for the bf16 backward on the inputs rounded to bf16, at
the shapes of ``K7_BIAS_SHAPES`` with D ≤ 128 and at qwen3-moe's prefill
(D = 128): bf16 dq, dk and dv of both forms, the shipped one (P and dS as
three bf16 pieces) and the two-piece ablation
(``tools/ablate_flash_attention.py``'s ``two_piece``, built into
``build/k7_output_bias_bf16/``), and of the plain version rounded once to
bf16, against float64 autograd on the same bf16 values.  It fails if the
shipped form's |bias| exceeds ``BF16_BIAS_MAX`` of the mean |exact| (one
rounding to nearest even adds noise of about 2e-6 at dk's 1 M elements
and no bias).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

#: The most |bias| the bf16 backward's gradients may show, of the mean
#: |exact|.
BF16_BIAS_MAX = 1e-5


def exact_grads(torch, q, k, v, do, causal, window, scale):
    """(dq, dk, dv) of attention in float64 by autograd, a head at a time,
    dk and dv summed over each group's heads in head order."""
    H, Hkv = q.shape[1], k.shape[1]
    rep = H // Hkv
    Lq, Lk = q.shape[2], k.shape[2]
    qpos = torch.arange(Lq, device=q.device)[:, None] + (Lk - Lq)
    kpos = torch.arange(Lk, device=q.device)[None, :]
    mask = torch.ones((Lq, Lk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    dq = torch.empty(q.shape, dtype=torch.float64, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float64, device=q.device)
    dv = torch.zeros(k.shape, dtype=torch.float64, device=q.device)
    for h in range(H):
        qh, kh, vh = (t.double().requires_grad_(True)
                      for t in (q[:, h], k[:, h // rep], v[:, h // rep]))
        s = torch.matmul(qh, kh.transpose(1, 2)) * scale
        p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
        gq, gk, gv = torch.autograd.grad(torch.matmul(p, vh), (qh, kh, vh),
                                         do[:, h].double())
        dq[:, h] = gq
        dk[:, h // rep] += gk
        dv[:, h // rep] += gv
        del s, p, gq, gk, gv
    return dq, dk, dv


def bf16_rows(torch, cs, card, out) -> int:
    """The ``--bf16`` mode (see the module's docstring)."""
    from ablate_flash_attention import BWD_BF16_VARIANTS, build_variants
    from repro_torch.kernels.flash_attention import (attention_bwd_ref,
                                                     flash_attention_bwd,
                                                     flash_attention_lse)
    from repro_torch.kernels.flash_attention import kernel as K

    lib = build_variants({"two_piece": BWD_BF16_VARIANTS["two_piece"]},
                         os.path.join(ROOT, "build", "k7_output_bias_bf16"),
                         kernels=())["two_piece"][0]
    shapes = [s for s in cs.K7_BIAS_SHAPES if s[5] <= 128] + [
        cs.K7_BWD_TIMED[1]]
    rows = []
    for B, H, Hkv, Lq, Lk, D, causal, window in shapes:
        q, k, v, do = (t.to(torch.bfloat16) for t in cs.k7_bias_inputs(
            torch, B, H, Hkv, Lq, Lk, D))
        want = exact_grads(torch, q, k, v, do, causal, window, D ** -0.5)
        o, lse = flash_attention_lse(q, k, v, causal=causal, window=window)
        row = {"shape": [B, H, Hkv, Lq, Lk, D], "causal": causal,
               "window": window}

        def bwd():
            return flash_attention_bwd(q, k, v, do, causal=causal,
                                       window=window, lse=lse, o=o)

        load = K.load
        K.load = lambda name: lib          # the two-piece build
        try:
            two = bwd()
        finally:
            K.load = load
        plain = [g.to(torch.bfloat16) for g in attention_bwd_ref(
            q, k, v, do, causal=causal, window=window)]
        for name, got in (("k7", bwd()), ("two_piece", two),
                          ("plain", plain)):
            row[name] = {n: cs.signed_error(g, w)
                         for n, g, w in zip(("dq", "dk", "dv"), got, want)}
        row["limit"] = BF16_BIAS_MAX
        rows.append(row)
        print(json.dumps(row), flush=True)
        del q, k, v, do, want, o, lse, two, plain
        torch.cuda.empty_cache()
    if out:
        with open(out, "w") as f:
            json.dump({"card": card, "bf16": True, "rows": rows}, f,
                      indent=1)
    bad = [r["shape"] for r in rows
           if any(abs(e[1]) > BF16_BIAS_MAX for e in r["k7"].values())]
    if bad:
        print(f"k7_output_bias: the bf16 backward's bias exceeds "
              f"{BF16_BIAS_MAX} at {bad}", file=sys.stderr)
        return 1
    return 0


def main(argv=None) -> int:
    import torch

    import chip_smoke as cs
    from repro_torch.kernels.flash_attention import (attention_bwd_ref,
                                                     flash_attention_bwd,
                                                     flash_attention_lse)

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--bf16", action="store_true",
                    help="the bf16 backward's gradients, both forms")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k7_output_bias: no CUDA device", file=sys.stderr)
        return 2
    card = cs.card_line()
    print(card, flush=True)
    cs.no_tf32(torch)
    if args.bf16:
        return bf16_rows(torch, cs, card, args.out)
    rows = cs.k7_bias_rows(torch)
    for row, shape, limit in zip(rows, cs.K7_BIAS_SHAPES, cs.K7_BIAS_MAX):
        B, H, Hkv, Lq, Lk, D, causal, window = shape
        q, k, v, do = cs.k7_bias_inputs(torch, B, H, Hkv, Lq, Lk, D)
        want = exact_grads(torch, q, k, v, do, causal, window, D ** -0.5)
        o, lse = flash_attention_lse(q, k, v, causal=causal, window=window)
        for name, got in (
                ("k7", flash_attention_bwd(q, k, v, do, causal=causal,
                                           window=window, lse=lse, o=o)),
                ("plain", attention_bwd_ref(q, k, v, do, causal=causal,
                                            window=window))):
            row[name].update({n: cs.signed_error(g, w)
                              for n, g, w in zip(("dq", "dk", "dv"), got,
                                                 want)})
        row["limit"] = limit
        print(json.dumps(row), flush=True)
        del q, k, v, do, want, o, lse
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "rows": rows}, f, indent=1)
    bad = [r["shape"] for r in rows if abs(r["k7"]["o"][1]) > r["limit"]]
    if bad:
        print(f"k7_output_bias: the output's bias exceeds K7_BIAS_MAX at "
              f"{bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
