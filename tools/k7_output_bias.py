#!/usr/bin/env python3
"""How far K7's forward output sits from the exact attention, and in which
direction: the float32 accumulation of its tensor-core products rounds
each partial sum towards zero, which a backward that takes Δ =
rowsum(dO ∘ o) from this output would carry into dQ.

    python3 tools/k7_output_bias.py [--out FILE]

For each shape (whisper-base's cross-attention: 64 queries over 1 500
frames, non-causal; tinyllama-1.1b's and recurrentgemma-2b's causal
prefills) it runs K7 (``flash_attention``, the serving forward, whose
output the grad forward's equals bit for bit) and the plain version
(``attention_ref``, float32) on the card, and the attention in float64 on
the card as the exact value, on inputs from a seed.  It prints, for each
of K7 and the plain version, the largest |o − exact| over the largest
|exact| and the mean signed error along the exact value's sign over the
mean |exact| (negative: shrunk towards zero), and the same two for Δ =
rowsum(dO ∘ o) against the exact Δ, beside the card's name and power
limit; writes them as JSON to ``--out`` if given.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

#: (B, H, Hkv, Lq, Lk, D, causal, window).
SHAPES = [(1, 8, 8, 64, 1500, 64, False, None),
          (4, 32, 4, 1024, 1024, 64, True, None),
          (2, 10, 1, 4096, 4096, 256, True, 2048)]


def exact(torch, q, k, v, causal, window, scale):
    """Attention in float64 on q's device, GQA by repeating k and v."""
    rep = q.shape[1] // k.shape[1]
    qd = q.double()
    kd, vd = (t.double().repeat_interleave(rep, dim=1) for t in (k, v))
    Lq, Lk = q.shape[2], k.shape[2]
    qpos = torch.arange(Lq, device=q.device)[:, None] + (Lk - Lq)
    kpos = torch.arange(Lk, device=q.device)[None, :]
    mask = torch.ones((Lq, Lk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    out = []
    for h in range(qd.shape[1]):         # a head at a time: [B, Lq, Lk]
        s = torch.einsum("bqd,bkd->bqk", qd[:, h], kd[:, h]) * scale
        p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
        out.append(torch.einsum("bqk,bkd->bqd", p, vd[:, h]))
    return torch.stack(out, dim=1)


def errors(got, want):
    """(max |got − want| / max |want|, mean signed error along want's sign
    over mean |want|)."""
    d = got.double() - want
    return (float(d.abs().max() / want.abs().max()),
            float((d * want.sign()).mean() / want.abs().mean()))


def main(argv=None) -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention)

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k7_output_bias: no CUDA device", file=sys.stderr)
        return 2
    card = cs.card_line()
    print(card, flush=True)
    cs.no_tf32(torch)
    rows = []
    for B, H, Hkv, Lq, Lk, D, causal, window in SHAPES:
        rng = np.random.RandomState(Lq + Lk + D)
        q, k, v, do = (torch.from_numpy(rng.randn(*s).astype(np.float32)
                                        * sc).cuda()
                       for s, sc in (((B, H, Lq, D), 0.5), ((B, Hkv, Lk, D),
                                                            0.5),
                                     ((B, Hkv, Lk, D), 1.0),
                                     ((B, H, Lq, D), 1.0)))
        scale = D ** -0.5
        want = exact(torch, q, k, v, causal, window, scale)
        delta = (do.double() * want).sum(-1)
        row = {"shape": [B, H, Hkv, Lq, Lk, D], "causal": causal,
               "window": window}
        with torch.no_grad():
            for name, o in (("k7", flash_attention(q, k, v, causal=causal,
                                                   window=window)),
                            ("plain", attention_ref(q, k, v, causal=causal,
                                                    window=window))):
                row[name] = {"o": errors(o, want),
                             "delta": errors((do * o).sum(-1), delta)}
        rows.append(row)
        print(json.dumps(row), flush=True)
        del want, delta
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
