#!/usr/bin/env python3
"""Paired timing of the flash-attention kernel K7 and tinyllama-1.1b's
forward.

For two checkouts on one card:

    python3 tools/pair_flash_attention.py OLD_ROOT NEW_ROOT [--out FILE]

Each root is the top of a checkout (its ``chip_smoke.py`` and ``src/``).
As ``tools/pair_decision_kernels.py`` does, it runs one child process per
measurement in the order old, new, new, old, each building its
checkout's K7.  A child times ``flash_attention`` with CUDA events
(``event_ms`` of its ``chip_smoke.py``) at the reference's seven pins
(``K7_PINS``), tinyllama-1.1b's prefill (``K7_PREFILL``) and decode at
Lk = 1024 (``K7_DECODE``), qwen3-moe's prefill at head width 128
(``K7_MOE``), recurrentgemma-2b's prefill and decode at head width 256
(``K7_RG_PREFILL``, ``K7_RG_DECODE``), and the serving
decode over a bf16 cache
read in place with the step's own key and value as the last row
(``K7_CACHE``); then runs phase 18's ``forward`` of tinyllama-1.1b on
4 × 1024 tokens (weights from seed 0) after a warm-up, three times, on
the host clock ending in a sync.  Each child also reports a digest of
every output (K7's at each shape, the forward's logits), so that two
checkouts whose kernels should compute the same bits can be seen to.  It
prints one JSON line per child and, last, a JSON summary with every
child's numbers beside the card's name and power limit.  Needs a CUDA
device.

    python3 tools/pair_flash_attention.py OLD_ROOT NEW_ROOT --backward
        [--out FILE]

times K7's backward instead, at the timed shapes of phases 26 and 27
(``K7_BWD_TIMED``: D = 64 and 128; ``K7_RG_PREFILL``: D = 256 with a
2048-key window), on each checkout's ``k7_bwd_inputs``: the backward
given what that checkout's train step gives it (the forward's lse, and
its output where ``flash_attention_bwd`` takes ``o``), then SDPA's
backward (``torch.autograd.grad`` on a retained graph; a window as a
mask) in the same child, with a digest of each backward's outputs.

    python3 tools/pair_flash_attention.py OLD_ROOT NEW_ROOT --backward --bf16
        [--out FILE]

times K7's bf16 backward instead, at ``K7_BWD_TIMED`` on each checkout's
``k7_bwd_inputs`` rounded to bf16: the backward given the bf16 grad
forward's lse and float32 output, SDPA's bf16 backward in the same child,
a digest of each backward's outputs, and the bf16 grad forward
(``flash_attention_lse``) beside SDPA's bf16 forward.
"""
from __future__ import annotations

import hashlib
import inspect
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from pair_decision_kernels import pair_main  # noqa: E402


def time_backward(cs, torch, bits, bf16: bool = False) -> dict:
    """K7's backward and SDPA's at the timed training shapes (µs); with
    ``bf16`` the bf16 backward at ``K7_BWD_TIMED`` and the bf16 grad
    forward beside SDPA's."""
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (flash_attention_bwd,
                                                     flash_attention_lse)

    takes_o = "o" in inspect.signature(flash_attention_bwd).parameters
    us, sdpa_us, fwd_us, sdpa_fwd_us = {}, {}, {}, {}
    shapes = list(cs.K7_BWD_TIMED) + ([] if bf16 else [cs.K7_RG_PREFILL])
    for B, H, Hkv, Lq, Lk, D, causal, window in shapes:
        q, k, v, do = cs.k7_bwd_inputs(torch, B, H, Hkv, Lq, Lk, D)
        if bf16:
            q, k, v, do = (t.to(torch.bfloat16) for t in (q, k, v, do))
        o, lse = flash_attention_lse(q, k, v, causal=causal, window=window)
        given = dict(lse=lse, o=o) if takes_o else dict(lse=lse)
        key = (f"B={B} H={H} Hkv={Hkv} Lq={Lq} Lk={Lk} D={D} causal={causal} "
               f"window={window}")

        def call():
            return flash_attention_bwd(q, k, v, do, causal=causal,
                                       window=window, **given)

        us[key] = 1e3 * cs.event_ms(torch, call, reps=20)
        bits(key, torch.cat([g.flatten() for g in call()]))
        qpos = np.arange(Lq)[:, None] + (Lk - Lq)
        kpos = np.arange(Lk)[None, :]
        mask = kpos <= qpos
        if window is not None:
            mask &= kpos > qpos - window
        kw = (dict(is_causal=True) if window is None else
              dict(attn_mask=torch.from_numpy(mask).cuda()))
        qs, ks, vs = (t.clone().requires_grad_(True) for t in (q, k, v))
        os_ = F.scaled_dot_product_attention(qs, ks, vs, enable_gqa=True,
                                             **kw)
        sdpa_us[key] = 1e3 * cs.event_ms(torch, lambda: torch.autograd.grad(
            os_, (qs, ks, vs), do, retain_graph=True), reps=20)
        if bf16:
            fwd_us[key] = 1e3 * cs.event_ms(torch, lambda: flash_attention_lse(
                q, k, v, causal=causal, window=window), reps=20)
            with torch.no_grad():
                sdpa_fwd_us[key] = 1e3 * cs.event_ms(
                    torch, lambda: F.scaled_dot_product_attention(
                        q, k, v, enable_gqa=True, **kw), reps=20)
        del os_, qs, ks, vs, q, k, v, do, o, lse
        torch.cuda.empty_cache()
    out = {"k7_bwd_us": us, "sdpa_bwd_us": sdpa_us, "takes_o": takes_o}
    if bf16:
        out.update(k7_fwd_us=fwd_us, sdpa_fwd_us=sdpa_fwd_us)
    return out


def child(root: str, backward: bool = False, bf16: bool = False) -> dict:
    """Measure the checkout at ``root`` (run in a process of its own)."""
    sys.path.insert(0, root)
    import chip_smoke as cs          # puts root/src first on sys.path
    import numpy as np
    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import registry

    _build.build(("flash_attention",))
    cs.no_tf32(torch)
    us, digest = {}, {}

    def bits(key, t):
        digest[key] = hashlib.sha256(
            t.contiguous().view(torch.uint8).cpu().numpy().tobytes()
        ).hexdigest()[:16]

    if backward:
        return dict(time_backward(cs, torch, bits, bf16=bf16), root=root,
                    digest=digest)
    for B, H, Hkv, Lq, Lk, D, causal, window in (
            list(cs.K7_PINS) + [cs.K7_PREFILL, cs.K7_DECODE,
                                cs.K7_MOE["qwen3-moe-235b-a22b"],
                                cs.K7_RG_PREFILL, cs.K7_RG_DECODE]):
        rng = np.random.RandomState(Lq + Lk)
        q, k, v = (torch.from_numpy(rng.randn(*s).astype(np.float32)).cuda()
                   for s in ((B, H, Lq, D), (B, Hkv, Lk, D),
                             (B, Hkv, Lk, D)))
        key = (f"B={B} H={H} Hkv={Hkv} Lq={Lq} Lk={Lk} D={D} causal={causal} "
               f"window={window}")
        us[key] = 1e3 * cs.event_ms(
            torch, lambda: flash_attention(q, k, v, causal=causal,
                                           window=window))
        bits(key, flash_attention(q, k, v, causal=causal, window=window))
    B, H, Hkv, Lk, D, slots = cs.K7_CACHE
    rng = np.random.RandomState(Lk)
    q = torch.from_numpy(rng.randn(B, H, 1, D).astype(np.float32)).cuda()
    kc, vc = (torch.from_numpy(rng.randn(B, Hkv, slots, D).astype(
        np.float32)).to(torch.bfloat16).cuda() for _ in range(2))
    kt, vt = (torch.from_numpy(rng.randn(B, Hkv, 1, D).astype(np.float32))
              .cuda() for _ in range(2))
    k, v = kc[:, :, :Lk], vc[:, :, :Lk]
    key = (f"B={B} H={H} Hkv={Hkv} Lq=1 Lk={Lk} of {slots} D={D} over a "
           f"bfloat16 cache")
    us[key] = 1e3 * cs.event_ms(
        torch, lambda: flash_attention(q, k, v, kv_last=(kt, vt)))
    bits(key, flash_attention(q, k, v, kv_last=(kt, vt)))

    cfg = ARCHS["tinyllama-1.1b"]
    params = registry.init_params(cfg, 0, device="cuda")
    rng = np.random.RandomState(0)
    tokens = torch.from_numpy(rng.randint(0, cfg.vocab, (4, 1024))).cuda()
    registry.forward(cfg, params, {"tokens": tokens[:1, :64]})   # warm-up
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, _ = registry.forward(cfg, params, {"tokens": tokens})
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    bits("tinyllama-1.1b forward logits", logits)
    return {"root": root, "k7_us": us, "forward_ms": walls,
            "digest": digest}


if __name__ == "__main__":
    sys.exit(pair_main(child, __doc__.splitlines()[0], __file__,
                       {"backward": "time K7's backward instead",
                        "bf16": "with --backward: its bf16 form"}))
