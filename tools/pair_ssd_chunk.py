#!/usr/bin/env python3
"""Paired timing of the SSD chunk kernel K8 and mamba2-1.3b's forward.

For two checkouts on one card:

    python3 tools/pair_ssd_chunk.py OLD_ROOT NEW_ROOT [--out FILE]

Each root is the top of a checkout (its ``chip_smoke.py`` and ``src/``).
As ``tools/pair_decision_kernels.py`` does, it runs one child process per
measurement in the order old, new, new, old, each building its
checkout's K8.  A child times ``ssd_chunk`` with CUDA events
(``event_ms`` of its ``chip_smoke.py``) at every shape of its phase 17
(``K8_SHAPES``: the reference's four pins, a 12-step chunk and
mamba2-1.3b's B = 2, L = 1024), on the operands ``ssd`` lays out; then
runs phase 19's ``forward`` of mamba2-1.3b on 2 × 1024 tokens (weights
from seed 0) after a warm-up, three times, on the host clock ending in a
sync.  It prints one JSON line per child and, last, a JSON summary with
every child's numbers beside the card's name and power limit.  Needs a
CUDA device.

    python3 tools/pair_ssd_chunk.py OLD_ROOT NEW_ROOT --backward
        [--out FILE]

times K8's backward instead (``ssd_chunk_bwd`` on the operands and output
gradients of each checkout's ``chip_smoke.k8_bwd_operands``) at every
shape of ``K8_SHAPES`` and at mamba2-1.3b's training shape
(``TRAIN_SSM_SHAPE``: B = 2, L = 1024), with a digest of each output so
that equal bits show, and no forward.
"""
from __future__ import annotations

import hashlib
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from pair_decision_kernels import pair_main  # noqa: E402


def time_backward(cs, torch) -> dict:
    """K8's backward at ``K8_SHAPES`` and the training shape: µs and a
    digest of each output a shape."""
    from repro_torch.kernels.ssd_chunk import ssd_chunk_bwd

    us, digest = {}, {}
    B, L = cs.TRAIN_SSM_SHAPE
    for shape in list(cs.K8_SHAPES) + [(B, L, 64, 64, 1, 128, 64)]:
        args, hpg = cs.k8_bwd_operands(torch, *shape)
        key = "B={} L={} H={} P={} G={} S={} Q={}".format(*shape)
        us[key] = 1e3 * cs.event_ms(
            torch, lambda: ssd_chunk_bwd(*args, heads_per_group=hpg))
        h = hashlib.sha256()
        for t in ssd_chunk_bwd(*args, heads_per_group=hpg):
            h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
        digest[key] = h.hexdigest()[:16]
        del args
        torch.cuda.empty_cache()
    return {"k8_bwd_us": us, "digest": digest}


def child(root: str, backward: bool = False) -> dict:
    """Measure the checkout at ``root`` (run in a process of its own)."""
    sys.path.insert(0, root)
    import chip_smoke as cs          # puts root/src first on sys.path
    import numpy as np
    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.kernels import _build
    from repro_torch.kernels.ssd_chunk import ssd_chunk
    from repro_torch.models import registry

    _build.build(("ssd_chunk",))
    cs.no_tf32(torch)
    if backward:
        return dict(time_backward(cs, torch), root=root)
    us = {}
    for B, L, H, P, G, S, chunk in cs.K8_SHAPES:
        x, dt, A, Bm, Cm = (torch.from_numpy(a).cuda() for a in
                            cs.ssd_inputs(B, L, H, P, G, S, L + S))
        NC, hpg = L // chunk, H // G
        ops = [t.contiguous() for t in (
            x.transpose(1, 2).reshape(B * H, NC, chunk, P),
            dt.transpose(1, 2).reshape(B * H, NC, chunk)
            * A.repeat(B)[:, None, None],
            dt.transpose(1, 2).reshape(B * H, NC, chunk),
            Bm.transpose(1, 2).reshape(B, G, NC, chunk, S),
            Cm.transpose(1, 2).reshape(B, G, NC, chunk, S))]
        us[f"B={B} L={L} H={H} P={P} G={G} S={S} Q={chunk}"] = 1e3 * (
            cs.event_ms(torch, lambda: ssd_chunk(*ops, heads_per_group=hpg)))

    cfg = ARCHS["mamba2-1.3b"]
    params = registry.init_params(cfg, 0, device="cuda")
    rng = np.random.RandomState(0)
    tokens = torch.from_numpy(rng.randint(0, cfg.vocab, (2, 1024))).cuda()
    registry.forward(cfg, params, {"tokens": tokens[:1, :64]})   # warm-up
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        registry.forward(cfg, params, {"tokens": tokens})
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    return {"root": root, "k8_us": us, "forward_ms": walls}


if __name__ == "__main__":
    sys.exit(pair_main(child, __doc__.splitlines()[0], __file__,
                       {"backward": "time K8's backward instead"}))
