"""End-to-end training driver — the port of ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
        --steps 200 --batch 8 --seq 256 [--smoke] [--ckpt-dir ckpts] \
        [--fail-at 50:4] [--resume] [--device cuda|cpu]

Wires the port's substrate together: config → model → synthetic pipeline
→ AdamW with the cosine schedule → checkpoint/restore → failure injection
→ straggler monitor.  It runs on the card unless ``--device cpu`` is
given; on the card every attention layer runs K7 forward and its
backward kernels, and every Mamba-2 mixer K8 and its backward, so every
family trains there.  The launcher trains in float32, as the
reference's does; a caller that trains under
``models.precision.options(dtype=torch.bfloat16)`` (the library's
``make_train_step``) gets K7's bf16 backward at head widths 32–128, and
a bf16 call it does not take (head width 256) raises before any
launch.

The resume path replays the reference's, fault included (ROADMAP §3,
R5): the checkpoint saved at step s holds the state *after* step s's
update, and both ``--resume`` and the failure path restart the loop at s,
so batch s is applied twice.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .._device import resolve_device
from ..checkpoint import Checkpointer, latest_step
from ..configs import ARCHS
from ..data import SyntheticLM
from ..ft import FailureInjector, StragglerMonitor
from ..optim import cosine_schedule
from ..train.steps import init_train_state, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--fail-at", default=None,
                    help="step:slices simulated failure, e.g. 50:4")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = ARCHS[args.arch]
    if args.smoke:
        cfg = cfg.smoke()
    print(f"arch={cfg.name} params≈{cfg.param_count()/1e6:.1f}M "
          f"steps={args.steps} batch={args.batch} seq={args.seq} "
          f"device={device.type}")

    data = SyntheticLM(cfg.vocab, args.seq, args.batch, seed=args.seed,
                       device=str(device))
    lr = cosine_schedule(args.lr, warmup=max(args.steps // 20, 5),
                         total=args.steps)
    step_fn = make_train_step(cfg, lr=lr)

    params, opt = init_train_state(cfg, args.seed, device=device)
    start = 0
    ckpt = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    if ckpt and args.resume and latest_step(args.ckpt_dir) is not None:
        (params, opt), start = ckpt.restore((params, opt))
        print(f"resumed from step {start}")

    injector = FailureInjector()
    if args.fail_at:
        s, n = args.fail_at.split(":")
        injector.fail_at.append((int(s), int(n)))
    monitor = StragglerMonitor(num_hosts=1)

    losses = []
    t_start = time.time()
    step = start
    while step < args.steps:
        n_lost = injector.should_fail(step)
        if n_lost:
            # The recovery path: restore the last checkpoint and continue
            # (one card: no survivor mesh to reshard onto).
            print(f"[ft] simulated failure at step {step}: lost {n_lost} "
                  f"data slices — restoring")
            if ckpt and latest_step(args.ckpt_dir) is not None:
                (params, opt), step = ckpt.restore((params, opt))
                print(f"[ft] restored step {step}")
            continue

        t0 = time.time()
        batch = data.batch(step)
        B = batch["tokens"].shape[0]
        if cfg.family == "vlm":
            n_p = 4
            batch = {
                "tokens": batch["tokens"][:, :-n_p],
                "labels": batch["labels"],
                "patches": torch.zeros((B, n_p, cfg.d_model), device=device),
                "positions3": torch.arange(args.seq, device=device)[
                    None, None].expand(B, 3, args.seq).to(torch.int32),
            }
        elif cfg.family == "audio":
            batch = {**batch, "frames": torch.zeros(
                (B, cfg.encoder_frames, cfg.d_model), device=device)}
        params, opt, metrics = step_fn(params, opt, batch)
        loss = float(metrics["loss"])
        losses.append(loss)
        monitor.report(step, np.array([time.time() - t0]))

        if step % args.log_every == 0:
            print(f"step {step:5d}  loss {loss:7.4f}  "
                  f"{time.time() - t0:5.2f}s/step", flush=True)
        if ckpt and step > start and step % args.ckpt_every == 0:
            path = ckpt.save(step, (params, opt))
            print(f"[ckpt] saved {path}")
        step += 1

    dt = time.time() - t_start
    print(f"done: {args.steps - start} steps in {dt:.1f}s; "
          f"loss {losses[0]:.4f} → {losses[-1]:.4f}")
    return losses


if __name__ == "__main__":
    main()
