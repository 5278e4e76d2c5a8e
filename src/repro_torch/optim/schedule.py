"""Learning-rate schedules — the port of the JAX package's
``optim/schedule.py``."""
from __future__ import annotations

import math

import torch

from .._arith import madd


def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    floor: float = 0.1):
    """Linear warmup → cosine decay to ``floor``·peak.  ``lr(step)``
    takes an integer tensor (or int) and returns a float32 0-d tensor on
    its device, computed as the reference's compiled form computes it:
    ``floor + (1 − floor)·0.5·(1 + cos(π·prog))`` is one fused
    multiply-add.  ``torch.cos`` differs from XLA:CPU's ``cos`` by one ulp
    on some arguments (≈ 5 % of a sweep of [0, π]), so a step in the decay
    may be an ulp or two from the reference's."""
    half = float(torch.tensor((1 - floor) * 0.5, dtype=torch.float32))

    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = peak_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0,
                           1.0)
        cos = peak_lr * madd(half, 1 + torch.cos(math.pi * prog), floor)
        return torch.where(step < warmup, warm, cos)

    return lr
