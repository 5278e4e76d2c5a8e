"""PreFilter (Algorithm 1, line 2) and inverse-CDF candidate sampling
(counterpart of ``repro.core.prefilter``).

A server is a candidate for a task iff its total capacity admits the
task's demand in every resource dimension (and, under server dynamics, it
is not inside a down window: :func:`avail_rows`).  Candidates are drawn with
replacement, uniformly over the feasible servers, by inverse CDF over the
mask's prefix count — one threefry uniform per draw, bit-identical to the
reference.  With no feasible server the draw falls back to uniform over
all servers.
"""
from __future__ import annotations

import torch

from ..random import uniform


def feasible_mask(r: torch.Tensor, C: torch.Tensor,
                  affinity: torch.Tensor | None = None) -> torch.Tensor:
    """r [K] or [T, K], C [N, K] → bool [N] or [T, N]."""
    if r.dim() == 1:
        ok = (r[None, :] <= C).all(dim=-1)
    else:
        ok = (r[:, None, :] <= C[None, :, :]).all(dim=-1)
    if affinity is not None:
        ok = ok & affinity
    return ok


def avail_rows(down0: torch.Tensor, down1: torch.Tensor,
               now: torch.Tensor) -> torch.Tensor:
    """Availability from per-server down windows [N, W] (``+inf`` pads) at
    ``now`` [T] → bool [T, N]: no window with ``down0 <= now < down1`` —
    the reference engine's ``_avail_rows``, ANDed into the capacity mask
    when a run has down windows."""
    t = now[:, None, None]
    return ~((down0[None] <= t) & (t < down1[None])).any(dim=-1)


def sample_feasible_batch(keys: torch.Tensor, mask: torch.Tensor,
                          num: int) -> torch.Tensor:
    """keys [T, 2], mask [T, N] → int32 [T, num] candidate indices, one
    threefry uniform per draw (:func:`inverse_cdf_draws`)."""
    return inverse_cdf_draws(mask, uniform(keys, (num,)))


def inverse_cdf_draws(mask: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """mask [T, N], uniforms u [T, num] → int32 [T, num].

    Draw ``i`` of task ``t`` takes rank ``min(floor(u·kk), kk-1) + 1``
    among the ``kk`` admissible servers (``kk = N`` when none is), and
    returns the position where the inclusive prefix count first reaches
    that rank."""
    n = mask.shape[-1]
    cnt = torch.cumsum(mask.to(torch.int32), dim=-1, dtype=torch.int32)
    k = cnt[:, -1]
    any_ok = k > 0
    iota = torch.arange(1, n + 1, dtype=torch.int32, device=mask.device)
    eff_cnt = torch.where(any_ok[:, None], cnt, iota[None, :])
    kk = torch.where(any_ok, k, torch.full_like(k, n))
    tgt = torch.minimum((u * kk.to(torch.float32)[:, None]).to(torch.int32),
                        (kk - 1)[:, None]) + 1
    # #positions whose prefix count is still below the rank.
    idx = torch.searchsorted(eff_cnt.contiguous(), tgt.contiguous(),
                             side="left")
    return idx.to(torch.int32)


def sample_feasible(key: torch.Tensor, mask: torch.Tensor,
                    num: int) -> torch.Tensor:
    """One task: key [2], mask [N] → int32 [num]."""
    return sample_feasible_batch(key[None], mask[None], num)[0]
