"""Plain-torch versions for Mamba-2's SSD layer.

``ssd_ref`` is the literal linear recurrence (the reference's oracle).
State h [S, P] per (batch, head); per step t:

    h_t = exp(A·dt_t) · h_{t-1} + dt_t · B_t xᵀ_t        (outer product)
    y_t = C_t · h_t

A is a per-head negative scalar; B, C are shared across head groups (G
groups, like GQA for state space models).

``ssd_chunk_ref`` is the plain version of the SSD chunk kernel K8: what the
reference's Pallas ``_kernel`` computes per (batch·head, chunk).  The
wrapper runs it for tensors on the CPU; ``chip_smoke.py`` holds the CUDA
kernel against it on the card.  ``ssd_chunk_bwd_ref`` is the plain
version of K8's backward, written out rather than taken by autograd; the
tests hold it against autograd through ``ssd_chunk_ref``.
"""
from __future__ import annotations

import torch


def ssd_ref(x, dt, A, B, C, h0=None):
    """x [B,L,H,P]; dt [B,L,H] (>0, post-softplus); A [H] (<0);
    B, C [B,L,G,S] with H divisible by G.

    Returns (y [B,L,H,P], h_final [B,H,S,P])."""
    Bb, L, H, P = x.shape
    G, S = B.shape[2], B.shape[3]
    rep = H // G
    Bh = B.repeat_interleave(rep, dim=2)         # [B,L,H,S]
    Ch = C.repeat_interleave(rep, dim=2)
    h = (torch.zeros((Bb, H, S, P), dtype=x.dtype, device=x.device)
         if h0 is None else h0)
    ys = []
    for t in range(L):
        dtt = dt[:, t, :, None, None]
        h = (torch.exp(A[None, :, None, None] * dtt) * h
             + dtt * (Bh[:, t, :, :, None] * x[:, t, :, None, :]))
        ys.append(torch.einsum("bhs,bhsp->bhp", Ch[:, t], h))
    return torch.stack(ys, dim=1), h


def ssd_chunk_ref(x, delta, dtv, Bm, Cm, *, heads_per_group: int):
    """The SSD intra-chunk block.  x [BH, NC, Q, P]; delta (= A·dt) and
    dtv [BH, NC, Q]; Bm/Cm [B, G, NC, Q, S]; BH = B·H with heads fastest
    (bh = b·H + h), and bh reads B and C of group ``(bh % H) //
    heads_per_group`` of batch ``bh // H``.  Per (bh, chunk):

        s_t        = Σ_{u≤t} delta_u                    (cumulative log-decay)
        y_intra[t] = Σ_{u≤t} exp(s_t−s_u)·dt_u·(C_t·B_u)·x_u
        H_out      = Σ_u exp(s_Q−s_u)·dt_u·B_uᵀ x_u      ([S, P] chunk state)
        exp_s[t]   = exp(s_t)

    Returns (y_intra [BH,NC,Q,P], H_out [BH,NC,S,P], exp_s [BH,NC,Q]),
    float32."""
    BH, NC, Q, P = x.shape
    Bb = Bm.shape[0]
    H = BH // Bb
    bh = torch.arange(BH, device=x.device)
    b_idx, g_idx = bh // H, (bh % H) // heads_per_group
    Bc = Bm[b_idx, g_idx]                           # [BH, NC, Q, S]
    Cc = Cm[b_idx, g_idx]
    s = torch.cumsum(delta, dim=-1)                 # [BH, NC, Q] inclusive
    # diff ≤ 0 on the valid (u ≤ t) triangle; clamp the masked region so
    # exp never overflows.
    diff = torch.clamp(s[..., :, None] - s[..., None, :], max=0.0)
    tri = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    M = torch.where(tri, torch.exp(diff), torch.zeros((), device=x.device))
    CB = torch.einsum("nctk,ncuk->nctu", Cc, Bc)    # [BH, NC, Q, Q]
    Gm = CB * M * dtv[..., None, :]
    y = torch.einsum("nctu,ncup->nctp", Gm, x)
    w = torch.exp(s[..., -1:] - s) * dtv            # [BH, NC, Q]
    Hc = torch.einsum("ncus,ncup->ncsp", Bc * w[..., None], x)
    return y, Hc, torch.exp(s)


def ssd_chunk_bwd_ref(x, delta, dtv, Bm, Cm, dy, dH, des, *,
                      heads_per_group: int):
    """The gradients of ``ssd_chunk_ref`` for the output gradients dy
    [BH, NC, Q, P], dH [BH, NC, S, P] and des [BH, NC, Q], written out.
    Per (bh, chunk), with s = cumsum(delta), M[t, u] = exp(min(s_t − s_u,
    0))·[u ≤ t], CB = C Bᵀ, G = CB ⊙ M ⊙ dt_u, w = exp(s_{Q−1} − s) ⊙ dt:

        dG = dy xᵀ on the triangle,  F = dG ⊙ M,  Z = F ⊙ dt_u,
        dx = Gᵀ dy + w ⊙ (B dH),
        dC = Z B,  dB = Zᵀ C + w ⊙ (x dHᵀ),
        dw = rowsum(B ⊙ x dHᵀ),  ddt = colsum(F ⊙ CB) + dw ⊙ exp(s_{Q−1} − s),
        ds_t = Σ_{u<t} E[t, u] − Σ_{t'>t} E[t', t] + des_t·exp(s_t)
               + [t = Q−1]·Σ_{u<Q−1} w_u dw_u − [t < Q−1]·w_t dw_t,

    with E = Z ⊙ CB strictly below the diagonal (M's row and column
    terms; on the diagonal they cancel), and ddelta the reverse cumulative
    sum of ds.  dB and dC sum over the heads of each group.  Returns (dx,
    ddelta, ddt, dB [B, G, NC, Q, S], dC), float32."""
    BH, NC, Q, P = x.shape
    Bb, G = Bm.shape[0], Bm.shape[1]
    S = Bm.shape[4]
    H = BH // Bb
    hpg = heads_per_group
    bh = torch.arange(BH, device=x.device)
    b_idx, g_idx = bh // H, (bh % H) // hpg
    Bc = Bm[b_idx, g_idx]                           # [BH, NC, Q, S]
    Cc = Cm[b_idx, g_idx]
    s = torch.cumsum(delta, dim=-1)
    tri = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    below = tri.tril(-1)
    zero = torch.zeros((), device=x.device)
    diff = torch.clamp(s[..., :, None] - s[..., None, :], max=0.0)
    M = torch.where(tri, torch.exp(diff), zero)
    CB = torch.einsum("nctk,ncuk->nctu", Cc, Bc)
    dt_u = dtv[..., None, :]
    dG = torch.where(tri, torch.einsum("nctp,ncup->nctu", dy, x), zero)
    F = dG * M
    Z = F * dt_u
    Gm = CB * M * dt_u
    e = torch.exp(s[..., -1:] - s)
    w = e * dtv
    XdH = torch.einsum("ncup,ncsp->ncus", x, dH)    # [BH, NC, Q, S]
    dw = (Bc * XdH).sum(dim=-1)
    dx = (torch.einsum("nctu,nctp->ncup", Gm, dy)
          + w[..., None] * torch.einsum("ncus,ncsp->ncup", Bc, dH))
    dC_h = torch.einsum("nctu,ncus->ncts", Z, Bc)
    dB_h = (torch.einsum("nctu,ncts->ncus", Z, Cc)
            + w[..., None] * XdH)
    dB = dB_h.reshape(Bb, G, hpg, NC, Q, S).sum(dim=2)
    dC = dC_h.reshape(Bb, G, hpg, NC, Q, S).sum(dim=2)
    FCB = F * CB
    ddt = FCB.sum(dim=-2) + dw * e
    E = torch.where(below, FCB * dt_u, zero)
    wdw = w * dw
    ds = E.sum(dim=-1) - E.sum(dim=-2) + des * torch.exp(s)
    last = wdw[..., :-1].sum(dim=-1, keepdim=True)
    ds = ds - torch.cat([wdw[..., :-1], -last], dim=-1)
    ddelta = torch.flip(torch.cumsum(torch.flip(ds, (-1,)), dim=-1), (-1,))
    return dx, ddelta, ddt, dB, dC
