"""Public SSD wrappers: the chunk kernel K8 (``ssd_chunk``), the chunked
SSD around it (``ssd``: chunking, the inter-chunk state scan and the h_in
correction, as torch ops like the reference's ``ops.py``) and the
one-token update (``ssd_decode_step``, plain torch: the reference has no
kernel for it either).

``ssd_chunk`` sends tensors on the CPU to the plain version (``ref.py``),
which autograd differentiates as it is; CUDA tensors are checked and go
to the kernel, or the call raises — there is no fallback.  Each call
that reaches the card counts one ``"ssd_chunk"`` in ``LAUNCHES``.  The
kernel's block takes a run of ``nh`` heads of one group in one chunk;
``plan_k8`` picks ``nh`` and ``k8_blocks`` states the grid the kernel
walks.

Gradients.  On the card a call made while grad mode is on, with any input
requiring grad, goes through ``SSDChunk`` (a ``torch.autograd.Function``):
its forward is K8, and its backward K8's hand-written backward
(``ssd_chunk_bwd``, counted as ``"ssd_chunk_bwd"``), on the grid of the
same blocks with ``plan_k8_bwd``'s ``nh``; dB and dC sum over a group's
heads in head order inside a block and over the runs of blocks in run
order.  The inter-chunk scan and the h_in correction in ``ssd`` are torch
ops, which autograd differentiates.
"""
from __future__ import annotations

import torch

from .._wrap import LAUNCHES, check, device_of, sm_count
from .kernel import launch_ssd_chunk, launch_ssd_chunk_bwd
from .ref import ssd_chunk_bwd_ref, ssd_chunk_ref

#: The largest chunk, head width and state width the kernel takes.
MAX_Q, MAX_P, MAX_S = 64, 64, 128
#: A K8 block is two teams of 8 warps that split its run of heads; its
#: shared memory (156 672 bytes at Q = 64) leaves room for one block an SM.
K8_TEAMS = 2
#: A block's C·Bᵀ triangle in units of one head's work: Q²S/2 against
#: QSP + Q²P/2 multiply-adds at mamba2-1.3b's Q = 64, P = 64, S = 128.
K8_CB_COST = 0.4
#: Team 1 starts after team 0's first scan, G_h and y: about half a head.
K8_OFFSET_COST = 0.5
#: The backward block's own work in units of one head's, on the tensor
#: cores (``ssd_chunk.cu``'s 16 warps, m16n8k8 MMAs three at a time): C·Bᵀ
#: (960 MMAs) and dC = ΣZ·B, dB = ΣZᵀ·C once a run (1 920) against a
#: head's dy·xᵀ and Gᵀ·dy on the triangle, x·dHᵀ and B·dH (4 032): 0.71
#: at mamba2-1.3b, plus the loads of B, C and the first head, which no
#: head's work hides, and C's second read: 1.
K8_BWD_BLOCK_COST = 1.0


def plan_k8(B: int, G: int, NC: int, hpg: int, sms: int) -> int:
    """Heads of a group per K8 block, 1 ≤ nh ≤ hpg: the nh that minimises
    waves × (⌈nh / K8_TEAMS⌉ + K8_CB_COST + K8_OFFSET_COST if both teams
    have heads), where a wave is one block on each of the card's ``sms``
    SMs and the grid holds B·G·NC·⌈hpg/nh⌉ blocks; ties go to the larger
    nh.  At mamba2-1.3b's B = 2, L = 1024 on 132 SMs: nh = 16, 128 blocks
    in one wave, 8 heads a team; at the reference's pins nh = 1."""
    cells = B * G * NC

    def cost(nh):
        waves = -(-cells * -(-hpg // nh) // sms)
        block = -(-nh // K8_TEAMS) + K8_CB_COST + (K8_OFFSET_COST
                                                    if nh > 1 else 0.0)
        return waves * block, -nh

    return min(range(1, hpg + 1), key=cost)


def k8_blocks(B: int, G: int, NC: int, hpg: int, nh: int) -> list:
    """K8's grid in launch order, as ``ssd_chunk.cu`` maps ``blockIdx.x``:
    (b, g, chunk, first head, end head) of each block; a group's last run
    is short when nh does not divide hpg.  A block's first ⌈run / 2⌉ heads
    go to its team 0, the rest to team 1."""
    nblk = -(-hpg // nh)
    return [(bgc // (G * NC), bgc // NC % G, bgc % NC, hb * nh,
             min(hb * nh + nh, hpg))
            for bgc in range(B * G * NC) for hb in range(nblk)]


def plan_k8_bwd(B: int, G: int, NC: int, hpg: int, sms: int) -> int:
    """Heads of a group per block of K8's backward, 1 ≤ nh ≤ hpg: the nh
    that minimises waves × (nh + ``K8_BWD_BLOCK_COST``), a wave being one
    block on each of the ``sms`` SMs over B·G·NC·⌈hpg/nh⌉ blocks; ties go
    to the larger nh (fewer runs to add).  At mamba2-1.3b's B = 2, L =
    1024 on 132 SMs: nh = 16, 128 blocks in one wave, 4 runs a group."""
    cells = B * G * NC

    def cost(nh):
        waves = -(-cells * -(-hpg // nh) // sms)
        return waves * (nh + K8_BWD_BLOCK_COST), -nh

    return min(range(1, hpg + 1), key=cost)


def _check_operands(fn, x, delta, dtv, Bm, Cm, hpg):
    """K8's operand checks (shapes, dtypes, contiguity, the kernel's
    widths); returns (BH, NC, Q, P, B, G, S)."""
    BH, NC, Q, P = x.shape
    Bb, G, _, _, S = Bm.shape
    if Bb < 1 or BH % Bb or (BH // Bb) != G * hpg:
        raise ValueError(f"{fn}: BH={BH} is not B·G·heads_per_group = "
                         f"{Bb}·{G}·{hpg}")
    if not (1 <= Q <= MAX_Q and 1 <= P <= MAX_P and 1 <= S <= MAX_S):
        raise ValueError(f"{fn}: the kernel takes Q ≤ {MAX_Q}, P ≤ "
                         f"{MAX_P}, S ≤ {MAX_S}; got Q={Q}, P={P}, S={S}")
    f32 = torch.float32
    check("x", x, f32, (BH, NC, Q, P))
    check("delta", delta, f32, (BH, NC, Q))
    check("dtv", dtv, f32, (BH, NC, Q))
    check("Bm", Bm, f32, (Bb, G, NC, Q, S))
    check("Cm", Cm, f32, (Bb, G, NC, Q, S))
    return BH, NC, Q, P, Bb, G, S


def _launch(x, delta, dtv, Bm, Cm, hpg):
    """K8 on checked CUDA operands: one counted call."""
    BH, NC, Q, P, Bb, G, S = _check_operands("ssd_chunk", x, delta, dtv,
                                             Bm, Cm, hpg)
    f32, device = torch.float32, x.device
    y = torch.empty((BH, NC, Q, P), dtype=f32, device=device)
    Hs = torch.empty((BH, NC, S, P), dtype=f32, device=device)
    exp_s = torch.empty((BH, NC, Q), dtype=f32, device=device)
    nh = plan_k8(Bb, G, NC, hpg, sm_count(device))
    launch_ssd_chunk(x, delta, dtv, Bm, Cm, y, Hs, exp_s,
                     heads_per_group=hpg, nh=nh)
    LAUNCHES["ssd_chunk"] += 1
    return y, Hs, exp_s


class SSDChunk(torch.autograd.Function):
    """K8 with its hand-written backward, for checked CUDA float32
    operands.  Saves the forward's inputs; the backward recomputes s and
    C·Bᵀ."""

    @staticmethod
    def forward(ctx, x, delta, dtv, Bm, Cm, hpg):
        out = _launch(x, delta, dtv, Bm, Cm, hpg)
        ctx.save_for_backward(x, delta, dtv, Bm, Cm)
        ctx.hpg = hpg
        return out

    @staticmethod
    def backward(ctx, dy, dH, des):
        x, delta, dtv, Bm, Cm = ctx.saved_tensors
        grads = ssd_chunk_bwd(x, delta, dtv, Bm, Cm, dy, dH, des,
                              heads_per_group=ctx.hpg)
        return (*grads, None)


def ssd_chunk_bwd(x, delta, dtv, Bm, Cm, dy, dH, des, *,
                  heads_per_group: int):
    """The gradients (dx, ddelta, ddt, dB, dC) of ``ssd_chunk`` at its
    inputs for the output gradients dy [BH, NC, Q, P], dH [BH, NC, S, P]
    and des [BH, NC, Q] (see ``ref.ssd_chunk_bwd_ref``), float32; dB and dC
    [B, G, NC, Q, S] sum over each group's heads.  On the CPU the plain
    version; on the card K8's backward (one counted ``"ssd_chunk_bwd"``
    call: one launch, and a second that adds the runs when
    ``plan_k8_bwd`` gives more than one)."""
    hpg = heads_per_group
    device = device_of("ssd_chunk_bwd", (x, delta, dtv, Bm, Cm, dy, dH, des))
    if device.type == "cpu":
        return ssd_chunk_bwd_ref(x, delta, dtv, Bm, Cm, dy, dH, des,
                                 heads_per_group=hpg)
    BH, NC, Q, P, Bb, G, S = _check_operands("ssd_chunk_bwd", x, delta, dtv,
                                             Bm, Cm, hpg)
    f32 = torch.float32
    dy, dH, des = (t.to(f32).contiguous() for t in (dy, dH, des))
    check("dy", dy, f32, (BH, NC, Q, P))
    check("dH", dH, f32, (BH, NC, S, P))
    check("des", des, f32, (BH, NC, Q))
    dx = torch.empty_like(x)
    ddelta = torch.empty_like(delta)
    ddt = torch.empty_like(dtv)
    dB = torch.empty_like(Bm)
    dC = torch.empty_like(Cm)
    nh = plan_k8_bwd(Bb, G, NC, hpg, sm_count(device))
    runs = -(-hpg // nh)
    part = (torch.empty(2 * runs * Bm.numel(), dtype=f32, device=device)
            if runs > 1 else None)
    launch_ssd_chunk_bwd(x, delta, dtv, Bm, Cm, dy, dH, des, dx, ddelta, ddt,
                         dB, dC, part, heads_per_group=hpg, nh=nh)
    LAUNCHES["ssd_chunk_bwd"] += 1
    return dx, ddelta, ddt, dB, dC


def ssd_chunk(x, delta, dtv, Bm, Cm, *, heads_per_group: int):
    """The SSD intra-chunk block (see ``ref.ssd_chunk_ref``): x [BH, NC, Q,
    P], delta/dtv [BH, NC, Q], Bm/Cm [B, G, NC, Q, S], all float32 →
    (y_intra [BH,NC,Q,P], H_out [BH,NC,S,P], exp_s [BH,NC,Q]).  On the
    card Q ≤ 64, P ≤ 64 and S ≤ 128 (any Q, so a sequence shorter than a
    chunk is one short chunk), and a call that needs a gradient goes
    through ``SSDChunk`` (K8's backward)."""
    device = device_of("ssd_chunk", (x, delta, dtv, Bm, Cm))
    if device.type == "cpu":
        return ssd_chunk_ref(x, delta, dtv, Bm, Cm,
                             heads_per_group=heads_per_group)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, delta, dtv, Bm, Cm)):
        return SSDChunk.apply(x, delta, dtv, Bm, Cm, heads_per_group)
    return _launch(x, delta, dtv, Bm, Cm, heads_per_group)


def ssd(x, dt, A, B, C, h0=None, *, chunk: int = 64):
    """Chunked SSD with the oracle's signature (see ``ref.ssd_ref``): x
    [B,L,H,P], dt [B,L,H], A [H], B/C [B,L,G,S].  L must be a multiple of
    ``chunk`` (the model layer pads sequences).  Returns (y [B,L,H,P],
    h [B,H,S,P] float32).  On the card a call that needs a gradient
    through x, dt, A, B or C takes K8's backward for the intra-chunk
    block (``SSDChunk``) and autograd for the torch ops around it; ``h0``
    enters through torch ops only."""
    Bb, L, H, P = x.shape
    G, S = B.shape[2], B.shape[3]
    if L % chunk:
        raise ValueError(f"ssd: L={L} is not a multiple of chunk={chunk}")
    NC = L // chunk
    hpg = H // G
    f32 = torch.float32

    # Layouts for the kernel: heads into the batch dim, chunked time.
    xk = x.transpose(1, 2).reshape(Bb * H, NC, chunk, P)
    dtk = dt.transpose(1, 2).reshape(Bb * H, NC, chunk)
    delta = dtk * A.repeat(Bb)[:, None, None]          # A·dt per (b·H+h)
    Bk = B.transpose(1, 2).reshape(Bb, G, NC, chunk, S)
    Ck = C.transpose(1, 2).reshape(Bb, G, NC, chunk, S)
    y_intra, H_out, exp_s = ssd_chunk(
        *(t.to(f32).contiguous() for t in (xk, delta, dtk, Bk, Ck)),
        heads_per_group=hpg)

    # Inter-chunk state recurrence: h_c = decay_c · h_{c-1} + H_out_c, with
    # decay_c = exp(Σ chunk deltas) = exp_s[..., -1]; keep the incoming
    # state of every chunk.
    h = (torch.zeros((Bb * H, S, P), dtype=f32, device=x.device)
         if h0 is None else h0.reshape(Bb * H, S, P).to(f32))
    decays = exp_s[:, :, -1, None, None]                # [BH, NC, 1, 1]
    h_in = []
    for c in range(NC):
        h_in.append(h)
        h = decays[:, c] * h + H_out[:, c]
    h_in = torch.stack(h_in, dim=1)                      # [BH, NC, S, P]

    # h_in correction: y_state[t] = exp(s_t) · C_t · h_in(chunk); C is per
    # group, so heads fold as [B, G, hpg, ...] instead of repeating it.
    y_state = torch.einsum("bgnqs,bghnsp->bghnqp", Ck.to(f32),
                           h_in.reshape(Bb, G, hpg, NC, S, P))
    y_state = y_state.reshape(Bb * H, NC, chunk, P) * exp_s[..., None]
    y = (y_intra + y_state).reshape(Bb, H, L, P).transpose(1, 2)
    return y.to(x.dtype), h.reshape(Bb, H, S, P)


def ssd_decode_step(x_t, dt_t, A, B_t, C_t, h):
    """Single-token SSD update (serving): x_t [B,H,P], dt_t [B,H], A [H],
    B_t/C_t [B,G,S], h [B,H,S,P] → (y_t [B,H,P], h')."""
    H = x_t.shape[1]
    rep = H // B_t.shape[1]
    Bh = B_t.repeat_interleave(rep, dim=1)        # [B,H,S]
    Ch = C_t.repeat_interleave(rep, dim=1)
    decay = torch.exp(A[None, :] * dt_t)          # [B,H]
    h = (decay[..., None, None] * h
         + dt_t[..., None, None] * Bh[..., None] * x_t[:, :, None, :])
    y = torch.einsum("bhs,bhsp->bhp", Ch, h)
    return y, h
