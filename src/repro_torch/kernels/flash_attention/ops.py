"""Public wrapper of the flash-attention kernel K7.

``flash_attention`` keeps the JAX wrapper's signature without its
``block_q``/``block_k``/``interpret`` knobs.  The JAX wrapper left-pads
queries and keys to block multiples and loops over the query heads of a
GQA group; the CUDA kernel masks its own ragged edge and maps query head
``h`` to key/value head ``h // rep`` inside one launch, so neither is
carried over.  Tensors on the CPU go to the plain version (``ref.py``);
CUDA tensors are checked and go to the kernel, or the call raises — there
is no fallback.  Each call that reaches the card counts one
``"flash_attention"`` in ``LAUNCHES``, whether the plan gives it one CUDA
launch or two.

``plan_k7`` picks the kernel's regime: groups of more than 16 rows (H /
Hkv · Lq, a prefill) go to the tensor-core kernel; smaller ones (a
decode) to the split kernel, whose keys are cut into ``splits`` runs
(``k7_split_ranges``) that a second launch merges when there is more than
one.

Gradients.  On the card a call made while grad mode is on, with any of q,
k, v requiring grad, goes through ``FlashAttention`` (a
``torch.autograd.Function``): its forward is K7's tensor-core kernel at
any group size, which then also writes each row's log2-sum-exp (the
split kernel writes none, so a grad call of at most 16 rows a group
takes the tensor-core kernel too), and its backward the hand-written
backward kernels given that lse and the output (``flash_attention_bwd``,
counted as ``"flash_attention_bwd"``; Δ = rowsum(dO ∘ o) comes from the
saved output, which the forward accumulates without bias).
``flash_attention_lse`` returns the output (unrounded in float32) and
the lse of one such forward.  The backward takes float32 operands at
every head width (at 256 with tiles of its own: 32 keys a dk/dv block and
32 rows a dq block, each walking raw tiles of 16, D split over warps) and
bfloat16 ones at ``BWD_BF16_HEAD_DIMS`` (a train step under
``precision.options(dtype=bf16)``: its forward also writes the output
unrounded in float32, which Δ is taken from, and dq, dk, dv come back in
bfloat16, rounded once).  The bfloat16 operands have passes of their own
on the bf16 tensor cores (``plan_k7_bwd_bf16`` gives their tiles,
``plan_k7_bwd(..., bf16=True)`` the dk/dv pass's runs).  A
grad-requiring call it does not take (bf16 at head width 256, q, k, v of
mixed dtypes, or ``kv_last``, which is decode only) raises before any
launch, never quietly differentiating the plain
form or widening to float32.  On the CPU the plain form differentiates
under autograd as it is.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .._wrap import LAUNCHES, device_of, sm_count
from .kernel import launch_flash_attention, launch_flash_attention_bwd
from .ref import attention_bwd_ref, attention_lse_ref, attention_ref

#: The head widths the kernel is built for.
HEAD_DIMS = (32, 64, 128, 256)
#: The head widths the backward kernels take float32 operands at.
BWD_HEAD_DIMS = (32, 64, 128, 256)
#: The head widths they take bfloat16 operands at: every width of a family
#: that honours ``precision``'s compute dtype (dense, MoE, VLM: 64 or 128;
#: 32 in the smoke copies).  recurrentgemma-2b's 256 trains in float32 in
#: both packages, so its bf16 form is not built.
BWD_BF16_HEAD_DIMS = (32, 64, 128)
#: The backward's dk/dv pass cuts a group's flattened rows (H / Hkv · Lq)
#: into runs of at most this many, one block per (key tile, run), and
#: adds the runs' partial sums in a fixed order.  ``plan_k7_bwd`` alone
#: decides: the kernel cuts the rows into the runs it is given.
K7_BWD_RUN_ROWS = 1024
#: The same at D = 256, whose dk/dv blocks hold 32 keys instead of 64.
K7_BWD_RUN_ROWS_WIDE = 4096
#: The same for bfloat16 operands, by head width: each run writes its
#: float32 partial dK, dV, and the bf16 passes take a run's rows faster,
#: so longer runs: at tinyllama-1.1b's prefill 707–718 µs with runs of
#: 1 024 rows, 662–665 with 4 096 (two runs); at qwen3-moe's 2 002–2 005
#: with 1 024, 1 951–1 952 with 2 048, 2 003–2 007 with 4 096
#: (``tools/ablate_flash_attention.py --backward --bf16``, an H100 80GB
#: HBM3 at 700 W).
K7_BWD_BF16_RUN_ROWS = {32: 4096, 64: 4096, 128: 2048}
#: Flattened rows a block of the backward's dq pass; each group's rows of
#: its (lse, Δ) scratch are padded to a multiple of this.
K7_BWD_ROWS = 64
DTYPES = (torch.float32, torch.bfloat16)


class K7BwdBf16Tiles(NamedTuple):
    """The blocks of the bf16 backward's passes at one head width
    (``flash_attention.cu``, "backward on bf16 operands"): 4 warps a
    block; the dk/dv pass holds ``keys`` keys and walks its run's rows
    ``rows`` a tile, the dq pass holds ``dq_rows`` rows and walks their
    keys ``dq_keys`` a tile; each pass's dynamic shared memory in bytes
    (bf16 tiles, the walked one in two buffers)."""
    keys: int
    rows: int
    dq_rows: int
    dq_keys: int
    smem_dkdv: int
    smem_dq: int


def plan_k7_bwd_bf16(D: int) -> K7BwdBf16Tiles:
    """The bf16 backward's tiles at head width D (32, 64 or 128): rows a
    dk/dv tile 32 at D ≤ 64 and 16 at 128, where a warp's dK and dV take
    128 registers, and keys a dq tile 64 at D ≤ 64 and 32 at 128; 64 keys
    a dk/dv block and 64 rows a dq block.  At least two blocks an SM by
    shared memory at each width (16 896 / 33 280 / 49 408 B dk/dv,
    24 576 / 49 152 / 65 536 B dq)."""
    if D not in BWD_BF16_HEAD_DIMS:
        raise ValueError(f"plan_k7_bwd_bf16: head widths "
                         f"{BWD_BF16_HEAD_DIMS}, got {D}")
    keys, dq_rows = 64, 64
    rows, dq_keys = (32, 64) if D <= 64 else (16, 32)
    return K7BwdBf16Tiles(
        keys, rows, dq_rows, dq_keys,
        smem_dkdv=2 * keys * D * 2 + 2 * 2 * rows * D * 2 + 2 * rows * 8,
        smem_dq=2 * dq_rows * D * 2 + 2 * 2 * dq_keys * D * 2)
#: Keys a tile of the split kernel; its runs are whole tiles.
K7_TILE = 64
#: The most rows (H / Hkv · Lq) a group may have for the split kernel.
K7_SPLIT_ROWS = 16
#: A group walks up to this many key tiles in one block.  Fitted to
#: chip_smoke's split sweep (phase 16) on an H100 80GB HBM3 at 700 W, a
#: tile's walk costs 2–2.6 µs and the second launch that merges the runs
#: ~3.2 µs, so a split pays from three tiles on.
K7_SERIAL_TILES = 2


class K7Plan(NamedTuple):
    """How one call runs: ``regime`` "prefill" (the tensor-core kernel,
    64 rows a block) or "decode" (the split kernel, a group's rows in one
    block per run), and the runs of keys a group is cut into."""
    regime: str
    splits: int


def k7_visible(Lq: int, Lk: int, window) -> tuple:
    """The keys [lo, hi) that any row of a group may see, its queries at
    the Lq right-aligned positions (causal or not, the last query sees up
    to key Lk − 1)."""
    lo = max(0, Lk - Lq - window + 1) if window else 0
    return lo, Lk


def k7_split_ranges(lo: int, hi: int, splits: int) -> list:
    """The runs [s_lo, s_hi) of the split kernel, as ``split_range`` in
    ``flash_attention.cu`` cuts them: ceil(tiles / splits) whole 64-key
    tiles each from ``lo``, the last ragged, runs past ``hi`` empty."""
    tiles = -(-(hi - lo) // K7_TILE)
    per = -(-tiles // splits)
    out = []
    for s in range(splits):
        s_lo = min(hi, lo + s * per * K7_TILE)
        out.append((s_lo, min(hi, s_lo + per * K7_TILE)))
    return out


def plan_k7(B: int, H: int, Hkv: int, Lq: int, Lk: int, window,
            sms: int) -> K7Plan:
    """The regime and the split count of one call on a card of ``sms``
    SMs.  More than ``K7_SPLIT_ROWS`` rows a group: "prefill", one run.
    Otherwise "decode": one run where the B·Hkv groups alone fill the card
    or the visible keys are at most ``K7_SERIAL_TILES`` tiles (Lk ≤ 128
    without a window); else enough runs for about two blocks an SM, at
    least one tile each, rebalanced so that no run is empty.  At
    tinyllama-1.1b's decode (B = 4, Hkv = 4, Lk = 1024) on 132 SMs: 16
    runs of 64 keys, 256 blocks; at the reference's decode pin (one
    group, Lk = 384): 6 runs."""
    rep = H // Hkv
    if rep * Lq > K7_SPLIT_ROWS:
        return K7Plan("prefill", 1)
    groups = B * Hkv
    lo, hi = k7_visible(Lq, Lk, window)
    tiles = -(-(hi - lo) // K7_TILE)
    if groups >= sms or tiles <= K7_SERIAL_TILES:
        return K7Plan("decode", 1)
    splits = min(tiles, -(-2 * sms // groups))
    per = -(-tiles // splits)
    return K7Plan("decode", -(-tiles // per))


def plan_k7_bwd(H: int, Hkv: int, Lq: int, D: int = 64,
                bf16: bool = False) -> int:
    """The runs of rows of the backward's dk/dv pass: ⌈H / Hkv · Lq /
    ``K7_BWD_RUN_ROWS``⌉ (8 at tinyllama-1.1b's prefill, 16 at
    qwen3-moe's), and at D = 256 ⌈H / Hkv · Lq / ``K7_BWD_RUN_ROWS_WIDE``⌉
    (10 at recurrentgemma-2b's 4 096 positions); for bfloat16 operands
    (``bf16``) by ``K7_BWD_BF16_RUN_ROWS`` (2 at tinyllama-1.1b's, 8 at
    qwen3-moe's).  Under a causal mask one block a key tile would make the
    first tiles, which every row sees, the pass's critical path."""
    if bf16:
        per = K7_BWD_BF16_RUN_ROWS[D]
    else:
        per = K7_BWD_RUN_ROWS_WIDE if D > 128 else K7_BWD_RUN_ROWS
    return max(1, -(-(H // Hkv) * Lq // per))


def check_causal_rows(fn: str, causal: bool, Lq: int, Lk: int) -> None:
    """Raise for a causal call with more queries than keys: its first
    Lq − Lk query rows have no valid key, where the reference's two forms
    disagree (mean of v, or NaN) and the kernel would give 0."""
    if causal and Lq > Lk:
        raise ValueError(f"{fn}: causal attention needs Lq ≤ Lk (queries "
                         f"are right-aligned against the keys), got Lq={Lq}"
                         f" > Lk={Lk}")


def _plain(q, k, v, *, causal, window, scale, kv_last):
    """The plain version: keys and values cast to q's dtype, the last row
    replaced, then the dense oracle."""
    if kv_last is not None:
        k = torch.cat([k[:, :, :-1].to(q.dtype), kv_last[0]], dim=2)
        v = torch.cat([v[:, :, :-1].to(q.dtype), kv_last[1]], dim=2)
    return attention_ref(q, k.to(q.dtype), v.to(q.dtype), causal=causal,
                         window=window, scale=scale)


def _check(fn: str, q, k, v, causal, window, kv_last):
    """The device of a call, after the checks every device makes (shapes,
    causal rows, kv_last) and, on the card, the kernel's own (head width,
    dtypes, unit stride along D, window ≥ 1)."""
    operands = (q, k, v) + (tuple(kv_last) if kv_last is not None else ())
    device = device_of(fn, operands)
    B, H, Lq, D = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != B or \
            k.shape[3] != D:
        raise ValueError(f"{fn}: k and v must be [B, Hkv, Lk, D] "
                         f"= [{B}, ·, ·, {D}], got {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    Hkv = k.shape[1]
    check_causal_rows(fn, causal, Lq, k.shape[2])
    if kv_last is not None:
        want = (B, Hkv, 1, D)
        if any(tuple(t.shape) != want or t.dtype != q.dtype
               for t in kv_last):
            raise ValueError(f"{fn}: kv_last must be two "
                             f"{list(want)} tensors of q's dtype {q.dtype}")
    if device.type == "cpu":
        return device
    if Hkv < 1 or H % Hkv:
        raise ValueError(f"{fn}: H={H} is not a multiple of Hkv={Hkv}")
    if D not in HEAD_DIMS:
        raise ValueError(f"{fn}: the kernel takes head widths "
                         f"{HEAD_DIMS}, got {D}")
    if q.dtype not in DTYPES or k.dtype not in DTYPES or v.dtype != k.dtype:
        raise TypeError(f"{fn}: q and k, v (one dtype) must each "
                        f"be in {DTYPES}, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if any(t.stride(3) != 1 for t in operands):
        raise ValueError(f"{fn}: q, k, v and kv_last need unit "
                         "stride along D")
    if window is not None and window < 1:
        raise ValueError(f"{fn}: window must be ≥ 1, got {window}")
    return device


def flash_attention(q, k, v, *, causal: bool = True, window=None,
                    scale=None, kv_last=None):
    """Flash attention with the oracle's signature: q [B, H, Lq, D],
    k/v [B, Hkv, Lk, D] (H divisible by Hkv).  Returns [B, H, Lq, D] in
    q's dtype.  Queries are right-aligned against the keys (prefill with
    Lq = Lk and decode with Lq = 1 against a cache are the same call);
    ``window`` restricts query position i to keys (i − window, i].  q is
    float32 or bfloat16 and k, v share either dtype: they are read in q's
    dtype, as the reference reads its cache in the activations' dtype, and
    accumulated in float32.  ``kv_last``: None, or (k_last, v_last)
    [B, Hkv, 1, D] in q's dtype, which take the place of key and value
    Lk − 1 (a decode step's own key and value, unrounded, over a cache of
    another dtype).  On the card D is 32, 64, 128 or 256, and every operand
    must have unit stride along D (a slice of a preallocated cache is read
    where it lies).  A causal call with Lq > Lk would leave its first
    queries no key to attend to; it raises ``ValueError`` on every device,
    before it dispatches."""
    device = _check("flash_attention", q, k, v, causal, window, kv_last)
    scale = scale if scale is not None else q.shape[3] ** -0.5
    needs_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    if needs_grad and kv_last is not None:
        raise NotImplementedError("flash_attention: kv_last is decode only; "
                                  "a call with it has no backward")
    if device.type == "cpu":
        return _plain(q, k, v, causal=causal, window=window, scale=scale,
                      kv_last=kv_last)
    if needs_grad:
        check_backward(q, k, v)
        return FlashAttention.apply(q, k, v, causal, window, scale)
    return _launch(q, k, v, causal=causal, window=window, scale=scale,
                   kv_last=kv_last)


def flash_attention_lse(q, k, v, *, causal: bool = True, window=None,
                        scale=None):
    """``flash_attention``'s output unrounded in float32 and each query
    row's log2-sum-exp of its logits scaled by scale·log₂ e (float32
    [B, H, Lq]): the forward that training runs, whose output and lse
    ``flash_attention_bwd`` takes as ``o`` and ``lse`` (a bfloat16 call's
    output is this one rounded once).  No gradient flows through it.  On
    the card one counted ``"flash_attention"`` call of the tensor-core
    kernel at any group size, for what the backward takes (else
    ``check_backward`` raises); on the CPU the plain versions,
    ``attention_ref`` on float32 q and ``attention_lse_ref``."""
    device = _check("flash_attention_lse", q, k, v, causal, window, None)
    scale = scale if scale is not None else q.shape[3] ** -0.5
    if device.type == "cpu":
        return (_plain(q.float(), k, v, causal=causal, window=window,
                       scale=scale, kv_last=None),
                attention_lse_ref(q, k, causal=causal, window=window,
                                  scale=scale))
    check_backward(q, k, v)
    with torch.no_grad():
        _, lse, o32 = _launch(q, k, v, causal=causal, window=window,
                              scale=scale, lse=True)
    return o32, lse


def _launch(q, k, v, *, causal, window, scale, kv_last=None, lse=False):
    """K7 on checked CUDA operands: one counted call.  With ``lse`` the
    tensor-core kernel at any group size, returning (o, lse, o32): o32 is
    the output unrounded in float32 (o itself for float32 operands)."""
    B, H, Lq, D = q.shape
    Hkv = k.shape[1]
    out = torch.empty((B, H, Lq, D), dtype=q.dtype, device=q.device)
    plan = (K7Plan("prefill", 1) if lse else
            plan_k7(B, H, Hkv, Lq, k.shape[2], window, sm_count(q.device)))
    lse_t = (torch.empty((B, H, Lq), dtype=torch.float32, device=q.device)
             if lse else None)
    o32 = (torch.empty((B, H, Lq, D), dtype=torch.float32, device=q.device)
           if lse and q.dtype != torch.float32 else None)
    part = None
    if plan.splits > 1:
        part = torch.empty(B * Hkv * plan.splits * (H // Hkv) * Lq * (D + 2),
                           dtype=torch.float32, device=q.device)
    launch_flash_attention(q, k, v, out, causal=causal, window=window,
                           scale=scale, kv_last=kv_last, splits=plan.splits,
                           part=part, lse=lse_t, o32=o32)
    LAUNCHES["flash_attention"] += 1
    return (out, lse_t, out if o32 is None else o32) if lse else out


def check_backward(q, k, v) -> None:
    """Raise ``NotImplementedError`` for a grad-requiring call on the card
    that the backward kernels do not take: a head width outside
    ``BWD_HEAD_DIMS``, q, k, v of mixed dtypes, or bfloat16 operands at a
    head width outside ``BWD_BF16_HEAD_DIMS``."""
    D = q.shape[3]
    if D not in BWD_HEAD_DIMS:
        raise NotImplementedError(
            f"flash_attention: K7 has no backward at head width {D} (it "
            f"takes {BWD_HEAD_DIMS})")
    if not q.dtype == k.dtype == v.dtype or q.dtype not in DTYPES:
        raise NotImplementedError(
            f"flash_attention: K7's backward takes q, k, v of one dtype "
            f"(float32 or bfloat16), got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dtype == torch.bfloat16 and D not in BWD_BF16_HEAD_DIMS:
        raise NotImplementedError(
            f"flash_attention: K7's backward takes bfloat16 q, k, v at head "
            f"widths {BWD_BF16_HEAD_DIMS}, got {D} (no family that trains "
            f"under a bf16 compute dtype has it)")


class FlashAttention(torch.autograd.Function):
    """K7 with its hand-written backward, for CUDA operands that
    ``check_backward`` passes (checked by the caller).  It saves the
    output unrounded in float32, which the backward's Δ is taken from."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        out, lse, o32 = _launch(q, k, v, causal=causal, window=window,
                                scale=scale, lse=True)
        ctx.save_for_backward(q, k, v, o32, lse)
        ctx.args = (causal, window, scale)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, scale = ctx.args
        dq, dk, dv = flash_attention_bwd(q, k, v, do, causal=causal,
                                         window=window, scale=scale, lse=lse,
                                         o=out)
        return dq, dk, dv, None, None, None


def _aligned16(t) -> bool:
    """Whether the backward reads ``t`` as it lies: unit stride along D,
    16-byte aligned rows, other strides multiples of 16 bytes (4 floats,
    8 bfloat16 values)."""
    per = 16 // t.element_size()
    return (t.stride(3) == 1 and t.data_ptr() % 16 == 0
            and all(s % per == 0 for s in t.stride()[:3]))


def flash_attention_bwd(q, k, v, do, *, causal: bool = True, window=None,
                        scale=None, lse=None, o=None):
    """The gradients (dq, dk, dv) of ``flash_attention(q, k, v)`` for the
    output gradient ``do``: dq of q's shape and dk, dv of k's (summed over
    each group's query heads), in the operands' dtype (float32, or
    bfloat16 rounded once from float32 sums, as autograd of the plain
    version gives them; ``do`` is read in that dtype).
    ``lse`` and ``o``: the forward's log2-sum-exp [B, H, Lq] and float32
    output (``flash_attention_lse``'s; what ``FlashAttention`` saves), given together or not at all.  On the card
    the backward kernels (each row's
    lse staged with Δ = rowsum(do ∘ o), dk/dv, dq, and one more that adds
    the dk/dv pass's runs when ``plan_k7_bwd`` gives more than one;
    counted once as ``"flash_attention_bwd"``), given ``lse`` and ``o``
    or, without them, those of one more forward (counted as
    ``"flash_attention"``: the same bits as the forward's, so this call
    and autograd agree bit for bit).  On the CPU ``attention_bwd_ref``,
    which needs neither, its float32 gradients rounded to the operands'
    dtypes."""
    device = device_of("flash_attention_bwd", (q, k, v, do))
    B, H, Lq, D = q.shape
    Hkv, Lk = k.shape[1], k.shape[2]
    scale = scale if scale is not None else D ** -0.5
    check_causal_rows("flash_attention_bwd", causal, Lq, Lk)
    if do.shape != q.shape:
        raise ValueError(f"flash_attention_bwd: do must be q's shape "
                         f"{tuple(q.shape)}, got {tuple(do.shape)}")
    if (lse is None) != (o is None):
        raise ValueError("flash_attention_bwd: give the forward's lse and "
                         "o together, or neither")
    if device.type == "cpu":
        dq, dk, dv = attention_bwd_ref(q, k, v, do, causal=causal,
                                       window=window, scale=scale)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
    check_backward(q, k, v)
    do = do.to(q.dtype)
    if H % Hkv or k.shape != v.shape:
        raise ValueError(f"flash_attention_bwd: k, v must be [B, Hkv, Lk, "
                         f"D] with H={H} a multiple of Hkv")
    q, k, v, do = (t if _aligned16(t) else t.contiguous()
                   for t in (q, k, v, do))
    if lse is None:
        _, lse, o = _launch(q, k, v, causal=causal, window=window,
                            scale=scale, lse=True)
    elif (lse.shape != (B, H, Lq) or lse.dtype != torch.float32
          or not lse.is_contiguous() or lse.device != q.device):
        raise ValueError(f"flash_attention_bwd: lse must be a contiguous "
                         f"float32 [{B}, {H}, {Lq}] on {q.device} (the "
                         f"forward's), got {lse.dtype} {tuple(lse.shape)} "
                         f"on {lse.device}")
    elif (o.shape != q.shape or o.dtype != torch.float32
          or o.device != q.device):
        raise ValueError(f"flash_attention_bwd: o must be the forward's "
                         f"float32 output (unrounded for bfloat16 "
                         f"operands) of q's shape on {q.device}, got "
                         f"{o.dtype} {tuple(o.shape)} on {o.device}")
    elif not _aligned16(o):
        o = o.contiguous()
    dq = torch.empty((B, H, Lq, D), dtype=q.dtype, device=device)
    dk = torch.empty((B, Hkv, Lk, D), dtype=q.dtype, device=device)
    dv = torch.empty_like(dk)
    rows_pad = -(-(H // Hkv) * Lq // K7_BWD_ROWS) * K7_BWD_ROWS
    stats = torch.empty(2 * B * Hkv * rows_pad, dtype=torch.float32,
                        device=device)
    runs = plan_k7_bwd(H, Hkv, Lq, D, bf16=q.dtype == torch.bfloat16)
    part = None
    if runs > 1:
        part = torch.empty(2 * runs * dk.numel(), dtype=torch.float32,
                           device=device)
    launch_flash_attention_bwd(q, k, v, o, do, lse, dq, dk, dv, stats,
                               causal=causal, window=window, scale=scale,
                               runs=runs, part=part)
    LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv
