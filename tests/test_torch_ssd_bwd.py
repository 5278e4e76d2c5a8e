"""K8's backward on the CPU: the plain backward ``ssd_chunk_bwd_ref``
against autograd through ``ssd_chunk_ref``; the port's ``ssd_scan_kernel``
(the card's SSD algorithm: chunks, the intra-chunk block, the inter-chunk
scan and the h_in correction) under autograd against ``jax.vjp`` of the
reference's ``repro.models.mamba2.ssd_scan``; the ``SSDChunk`` wiring,
with the plain versions standing in for the kernels; and the backward's
block decomposition (``plan_k8_bwd``, ``k8_blocks``: each head of a group
once, dB and dC summed over a block's heads in order and over the runs
in run order).

Tolerances: float64 for the plain backward against autograd (1e-10
relative to each gradient's largest magnitude: the same formulas, summed
in another order); float32 against the reference within 2e-4·|ref| +
2e-5·max|ref| for each gradient (``chip_smoke.py``'s gate for the
kernel): the two algorithms differ (a state carried chunk to chunk
against the chunk block plus a scan), and the gradients of A and of the
deltas are sums over every step.

On a machine with a card, the kernel is held against the plain backward
(``gpu`` marker)."""
import numpy as np
import pytest

from _reference_cache import no_persistent_compile_cache  # noqa: F401

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.models import mamba2 as jmamba2  # noqa: E402
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.kernels.ssd_chunk import (  # noqa: E402
    ssd_chunk_bwd, ssd_chunk_bwd_ref, ssd_chunk_ref)
from repro_torch.kernels.ssd_chunk import ops as k8ops  # noqa: E402
from repro_torch.kernels.ssd_chunk.ops import (  # noqa: E402
    K8_BWD_BLOCK_COST, SSDChunk, k8_blocks, plan_k8_bwd)
from repro_torch.models.mamba2 import ssd_scan_kernel  # noqa: E402

RTOL, ATOL_OF_MAX = 2e-4, 2e-5
NAMES = ("dx", "ddelta", "ddt", "dB", "dC")

#: (B, G, heads a group, chunks, Q, P, S): one head, several heads and
#: groups, a short chunk, a 1-step chunk, odd widths, the kernel's
#: largest widths.
CELLS = [
    (1, 1, 1, 1, 8, 4, 5),
    (2, 2, 3, 2, 16, 8, 12),
    (1, 1, 4, 3, 1, 3, 2),
    (2, 1, 2, 2, 17, 5, 9),
    (1, 3, 2, 1, 33, 24, 48),
    (1, 1, 2, 1, 64, 64, 128),
]

#: (B, L, H, P, G, S, chunk, h0): several chunks, a padded tail, h0
#: given, G = 2 with two heads a group, a sequence shorter than a chunk,
#: one head a group.
SCANS = [
    (1, 128, 2, 16, 1, 32, 32, False),
    (2, 100, 4, 8, 2, 16, 32, False),
    (1, 96, 4, 8, 2, 16, 32, True),
    (2, 20, 2, 16, 1, 8, 64, True),
    (1, 72, 3, 8, 3, 8, 16, False),
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cell_inputs(B, G, hpg, NC, Q, P, S, dtype, seed=0, a_scale=1.0):
    """x, delta, dt, Bm, Cm and the output gradients dy, dH, des."""
    rng = np.random.RandomState(seed + 7 * Q + P + S)
    BH = B * G * hpg
    dt = 0.01 + rng.rand(BH, NC, Q)
    A = -(0.1 + rng.rand(BH, 1, 1)) * a_scale
    arrays = (rng.randn(BH, NC, Q, P) * 0.5, dt * A, dt,
              rng.randn(B, G, NC, Q, S) * 0.3, rng.randn(B, G, NC, Q, S) * 0.3,
              rng.randn(BH, NC, Q, P), rng.randn(BH, NC, S, P),
              rng.randn(BH, NC, Q))
    return [torch.from_numpy(a.astype(np.float32)).to(dtype) for a in arrays]


def _max_rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


def _within(name, got, want):
    """|got − want| ≤ RTOL·|want| + ATOL_OF_MAX·max|want| everywhere."""
    g, w = got.detach().double(), want.detach().double()
    assert g.shape == w.shape, name
    assert bool(g.isfinite().all()), name
    tol = RTOL * w.abs() + ATOL_OF_MAX * float(w.abs().max())
    bad = (g - w).abs() > tol
    assert not bool(bad.any()), (f"{name}: {int(bad.sum())} of "
                                 f"{bad.numel()} outside, max |Δ| "
                                 f"{float((g - w).abs().max()):.3g}")


# ------------------------------------------------ the plain backward

@pytest.mark.parametrize("cell", CELLS, ids=str)
def test_plain_backward_matches_autograd(cell):
    B, G, hpg = cell[:3]
    x, delta, dt, Bm, Cm, dy, dH, des = _cell_inputs(*cell, torch.float64)
    leaves = [t.clone().requires_grad_(True) for t in (x, delta, dt, Bm, Cm)]
    outs = ssd_chunk_ref(*leaves, heads_per_group=hpg)
    want = torch.autograd.grad(outs, leaves, (dy, dH, des))
    got = ssd_chunk_bwd_ref(x, delta, dt, Bm, Cm, dy, dH, des,
                            heads_per_group=hpg)
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape and g.dtype == torch.float64, name
        assert _max_rel(g, w) < 1e-10, name


def test_plain_backward_in_float32_and_with_underflowing_decays():
    """In float32 the two forms agree within the kernel's gate, also where
    exp(s) underflows to 0 (A × 20)."""
    cell = (1, 1, 3, 2, 64, 16, 32)
    x, delta, dt, Bm, Cm, dy, dH, des = _cell_inputs(*cell, torch.float32,
                                                     a_scale=20.0)
    assert bool((torch.exp(torch.cumsum(delta, -1)) == 0).any())
    leaves = [t.clone().requires_grad_(True) for t in (x, delta, dt, Bm, Cm)]
    want = torch.autograd.grad(ssd_chunk_ref(*leaves, heads_per_group=3),
                               leaves, (dy, dH, des))
    got = ssd_chunk_bwd_ref(x, delta, dt, Bm, Cm, dy, dH, des,
                            heads_per_group=3)
    for name, g, w in zip(NAMES, got, want):
        _within(name, g, w)


def test_cpu_wrapper_is_the_plain_backward():
    """``ssd_chunk_bwd`` on CPU tensors is ``ssd_chunk_bwd_ref`` bit for
    bit, and launches nothing."""
    ins = _cell_inputs(*CELLS[1], torch.float32)
    LAUNCHES.clear()
    got = ssd_chunk_bwd(*ins, heads_per_group=3)
    assert not LAUNCHES
    for g, w in zip(got, ssd_chunk_bwd_ref(*ins, heads_per_group=3)):
        assert torch.equal(g, w)


def test_padded_steps_get_no_gradient_through_the_pad():
    """A padded step has dt = 0 and x = 0: its own gradients are dropped
    by the pad's backward, and the real steps' gradients equal those of
    the unpadded chunk."""
    B, G, hpg, Q, P, S = 1, 1, 2, 12, 4, 6
    x, delta, dt, Bm, Cm, dy, dH, des = _cell_inputs(B, G, hpg, 1, Q, P, S,
                                                     torch.float64)
    pad = 4
    leaves = [t.clone().requires_grad_(True) for t in (x, delta, dt, Bm, Cm)]
    padded = [torch.nn.functional.pad(t, (0, 0, 0, pad)) if t.dim() == 4 else
              torch.nn.functional.pad(t, (0, pad)) for t in leaves[:3]]
    padded += [torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in leaves[3:]]
    y, Hs, es = ssd_chunk_ref(*padded, heads_per_group=hpg)
    # Only the real steps' outputs are used downstream of a padded chunk;
    # H_out sees the padded steps as exact no-ops (dt = 0, x = 0, s flat).
    loss = (y[..., :Q, :] * dy).sum() + (Hs * dH).sum() + (
        es[..., :Q] * des).sum()
    got = torch.autograd.grad(loss, leaves)
    short = [t.clone().requires_grad_(True) for t in (x, delta, dt, Bm, Cm)]
    want = torch.autograd.grad(ssd_chunk_ref(*short, heads_per_group=hpg),
                               short, (dy, dH, des))
    for name, g, w in zip(NAMES, got, want):
        assert _max_rel(g, w) < 1e-10, name


# ----------------------------------------- SSDChunk and ssd_scan_kernel

def _fake_card(monkeypatch):
    """Make ``ssd_chunk`` take its card branch on CPU tensors: the device
    reads as CUDA and the launch is the plain forward, detached (the
    kernel's output has no graph of its own)."""
    launched = []

    def launch(x, delta, dtv, Bm, Cm, hpg):
        launched.append(torch.is_grad_enabled())
        with torch.no_grad():
            return ssd_chunk_ref(x, delta, dtv, Bm, Cm, heads_per_group=hpg)

    monkeypatch.setattr(k8ops, "_launch", launch)
    monkeypatch.setattr(k8ops, "device_of",
                        lambda fn, ts: torch.device("cuda"))
    return launched


def test_ssd_chunk_under_grad_takes_ssdchunk(monkeypatch):
    """On the card ``ssd_chunk`` under grad goes through ``SSDChunk`` (the
    outputs keep a grad_fn) and its backward returns the plain backward's
    gradients in the inputs' order; without grad the kernel alone."""
    x, delta, dt, Bm, Cm, dy, dH, des = _cell_inputs(*CELLS[1], torch.float32)
    launched = _fake_card(monkeypatch)
    leaves = [t.clone().requires_grad_(True) for t in (x, delta, dt, Bm, Cm)]
    outs = k8ops.ssd_chunk(*leaves, heads_per_group=3)
    assert all(type(o.grad_fn).__name__ == "SSDChunkBackward" for o in outs)
    with torch.no_grad():
        plain = k8ops.ssd_chunk(*leaves, heads_per_group=3)
    assert all(o.grad_fn is None for o in plain)
    assert launched == [False, False]     # SSDChunk launches without grad
    monkeypatch.undo()                    # the backward on the CPU: plain
    got = torch.autograd.grad(outs, leaves, (dy, dH, des))
    want = ssd_chunk_bwd_ref(x, delta, dt, Bm, Cm, dy, dH, des,
                             heads_per_group=3)
    for name, g, w in zip(NAMES, got, want):
        assert torch.equal(g, w), name


def _scan_inputs(B, L, H, P, G, S, seed=0):
    rng = np.random.RandomState(seed + L + H + S)
    return (rng.randn(B, L, H, P).astype(np.float32) * 0.5,
            (0.01 + rng.rand(B, L, H)).astype(np.float32),
            -(0.1 + rng.rand(H)).astype(np.float32),
            rng.randn(B, L, G, S).astype(np.float32) * 0.3,
            rng.randn(B, L, G, S).astype(np.float32) * 0.3,
            rng.randn(B, H, S, P).astype(np.float32) * 0.5,
            rng.randn(B, L, H, P).astype(np.float32),
            rng.randn(B, H, S, P).astype(np.float32))


def _reference_scan_vjp(B, L, H, P, G, S, chunk, with_h0):
    x, dt, A, Bm, Cm, h0, dy, dh = _scan_inputs(B, L, H, P, G, S)
    args = [jnp.asarray(a) for a in (x, dt, A, Bm, Cm)]
    if with_h0:
        fn = jax.jit(lambda x, dt, A, Bm, Cm, h0: jmamba2.ssd_scan(
            x, dt, A, Bm, Cm, h0, chunk=chunk))
        args.append(jnp.asarray(h0))
    else:
        fn = jax.jit(lambda x, dt, A, Bm, Cm: jmamba2.ssd_scan(
            x, dt, A, Bm, Cm, chunk=chunk))
    out, vjp = jax.vjp(fn, *args)
    grads = vjp((jnp.asarray(dy), jnp.asarray(dh)))
    return [np.array(o) for o in out], [np.array(g) for g in grads]


@pytest.mark.parametrize("shape", SCANS, ids=str)
def test_ssd_scan_kernel_gradients_match_reference_vjp(shape):
    """The port's ``ssd_scan_kernel`` under autograd (pad, chunk block,
    inter-chunk scan, h_in correction) against ``jax.vjp`` of the
    reference's chunk scan: y, h and the gradients of x, dt, A, B, C and
    h0."""
    B, L, H, P, G, S, chunk, with_h0 = shape
    x, dt, A, Bm, Cm, h0, dy, dh = _scan_inputs(B, L, H, P, G, S)
    leaves = [torch.from_numpy(a).requires_grad_(True)
              for a in (x, dt, A, Bm, Cm) + ((h0,) if with_h0 else ())]
    y, h = ssd_scan_kernel(*leaves[:5], leaves[5] if with_h0 else None,
                           chunk=chunk)
    got = torch.autograd.grad((y, h), leaves,
                              (torch.from_numpy(dy), torch.from_numpy(dh)))
    (ry, rh), want = _reference_scan_vjp(B, L, H, P, G, S, chunk, with_h0)
    _within("y", y, torch.from_numpy(ry))
    _within("h", h, torch.from_numpy(rh))
    for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC", "dh0"), got, want):
        _within(name, g, torch.from_numpy(w))


@pytest.mark.parametrize("shape", SCANS[:3], ids=str)
def test_ssd_scan_kernel_through_ssdchunk_matches_reference_vjp(
        monkeypatch, shape):
    """The same with the intra-chunk block taken through ``SSDChunk`` as
    on the card (its backward the plain ``ssd_chunk_bwd_ref``): the
    gradients autograd gives the torch ops around the block, fed through
    K8's backward formulas, hold to the reference."""
    B, L, H, P, G, S, chunk, with_h0 = shape
    x, dt, A, Bm, Cm, h0, dy, dh = _scan_inputs(B, L, H, P, G, S)
    leaves = [torch.from_numpy(a).requires_grad_(True)
              for a in (x, dt, A, Bm, Cm) + ((h0,) if with_h0 else ())]
    _fake_card(monkeypatch)
    y, h = ssd_scan_kernel(*leaves[:5], leaves[5] if with_h0 else None,
                           chunk=chunk)
    monkeypatch.undo()
    got = torch.autograd.grad((y, h), leaves,
                              (torch.from_numpy(dy), torch.from_numpy(dh)))
    _, want = _reference_scan_vjp(B, L, H, P, G, S, chunk, with_h0)
    for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC", "dh0"), got, want):
        _within(name, g, torch.from_numpy(w))


# ------------------------------------------------ the block design

@pytest.mark.parametrize("B,G,NC,hpg,sms", [
    (2, 1, 16, 64, 132), (1, 1, 1, 1, 132), (1, 2, 2, 3, 132),
    (4, 1, 16, 64, 132), (2, 8, 16, 8, 132), (1, 1, 2, 10, 4)])
def test_plan_k8_bwd_within_its_bounds(B, G, NC, hpg, sms):
    """1 ≤ nh ≤ hpg, no cheaper nh under the cost the plan minimises; 16
    heads a block (4 runs) at mamba2-1.3b's B = 2, L = 1024 on an H100's
    132 SMs."""
    nh = plan_k8_bwd(B, G, NC, hpg, sms)
    assert 1 <= nh <= hpg
    cells = B * G * NC

    def cost(n):
        return -(-cells * -(-hpg // n) // sms) * (n + K8_BWD_BLOCK_COST)

    assert all(cost(nh) <= cost(n) for n in range(1, hpg + 1))
    if (B, G, NC, hpg, sms) == (2, 1, 16, 64, 132):
        assert nh == 16 and -(-hpg // nh) == 4


def mirror_runs(x, delta, dt, Bm, Cm, dy, dH, des, hpg, nh):
    """The backward's dB and dC as its blocks form them: per block of
    ``k8_blocks``, ΣZ over its heads in order and the heads' w ⊙ x·dHᵀ in
    order, then dC = ΣZ·B, dB = ΣZᵀ·C + Σw ⊙ x·dHᵀ; the runs' partials
    added in run order.  Also returns how often each (b, g, c, head) was
    taken."""
    BH, NC, Q, P = x.shape
    Bb, G, _, _, S = Bm.shape
    H = BH // Bb
    s = torch.cumsum(delta, -1)
    tri = torch.ones(Q, Q, dtype=torch.bool).tril()
    taken = torch.zeros(Bb, G, NC, hpg, dtype=torch.int64)
    parts = {}
    for b, g, c, h0, h1 in k8_blocks(Bb, G, NC, hpg, nh):
        Bc, Cc = Bm[b, g, c], Cm[b, g, c]
        CB = Cc @ Bc.T
        Zs = torch.zeros(Q, Q, dtype=x.dtype)
        dbh = torch.zeros(Q, S, dtype=x.dtype)
        for h in range(h0, h1):
            taken[b, g, c, h] += 1
            bh = b * H + g * hpg + h
            sv, dtv = s[bh, c], dt[bh, c]
            M = torch.where(tri, torch.exp(torch.clamp(
                sv[:, None] - sv[None, :], max=0.0)), 0.0)
            dG = torch.where(tri, dy[bh, c] @ x[bh, c].T, 0.0)
            Zs = Zs + dG * M * dtv[None, :]
            w = torch.exp(sv[-1] - sv) * dtv
            dbh = dbh + w[:, None] * (x[bh, c] @ dH[bh, c].T)
        run = h0 // nh
        parts[(b, g, c, run)] = (Zs.T @ Cc + dbh, Zs @ Bc)
        del CB
    dB, dC = torch.zeros_like(Bm), torch.zeros_like(Cm)
    runs = -(-hpg // nh)
    for b in range(Bb):
        for g in range(G):
            for c in range(NC):
                for run in range(runs):            # in run order
                    pb, pc = parts[(b, g, c, run)]
                    dB[b, g, c] = dB[b, g, c] + pb
                    dC[b, g, c] = dC[b, g, c] + pc
    return dB, dC, taken


@pytest.mark.parametrize("cell,nh", [
    (CELLS[1], 1), (CELLS[1], 2), (CELLS[1], 3), (CELLS[2], 3),
    ((1, 1, 5, 2, 8, 4, 6), 2), ((2, 2, 4, 1, 6, 3, 5), 4)], ids=str)
def test_blocks_cover_each_head_once_and_runs_sum_to_db_dc(cell, nh):
    B, G, hpg, NC = cell[:4]
    ins = _cell_inputs(*cell, torch.float64)
    dB, dC, taken = mirror_runs(*ins, hpg, nh)
    assert bool((taken == 1).all())
    blocks = k8_blocks(B, G, NC, hpg, nh)
    assert len(blocks) == B * G * NC * -(-hpg // nh)
    _, _, _, wB, wC = ssd_chunk_bwd_ref(*ins, heads_per_group=hpg)
    assert _max_rel(dB, wB) < 1e-10 and _max_rel(dC, wC) < 1e-10


# ------------------------------------------------------------- on the card

@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS, ids=str)
def test_cuda_backward_matches_plain_version(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU form)")
    hpg = cell[2]
    ins = _cell_inputs(*cell, torch.float32)
    want = ssd_chunk_bwd_ref(*ins, heads_per_group=hpg)
    LAUNCHES.clear()
    got = ssd_chunk_bwd(*(t.cuda() for t in ins), heads_per_group=hpg)
    again = ssd_chunk_bwd(*(t.cuda() for t in ins), heads_per_group=hpg)
    assert LAUNCHES["ssd_chunk_bwd"] == 2
    for name, g, a, w in zip(NAMES, got, again, want):
        assert torch.equal(g, a), name
        _within(name, g.cpu(), w)
