"""The tensor-core design of K8's backward, on the CPU.

- The block's fragment maps (``ssd_chunk.cu``, ``ssd_chunk_bwd_kernel``:
  16 warps, warp w = (mi, nj) = (w / 4, w % 4) on rows 16 mi .. 16 mi +
  15): the 8-column tiles of C·Bᵀ, dG = dy·xᵀ, G and ΣZ (j ∈ {nj, nj +
  4}, j ≤ 2 mi + 1) cover the causal triangle of the Q × Q products
  exactly once;
  x·dHᵀ, dB and dC cover every (u, s) cell once, dx every (u, p) cell
  once; the k-steps of Gᵀ·dy, ΣZ·B and ΣZᵀ·C reach every term of their
  sums and read only tiles of G and ΣZ that some warp stored; every
  per-head sum the finishing warp reads was written.
- The tiles' swizzle: a permutation of each row's columns that keeps a
  16-byte piece whole, and every fragment read, along a row (rows g,
  columns t) or across rows (rows t, columns g), on 32 distinct banks.
- The shared memory of a block within the 232 448 bytes it may opt into,
  and ``plan_k8_bwd`` at mamba2-1.3b's shape.
- A plain-torch mirror of the block: every product 3×TF32 emulated (as
  ``tests/test_torch_k7_design.py`` does), each product's accumulator from
  zero, Z and w·(x·dHᵀ) summed over a run's heads in head order, the runs
  in run order, ddt and ds from the sums of F·CB and E as the finishing
  warp forms them; held against ``ssd_chunk_bwd_ref`` within the card's
  gate (``K8_BWD_RTOL``·|ref| + ``K8_BWD_ATOL_OF_MAX``·max|ref|) at
  ``chip_smoke.py``'s ``K8_SHAPES`` and ``K8_BWD_MORE``.  With one TF32
  product instead of three the mirror misses that gate: the reason the
  kernel splits its operands.  ``ssd_chunk_bwd_ref`` itself is held
  against ``jax.vjp`` of the JAX package's chunk scan by
  ``tests/test_torch_ssd_bwd.py``."""
import os
import sys

import numpy as np
import pytest

from _reference_cache import no_persistent_compile_cache  # noqa: F401

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro_torch.kernels.ssd_chunk import ssd_chunk_bwd_ref  # noqa: E402
from repro_torch.kernels.ssd_chunk.ops import (  # noqa: E402
    MAX_P, MAX_Q, MAX_S, plan_k8_bwd)
from test_torch_k7_design import tc_matmul  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402

RTOL, ATOL_OF_MAX = cs.K8_BWD_RTOL, cs.K8_BWD_ATOL_OF_MAX
WARPS = 16
#: Bytes a block may opt into on an H100, and the block's (``kBwdWords``:
#: B [64][128], C·Bᵀ, G and ΣZ [64][64], two head buffers of x, dy
#: [64][64], dH [128][64] and three step vectors, two sets of per-head
#: sums and steps [17][64]).
OPT_IN = 232_448
HEAD_WORDS = 2 * MAX_Q * MAX_P + MAX_S * MAX_P + 3 * MAX_Q
PART_WORDS = 17 * MAX_Q
SMEM = 4 * (MAX_Q * MAX_S + 3 * MAX_Q * MAX_Q + 2 * HEAD_WORDS
            + 2 * PART_WORDS)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ---------------------------------------------------- the fragment maps

def triangle_tiles(w):
    """(mi, j) of the 8-column tiles of C·Bᵀ, dG, G and ΣZ warp w owns."""
    mi, nj = divmod(w, 4)
    return [(mi, j) for j in (nj, nj + 4) if j <= 2 * mi + 1]


def rows_cols(w, width):
    """(rows, columns) of warp w's share of a [64, 4·width] product."""
    mi, nj = divmod(w, 4)
    return range(16 * mi, 16 * mi + 16), range(width * nj, width * nj + width)


def test_triangle_tiles_cover_the_causal_triangle_once():
    seen = np.zeros((MAX_Q, MAX_Q), int)
    for w in range(WARPS):
        for mi, j in triangle_tiles(w):
            seen[16 * mi:16 * mi + 16, 8 * j:8 * j + 8] += 1
    tri = np.tril(np.ones((MAX_Q, MAX_Q), bool))
    assert (seen[tri] == 1).all()
    assert seen.max() == 1
    # Only the diagonal tiles reach above the triangle.
    assert sum(len(triangle_tiles(w)) for w in range(WARPS)) == 20


@pytest.mark.parametrize("width,cols", [(32, MAX_S), (16, MAX_P)])
def test_warp_shares_cover_every_cell_once(width, cols):
    """x·dHᵀ, dB, dC over (u, s) and dx over (u, p)."""
    seen = np.zeros((MAX_Q, cols), int)
    for w in range(WARPS):
        r, c = rows_cols(w, width)
        seen[r.start:r.stop, c.start:c.stop] += 1
    assert (seen == 1).all()


def stored(t, u):
    """Whether the tile holding G[t, u] (and ΣZ[t, u]) is stored."""
    return any((t // 16, u // 8) in triangle_tiles(w) for w in range(WARPS))


def test_k_steps_reach_every_term_and_read_stored_tiles():
    """Gᵀ·dy and ΣZᵀ·C: rows u of block mi take k-steps ks ≥ 2 mi (t =
    8 ks ..); ΣZ·B: rows t take ks ≤ 2 mi + 1 (u = 8 ks ..)."""
    for mi in range(4):
        rows = range(16 * mi, 16 * mi + 16)
        up = [t for ks in range(2 * mi, 8) for t in range(8 * ks, 8 * ks + 8)]
        down = [u for ks in range(2 * mi + 2) for u in range(8 * ks,
                                                              8 * ks + 8)]
        for r in rows:
            assert set(range(r, MAX_Q)) <= set(up)      # t ≥ u
            assert set(range(r + 1)) <= set(down)       # u ≤ t
            assert all(stored(t, r) for t in up)        # read transposed
            assert all(stored(r, u) for u in down)


def test_the_finishing_warp_reads_only_written_sums():
    """F·CB's strict column sums: block mi writes the columns of its
    tiles; the finishing warp adds blocks mi ≥ u / 16 for column u.  E's
    and dw's row sums: every (nj, row) is written."""
    written = np.zeros((4, MAX_Q), bool)
    for w in range(WARPS):
        for mi, j in triangle_tiles(w):
            written[mi, 8 * j:8 * j + 8] = True
    for u in range(MAX_Q):
        assert all(written[mi, u] for mi in range(u >> 4, 4))
        # and every block below the triangle of column u is covered
        assert all(not written[mi, u] or mi >= u >> 4 for mi in range(4))
    rows = np.zeros((4, MAX_Q), int)
    for w in range(WARPS):
        mi, nj = divmod(w, 4)
        rows[nj, 16 * mi:16 * mi + 16] += 1
    assert (rows == 1).all()


# ------------------------------------------------------------ the swizzle

def swz(r):
    return (((r & 3) << 1) | ((r >> 2) & 1)) << 2


def slot(r, c, width):
    return r * width + (c ^ swz(r))


@pytest.mark.parametrize("width", [MAX_P, MAX_S])
def test_swizzle_is_a_permutation_keeping_16_byte_pieces(width):
    for r in range(16):
        cols = [slot(r, c, width) - r * width for c in range(width)]
        assert sorted(cols) == list(range(width))
        for c in range(0, width, 4):
            piece = [slot(r, c + i, width) for i in range(4)]
            assert piece == list(range(piece[0], piece[0] + 4))
            assert piece[0] % 4 == 0


@pytest.mark.parametrize("width", [MAX_P, MAX_S])
@pytest.mark.parametrize("along", [True, False])
def test_fragment_reads_fall_on_distinct_banks(width, along):
    """Lane (g, t): rows r0 + g, columns c0 + t (a fragment read along a
    row; c0 a multiple of 4) or rows r0 + t, columns c0 + g (across rows;
    r0 ≡ 0 or 4 mod 8, c0 a multiple of 8)."""
    for r0 in range(0, 16, 4 if not along else 8):
        for c0 in range(0, width, 4 if along else 8):
            if along:
                addr = [slot(r0 + g, c0 + t, width) for g in range(8)
                        for t in range(4)]
            else:
                addr = [slot(r0 + t, c0 + g, width) for g in range(8)
                        for t in range(4)]
            assert len({a % 32 for a in addr}) == 32, (r0, c0)


def test_shared_memory_fits_the_opt_in():
    assert SMEM == 223_232
    assert SMEM <= OPT_IN
    # C (at the start and the end) fits a head buffer's x and dy.
    assert 2 * MAX_Q * MAX_P >= MAX_Q * MAX_S


def test_plan_at_mamba2_keeps_sixteen_heads_a_block():
    """One wave of 128 blocks at B = 2, L = 1024 (16 chunks, 64 heads)."""
    assert plan_k8_bwd(2, 1, 16, 64, 132) == 16


# ------------------------------------------------------------- the mirror

def mirror(x, delta, dtv, Bm, Cm, dy, dH, des, *, hpg, terms=3):
    """The block's arithmetic in plain torch (float32 values, products
    ``tc_matmul`` with ``terms`` TF32 terms), vectorised over (b, g,
    chunk); returns (dx, ddelta, ddt, dB, dC)."""
    BH, NC, Q, P = x.shape
    Bb, G, _, _, S = Bm.shape
    nh = plan_k8_bwd(Bb, G, NC, hpg, 132)
    prod = lambda a, b: tc_matmul(a, b, terms)  # noqa: E731
    tri = torch.ones(Q, Q, dtype=torch.bool).tril()
    below = tri.tril(-1)
    cells = lambda t: t.reshape(Bb, G, hpg, *t.shape[1:])  # noqa: E731
    xs, dls, dts, ys, hs, ds_ = map(cells, (x, delta, dtv, dy, dH, des))
    CB = prod(Cm, Bm.transpose(-1, -2))                    # [B, G, NC, t, u]
    dx = torch.empty(Bb, G, hpg, NC, Q, P)
    ddelta = torch.empty(Bb, G, hpg, NC, Q)
    ddt = torch.empty(Bb, G, hpg, NC, Q)
    run_B, run_C = [], []
    for h0 in range(0, hpg, nh):
        zsum = torch.zeros(Bb, G, NC, Q, Q)
        dbh = torch.zeros(Bb, G, NC, Q, S)
        for h in range(h0, min(h0 + nh, hpg)):
            xh, yh, Hh = xs[:, :, h], ys[:, :, h], hs[:, :, h]
            s = torch.cumsum(dls[:, :, h], dim=-1)
            dt = dts[:, :, h]
            w = torch.exp(s[..., -1:] - s) * dt
            M = torch.where(tri, torch.exp(torch.clamp(
                s[..., :, None] - s[..., None, :], max=0.0)), 0.0)
            F = prod(yh, xh.transpose(-1, -2)) * M
            zsum = zsum + torch.where(tri, F * dt[..., None, :], 0.0)
            FCB = torch.where(tri, F * CB, 0.0)
            G_ = torch.where(tri, CB * M * dt[..., None, :], 0.0)
            XdH = prod(xh, Hh.transpose(-1, -2))            # [u, s]
            dbh = dbh + w[..., None] * XdH
            dw = (Bm * XdH).sum(-1)
            dx[:, :, h] = (prod(G_.transpose(-1, -2), yh)
                           + w[..., None] * prod(Bm, Hh))
            col = torch.where(below, FCB, 0.0).sum(-2)      # Σ_{t > u}
            diag = torch.diagonal(FCB, dim1=-2, dim2=-1)
            row = torch.where(below, FCB * dt[..., None, :], 0.0).sum(-1)
            ddt[:, :, h] = (col + diag) + dw * torch.exp(s[..., -1:] - s)
            wdw = w * dw
            d = row - dt * col + ds_[:, :, h] * torch.exp(s)
            last = wdw[..., :-1].sum(-1, keepdim=True)
            d = d - torch.cat([wdw[..., :-1], -last], dim=-1)
            ddelta[:, :, h] = torch.flip(torch.cumsum(torch.flip(
                d, (-1,)), dim=-1), (-1,))
        run_C.append(prod(zsum, Bm))
        run_B.append(prod(zsum.transpose(-1, -2), Cm) + dbh)
    dB, dC = run_B[0], run_C[0]
    for b_, c_ in zip(run_B[1:], run_C[1:]):
        dB, dC = dB + b_, dC + c_
    flat = lambda t: t.reshape(BH, *t.shape[3:])  # noqa: E731
    return flat(dx), flat(ddelta), flat(ddt), dB, dC


CASES = [tuple(s) for s in cs.K8_SHAPES] + [tuple(s) for s in
                                            cs.K8_BWD_MORE]


def _operands(B, L, H, P, G, S, chunk):
    x, dt, A, Bm, Cm = map(torch.from_numpy,
                           cs.ssd_inputs(B, L, H, P, G, S, L + S))
    NC = L // chunk
    ops = [t.contiguous() for t in (
        x.transpose(1, 2).reshape(B * H, NC, chunk, P),
        dt.transpose(1, 2).reshape(B * H, NC, chunk) * A.repeat(B)[:, None,
                                                                    None],
        dt.transpose(1, 2).reshape(B * H, NC, chunk),
        Bm.transpose(1, 2).reshape(B, G, NC, chunk, S),
        Cm.transpose(1, 2).reshape(B, G, NC, chunk, S))]
    rng = np.random.RandomState(L + H + S)
    grads = [torch.from_numpy(rng.randn(*s).astype(np.float32))
             for s in ((B * H, NC, chunk, P), (B * H, NC, S, P),
                       (B * H, NC, chunk))]
    return ops + grads, H // G


def _misses(got, want):
    """Values outside RTOL·|want| + ATOL_OF_MAX·max|want|, each output."""
    out = []
    for g, w in zip(got, want):
        assert bool(g.isfinite().all())
        tol = RTOL * w.abs() + ATOL_OF_MAX * float(w.abs().max())
        out.append(int(((g - w).abs() > tol).sum()))
    return out


@pytest.mark.parametrize("case", CASES, ids=str)
def test_mirror_matches_the_plain_backward(case):
    args, hpg = _operands(*case)
    want = ssd_chunk_bwd_ref(*args, heads_per_group=hpg)
    got = mirror(*args, hpg=hpg)
    assert _misses(got, want) == [0] * 5


@pytest.mark.parametrize("case", [cs.K8_SHAPES[2], cs.K8_BWD_MORE[0]],
                         ids=str)
def test_mirror_with_one_tf32_product_misses_the_tolerance(case):
    args, hpg = _operands(*case)
    want = ssd_chunk_bwd_ref(*args, heads_per_group=hpg)
    assert sum(_misses(mirror(*args, hpg=hpg, terms=1), want)) > 0
