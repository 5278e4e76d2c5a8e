"""The block design of the SSD chunk kernel K8, on the CPU.

- ``plan_k8`` picks the heads of a group per block within 1..hpg, and
  ``k8_blocks`` (the grid the CUDA kernel walks) covers every (b, g,
  chunk, head) exactly once, with a short last run when nh does not
  divide hpg;
- a plain-torch mirror of the kernel's decomposition: per block, C·Bᵀ
  once over the 8 × 4 tiles that reach the diagonal (the rest of the
  square left as NaN, so a missing tile shows), its k range summed in two
  halves added low + high; per head of the block's two teams, the decay
  applied to C·Bᵀ on the triangle, y = G_h x, and H = Bᵀ (w ⊙ x).  It is
  held against ``ssd_chunk_ref`` and against the reference's
  ``ssd_chunk_pallas`` in interpret mode at the reference's pins and
  ``chip_smoke.py``'s edge shapes (3 and 5 heads a group, G > 1 with one
  head a group, Q = 1, 17, 33, P = 5, 8, 24, S = 9, 16, 48, decays that
  underflow), with several heads per block, within rtol = atol = 2e-4
  (the reference's pin).

On a machine with a card, the CUDA kernel is held against its plain
version at the edge shapes with each heads-per-block it can be launched
with, and two calls at mamba2-1.3b's shape are bit for bit equal
(``gpu`` marker)."""
import os
import sys

import numpy as np
import pytest

from _reference_cache import no_persistent_compile_cache  # noqa: F401

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd_chunk.kernel import ssd_chunk_pallas  # noqa: E402
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.kernels.ssd_chunk import ssd_chunk, ssd_chunk_ref  # noqa: E402
from repro_torch.kernels.ssd_chunk.kernel import (  # noqa: E402
    launch_ssd_chunk)
from repro_torch.kernels.ssd_chunk.ops import (K8_TEAMS,  # noqa: E402
                                               k8_blocks, plan_k8)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402

SSD = dict(rtol=2e-4, atol=2e-4)
#: The reference's pins and the 12-step chunk (chip_smoke's K8_SHAPES
#: without mamba2-1.3b's full size), with A's scale 1.
PINS = [shape + (1.0,) for shape in cs.K8_SHAPES[:-1]]
EDGES = list(cs.K8_EDGES)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _operands(B, L, H, P, G, S, chunk, a_scale):
    """K8's operands from chip_smoke's inputs, laid out as ``ssd`` lays
    them out (heads into the batch dim, chunked time)."""
    x, dt, A, Bm, Cm = map(torch.from_numpy,
                           cs.ssd_inputs(B, L, H, P, G, S, L + S, a_scale))
    NC = L // chunk
    ops = [t.contiguous() for t in (
        x.transpose(1, 2).reshape(B * H, NC, chunk, P),
        dt.transpose(1, 2).reshape(B * H, NC, chunk)
        * A.repeat(B)[:, None, None],
        dt.transpose(1, 2).reshape(B * H, NC, chunk),
        Bm.transpose(1, 2).reshape(B, G, NC, chunk, S),
        Cm.transpose(1, 2).reshape(B, G, NC, chunk, S))]
    return ops, H // G


def _nhs(hpg):
    return sorted({1, 2, 3, 4, hpg} & set(range(1, hpg + 1)))


# ----------------------------------------------------------- the block plan

@pytest.mark.parametrize("B,G,NC,hpg,sms", [
    (1, 1, 1, 1, 132), (1, 1, 2, 2, 132), (2, 2, 2, 2, 132),
    (1, 4, 4, 1, 132), (2, 1, 16, 64, 132), (1, 1, 4, 64, 132),
    (8, 1, 64, 64, 132), (2, 1, 2, 3, 132), (1, 2, 2, 5, 132),
    (1, 1, 1, 64, 1), (4, 2, 8, 24, 16), (3, 1, 5, 7, 2)])
def test_plan_k8_stays_within_its_bounds(B, G, NC, hpg, sms):
    nh = plan_k8(B, G, NC, hpg, sms)
    assert isinstance(nh, int) and 1 <= nh <= hpg


def test_plan_k8_at_mamba2_fills_the_card_in_one_wave():
    """mamba2-1.3b at B = 2, L = 1024 (G = 1, 64 heads, 16 chunks) on 132
    SMs: 16 heads a block, 8 a team, 128 blocks, one an SM."""
    nh = plan_k8(2, 1, 16, 64, 132)
    assert nh == 16 and -(-nh // K8_TEAMS) == 8
    assert len(k8_blocks(2, 1, 16, 64, nh)) == 128 <= 132


def test_plan_k8_gives_launch_sized_grids_one_head_a_block():
    for B, L, H, P, G, S, chunk in cs.K8_SHAPES[:-1]:
        assert plan_k8(B, G, L // chunk, H // G, 132) == 1


@pytest.mark.parametrize("B,G,NC,hpg,nh", [
    (1, 1, 1, 1, 1), (2, 1, 2, 3, 2), (1, 2, 2, 5, 2), (1, 2, 2, 5, 3),
    (1, 2, 2, 5, 4), (2, 4, 2, 1, 1), (2, 1, 16, 64, 16), (1, 3, 3, 7, 5),
    (1, 1, 2, 64, 64)])
def test_k8_blocks_cover_each_head_once(B, G, NC, hpg, nh):
    blocks = k8_blocks(B, G, NC, hpg, nh)
    nblk = -(-hpg // nh)
    assert len(blocks) == B * G * NC * nblk
    seen = {}
    for i, (b, g, c, h0, h1) in enumerate(blocks):
        # launch order: (b, g, chunk) major, the run of heads minor
        assert i // nblk == (b * G + g) * NC + c
        assert h0 == (i % nblk) * nh and 1 <= h1 - h0 <= nh
        for h in range(h0, h1):
            seen[(b, g, c, h)] = seen.get((b, g, c, h), 0) + 1
    assert seen == {(b, g, c, h): 1 for b in range(B) for g in range(G)
                    for c in range(NC) for h in range(hpg)}
    last = [h1 - h0 for (_, _, _, h0, h1) in blocks[nblk - 1::nblk]]
    assert set(last) == {hpg - (nblk - 1) * nh}


# ---------------------------------------------- the decomposition, mirrored

def k8_mirror(x, delta, dtv, Bm, Cm, *, heads_per_group, nh):
    """The CUDA kernel's decomposition in plain torch, block by block of
    ``k8_blocks``.  Every output is written once (a second write, or a
    missing one, fails)."""
    BH, NC, Q, P = x.shape
    Bb, G, _, _, S = Bm.shape
    hpg = heads_per_group
    outs = [torch.full(s, float("nan")) for s in
            ((BH, NC, Q, P), (BH, NC, S, P), (BH, NC, Q))]
    written = torch.zeros((BH, NC), dtype=torch.int64)
    t_idx = torch.arange(Q)
    tri = t_idx[None, :] <= t_idx[:, None]           # [t, u]: u <= t
    S4 = -(-S // 4) * 4
    kmid = (S4 // 8) * 4
    for b, g, c, h0, h1 in k8_blocks(Bb, G, NC, hpg, nh):
        Bc, Cc = Bm[b, g, c], Cm[b, g, c]            # [Q, S]
        # C·Bᵀ over the 8 × 4 tiles with ub <= 2 tb + 1, k in two halves.
        CB = torch.full((Q, Q), float("nan"))
        nb = -(-Q // 8)
        for tb in range(nb):
            for ub in range(2 * tb + 2):
                rows = slice(8 * tb, min(8 * tb + 8, Q))
                cols = slice(4 * ub, min(4 * ub + 4, Q))
                lo = Cc[rows, :kmid] @ Bc[cols, :kmid].T
                hi = Cc[rows, kmid:] @ Bc[cols, kmid:].T
                CB[rows, cols] = lo + hi
        split = h0 + (h1 - h0 + 1) // 2                # team 0 | team 1
        for team in (range(h0, split), range(split, h1)):
            for h in team:
                bh = (b * G + g) * hpg + h
                s = torch.cumsum(delta[bh, c], 0)
                dt = dtv[bh, c]
                decay = torch.exp(torch.clamp(s[:, None] - s[None, :],
                                              max=0.0))
                Gh = torch.where(tri, CB * decay * dt[None, :],
                                 torch.zeros(()))
                w = torch.exp(s[-1] - s) * dt
                outs[0][bh, c] = Gh @ x[bh, c]
                outs[1][bh, c] = Bc.T @ (x[bh, c] * w[:, None])
                outs[2][bh, c] = torch.exp(s)
                written[bh, c] += 1
    assert bool((written == 1).all()), "an output written twice or never"
    return outs


def _close(got, want, what):
    for name, g, w in zip(("y_intra", "H_out", "exp_s"), got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape, (what, name)
        assert np.isfinite(g).all(), (what, name)
        np.testing.assert_allclose(g, w, **SSD, err_msg=f"{what} {name}")


@pytest.mark.parametrize("shape", PINS + EDGES, ids=str)
def test_mirror_matches_ref_and_pallas(shape):
    """The mirror with the plan's nh and with every nh chip_smoke
    launches, against the plain version; with the plan's nh, against
    the reference's Pallas kernel in interpret mode."""
    B, L, H, P, G, S, chunk, a_scale = shape
    ops, hpg = _operands(*shape)
    want = ssd_chunk_ref(*ops, heads_per_group=hpg)
    if a_scale != 1.0:
        assert bool((want[2] == 0).any()), "no decay underflows"
    nh0 = plan_k8(B, G, L // chunk, hpg, 132)
    for nh in sorted({nh0, *_nhs(hpg)}):
        got = k8_mirror(*ops, heads_per_group=hpg, nh=nh)
        _close([t.numpy() for t in got], [t.numpy() for t in want],
               f"nh={nh} vs ssd_chunk_ref")
    got = k8_mirror(*ops, heads_per_group=hpg, nh=nh0)
    ref = ssd_chunk_pallas(*(jnp.asarray(t.numpy()) for t in ops),
                           heads_per_group=hpg, interpret=True)
    _close([t.numpy() for t in got], ref, "vs ssd_chunk_pallas")


def test_mirror_with_full_teams_and_a_short_run():
    """Several heads a team and a last run shorter than nh: 64 heads a
    group in runs of 16 and of 24 (24, 24, 16)."""
    shape = (1, 128, 64, 16, 1, 32, 64, 1.0)
    ops, hpg = _operands(*shape)
    want = ssd_chunk_ref(*ops, heads_per_group=hpg)
    for nh in (16, 24):
        got = k8_mirror(*ops, heads_per_group=hpg, nh=nh)
        _close([t.numpy() for t in got], [t.numpy() for t in want],
               f"nh={nh}")


def test_the_wrapper_on_the_cpu_is_the_plain_version():
    ops, hpg = _operands(*EDGES[1])
    LAUNCHES.clear()
    got = ssd_chunk(*ops, heads_per_group=hpg)
    assert not LAUNCHES
    for g, w in zip(got, ssd_chunk_ref(*ops, heads_per_group=hpg)):
        assert torch.equal(g, w)


# ------------------------------------------------------------- on the card

def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU form)")


@pytest.mark.gpu
@pytest.mark.parametrize("shape", EDGES, ids=str)
def test_cuda_k8_at_the_edges_with_each_nh(shape):
    _needs_card()
    ops, hpg = _operands(*shape)
    want = ssd_chunk_ref(*ops, heads_per_group=hpg)
    dev = [t.cuda() for t in ops]
    for nh in _nhs(hpg):
        out = [torch.full_like(w, float("nan")).cuda() for w in want]
        launch_ssd_chunk(*dev, *out, heads_per_group=hpg, nh=nh)
        torch.cuda.synchronize()
        _close([t.cpu().numpy() for t in out], [t.numpy() for t in want],
               f"nh={nh}")


@pytest.mark.gpu
def test_cuda_k8_is_bit_for_bit_repeatable():
    _needs_card()
    ops, hpg = _operands(*(cs.K8_SHAPES[-1] + (1.0,)))
    dev = [t.cuda() for t in ops]
    first = ssd_chunk(*dev, heads_per_group=hpg)
    again = ssd_chunk(*dev, heads_per_group=hpg)
    assert all(torch.equal(a, b) for a, b in zip(first, again))
