"""The redesigned decision template of the port (K1–K4 share it) and the
faults closed beside it, on the CPU:

- K2 reads window-major planes [Wd, N]; the engine makes them once per
  run, beside ``_Win.down0``/``down1``, and hands the same pair to every
  block of every wave;
- the template's edge shapes (N of 1, 31, 33, 1 000, 10⁴ + 7; one task;
  2 048 tasks; one, eight and eleven windows) as ``chip_smoke.py`` builds
  them: the plain versions against the JAX reference's two-stage path,
  and the edge rows where they should land;
- attention raises for a causal call with more queries than keys (F3).

On a machine with a card, the CUDA template is held against its plain
version at the same edge shapes (``gpu`` marker)."""
import os
import sys

import numpy as np
import pytest

from _reference_cache import no_persistent_compile_cache  # noqa: F401

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402
import repro_torch.sim as tsim  # noqa: E402
from repro_torch.kernels.dodoor_choice import (LAUNCHES,  # noqa: E402
                                               dodoor_fused_ref,
                                               dodoor_fused_sparse,
                                               dodoor_fused_sparse_ref)
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.models import common  # noqa: E402
from repro_torch.sim import engine as teng  # noqa: E402
from repro_torch.workloads import MapReduceDAG, functionbench  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU runs are many tiny ops; a thread pool only adds
    overhead to them (and contends with the other test workers)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ------------------------------------------- window-major planes, once a run

def _recording(monkeypatch):
    """Record the window operands of every decision-kernel call the engine
    makes, then run the real wrapper."""
    calls = []

    def spy(*args, **kw):
        calls.append({k: kw.get(k) for k in ("down0", "down1", "down_t")})
        return dodoor_fused_sparse(*args, **kw)

    monkeypatch.setattr(teng, "dodoor_fused_sparse", spy)
    return calls


def _testbed_run(kind):
    tb = tsim.make_testbed()
    wl = functionbench.synthesize(m=300, qps=60.0, seed=0)
    H = float(wl.submit_ms[-1])
    dyn = tsim.random_outages(tb.num_servers, 25, 0.6 * H,
                              mean_down_ms=0.15 * H, seed=7).merge(
        tsim.random_churn(tb.num_servers, 0.15, 0.15, H, seed=11))
    kw = {}
    cfg = tsim.EngineConfig(policy="dodoor", b=20)
    if kind == "retries":
        cfg = cfg._replace(retry=tsim.RetryPolicy())
    if kind == "dag":
        cfg = cfg._replace(locality=tsim.LocalityModel(gamma=2.0))
        kw["dag"] = MapReduceDAG(mappers=4, reducers=2, edge_delay_ms=0.5,
                                 edge_bytes_mb=8.0)
    return wl, tb, cfg, dyn, kw


@pytest.mark.parametrize("kind", ["blocks", "retries", "dag"])
def test_window_major_planes_are_made_once_per_run(kind, monkeypatch):
    """Every block of every wave gets the same two [Wd, N] tensors, the
    exact contiguous transposes of the down planes it also gets, and the
    run's result is the one without the recording."""
    wl, tb, cfg, dyn, kw = _testbed_run(kind)
    want = tsim.simulate(wl, tb, cfg, device="cpu", dynamics=dyn, **kw)
    calls = _recording(monkeypatch)
    got = tsim.simulate(wl, tb, cfg, device="cpu", dynamics=dyn, **kw)
    assert len(calls) > 1
    first = calls[0]
    d0t, d1t = first["down_t"]
    for c in calls:
        assert c["down_t"][0] is d0t and c["down_t"][1] is d1t
        assert c["down0"] is first["down0"] and c["down1"] is first["down1"]
    for plane, t in ((first["down0"], d0t), (first["down1"], d1t)):
        assert t.is_contiguous() and t.shape == plane.shape[::-1]
        assert torch.equal(t, plane.t())
    assert np.array_equal(got.server, want.server)
    assert np.array_equal(got.finish_ms, want.finish_ms)
    assert (got.msgs_base, got.msgs_push, got.msgs_flush) == (
        want.msgs_base, want.msgs_push, want.msgs_flush)


def test_no_window_major_planes_without_down_windows(monkeypatch):
    wl, tb, cfg, _, _ = _testbed_run("blocks")
    ctx = teng._make_ctx(tb, cfg, 0, "cpu", None)
    assert ctx.down_t is None and not ctx.masked
    calls = _recording(monkeypatch)
    tsim.simulate(wl, tb, cfg, device="cpu")
    assert calls and all(c["down_t"] is None for c in calls)


def test_wrapper_on_cpu_ignores_the_window_major_pair():
    args, kw = cs.edge_case(torch, "sparse", 50, 33, Wd=3, device="cpu")
    want = dodoor_fused_sparse_ref(*args, 0.5, **kw)
    bogus = (torch.zeros(1), torch.zeros(1))      # on the CPU, unread
    LAUNCHES.clear()
    got = dodoor_fused_sparse(*args, alpha=0.5, down_t=bogus, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert sum(LAUNCHES.values()) == 0


# ------------------------------------------------------------ edge shapes

@pytest.mark.parametrize("form", ["sparse", "dense"])
@pytest.mark.parametrize("T,N", cs.EDGE_SHAPES)
def test_edge_rows_land_where_built(form, T, N):
    """The plain versions at chip_smoke's edge shapes (masked; 8 windows,
    one on the largest block to keep its [T, N, Wd] planes small): row 3
    on its one admissible server, row 4 on the first and the last
    admissible, rows 1-2 all down and row 0 infeasible (T ≥ 5)."""
    Wd = 8 if T * N <= 10 ** 6 else 1
    args, kw = cs.edge_case(torch, form, T, N, Wd=Wd, device="cpu")
    plain = dodoor_fused_sparse_ref if form == "sparse" else dodoor_fused_ref
    want = plain(*args, 0.5, **kw)
    cs.edge_check(f"{form} T={T} N={N}", want, want, T, N)
    cand = want[1].numpy()
    assert ((cand >= 0) & (cand < N)).all()


@jax.jit
def _two_stage(keys, r, d_types, node_type, L, D, C, d0, d1, now):
    """The reference's two-stage path under down windows: prefilter and
    availability, ``sample_feasible_batch``, ``load_score_batched``,
    Algorithm 1's pick (ties keep A)."""
    t = now[:, None, None]
    up = ~((d0[None] <= t) & (t < d1[None])).any(-1)
    mask = jcore.feasible_mask(r, C) & up
    cand = jcore.sample_feasible_batch(keys, mask, 2)
    tt = jnp.arange(r.shape[0])
    d_cand = d_types[tt[:, None], node_type[cand]]
    scores = jcore.load_score_batched(r, L[cand], D[cand] + d_cand, C[cand],
                                      0.5)
    choice = jnp.where(scores[:, 0] > scores[:, 1], cand[:, 1], cand[:, 0])
    return choice, cand, scores


@pytest.mark.parametrize("Wd", cs.EDGE_WD)
@pytest.mark.parametrize("T,N", [(50, 1), (50, 31), (50, 33), (64, 1000),
                                 (1, 100)])
def test_masked_plain_version_matches_the_reference_at_edge_shapes(T, N, Wd):
    """K2's plain version at the edge shapes and window counts, bit for
    bit against the reference's two-stage path."""
    args, kw = cs.edge_case(torch, "sparse", T, N, Wd=Wd, device="cpu")
    got = dodoor_fused_sparse_ref(*args, 0.5, **kw)
    keys, r, d_types, nt, L, D, C = (a.numpy() for a in args)
    want = _two_stage(keys.astype(np.uint32), r, d_types, nt, L, D, C,
                      kw["down0"].numpy(), kw["down1"].numpy(),
                      kw["now"].numpy())
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy(), np.asarray(b))


@pytest.mark.gpu
@pytest.mark.parametrize("form", ["sparse", "dense"])
def test_cuda_template_matches_plain_version_at_edge_shapes(form):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU form)")
    Wds = (0,) + cs.EDGE_WD
    Ps = (0, 8) if form == "sparse" else (0,)
    assert cs.edge_phase(torch, form, Wds, Ps) == (
        len(cs.EDGE_SHAPES) * len(Wds) * len(Ps))


# ---------------------------------------------------- F3: no valid key rows

def _qkv(Lq, Lk, seed=0):
    rng = np.random.RandomState(seed)
    return tuple(torch.from_numpy(rng.randn(*s).astype(np.float32))
                 for s in ((1, 4, Lq, 32), (1, 2, Lk, 32), (1, 2, Lk, 32)))


@pytest.mark.parametrize("fn", [flash_attention, common.attention],
                         ids=["flash_attention", "common.attention"])
def test_causal_attention_with_more_queries_than_keys_raises(fn):
    q, k, v = _qkv(Lq=8, Lk=5)
    with pytest.raises(ValueError, match="Lq ≤ Lk"):
        fn(q, k, v, causal=True)


@pytest.mark.parametrize("fn", [flash_attention, common.attention],
                         ids=["flash_attention", "common.attention"])
def test_attention_without_empty_rows_still_runs(fn):
    """Non-causal Lq > Lk has no empty row; causal Lq ≤ Lk neither."""
    q, k, v = _qkv(Lq=8, Lk=5)
    assert fn(q, k, v, causal=False).shape == q.shape
    q, k, v = _qkv(Lq=5, Lk=8, seed=1)
    out = fn(q, k, v, causal=True)
    assert out.shape == q.shape and bool(out.isfinite().all())
