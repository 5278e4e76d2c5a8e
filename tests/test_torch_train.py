"""The port's train step (``repro_torch.train``) and training launcher
against the JAX package's on the CPU, with the reference's weights
carried by ``params_from_numpy`` and the same synthetic batches.

Tolerances (float32): the loss within rtol 1e-5 — the smoke models'
forward agrees to rtol 2e-4 elementwise (``test_torch_models.py``), and
the mean cross-entropy averages those differences out; each gradient
leaf within 1e-4 of that leaf's largest magnitude (the same products and
sums in torch's order against XLA's, through three layers and back)."""
import numpy as np
import pytest

from _reference_cache import no_persistent_compile_cache  # noqa: F401

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.launch.train import main as train_main  # noqa: E402
from repro_torch.models import params_from_numpy  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402

LOSS_RTOL = 1e-5
GRAD_OF_MAX = 1e-4
#: Dense (tied, GQA), dense untied with 22 → 3 layers, MoE (the aux term
#: in the loss) and the VLM backbone (patches ahead of the tokens: the
#: loss on the text tail only).
ARCHS = ["smollm-135m", "tinyllama-1.1b", "qwen3-moe-235b-a22b",
         "qwen2-vl-2b"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _setup(name, B=2, L=32, seed=0):
    """(reference cfg, port cfg, reference params, port params, reference
    batch, port batch): the launcher's batch for the family, the
    reference's from the reference pipeline, the port's from the port's."""
    jcfg, tcfg = jconfigs.ARCHS[name].smoke(), tconfigs.ARCHS[name].smoke()
    jp = jregistry.init_params(jcfg, jax.random.PRNGKey(seed))
    tp = params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    from repro.data import SyntheticLM as JSyntheticLM
    jb = dict(JSyntheticLM(jcfg.vocab, L, B, seed).batch(0))
    tb = SyntheticLM(tcfg.vocab, L, B, seed, device="cpu").batch(0)
    if jcfg.family == "vlm":
        n_p = 4
        patches = np.random.RandomState(seed).randn(
            B, n_p, jcfg.d_model).astype(np.float32)
        pos3 = np.broadcast_to(np.arange(L)[None, None], (B, 3, L)).astype(
            np.int32)
        jb = {"tokens": jb["tokens"][:, :-n_p], "labels": jb["labels"],
              "patches": jnp.asarray(patches), "positions3": jnp.asarray(pos3)}
        tb = {"tokens": tb["tokens"][:, :-n_p], "labels": tb["labels"],
              "patches": torch.from_numpy(patches),
              "positions3": torch.from_numpy(pos3)}
    return jcfg, tcfg, jp, tp, jb, tb


def _reference_grads(cfg, p, batch, aux_weight=0.01):
    labels = batch["labels"]

    def loss_fn(p):
        hidden, aux = jregistry.forward(cfg, p, batch, remat=True,
                                        unembed=False)
        hidden = hidden[:, -labels.shape[1]:]
        loss = jsteps.chunked_ce_loss(cfg, p, hidden, labels)
        return loss + aux_weight * aux.get("moe_aux", 0.0)

    return jax.jit(jax.value_and_grad(loss_fn))(p)


def _grads_close(jg, tg):
    jl = [np.asarray(x) for x in jax.tree.leaves(jg)]
    tl = [x.numpy() for x in tree_leaves(tg)]
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert a.shape == b.shape
        scale = float(np.abs(a).max())
        np.testing.assert_allclose(b, a, rtol=0, atol=GRAD_OF_MAX * scale)


@pytest.mark.parametrize("L,chunk", [(70, 32), (64, 512), (1, 8)])
def test_chunked_ce_loss_matches_reference(L, chunk):
    """A ragged last chunk, one chunk, ignored labels (−1)."""
    cfg = tconfigs.ARCHS["smollm-135m"].smoke()
    rng = np.random.RandomState(L)
    hidden = rng.randn(2, L, cfg.d_model).astype(np.float32)
    labels = rng.randint(-1, cfg.vocab, (2, L)).astype(np.int32)
    embed = rng.randn(cfg.vocab, cfg.d_model).astype(np.float32) * 0.1
    want = jsteps.chunked_ce_loss(cfg, {"embed": jnp.asarray(embed)},
                                  jnp.asarray(hidden), jnp.asarray(labels),
                                  chunk=chunk)
    got = tsteps.chunked_ce_loss(cfg, {"embed": torch.from_numpy(embed)},
                                 torch.from_numpy(hidden),
                                 torch.from_numpy(labels), chunk=chunk)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("name", ARCHS)
def test_train_step_matches_reference(name):
    """One ``make_train_step`` step: the loss; then the gradients of the
    same loss (``loss_and_grads``) against ``jax.value_and_grad``."""
    jcfg, tcfg, jp, tp, jb, tb = _setup(name)
    jstep = jax.jit(jsteps.make_train_step(jcfg, lr=1e-3))
    _, _, jm = jstep(jp, jsteps.adamw_init(jp), jb)
    LAUNCHES.clear()
    _, opt, tm = tsteps.make_train_step(tcfg, lr=1e-3)(tp, adamw_init(tp),
                                                        tb)
    assert not LAUNCHES and int(opt.step) == 1
    for k in ("loss", "total"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                   rtol=LOSS_RTOL)
    jtotal, jg = _reference_grads(jcfg, jp, jb)
    total, ce, tg = tsteps.loss_and_grads(tcfg, tp, tb)
    np.testing.assert_allclose(float(total), float(jtotal), rtol=LOSS_RTOL)
    _grads_close(jg, tg)


@pytest.mark.parametrize("name", ["smollm-135m", "qwen3-moe-235b-a22b"])
def test_remat_gives_the_same_gradients(name):
    """``remat`` recomputes each layer in the backward pass: the same
    gradients bit for bit (the same ops on the same inputs)."""
    _, tcfg, _, tp, _, tb = _setup(name)
    _, _, g1 = tsteps.loss_and_grads(tcfg, tp, tb, remat=True)
    _, _, g0 = tsteps.loss_and_grads(tcfg, tp, tb, remat=False)
    for a, b in zip(tree_leaves(g1), tree_leaves(g0)):
        assert torch.equal(a, b)


def test_prefill_and_serve_steps_match_reference():
    jcfg, tcfg, jp, tp, jb, tb = _setup("tinyllama-1.1b")
    want = np.asarray(jax.jit(jsteps.make_prefill_step(jcfg))(jp, jb))
    got = tsteps.make_prefill_step(tcfg)(tp, tb)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-5)
    from repro_torch.models import registry
    jcache = jregistry.init_cache(jcfg, 2, 8)
    tcache = registry.init_cache(tcfg, 2, 8, device="cpu")
    jserve = jax.jit(jsteps.make_serve_step(jcfg))
    tserve = tsteps.make_serve_step(tcfg)
    jt, tt = jb["tokens"][:, :1], tb["tokens"][:, :1]
    for _ in range(4):
        jt, jcache = jserve(jp, jcache, jt)
        tt, tcache = tserve(tp, tcache, tt)
        assert tt.dtype == torch.int32
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_init_train_state():
    cfg = tconfigs.ARCHS["smollm-135m"].smoke()
    p, opt = tsteps.init_train_state(cfg, 0, device="cpu")
    assert int(opt.step) == 0
    assert [t.shape for t in tree_leaves(p)] == \
        [t.shape for t in tree_leaves(opt.m)]


# ---------------------------------------------------------------- launcher

def test_launcher_loss_decreases_and_resumes(tmp_path):
    """The port's version of the reference's
    ``TestTrainDriver.test_loss_decreases_and_resumes``."""
    losses = train_main([
        "--arch", "smollm-135m", "--smoke", "--steps", "30",
        "--batch", "4", "--seq", "64", "--lr", "3e-3",
        "--ckpt-dir", str(tmp_path), "--ckpt-every", "10",
        "--log-every", "100", "--device", "cpu"])
    assert np.mean(losses[-5:]) < np.mean(losses[:5])
    losses2 = train_main([
        "--arch", "smollm-135m", "--smoke", "--steps", "35",
        "--batch", "4", "--seq", "64", "--resume",
        "--ckpt-dir", str(tmp_path), "--log-every", "100",
        "--device", "cpu"])
    # The last checkpoint is step 20, so the resumed run replays 20–34
    # (R5: step 20's batch twice).
    assert len(losses2) == 15


def test_launcher_failure_recovery_path(tmp_path, capsys):
    """The port's version of ``test_failure_recovery_path``, with R5
    replayed: the failure at 15 restores step 10's checkpoint (the state
    after step 10) and reruns from step 10."""
    losses = train_main([
        "--arch", "smollm-135m", "--smoke", "--steps", "25",
        "--batch", "2", "--seq", "32", "--ckpt-dir", str(tmp_path),
        "--ckpt-every", "10", "--fail-at", "15:4",
        "--log-every", "100", "--device", "cpu"])
    assert len(losses) == 30        # steps 0–14, then 10–24
    assert "[ft] restored step 10" in capsys.readouterr().out


@pytest.mark.parametrize("name", ["qwen2-vl-2b", "whisper-base",
                                  "dbrx-132b"])
def test_launcher_family_branches(name):
    """The launcher's vlm (patches ahead of the tokens) and audio
    (encoder frames) batches, and an MoE model: finite losses."""
    losses = train_main(["--arch", name, "--smoke", "--steps", "3",
                         "--batch", "2", "--seq", "32", "--log-every",
                         "100", "--device", "cpu"])
    assert len(losses) == 3 and np.all(np.isfinite(losses))
