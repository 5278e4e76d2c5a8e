"""Checkpoints across the two packages: the port's ``Checkpointer``
writes and reads the JAX package's format (``step_NNNNNN/manifest.json``
and raw-byte ``shard_00000.npz``), so a checkpoint written by either
restores in the other, bf16 leaves included; and a JAX-trained state
carried over by ``train_state_from_numpy`` takes one more step in the
port that matches the reference's next step."""
import json

import numpy as np
import pytest

from _reference_cache import no_persistent_compile_cache  # noqa: F401

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402,F401  (the reference's restore needs it)

import repro.configs as jconfigs  # noqa: E402
from repro.checkpoint import Checkpointer as JCheckpointer  # noqa: E402
from repro.data import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro_torch.checkpoint import Checkpointer, latest_step  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.models import train_state_from_numpy  # noqa: E402
from repro_torch.optim import AdamWState  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402

NAME = "smollm-135m"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _jax_state(steps=1):
    """The reference's (params, opt) after ``steps`` train steps."""
    cfg = jconfigs.ARCHS[NAME].smoke()
    p, opt = jsteps.init_train_state(cfg, jax.random.PRNGKey(0))
    step = jax.jit(jsteps.make_train_step(cfg, lr=1e-3))
    data = JSyntheticLM(cfg.vocab, 32, 2, 0)
    for s in range(steps):
        p, opt, _ = step(p, opt, data.batch(s))
    return cfg, p, opt


def _port_template():
    cfg = tconfigs.ARCHS[NAME].smoke()
    return cfg, tsteps.init_train_state(cfg, 1, device="cpu")


def _same_leaves(jtree, ttree):
    jl = [np.asarray(x) for x in jax.tree.leaves(jtree)]
    tl = tree_leaves(ttree)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert a.shape == tuple(b.shape)
        np.testing.assert_array_equal(b.numpy(), a)


def test_a_reference_checkpoint_restores_in_the_port(tmp_path):
    _, p, opt = _jax_state()
    JCheckpointer(tmp_path).save(1, (p, opt))
    _, template = _port_template()
    (tp, topt), step = Checkpointer(tmp_path).restore(template)
    assert step == 1 and isinstance(topt, AdamWState)
    assert topt.step.dtype == torch.int32 and int(topt.step) == 1
    _same_leaves((p, opt), (tp, topt))


def test_a_port_checkpoint_restores_in_the_reference(tmp_path):
    cfg, (tp, topt) = _port_template()
    tp, topt, _ = tsteps.make_train_step(cfg, lr=1e-3)(
        tp, topt, SyntheticLM(cfg.vocab, 32, 2, 0, device="cpu").batch(0))
    Checkpointer(tmp_path).save(7, (tp, topt))
    manifest = json.loads((tmp_path / "step_000007" / "manifest.json")
                          .read_text())
    assert manifest["keys"]["1/step"] == {"shape": [], "dtype": "int32"}
    assert "0/layers/attn/wq" in manifest["keys"]
    _, jp, jopt = _jax_state(0)
    (rp, ropt), step = JCheckpointer(tmp_path).restore((jp, jopt))
    assert step == 7
    _same_leaves((rp, ropt), (tp, topt))


def test_bf16_leaves_round_trip_both_ways(tmp_path):
    """bf16 leaves (and int8, int32 and 0-d ones) bit for bit, each
    package reading the other's; the port rebuilds bf16 through torch
    (an int16 view), not numpy."""
    rng = np.random.RandomState(0)
    a = rng.randn(5, 7).astype(np.float32)
    jtree = {"w": jnp.asarray(a, jnp.bfloat16),
             "q": jnp.asarray(rng.randint(-127, 128, (9,)), jnp.int8),
             "s": jnp.int32(3), "f": jnp.asarray(a)}
    JCheckpointer(tmp_path / "j").save(2, jtree)
    ttree = {"w": torch.from_numpy(a).to(torch.bfloat16),
             "q": torch.zeros(9, dtype=torch.int8),
             "s": torch.tensor(0, dtype=torch.int32),
             "f": torch.zeros(5, 7)}
    got, _ = Checkpointer(tmp_path / "j").restore(ttree)
    assert got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"].view(torch.int16), ttree["w"].view(
        torch.int16))
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(jtree["q"]))
    assert int(got["s"]) == 3 and got["s"].shape == ()
    np.testing.assert_array_equal(got["f"].numpy(), a)
    Checkpointer(tmp_path / "t").save(3, got)
    back, _ = JCheckpointer(tmp_path / "t").restore(jtree)
    assert back["w"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(back["w"]).view(np.int16),
                                  np.asarray(jtree["w"]).view(np.int16))
    np.testing.assert_array_equal(np.asarray(back["q"]),
                                  np.asarray(jtree["q"]))


def test_keep_latest_and_atomic_publish(tmp_path):
    """``keep`` newest steps survive; ``latest_step`` ignores a half-written
    ``.tmp`` directory and restores the newest complete step."""
    ck = Checkpointer(tmp_path, keep=2)
    for s in (1, 2, 3):
        ck.save(s, {"x": torch.full((3,), float(s))})
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        ["step_000002", "step_000003"]
    (tmp_path / "step_000009.tmp").mkdir()
    assert latest_step(tmp_path) == 3
    got, step = ck.restore({"x": torch.zeros(3)})
    assert step == 3 and torch.equal(got["x"], torch.full((3,), 3.0))
    assert latest_step(tmp_path / "none") is None
    with pytest.raises(FileNotFoundError):
        Checkpointer(tmp_path / "empty").restore({"x": torch.zeros(3)})


def test_a_jax_trained_state_continues_in_the_port():
    """Two reference steps, then the state carried over by
    ``train_state_from_numpy``: the port's third step against the
    reference's third — the loss within rtol 1e-5 and the parameters
    within 1e-2 of the learning rate (AdamW moves each parameter by at
    most lr·(|m̂/(√v̂+ε)| + wd·|p|); the gradients agree to 1e-4 of their
    leaf's largest value, and ε = 1e-8 lets that reach the step only on
    entries whose v̂ is tiny)."""
    cfg, p, opt = _jax_state(2)
    batch = JSyntheticLM(cfg.vocab, 32, 2, 0).batch(2)
    jp, jopt, jm = jax.jit(jsteps.make_train_step(cfg, lr=1e-3))(p, opt,
                                                                 batch)
    tcfg = tconfigs.ARCHS[NAME].smoke()
    tp, topt = train_state_from_numpy(
        tcfg, jax.tree.map(np.asarray, p), jax.tree.map(np.asarray, opt),
        device="cpu")
    assert int(topt.step) == 2
    tb = SyntheticLM(tcfg.vocab, 32, 2, 0, device="cpu").batch(2)
    tp, topt, tm = tsteps.make_train_step(tcfg, lr=1e-3)(tp, topt, tb)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    assert int(topt.step) == 3
    for a, b in zip(jax.tree.leaves(jp), tree_leaves(tp)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-2 * 1e-3)
