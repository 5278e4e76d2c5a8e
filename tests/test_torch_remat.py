"""F9: ``remat`` in the three families that ignored it.  Under grad mode
with ``remat=True`` the port now checkpoints the units the reference
wraps in ``jax.checkpoint`` (``torch.utils.checkpoint``, non-reentrant):
each mamba2 layer, each recurrentgemma ``block_pattern`` block with the
``rem`` sublayers outside, and each whisper decoder layer (the encoder is
not checkpointed).  On the CPU, smoke configs with the reference's
weights carried by ``params_from_numpy``:

* the gradients with ``remat`` on equal those with it off, bit for bit
  (the recomputation repeats the same operations on the same inputs);
* fewer bytes are saved for the backward with it on, counted by
  ``torch.autograd.graph.saved_tensors_hooks`` over the whole forward;
* each family's gradients are held to the reference's ``remat=True``
  ones within ``tests/test_torch_train.py``'s tolerances (the loss within
  rtol 1e-5, each leaf within 1e-4 of its largest magnitude)."""
import numpy as np
import pytest

from _reference_cache import no_persistent_compile_cache  # noqa: F401

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro_torch.models import registry  # noqa: E402
from repro_torch.models.common import tree_leaves, tree_map  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402
from test_torch_train import (  # noqa: E402
    LOSS_RTOL, _grads_close, _reference_grads)
from test_torch_train_families import FAMILIES, _family_setup  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _saved_bytes(cfg, params, batch, remat: bool) -> int:
    """Bytes of the tensors the forward saves for the backward (each
    storage once), with grad mode on."""
    seen, total = set(), [0]

    def pack(t):
        key = (t.untyped_storage().data_ptr(), t.untyped_storage().nbytes())
        if key not in seen:
            seen.add(key)
            total[0] += key[1]
        return t

    p = tree_map(lambda a: a.detach().requires_grad_(True), params)
    with torch.enable_grad(), \
            torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out, _ = registry.forward(cfg, p, batch, remat=remat, unembed=False)
    del out
    return total[0]


@pytest.mark.parametrize("name", FAMILIES)
def test_remat_gradients_bit_for_bit(name):
    _, tcfg, _, tp, _, tb = _family_setup(name)
    on = tsteps.loss_and_grads(tcfg, tp, tb, remat=True)
    off = tsteps.loss_and_grads(tcfg, tp, tb, remat=False)
    assert torch.equal(on[0], off[0]) and torch.equal(on[1], off[1])
    for a, b in zip(tree_leaves(on[2]), tree_leaves(off[2])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", FAMILIES)
def test_remat_saves_fewer_bytes(name):
    """With remat each checkpointed unit keeps its inputs only (the
    hybrid's remainder and whisper's encoder keep theirs as before), and
    the forward's output is unchanged."""
    _, tcfg, _, tp, _, tb = _family_setup(name)
    on = _saved_bytes(tcfg, tp, tb, remat=True)
    off = _saved_bytes(tcfg, tp, tb, remat=False)
    assert 0 < on < off
    with torch.no_grad():
        a, _ = registry.forward(tcfg, tp, tb, remat=True)
        b, _ = registry.forward(tcfg, tp, tb, remat=False)
    assert torch.equal(a, b)


@pytest.mark.parametrize("name", FAMILIES)
def test_remat_gradients_match_reference(name):
    """The port's ``remat=True`` gradients against ``jax.value_and_grad``
    through the reference's ``jax.checkpoint``-ed forward."""
    jcfg, tcfg, jp, tp, jb, tb = _family_setup(name)
    jtotal, jg = _reference_grads(jcfg, jp, jb)
    total, _, tg = tsteps.loss_and_grads(tcfg, tp, tb, remat=True)
    np.testing.assert_allclose(float(total), float(jtotal), rtol=LOSS_RTOL)
    _grads_close(jg, tg)
