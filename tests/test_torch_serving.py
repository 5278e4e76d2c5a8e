"""The port's serving path — the request cost model, replica pools and
request traces (``repro_torch.serving``), the online ``DodoorRouter`` and
the ``serve`` launcher — against the JAX reference on the CPU: every
number and placement equal, every printed policy row and placement line
equal.  The launcher's greedy-decode line comes from weights of another
generator than the reference's, so only its form is checked."""
import ast
import dataclasses

import numpy as np
import pytest

from _reference_cache import no_persistent_compile_cache  # noqa: F401

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import repro.configs as jconfigs  # noqa: E402
from repro import serving as jserving  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.serving import costs as jcosts  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro_torch import serving as tserving  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.serving import costs as tcosts  # noqa: E402

POLICIES = ["random", "pot", "prequal", "dodoor"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("name", list(jconfigs.ARCHS))
def test_costs_equal_the_reference(name):
    j, t = jconfigs.ARCHS[name], tconfigs.ARCHS[name]
    assert tcosts.kv_bytes_per_token(t) == jcosts.kv_bytes_per_token(j)
    assert tcosts.state_bytes(t) == jcosts.state_bytes(j)
    for plen, glen in ((16, 4), (1024, 128), (8192, 1024)):
        for got, want in zip(tserving.request_cost(t, plen, glen),
                             jserving.request_cost(j, plen, glen)):
            assert got.dtype == want.dtype
            assert np.array_equal(got, want)
    trace = tserving.synthesize_requests(t, 60, 25.0, seed=3)
    want = jserving.synthesize_requests(j, 60, 25.0, seed=3)
    for field in dataclasses.fields(want):
        got_f, want_f = (getattr(trace, field.name),
                         getattr(want, field.name))
        assert got_f.dtype == want_f.dtype, field.name
        assert np.array_equal(got_f, want_f), field.name


@pytest.mark.parametrize("interleave", [True, False])
def test_pool_equals_the_reference(interleave):
    got = tserving.make_replica_pool(interleave=interleave)
    want = jserving.make_replica_pool(interleave=interleave)
    assert np.array_equal(got.C, want.C) and got.C.dtype == want.C.dtype
    assert np.array_equal(got.node_type, want.node_type)
    assert got.type_names == want.type_names
    assert tserving.REPLICA_TYPES == tuple(
        tcosts.ReplicaType(**dataclasses.asdict(r))
        for r in jserving.REPLICA_TYPES)


@pytest.mark.parametrize("b,seed", [(None, 0), (5, 3)])
def test_router_places_as_the_reference(b, seed):
    """200 ``place`` calls with a ``complete`` after every third, over the
    request buckets of two archs: every placement equal, and the store
    and view equal after the run."""
    pool_j = jserving.make_replica_pool()
    pool_t = tserving.make_replica_pool()
    ref = jserving.DodoorRouter(pool_j, b=b, seed=seed)
    ours = tserving.DodoorRouter(pool_t, b=b, seed=seed, device="cpu")
    assert ours.b == ref.b
    rng = np.random.RandomState(seed)
    placed = []
    for i in range(200):
        name = ("qwen3-moe-235b-a22b", "tinyllama-1.1b")[i % 2]
        plen, glen = int(rng.randint(16, 8192)), int(rng.randint(4, 1024))
        j = ref.place(jconfigs.ARCHS[name], plen, glen)
        assert ours.place(tconfigs.ARCHS[name], plen, glen) == j, i
        placed.append((j, name, plen, glen))
        if i % 3 == 2:
            k, name, plen, glen = placed.pop(rng.randint(len(placed)))
            r, d = jserving.request_cost(jconfigs.ARCHS[name], plen, glen)
            d_ms = float(d[pool_j.node_type[k]])
            ref.complete(k, r, d_ms)
            ours.complete(k, r, d_ms)
    for attr in ("_store_L", "_store_D", "_view_L", "_view_D"):
        assert np.array_equal(getattr(ours, attr), getattr(ref, attr)), attr
    assert len({j for j, *_ in placed}) > 1


def test_router_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserving.DodoorRouter(tserving.make_replica_pool())


@pytest.mark.parametrize("policy", POLICIES)
def test_launcher_prints_the_references_rows(policy, capsys):
    """``launch.serve.main`` on the CPU prints the reference launcher's
    fleet line, policy row and eight placements."""
    argv = ["--arch", "qwen3-moe-235b-a22b", "--requests", "200",
            "--policy", policy]
    jserve.main(argv)
    want = capsys.readouterr().out.splitlines()
    tserve.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert len(want) == 10 and got == want


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "tinyllama-1.1b",
                                  "qwen2-vl-2b", "recurrentgemma-2b",
                                  "whisper-base"])
def test_launcher_decode_demo(arch, capsys):
    """``--decode-demo`` decodes 16 greedy tokens of the smoke model (MoE,
    dense, the VLM backbone, the hybrid or Whisper, unprimed as in the
    reference's launcher) after the router lines."""
    tserve.main(["--arch", arch, "--requests", "20", "--policy", "random",
                 "--decode-demo", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 11
    head = "greedy decode (smoke model): "
    assert lines[-1].startswith(head)
    toks = ast.literal_eval(lines[-1][len(head):])
    vocab = tconfigs.ARCHS[arch].smoke().vocab
    assert len(toks) == 16
    assert all(isinstance(t, int) and 0 <= t < vocab for t in toks)
