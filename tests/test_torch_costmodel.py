"""The port's cost model (``launch/costmodel.py``), roofline terms
(``launch/hlo_analysis.py``) and dry-run (``launch/dryrun.py``) against
the JAX package's on the CPU.

Tolerance: exact everywhere.  ``flops_per_device``, ``bytes_per_device``
and ``collective_bytes_per_device`` are hardware-free and equal the
reference's bit for bit (the same terms in the same order) over every
arch × shape × mesh × option set; ``roofline_terms`` equals the
reference's on the same inputs.  ``PerfOpts.peak_scale`` is the one
hardware fact, pinned to the H100's FP32 / BF16 ratio where the
reference has the TPU's 0.5.  The reference's dry-run forces 512 XLA
host devices when imported, so the port's dry-run cells are held to the
reference's ``applicable`` and to the cost model, not to that module."""
import itertools
import json

import pytest

from _reference_cache import no_persistent_compile_cache  # noqa: F401

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import repro.configs as jconfigs  # noqa: E402
from repro.launch import costmodel as jcm  # noqa: E402
from repro.launch import hlo_analysis as jhlo  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro_torch.launch import costmodel as cm  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import hlo_analysis as hlo  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402

ARCHS = sorted(tconfigs.ARCHS)
#: (data, model, chips): one card, the pod, two pods, the pod's data
#: axis alone, and two that leave part of the mesh unused.
MESH_DIMS = [(1, 1, 1), (16, 16, 256), (32, 16, 512), (16, 1, 16),
             (8, 2, 16), (1, 16, 16)]
#: Every combination of the five levers.
OPTS = [dict(bf16=b, sp=s, layout=lay, kv_int8=k, remat=r)
        for b, s, lay, k, r in itertools.product(
            (False, True), (False, True), ("fsdp", "inference", "dp"),
            (False, True), (False, True))]


@pytest.mark.parametrize("shape", sorted(tconfigs.SHAPES))
@pytest.mark.parametrize("name", ARCHS)
def test_costs_exact(name, shape):
    tcfg, jcfg = tconfigs.ARCHS[name], jconfigs.ARCHS[name]
    ts, js = tconfigs.SHAPES[shape], jconfigs.SHAPES[shape]
    for dims in MESH_DIMS:
        tm, jm = cm.MeshDims(*dims), jcm.MeshDims(*dims)
        for kw in OPTS:
            to, jo = cm.PerfOpts(**kw), jcm.PerfOpts(**kw)
            assert cm.flops_per_device(tcfg, ts, tm, to) == \
                jcm.flops_per_device(jcfg, js, jm, jo), (dims, kw)
            assert cm.bytes_per_device(tcfg, ts, tm, to) == \
                jcm.bytes_per_device(jcfg, js, jm, jo), (dims, kw)
            assert cm.collective_bytes_per_device(tcfg, ts, tm, to) == \
                jcm.collective_bytes_per_device(jcfg, js, jm, jo), (dims, kw)
        for remat in (False, True):
            assert cm.flops_per_device(tcfg, ts, tm, remat=remat) == \
                jcm.flops_per_device(jcfg, js, jm, remat=remat)


@pytest.mark.parametrize("bf16", [False, True])
def test_peak_scale_pinned(bf16):
    """``peak_scale`` differs from the reference's only where the hardware
    does: bf16 runs at the full bf16 peak on both; float32 at the H100's
    FP32 / BF16 ratio (67 / 989) where the TPU's MXU runs at 0.5.  The
    hardware-free levers are the reference's."""
    for sp, layout in itertools.product((False, True), ("fsdp", "dp")):
        to = cm.PerfOpts(bf16=bf16, sp=sp, layout=layout)
        jo = jcm.PerfOpts(bf16=bf16, sp=sp, layout=layout)
        assert (to.act_bytes, to.ar_factor) == (jo.act_bytes, jo.ar_factor)
        if bf16:
            assert to.peak_scale == jo.peak_scale == 1.0
        else:
            assert jo.peak_scale == 0.5
            assert to.peak_scale == 67e12 / 989e12
            assert tmesh.PEAK_FLOPS_BF16 * to.peak_scale == pytest.approx(
                tmesh.PEAK_FLOPS_FP32, rel=1e-15)


ROOFLINE_CASES = [
    (1e15, 1e11, 1e9), (1e12, 1e12, 0.0), (0.0, 0.0, 0.0), (3.0, 7.0, 11.0),
    (5e14, 5e10, 5e10), (1.0, 1.0, 1.0)]


@pytest.mark.parametrize("flops,nbytes,coll", ROOFLINE_CASES)
@pytest.mark.parametrize("rates", [(989e12, 3.35e12, 50e9),
                                   (197e12, 819e9, 50e9), (1.0, 1.0, 1.0)])
def test_roofline_terms(flops, nbytes, coll, rates):
    peak, hbm, link = rates
    assert hlo.roofline_terms(flops, nbytes, coll, peak_flops=peak,
                              hbm_bw=hbm, link_bw=link) == \
        jhlo.roofline_terms(flops, nbytes, coll, peak_flops=peak,
                            hbm_bw=hbm, link_bw=link)


def _meta_only(tree) -> bool:
    if isinstance(tree, dict):
        return all(_meta_only(v) for v in tree.values())
    if isinstance(tree, tuple):
        return all(_meta_only(v) for v in tree)
    return tree.device.type == "meta"


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_dryrun_cell(shape, tmp_path):
    """A cell of smollm-135m on the pod, in-process: status ok, 256 chips,
    the cost model's numbers, the roofline at the H100's rates, every
    input on meta (no allocation), no ``hlo_*`` key."""
    rec = dryrun.run_cell("smollm-135m", shape, multi_pod=False,
                          out_dir=tmp_path)
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["chips"] == 256 and rec["mesh"] == "pod16x16"
    assert rec["compute_s"] > 0
    assert not [k for k in rec if k.startswith("hlo")]
    assert "memory_analysis" not in rec
    cfg, ts = tconfigs.ARCHS["smollm-135m"], tconfigs.SHAPES[shape]
    jcfg, js = jconfigs.ARCHS["smollm-135m"], jconfigs.SHAPES[shape]
    m = jcm.MeshDims(data=16, model=16, chips=256)
    assert rec["flops_per_device"] == jcm.flops_per_device(jcfg, js, m)
    assert rec["bytes_per_device"] == jcm.bytes_per_device(jcfg, js, m)
    assert rec["collective_bytes_per_device"] == \
        jcm.collective_bytes_per_device(jcfg, js, m)
    peak = tmesh.PEAK_FLOPS_BF16 * cm.PerfOpts().peak_scale
    assert rec["compute_s"] == rec["flops_per_device"] / peak
    assert rec["memory_s"] == rec["bytes_per_device"] / tmesh.HBM_BW
    assert rec["collective_s"] == \
        rec["collective_bytes_per_device"] / tmesh.LINK_BW
    n = cfg.active_param_count()
    want_mf = {"train": 6.0 * n * ts.seq_len * ts.global_batch,
               "prefill": 2.0 * n * ts.seq_len * ts.global_batch,
               "decode": 2.0 * n * ts.global_batch}[ts.kind]
    assert rec["model_flops_global"] == want_mf
    assert rec["useful_flops_ratio"] == want_mf / (
        rec["flops_per_device"] * 256)
    parts = rec["state_bytes_by_part"]
    assert rec["state_bytes_per_device"] == sum(parts.values()) > 0
    assert set(parts) == {"train": {"params", "opt", "batch"},
                          "prefill": {"params", "batch"},
                          "decode": {"params", "cache", "token"}}[ts.kind]
    mesh = tmesh.make_production_mesh()
    for tree, _ in dryrun.build_cell(cfg, ts, mesh).values():
        assert _meta_only(tree)
    on_disk = json.loads(
        (tmp_path / f"smollm-135m__{shape}__pod16x16.json").read_text())
    assert on_disk == json.loads(json.dumps(rec))


def test_dryrun_skipped_cell(tmp_path):
    """A cell the reference skips is skipped with its reason."""
    rec = dryrun.run_cell("smollm-135m", "long_500k", multi_pod=True,
                          out_dir=tmp_path, tag="t")
    ok, why = jconfigs.applicable(jconfigs.ARCHS["smollm-135m"],
                                  jconfigs.SHAPES["long_500k"])
    assert not ok
    assert rec == {"arch": "smollm-135m", "shape": "long_500k",
                   "mesh": "pod2x16x16", "chips": 512, "layout": "fsdp",
                   "bf16": False, "sp": False, "status": "skipped",
                   "reason": why}
    assert (tmp_path / "smollm-135m__long_500k__pod2x16x16__t.json").exists()


def test_dryrun_cli_optimized(tmp_path, capsys):
    """``main`` with ``--optimized`` over one arch's four shapes: the
    per-cell policy's layout and levers reach the records."""
    with pytest.raises(SystemExit) as done:
        dryrun.main(["--arch", "qwen2-7b", "--shape", "all", "--optimized",
                     "--out", str(tmp_path)])
    assert done.value.code == 0
    out = capsys.readouterr().out
    assert "3 ok, 1 skipped, 0 errors" in out
    train = json.loads((tmp_path / "qwen2-7b__train_4k__pod16x16__opt.json")
                       .read_text())
    decode = json.loads(
        (tmp_path / "qwen2-7b__decode_32k__pod16x16__opt.json").read_text())
    assert (train["layout"], train["bf16"], train["sp"]) == ("fsdp", True,
                                                              True)
    assert (decode["layout"], decode["bf16"]) == ("inference", True)
    cfg, s = jconfigs.ARCHS["qwen2-7b"], jconfigs.SHAPES["decode_32k"]
    m = jcm.MeshDims(data=16, model=16, chips=256)
    assert decode["bytes_per_device"] == jcm.bytes_per_device(
        cfg, s, m, jcm.PerfOpts(bf16=True, layout="inference",
                                kv_int8=True))
    assert decode["compute_s"] == decode["flops_per_device"] / 989e12
