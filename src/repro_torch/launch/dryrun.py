"""Multi-pod dry-run of every (arch × shape × mesh) cell, on the ``meta``
device — the port of the JAX package's ``launch/dryrun.py``.

Each cell builds the step's inputs as meta tensors (shapes and dtypes, no
storage): the train state (``train.abstract_train_state``) and batch for
``train_*``, the parameters and batch for ``prefill_*``, the parameters,
cache and token for ``decode_*`` / ``long_*`` (``models.registry``).  It
lays them out by the sharding rules (``repro_torch.sharding``) over the
production mesh's named shape, and writes:

* ``state_bytes_per_device``: the bytes those tensors put on one card
  under those placements (and ``state_bytes_by_part``);
* the analytic cost model's per-device flops, HBM bytes and collective
  bytes (``launch/costmodel.py``) and the roofline terms at the H100's
  peak rates (``launch/mesh.py``);
* ``model_flops_global`` and ``useful_flops_ratio``.

No cell allocates, touches a card or needs a process group, so every
cell runs on any host.  The reference's ``hlo_*`` keys and its
``memory_analysis`` come from an XLA compile and have no counterpart
here (README).  Artifacts land in ``<out>/<arch>__<shape>__<mesh>[__tag]
.json``.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m \
        --shape train_4k [--multi-pod] [--all] [--out experiments/dryrun]
"""
from __future__ import annotations

import argparse
import json
import time
import traceback
from dataclasses import replace
from pathlib import Path

import torch

from .. import sharding as shd
from ..configs import ARCHS, SHAPES, applicable
from ..models import registry
from ..train.steps import abstract_train_state
from . import costmodel as cm
from .hlo_analysis import roofline_terms
from .mesh import HBM_BW, LINK_BW, PEAK_FLOPS_BF16, make_production_mesh


def model_flops(cfg, shape) -> float:
    """Analytic MODEL_FLOPS: 6·N·D train / 2·N_active·D forward."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n_active * shape.seq_len * shape.global_batch
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.seq_len * shape.global_batch
    return 2.0 * n_active * shape.global_batch       # decode: 1 tok/seq


def build_cell(cfg, shape, mesh, layout: str = "fsdp",
               kv_int8: bool = False) -> dict:
    """{part: (meta tree, spec tree)} of a cell's step inputs: params,
    opt (train), batch (train, prefill), cache and token (decode)."""
    if shape.kind == "train":
        params, opt = abstract_train_state(cfg)
        batch = registry.make_inputs(cfg, shape)
        opt_specs = type(opt)(step=shd.P(),
                              m=shd.param_specs(opt.m, mesh, layout),
                              v=shd.param_specs(opt.v, mesh, layout))
        return {"params": (params, shd.param_specs(params, mesh, layout)),
                "opt": (opt, opt_specs),
                "batch": (batch, shd.batch_specs(batch, mesh, layout))}
    params = registry.abstract_params(cfg)
    parts = {"params": (params, shd.param_specs(params, mesh, layout))}
    if shape.kind == "prefill":
        batch = registry.make_inputs(cfg, shape)
        parts["batch"] = (batch, shd.batch_specs(batch, mesh, layout))
        return parts
    specs = registry.make_inputs(
        cfg, shape, cache_dtype=torch.int8 if kv_int8 else None)
    cache, token = specs["cache"], specs["token"]
    parts["cache"] = (cache, shd.cache_specs(cache, mesh))
    parts["token"] = (token, shd.batch_specs({"t": token}, mesh)["t"])
    return parts


def state_bytes(cfg, shape, mesh, layout: str = "fsdp",
                kv_int8: bool = False) -> dict:
    """{part: bytes on one device} of a cell's step inputs under the
    sharding rules on ``mesh`` (a ``launch.mesh.Mesh``)."""
    return {k: shd.bytes_per_device(tree, specs, mesh)
            for k, (tree, specs) in build_cell(cfg, shape, mesh, layout,
                                               kv_int8).items()}


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             out_dir: Path, layout: str = "fsdp", bf16: bool = False,
             sp: bool = False, tag: str = "",
             moe_dodoor_cf: float | None = None, kv_int8: bool = False,
             remat: bool = True) -> dict:
    mesh = make_production_mesh(multi_pod=multi_pod)
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    chips = 512 if multi_pod else 256
    cfg = ARCHS[arch]
    if moe_dodoor_cf is not None and cfg.is_moe:
        cfg = replace(cfg, router="dodoor", capacity_factor=moe_dodoor_cf)
    shape = SHAPES[shape_name]
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "chips": chips, "layout": layout, "bf16": bf16, "sp": sp}
    suffix = f"__{tag}" if tag else ""
    path = out_dir / f"{arch}__{shape_name}__{mesh_name}{suffix}.json"
    ok, why = applicable(cfg, shape)
    if not ok:
        rec.update(status="skipped", reason=why)
        out_dir.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(rec, indent=1))
        return rec
    t0 = time.time()
    try:
        parts = state_bytes(cfg, shape, mesh, layout, kv_int8)
        mdims = cm.MeshDims(data=chips // 16, model=16, chips=chips)
        opts = cm.PerfOpts(bf16=bf16, sp=sp, layout=layout,
                           kv_int8=kv_int8, remat=remat)
        flops_dev = cm.flops_per_device(cfg, shape, mdims, opts)
        bytes_dev = cm.bytes_per_device(cfg, shape, mdims, opts)
        coll_dev = cm.collective_bytes_per_device(cfg, shape, mdims, opts)
        terms = roofline_terms(flops_dev, bytes_dev, coll_dev,
                               peak_flops=PEAK_FLOPS_BF16 * opts.peak_scale,
                               hbm_bw=HBM_BW, link_bw=LINK_BW)
        mf = model_flops(cfg, shape)
        rec.update(
            status="ok", build_s=round(time.time() - t0, 3),
            flops_per_device=flops_dev,
            bytes_per_device=bytes_dev,
            collective_bytes_per_device=coll_dev,
            state_bytes_per_device=sum(parts.values()),
            state_bytes_by_part=parts,
            model_flops_global=mf,
            useful_flops_ratio=(mf / (flops_dev * chips)
                                if flops_dev else 0.0),
            **terms,
        )
    except Exception as e:                                # noqa: BLE001
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
    out_dir.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(rec, indent=1, default=str))
    return rec


def _auto_optimized(arch: str, shape_name: str) -> dict:
    """The per-cell layout policy distilled from the §Perf hillclimbs."""
    cfg = ARCHS[arch]
    shape = SHAPES[shape_name]
    kw = dict(bf16=True)
    if shape.kind == "decode":
        kw.update(layout="inference", kv_int8=True)
        return kw
    small = cfg.param_count() < 500e6
    if small:
        kw.update(layout="dp", remat=False)
    else:
        kw.update(layout="fsdp", sp=True)
        if cfg.is_moe:
            kw.update(moe_dodoor_cf=1.0)
    return kw


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="arch id or 'all'")
    ap.add_argument("--shape", default=None, help="shape name or 'all'")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="every (arch × shape) cell")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--layout", default="fsdp",
                    choices=["fsdp", "inference", "dp"])
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--sp", action="store_true")
    ap.add_argument("--tag", default="",
                    help="artifact filename suffix for perf iterations")
    ap.add_argument("--moe-dodoor-cf", type=float, default=None,
                    help="switch MoE router to dodoor and set the capacity "
                         "factor (balanced routing tolerates lower cf)")
    ap.add_argument("--kv-int8", action="store_true",
                    help="int8 KV cache (decode cells)")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--optimized", action="store_true",
                    help="apply the per-cell auto-layout heuristic learned "
                         "in §Perf (bf16 everywhere; dp for <500M models; "
                         "inference layout + int8 KV for decode; SP + "
                         "dodoor-cf1.0 for large/MoE training)")
    args = ap.parse_args(argv)

    archs = list(ARCHS) if (args.all or args.arch in (None, "all")) \
        else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape in (None, "all")) \
        else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    out_dir = Path(args.out)
    n_ok = n_skip = n_err = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                kw = dict(layout=args.layout, bf16=args.bf16, sp=args.sp,
                          tag=args.tag, moe_dodoor_cf=args.moe_dodoor_cf,
                          kv_int8=args.kv_int8, remat=not args.no_remat)
                if args.optimized:
                    kw.update(_auto_optimized(arch, shape))
                    kw["tag"] = args.tag or "opt"
                rec = run_cell(arch, shape, multi_pod=mp, out_dir=out_dir,
                               **kw)
                tag = rec["status"]
                n_ok += tag == "ok"
                n_skip += tag == "skipped"
                n_err += tag == "error"
                if tag == "ok":
                    print(f"[ok]   {arch:22s} {shape:12s} {rec['mesh']:10s} "
                          f"state={rec['state_bytes_per_device']/1e9:7.2f}GB "
                          f"dom={rec['dominant']:10s} "
                          f"roofline={rec['roofline_fraction']:.3f} "
                          f"coll="
                          f"{rec['collective_bytes_per_device'] / 1e6:.1f}MB",
                          flush=True)
                elif tag == "skipped":
                    print(f"[skip] {arch:22s} {shape:12s} {rec['mesh']:10s} "
                          f"{rec['reason'][:60]}", flush=True)
                else:
                    print(f"[ERR]  {arch:22s} {shape:12s} {rec['mesh']:10s} "
                          f"{rec['error'][:120]}", flush=True)
    print(f"\ndry-run complete: {n_ok} ok, {n_skip} skipped, {n_err} errors")
    raise SystemExit(1 if n_err else 0)


if __name__ == "__main__":
    main()
