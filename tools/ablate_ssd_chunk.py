#!/usr/bin/env python3
"""Where the SSD chunk kernel K8's time goes: variants of it, each with one
part of its work cut out, timed at mamba2-1.3b's shape.

    python3 tools/ablate_ssd_chunk.py [--out FILE]

Each variant is a copy of ``src/repro_torch/kernels/csrc/ssd_chunk.cu``
with switches put into its loops and stores (``EDITS``; the tool fails if
the source no longer has the text it edits), built with the port's nvcc
flags, all at once, into ``build/ablate_ssd_chunk/``, and timed with CUDA
events (``chip_smoke.event_ms``) at B = 2, L = 1024, G = 1, 64 heads,
Q = P = 64, S = 128; the full kernel also at several heads per block.
A variant's outputs are wrong by design: only its time means something.
Its difference to the full kernel is what the cut part costs while the
rest runs; the parts overlap, so the differences do not add up.  Each
variant runs twice, in turns.  Prints the card's name and power limit,
each variant's registers and times, and a JSON summary last.  Needs a CUDA
device.

    python3 tools/ablate_ssd_chunk.py --backward [--baseline OLD.cu ...]
        [--out FILE]

does the same for K8's backward (``BWD_VARIANTS``: text edits, built into
``build/ablate_ssd_chunk_bwd/``): each variant's ``ssd_chunk_bwd_launch``
at mamba2-1.3b's training shape with the planned heads a block, in turns,
beside the registers and spill bytes of its backward kernel, and each
source given as ``--baseline OLD.cu`` (an earlier ``ssd_chunk.cu`` whose
backward launcher takes the same arguments) unedited as "baseline0",
"baseline1", ... in the order given.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc",
                      "ssd_chunk.cu")
OUT_DIR = os.path.join(ROOT, "build", "ablate_ssd_chunk")
SHAPE = (2, 1024, 64, 64, 1, 128, 64)   # B, L, H, P, G, S, chunk

#: (text of the kernel, the text with a switch): K_H, K_Y (the products),
#: K_ST (y and H stores; kept in the code by a condition the compiler
#: cannot decide), K_E (G_h's exponentials), K_HEAD (the head loop), K_CB
#: (C·Bᵀ), K_VEC (16- and 8-byte stores), K_OFF (team 1 starts after
#: team 0's first y).
EDITS = (
    ("for (int u = 0; u < Q; ++u) {\n        const float* br",
     "for (int u = 0; u < Q * K_H; ++u) {\n        const float* br"),
    ("for (; u < lo_end; ++u)", "for (; u < lo_end * K_Y; ++u)"),
    ("for (; u < hi_end; ++u)", "for (; u < hi_end * K_Y; ++u)"),
    ("if (2 * lane < P)", "if (2 * lane < P && (K_ST || P < 0))"),
    ("if (p >= P) continue;", "if (p >= P || !(K_ST || P < 0)) continue;"),
    ("if (p >= P || s0 + i >= S) continue;",
     "if (p >= P || s0 + i >= S || !(K_ST || P < 0)) continue;"),
    ("expf(fminf(st[i] - su, 0.0f))",
     "(K_E ? expf(fminf(st[i] - su, 0.0f)) : st[i] - su)"),
    ("for (int h = h_begin; h < h_end;",
     "for (int h = h_begin; h < (K_HEAD ? h_end : h_begin);"),
    # team 1 waits for team 0's first y only when both run heads
    ("if (team == 1 && h_begin < h_end) bar_sync(3, kThreads);",
     "if (K_HEAD && K_OFF && team == 1 && h_begin < h_end) "
     "bar_sync(3, kThreads);"),
    ("if (team == 0 && h == h_begin && split < h_last)",
     "if (K_OFF && team == 0 && h == h_begin && split < h_last)"),
    ("base < ntiles;", "base < K_CB * ntiles;"),
    ("nh, nblk, vec);", "nh, nblk, K_VEC ? vec : vec & (kVecX | kVecBC));"),
)
ON = dict(K_H=1, K_Y=1, K_ST=1, K_E=1, K_HEAD=1, K_CB=1, K_VEC=1, K_OFF=1)
VARIANTS = {
    "full": {},
    "no_H": dict(K_H=0),
    "no_y": dict(K_Y=0),
    "no_y_H": dict(K_H=0, K_Y=0),
    "no_stores": dict(K_ST=0),
    "no_exp": dict(K_E=0),
    "no_CB": dict(K_CB=0),
    "no_heads": dict(K_HEAD=0),
    "skeleton": dict(K_H=0, K_Y=0, K_ST=0),
    "scalar_stores": dict(K_VEC=0),
    "no_team_offset": dict(K_OFF=0),
}
#: Variants that change the text of the kernel: the unroll depths of H's
#: loop and of y's first loop (8 in the kernel).
TEXT_VARIANTS = {
    f"unroll_{loop}{n}": ((old, old.replace(f"unroll {was}", f"unroll {n}")),)
    for loop, was, old, ns in (
        ("H", 8, "#pragma unroll 8\n      for (int u = 0; u < Q", (4, 16)),
        ("y", 8, "#pragma unroll 8\n      for (; u < lo_end", (4, 16)))
    for n in ns}
NHS = (2, 4, 8, 16)

#: The "phases" variants: lane 0 of each warp stamps clock64() at the
#: kernel's phase boundaries (slot 0 the start, 1 after the loads; for
#: head j, slot 2 + 6j + k: k = 0 after the head's first barrier, 1 after
#: the scan and the warp's columns of G_h, 2 after y's stores, 3 after
#: x*w, 4 after the barrier behind it, 5 after H's stores; slot 50 + j
#: after head j's copies have landed, before its first barrier; slot 63
#: after C·Bᵀ), and block 0's thread 0 reads %globaltimer beside clock64()
#: at the start and after the last head, which gives the SM clock.
STAMPS = 64
PHASED = {"phases": {}, "phases_no_stores": dict(K_ST=0),
          "phases_no_team_offset": dict(K_OFF=0)}
MAX_BLOCKS = 4096
PHASE_HEAD = r"""
__device__ long long k8_clk[4096 * 16 * 64];
__device__ long long k8_gt[4];
__device__ __forceinline__ long long k8_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define STAMP(k) do { if ((threadIdx.x & 31) == 0 && (k) < 64 &&             \
    blockIdx.x < 4096) k8_clk[(blockIdx.x * 16 + (threadIdx.x >> 5)) * 64 + \
    (k)] = clock64(); } while (0)
#define EDGE(i) do { if (blockIdx.x == 0 && threadIdx.x == 0) {             \
    k8_gt[2 * (i)] = k8_ns(); k8_gt[2 * (i) + 1] = clock64(); } } while (0)
extern "C" int k8_read(void* clk, void* gt) {
  cudaError_t e = cudaMemcpyFromSymbol(clk, k8_clk, sizeof(k8_clk));
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(gt, k8_gt, sizeof(k8_gt));
  return (int)e;
}
"""
PHASE_EDITS = (
    ("  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n",
     "  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n"
     "  STAMP(0); EDGE(0);\n"),
    ("  cp_async_wait<2>();\n  __syncthreads();\n\n",
     "  cp_async_wait<2>();\n  __syncthreads();\n  STAMP(1);\n\n"),
    ("  __syncthreads();   // C B^T is in; C is dead\n",
     "  __syncthreads();   // C B^T is in; C is dead\n  STAMP(63);\n"),
    ("  // Warp w of a team takes rows",
     "  STAMP(62);\n  // Warp w of a team takes rows"),
    ("    cp_async_wait<1>();\n    bar_sync(1 + team, kTeamThreads);",
     "    cp_async_wait<1>();\n    STAMP(50 + h - h_begin);\n"
     "    bar_sync(1 + team, kTeamThreads);"),
    ("// head h's x, deltas, dt are in\n",
     "// head h's x, deltas, dt are in\n"
     "    const int j6 = 2 + 6 * (h - h_begin);\n    STAMP(j6);\n"),
    ("    __syncwarp();\n\n", "    __syncwarp();\n    STAMP(j6 + 1);\n\n"),
    ("    if (K_OFF && team == 0 && h == h_begin",
     "    STAMP(j6 + 2);\n    if (K_OFF && team == 0 && h == h_begin"),
    ("    bar_sync(1 + team, kTeamThreads);   // x*w is in",
     "    STAMP(j6 + 3);\n"
     "    bar_sync(1 + team, kTeamThreads);   STAMP(j6 + 4);  // x*w is in"),
    ("    // Head h + 1's x becomes the current one",
     "    STAMP(j6 + 5);\n    // Head h + 1's x becomes the current one"),
    ("    gcur = t;\n  }\n", "    gcur = t;\n  }\n  EDGE(1);\n"),
)


def build_variants() -> dict:
    from repro_torch.kernels import _build

    src = open(SOURCE).read()
    for old, new in EDITS:
        if old not in src:
            raise RuntimeError(f"ablate_ssd_chunk: the kernel no longer has "
                               f"{old!r}")
        src = src.replace(old, new)
    phased = src
    for old, new in PHASE_EDITS:
        if old not in phased:
            raise RuntimeError(f"ablate_ssd_chunk: the kernel no longer has "
                               f"{old!r}")
        phased = phased.replace(old, new)
    os.makedirs(OUT_DIR, exist_ok=True)
    procs = {}
    for name, off in dict(VARIANTS, **PHASED, **TEXT_VARIANTS).items():
        cu = os.path.join(OUT_DIR, f"{name}.cu")
        text = PHASE_HEAD + phased if name in PHASED else src
        if name in TEXT_VARIANTS:
            for old, new in off:
                if old not in text:
                    raise RuntimeError(f"ablate_ssd_chunk: the kernel no "
                                       f"longer has {old!r}")
                text = text.replace(old, new)
            off = {}
        with open(cu, "w") as f:
            f.write("".join(f"#define {k} {v}\n"
                            for k, v in dict(ON, **off).items()))
            f.write(text)
        so = os.path.join(OUT_DIR, f"{name}.so")
        procs[name] = (so, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"ablate_ssd_chunk: {name} failed:\n{log}")
        regs = [ln.split(":", 1)[-1].strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"{name}: {'; '.join(regs)}", flush=True)
        libs[name] = ctypes.CDLL(so)
    return libs


def read_phases(torch, lib, go, blocks: int, heads: int, name: str) -> dict:
    """Run the "phases" variant once (after a warm-up call) and reduce its
    stamps: the mean cycles of each phase over blocks and warps (and
    heads), warp 0's scan apart, and the SM clock from block 0."""
    import numpy as np

    go()
    torch.cuda.synchronize()
    go()
    torch.cuda.synchronize()
    clk = np.zeros((MAX_BLOCKS, 16, STAMPS), dtype=np.int64)
    gt = np.zeros(4, dtype=np.int64)
    fn = lib.k8_read
    fn.argtypes, fn.restype = (ctypes.c_void_p, ctypes.c_void_p), ctypes.c_int
    err = fn(clk.ctypes.data, gt.ctypes.data)
    if err:
        raise RuntimeError(f"ablate_ssd_chunk: CUDA error {err}")
    st = clk[:blocks].astype(np.float64)        # [block, warp, slot]
    ghz = (gt[3] - gt[1]) / max(gt[2] - gt[0], 1)
    phases = ("scan and G_h", "y", "x*w", "barrier", "H",
              "wait for the next head")
    mean = lambda a, b: float(np.mean(st[:, :, b] - st[:, :, a]))  # noqa
    cyc = {"loads, barrier": mean(0, 1), "C·Bᵀ": mean(1, 63),
           "team 1's start after team 0's first y": float(
               np.mean(st[:, 8:, 62] - st[:, 8:, 63])),
           "first copies": mean(62, 50), "first barrier": mean(50, 2)}
    if heads > 1:
        cyc["copies (a later head)"] = float(np.mean(
            [mean(2 + 6 * j - 1, 50 + j) for j in range(1, heads)]))
        cyc["first barrier (a later head)"] = float(np.mean(
            [mean(50 + j, 2 + 6 * j) for j in range(1, heads)]))
    for k, phase in enumerate(phases):
        lo = [2 + 6 * j + k for j in range(heads)]
        hi = [i + 1 for i in lo]
        if k == len(phases) - 1:                 # up to the next head's start
            lo, hi = lo[:-1], hi[:-1]
        if not lo:
            continue
        d = st[:, :, hi] - st[:, :, lo]          # [block, warp, head]
        cyc[f"{phase} (a head)"] = float(np.mean(d))
    last = 2 + 6 * (heads - 1) + 5
    cyc["block total"] = float(np.mean(st[:, :, last] - st[:, :, 0]))
    print(f"{name} (SM clock {ghz:.3f} GHz from block 0; mean cycles):",
          flush=True)
    for k, v in cyc.items():
        print(f"  {k}: {v:.0f} cycles = {v / ghz / 1e3:.3f} us", flush=True)
    return {"sm_ghz": float(ghz), "cycles": cyc}


def _drop(text):
    """A variant's edit: ``text`` taken out."""
    return ((text, ""),)


#: K8's backward's variants, name: ((text, replacement), ...): one TF32
#: product instead of three; each product of a head cut out (its operand
#: loads and splits go with it); G's exponentials as __expf; no warp
#: finishing the heads; no barrier between G and dx.
BWD_VARIANTS = {
    "full": (),
    "one_product": (("  mma_tf32(c, a.l, h0, h1);\n"
                     "  mma_tf32(c, a.h, l0, l1);\n", ""),),
    "no_dG": _drop("          mma3(acc, FragA(af), b);\n"),
    "no_xdH": _drop("          frag_bn<kMaxP>(hs, 32 * nj + 8 * n, 8 * ks, g, "
                    "t, b);\n          mma3(acc[n], a, b);\n"),
    "no_GTdy": _drop("          mma3(a1[n], a, b);\n"),
    "no_BdH": _drop("          mma3(a2[n], a, b);\n"),
    "fast_exp": (("const float m = expf(fminf(s_r[i] - su[e], 0.0f));",
                  "const float m = __expf(fminf(s_r[i] - su[e], 0.0f));"),),
    "no_finish": (("    if (j > 0 && warp == ((j - 1) & 15))\n",
                   "    if (j < 0)\n"),),
    "no_G_barrier": _drop("    __syncthreads();   // G is in\n"),
}
BWD_SHAPE = (2, 1024, 64, 64, 1, 128, 64)   # B, L, H, P, G, S, chunk


def backward(cs, torch, out, baselines=()) -> int:
    """The ``--backward`` mode (see the module's docstring)."""
    import re

    from repro_torch.kernels import _build
    from repro_torch.kernels._wrap import sm_count
    from repro_torch.kernels.ssd_chunk import ssd_chunk_bwd_ref
    from repro_torch.kernels.ssd_chunk.kernel import _BWD_ARGTYPES
    from repro_torch.kernels.ssd_chunk.ops import plan_k8_bwd

    card = cs.card_line()
    print(card, flush=True)
    cs.no_tf32(torch)
    src = open(SOURCE).read()
    texts = {}
    for name, edits in BWD_VARIANTS.items():     # every edit checked first
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"ablate_ssd_chunk: variant {name} does "
                                   f"not find {old!r} once")
            text = text.replace(old, new)
        texts[name] = text
    for i, path in enumerate(baselines or ()):
        texts[f"baseline{i}"] = open(path).read()
    out_dir = OUT_DIR + "_bwd"
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, text in texts.items():
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(out_dir, f"{name}.so")
        procs[name] = (so, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, regs = {}, {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"ablate_ssd_chunk: {name} failed:\n{log}")
        m = re.search(r"ssd_chunk_bwd_kernel.*?\n.*?(\d+) bytes spill stores"
                      r".*?\n.*?Used (\d+) registers", log, re.S)
        regs[name] = (int(m.group(2)), int(m.group(1))) if m else None
        print(f"{name}: registers, spill stores {regs[name]}", flush=True)
        libs[name] = ctypes.CDLL(so)
    B, L, H, P, G, S, chunk = BWD_SHAPE
    args, hpg = cs.k8_bwd_operands(torch, B, L, H, P, G, S, chunk)
    NC = L // chunk
    nh = plan_k8_bwd(B, G, NC, hpg, sm_count(torch.device("cuda")))
    runs = -(-hpg // nh)
    outs = [torch.empty_like(t) for t in args[:5]]
    part = torch.empty(2 * runs * args[3].numel(), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    want = ssd_chunk_bwd_ref(*args, heads_per_group=hpg)
    us, err = {}, {}
    for _ in range(2):
        for name, lib in libs.items():
            fn = lib.ssd_chunk_bwd_launch
            fn.argtypes, fn.restype = _BWD_ARGTYPES, ctypes.c_int

            def go(fn=fn):
                e = fn(*(t.data_ptr() for t in args + outs), part.data_ptr(),
                       B * H, NC, chunk, P, S, B, G, hpg, nh, stream)
                if e:
                    raise RuntimeError(f"ablate_ssd_chunk: CUDA error {e}")
            go()
            torch.cuda.synchronize()
            err[name] = max(float((a - b).abs().max())
                            for a, b in zip(outs, want))
            us.setdefault(name, []).append(1e3 * cs.event_ms(torch, go))
    for name, t in us.items():
        print(f"{name}: {', '.join(f'{x:.3f}' for x in t)} us", flush=True)
    summary = {"card": card, "shape": dict(zip(
        "B L H P G S chunk".split(), BWD_SHAPE)), "nh": nh, "us": us,
        "registers_spill": regs, "max_abs_err": err}
    if out:
        with open(out, "w") as f:
            json.dump(summary, f, indent=1)
    print(json.dumps(summary), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="also write the summary JSON to this file")
    ap.add_argument("--backward", action="store_true",
                    help="ablate K8's backward instead of its forward")
    ap.add_argument("--baseline", action="append", default=[],
                    help="with --backward: also time this copy of "
                         "ssd_chunk.cu unedited, in turns with the variants "
                         "(may be given more than once)")
    a = ap.parse_args()
    sys.path.insert(0, ROOT)
    import chip_smoke as cs          # puts ROOT/src first on sys.path
    import torch

    if not torch.cuda.is_available():
        print("ablate_ssd_chunk: no CUDA device", file=sys.stderr)
        return 2
    if a.backward:
        return backward(cs, torch, a.out, a.baseline)
    from repro_torch.kernels._wrap import sm_count
    from repro_torch.kernels.ssd_chunk.ops import plan_k8

    card = cs.card_line()
    print(card, flush=True)
    libs = build_variants()
    B, L, H, P, G, S, chunk = SHAPE
    _, ops, hpg = cs.k8_operands(torch, B, L, H, P, G, S, chunk)
    BH, NC, Q, _ = ops[0].shape
    outs = [torch.empty(s, device="cuda")
            for s in ((BH, NC, Q, P), (BH, NC, S, P), (BH, NC, Q))]
    nh0 = plan_k8(B, G, NC, hpg, sm_count(torch.device("cuda")))
    stream = torch.cuda.current_stream().cuda_stream

    def launcher(lib, nh):
        fn = lib.ssd_chunk_launch
        fn.argtypes = (ctypes.c_void_p,) * 8 + (ctypes.c_int,) * 9 + (
            ctypes.c_void_p,)
        fn.restype = ctypes.c_int
        args = ([t.data_ptr() for t in ops] + [t.data_ptr() for t in outs]
                + [BH, NC, Q, P, S, B, G, hpg, nh, stream])

        def go():
            err = fn(*args)
            if err:
                raise RuntimeError(f"ablate_ssd_chunk: CUDA error {err}")
        return go

    us = {}
    for _ in range(2):
        for name, lib in libs.items():
            if name in PHASED:
                continue
            for nh in (sorted({nh0, *NHS}) if name == "full" else (nh0,)):
                us.setdefault(f"{name} nh={nh}", []).append(
                    1e3 * cs.event_ms(torch, launcher(lib, nh)))
    for k, v in us.items():
        print(f"{k}: {', '.join(f'{t:.3f}' for t in v)} us", flush=True)
    phases = {name: read_phases(torch, libs[name], launcher(libs[name], nh0),
                                B * G * NC * -(-hpg // nh0),
                                -(-min(nh0, hpg) // 2), name)
              for name in PHASED}
    summary = {"card": card, "shape": dict(zip("B L H P G S chunk".split(),
                                               SHAPE)),
               "planned_nh": nh0, "us": us, "phases": phases}
    if a.out:
        with open(a.out, "w") as f:
            json.dump(summary, f, indent=1)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
