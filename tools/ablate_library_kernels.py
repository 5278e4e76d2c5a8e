#!/usr/bin/env python3
"""Variants of the library-API kernels K5 and K6, timed at the main
path's shapes: what their stores, their prologue, their block order and
a staged server table cost.

    python3 tools/ablate_library_kernels.py [--out FILE]

Each variant is a copy of ``src/repro_torch/kernels/csrc/rl_score.cu``
(K6) or ``dodoor_fused_sparse.cu`` (K5) with text edits (``VARIANTS``;
the tool fails if the source no longer has the text it edits), built with
the port's nvcc flags, all at once, into ``build/ablate_library/``, and
timed with CUDA events (``chip_smoke.event_ms``), in turns with the
unedited kernel (a, b, ..., b, a), under each kernel's plan
(``ops.plan_k6``, ``ops.plan_k5``).  Every variant computes the same
outputs, which are checked against the plain versions first:

- ``k6_plain_store``: K6's 16-byte stores without the streaming hint
  (plain ``st.global`` instead of ``__stcs``);
- ``k6_rowmajor``: K6's blocks launched row tile fastest instead of
  column tile fastest (a row's tiles together);
- ``k6_global``: no shared prologue and no barrier: each thread reads its
  own 4 columns' C and L from global memory;
- ``k5_staged``: K5 copies the whole server table (L, C, D: 20N bytes)
  into shared memory with ``cp.async``, issued together with the task's
  own loads, and gathers there after one wait and one barrier (at the
  shapes whose table fits 48 KB).

Prints the card's name and power limit, each variant's times and a JSON
summary last.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc")
OUT_DIR = os.path.join(ROOT, "build", "ablate_library")

#: K5 staging its server table: helpers put before the kernel.
_STAGE_HELPERS = r"""// Copies 4 or 16 bytes from global to shared memory without a register.
template <int kBytes>
__device__ __forceinline__ void cp_async(unsigned char* dst,
                                         const unsigned char* src) {
#ifdef __CUDA_ARCH__
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src) : "memory");
#else
  for (int i = 0; i < kBytes; ++i) dst[i] = src[i];
#endif
}

// The block's threads copy `bytes` from src to the 16-byte aligned dst:
// 16 bytes a copy where src is 16-byte aligned, 4 bytes for the rest.
__device__ __forceinline__ void k5_stage(unsigned char* dst, const void* src,
                                         int bytes) {
  const unsigned char* s = static_cast<const unsigned char*>(src);
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    done = bytes & ~15;
    for (int i = threadIdx.x * 16; i < done; i += blockDim.x * 16)
      cp_async<16>(dst + i, s + i);
  }
  for (int i = done + threadIdx.x * 4; i < bytes; i += blockDim.x * 4)
    cp_async<4>(dst + i, s + i);
}

// K5: one thread per task scores"""
_STAGED_BODY = r"""  extern __shared__ __align__(16) unsigned char k5_table[];
  const int pair = (8 * N + 15) & ~15;
  k5_stage(k5_table, L, 8 * N);
  k5_stage(k5_table + pair, C, 8 * N);
  k5_stage(k5_table + 2 * pair, D, 4 * N);
  const bool live = t < T;
  float2 rt = make_float2(0.0f, 0.0f), dc = rt;
  int2 c = make_int2(0, 0);
  if (live) {
    rt = reinterpret_cast<const float2*>(r)[t];
    c = reinterpret_cast<const int2*>(cand)[t];
    dc = reinterpret_cast<const float2*>(d_cand)[t];
  }
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
  __syncthreads();
  if (!live) return;
  const float2* L2 = reinterpret_cast<const float2*>(k5_table);
  const float2* C2 = reinterpret_cast<const float2*>(k5_table + pair);
  D = reinterpret_cast<const float*>(k5_table + 2 * pair);"""

#: name: (source, ((text, replacement), ...)); "k6" and "k5" unedited.
VARIANTS = {
    "k6": ("rl_score", ()),
    "k6_plain_store": ("rl_score", ((
        "__stcs(reinterpret_cast<float4*>(row + jb),\n"
        "               make_float4(o[0], o[1], o[2], o[3]));",
        "*reinterpret_cast<float4*>(row + jb) =\n"
        "            make_float4(o[0], o[1], o[2], o[3]);"),)),
    "k6_rowmajor": ("rl_score", ((
        "const int col_tile = static_cast<int>(blockIdx.x % col_tiles);\n"
        "  const long long row_tile = blockIdx.x / col_tiles;",
        "const int row_tiles = gridDim.x / col_tiles;\n"
        "  const int col_tile = static_cast<int>(blockIdx.x / row_tiles);\n"
        "  const long long row_tile = blockIdx.x % row_tiles;"),)),
    "k6_global": ("rl_score", (
        ("for (int i = tid; i < W; i += blockDim.x) {",
         "for (int i = tid; i < 0 * W; i += blockDim.x) {"),
        ("__syncthreads();", ""),
        ("    ic[c] = inv_s[sb + c];\n#pragma unroll\n"
         "    for (int k = 0; k < K; ++k) lc[c][k] = l_s[k][sb + c];",
         "    ic[c] = load_column<K>(L, C, jb + c, N, nvec, lc[c]);"))),
    "k5": ("dodoor_fused_sparse", ()),
    "k5_staged": ("dodoor_fused_sparse", (
        ("// K5: one thread per task scores", _STAGE_HELPERS),
        ("const float* __restrict__ C, int T, float alpha,",
         "const float* __restrict__ C, int T, int N, float alpha,"),
        ("  if (t >= T) return;\n"
         "  const float2 rt = reinterpret_cast<const float2*>(r)[t];\n"
         "  const int2 c = reinterpret_cast<const int2*>(cand)[t];\n"
         "  const float2 dc = reinterpret_cast<const float2*>(d_cand)[t];\n"
         "  const float2* L2 = reinterpret_cast<const float2*>(L);\n"
         "  const float2* C2 = reinterpret_cast<const float2*>(C);",
         _STAGED_BODY),
        ("const void* D, const void* C, int T,\n"
         "                                    float alpha, float one_m_alpha, int tpb,",
         "const void* D, const void* C, int T, int N,\n"
         "                                    float alpha, float one_m_alpha, int tpb,"),
        ("dodoor_choice_kernel<<<(T + tpb - 1) / tpb, tpb, 0,",
         "dodoor_choice_kernel<<<(T + tpb - 1) / tpb, tpb,\n"
         "                           2 * ((8 * N + 15) & ~15) + 4 * N,"),
        ("static_cast<const float*>(C), T, alpha,",
         "static_cast<const float*>(C), T, N, alpha,"))),
}
K6_VARIANTS = ("k6", "k6_plain_store", "k6_rowmajor", "k6_global")
K6_SHAPES = ((2048, 100, 2), (500, 10_000, 2), (1024, 10_000, 2),
             (384, 257, 8), (50, 100, 2))
K5_SHAPES = ((50, 100), (2048, 100), (500, 10_000))


def build_variants() -> dict:
    """Write and compile every variant (one nvcc each, all at once);
    returns {name: ctypes handle}."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import _build

    os.makedirs(OUT_DIR, exist_ok=True)
    procs = {}
    for name, (source, edits) in VARIANTS.items():
        with open(os.path.join(CSRC, source + ".cu")) as f:
            text = f.read()
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the source has {text.count(old)}"
                                   f" copies of {old!r}, not one")
            text = text.replace(old, new)
        cu = os.path.join(OUT_DIR, name + ".cu")
        so = os.path.join(OUT_DIR, name + ".so")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = (so, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        libs[name] = ctypes.CDLL(so)
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the JSON here")
    a = ap.parse_args()
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("ablate_library_kernels: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels._wrap import sm_count
    from repro_torch.kernels.dodoor_choice import dodoor_choice_ref
    from repro_torch.kernels.dodoor_choice.ops import plan_k5
    from repro_torch.kernels.rl_score import rl_score_matrix_ref
    from repro_torch.kernels.rl_score.ref import unfused_columns
    from repro_torch.kernels.rl_score.ops import plan_k6

    card = cs.card_line()
    print(card, flush=True)
    libs = build_variants()
    sms = sm_count(torch.device("cuda"))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    us = {}

    def time_pair(label, names, make):
        """Time each variant of ``names`` in turns (a, b, b, a)."""
        fns = {n: make(libs[n]) for n in names}
        order = list(names) + list(reversed(names))
        for n in order:
            us.setdefault(f"{label} {n}", []).append(
                1e3 * cs.event_ms(torch, fns[n]))

    for T, N, K in K6_SHAPES:
        r, L, C = cs.k6_operands(torch, T, N, K)
        want = rl_score_matrix_ref(r, L, C)
        plan = plan_k6(T, N, sms)
        out = torch.empty((T, N), device="cuda")

        def make(lib):
            fn = lib.rl_score_launch
            fn.argtypes, fn.restype = (P,) * 4 + (I,) * 7 + (P,), I
            stream = torch.cuda.current_stream().cuda_stream

            def go():
                err = fn(r.data_ptr(), L.data_ptr(), C.data_ptr(),
                         out.data_ptr(), T, N, K, *plan,
                         unfused_columns(N, K), stream)
                cs.check(err == 0, f"launch error {err}")
            return go

        for name in K6_VARIANTS:
            out.fill_(float("nan"))
            make(libs[name])()
            cs.check(torch.equal(out, want), f"{name} T={T} N={N}: differs")
        time_pair(f"K6 T={T} N={N} K={K}", K6_VARIANTS, make)

    for T, N in K5_SHAPES:
        args = cs.pair_inputs(torch, T, N, seed=T + N)
        want = dodoor_choice_ref(*args, alpha=0.5)
        choice = torch.empty((T,), dtype=torch.int32, device="cuda")
        scores = torch.empty((T, 2), device="cuda")
        tpb = plan_k5(T, sms)

        def make(lib):
            fn = lib.dodoor_choice_launch
            staged = lib is libs["k5_staged"]
            fn.argtypes = (P,) * 6 + (I,) * (2 if staged else 1) + (
                F, F, I) + (P,) * 3
            fn.restype = I
            dims = (T, N) if staged else (T,)
            stream = torch.cuda.current_stream().cuda_stream

            def go():
                err = fn(*(t.data_ptr() for t in args), *dims,
                         np.float32(0.5), np.float32(0.5), tpb,
                         choice.data_ptr(), scores.data_ptr(), stream)
                cs.check(err == 0, f"launch error {err}")
            return go

        names = ("k5", "k5_staged") if 20 * N + 32 <= 48 * 1024 else ("k5",)
        for name in names:
            choice.fill_(-7)
            make(libs[name])()
            cs.same(f"{name} T={T} N={N}", (choice, scores), want)
        time_pair(f"K5 T={T} N={N}", names, make)
    for k, v in us.items():
        print(f"{k}: " + " / ".join(f"{x:.3f}" for x in v) + " us",
              flush=True)
    summary = {"card": card, "us": us}
    if a.out:
        with open(a.out, "w") as f:
            json.dump(summary, f, indent=1)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
