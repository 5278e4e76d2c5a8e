"""Run K7's CUDA source on the CPU: a rehearsal before a chip call.

    PYTHONPATH=src python tools/shim_flash_attention.py [--runs N] \
        [--case B,H,Hkv,Lq,Lk,D,causal,window,dtype ...]

Compiles ``src/repro_torch/kernels/csrc/flash_attention.cu`` with g++
against a header that stands in for CUDA (``SHIM_HEADER``): each block's
threads are ``std::thread``s, ``__syncthreads`` and the warp shuffles are
``std::barrier``s, dynamic shared memory is one NaN-filled buffer a block
(so a read of an unwritten slot shows), and ``<<<...>>>`` launches run the
grid's blocks one after another.  The source's own host forms stand in
for the PTX (``mma_tf32`` gathers the warp's fragments by shuffles,
``cp.async`` is a plain copy).  Then each case runs K7's forward with the
lse (and for bf16 the float32 output) and its backward through
``kernels/flash_attention/kernel.py``'s launchers on CPU tensors, held to
``attention_ref``, ``attention_lse_ref`` and ``attention_bwd_ref`` with
``chip_smoke.py``'s pins (2e-4·|ref| + 2e-5·max|ref|, plus 2⁻⁸·|ref| for
bf16).  A D = 128 case takes seconds, a tinyllama-size one hours: keep
the shapes small.  It says nothing about speed, and it runs what the
source's ``#else`` branches compute, not what nvcc emits.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc",
                      "flash_attention.cu")
OUT_DIR = os.path.join(ROOT, "build", "shim_flash_attention")

SHIM_HEADER = r"""#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
using std::max;
using std::min;
struct dim3s { unsigned x, y, z; };
inline thread_local dim3s threadIdx, blockIdx;
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
struct uint2 { uint32_t x, y; };
struct uint4 { uint32_t x, y, z, w; };
inline float2 make_float2(float a, float b) { return {a, b}; }
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}
inline uint4 make_uint4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return {a, b, c, d};
}
inline float __uint_as_float(uint32_t u) { float f; memcpy(&f, &u, 4); return f; }
inline uint32_t __float_as_uint(float f) { uint32_t u; memcpy(&u, &f, 4); return u; }
struct __nv_bfloat16 { uint16_t x; };
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
inline float __bfloat162float(__nv_bfloat16 v) {
  return __uint_as_float(uint32_t(v.x) << 16);
}
inline __nv_bfloat16 __float2bfloat16(float f) {   // to nearest, ties even
  uint32_t u = __float_as_uint(f);
  u += 0x7fffu + ((u >> 16) & 1u);
  return {uint16_t(u >> 16)};
}
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) {
  return {__float2bfloat16(a), __float2bfloat16(b)};
}
struct BlockCtx {
  std::unique_ptr<std::barrier<>> all;
  std::vector<std::unique_ptr<std::barrier<>>> warps;
  uint32_t slots[32][32];
};
inline BlockCtx* g_ctx;
inline uint4* g_smem;
inline void __syncthreads() { g_ctx->all->arrive_and_wait(); }
inline void __syncwarp() { g_ctx->warps[threadIdx.x / 32]->arrive_and_wait(); }
inline uint32_t shfl_u(uint32_t v, int src) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  g_ctx->slots[w][l] = v;
  g_ctx->warps[w]->arrive_and_wait();
  const uint32_t r = g_ctx->slots[w][src & 31];
  g_ctx->warps[w]->arrive_and_wait();
  return r;
}
inline uint32_t __shfl_sync(unsigned, uint32_t v, int src) { return shfl_u(v, src); }
inline float __shfl_sync(unsigned, float v, int src) {
  return __uint_as_float(shfl_u(__float_as_uint(v), src));
}
inline float __shfl_xor_sync(unsigned, float v, int m) {
  return __shfl_sync(0u, v, int(threadIdx.x % 32) ^ m);
}
inline size_t __cvta_generic_to_shared(const void* p) { return (size_t)p; }
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class F>
cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return cudaSuccess; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
struct cudaFuncAttributes { int numRegs; size_t localSizeBytes; };
template <class F>
cudaError_t cudaFuncGetAttributes(cudaFuncAttributes* fa, F) {
  *fa = {0, 0};
  return cudaSuccess;
}
template <class F>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int,
                                                          size_t) {
  *n = 0;
  return cudaSuccess;
}
template <class F, class... A>
void shim_launch(F f, int grid, int threads, size_t smem, A... args) {
  std::vector<uint32_t> buf(smem / 4 + 16);
  for (int b = 0; b < grid; ++b) {
    for (auto& x : buf) x = 0x7fc00000u;     // NaN
    BlockCtx ctx;
    ctx.all = std::make_unique<std::barrier<>>(threads);
    for (int w = 0; w < (threads + 31) / 32; ++w)
      ctx.warps.push_back(
          std::make_unique<std::barrier<>>(std::min(32, threads - 32 * w)));
    g_ctx = &ctx;
    g_smem = reinterpret_cast<uint4*>(buf.data());
    std::vector<std::thread> ts;
    for (int t = 0; t < threads; ++t)
      ts.emplace_back([&, t, b] {
        threadIdx = {unsigned(t), 0, 0};
        blockIdx = {unsigned(b), 0, 0};
        f(args...);
      });
    for (auto& t : ts) t.join();
  }
}
"""


def build() -> str:
    """The shim library of the current source (rebuilt every call)."""
    os.makedirs(OUT_DIR, exist_ok=True)
    src = open(SOURCE).read()
    src = src.replace("#include <cuda_bf16.h>", '#include "shim.h"')
    src = src.replace("#include <cuda_runtime.h>", "")
    src = src.replace("extern __shared__ uint4 smem_u4[];",
                      "uint4* smem_u4 = g_smem;")
    src = re.sub(
        r"([A-Za-z_]\w*(?:<[^<>;]*>)?)\s*<<<([^;]*?)>>>\(([^;]*)\);",
        lambda m: (f"shim_launch({m.group(1).strip()}, "
                   f"{m.group(2).replace(chr(10), ' ').rsplit(',', 1)[0]}, "
                   f"{m.group(3)});"), src, flags=re.S)
    with open(os.path.join(OUT_DIR, "shim.h"), "w") as f:
        f.write(SHIM_HEADER)
    cpp = os.path.join(OUT_DIR, "flash_attention.cpp")
    with open(cpp, "w") as f:
        f.write(src)
    lib = os.path.join(OUT_DIR, "libflash_attention_shim.so")
    subprocess.run(["g++", "-std=c++20", "-O1", "-shared", "-fPIC",
                    "-pthread", "-Wno-unknown-pragmas", "-I", OUT_DIR,
                    "-o", lib, cpp], check=True)
    return lib


def run_case(torch, K, ops, ref, B, H, Hkv, Lq, Lk, D, causal, window,
             dtype, runs=None) -> str:
    """One case through the shim's forward (with lse) and backward."""
    import numpy as np

    rng = np.random.RandomState(B + H + Lq + D)
    q, k, v, do = (torch.from_numpy(rng.randn(*s).astype(np.float32) * sc)
                   .to(dtype)
                   for s, sc in (((B, H, Lq, D), 0.5), ((B, Hkv, Lk, D), 0.5),
                                 ((B, Hkv, Lk, D), 1.0), ((B, H, Lq, D), 1.0)))
    nan = float("nan")
    out = torch.full((B, H, Lq, D), nan).to(dtype)
    lse = torch.full((B, H, Lq), nan)
    o32 = torch.full((B, H, Lq, D), nan) if dtype != torch.float32 else None
    K.launch_flash_attention(q, k, v, out, causal=causal, window=window,
                             scale=D ** -0.5, lse=lse, o32=o32)
    of = out if o32 is None else o32
    if o32 is not None and not torch.equal(out, o32.to(dtype)):
        return "FAIL: o is not o32 rounded once"
    e_o = float((of - ref.attention_ref(q.float(), k.float(), v.float(),
                                        causal=causal, window=window))
                .abs().max())
    e_l = float((lse - ref.attention_lse_ref(q, k, causal=causal,
                                             window=window)).abs().max())
    rows = H // Hkv * Lq
    rows_pad = -(-rows // ops.K7_BWD_ROWS) * ops.K7_BWD_ROWS
    runs = runs or ops.plan_k7_bwd(H, Hkv, Lq, D,
                                   bf16=dtype == torch.bfloat16)
    runs = max(1, min(runs, rows))
    part = (torch.full((2 * runs * B * Hkv * Lk * D,), nan) if runs > 1
            else None)
    grads = [torch.full(t.shape, nan).to(dtype) for t in (q, k, v)]
    K.launch_flash_attention_bwd(
        q, k, v, of, do, lse, *grads, torch.full((2 * B * Hkv * rows_pad,),
                                                 nan),
        causal=causal, window=window, scale=D ** -0.5, runs=runs, part=part)
    want = ref.attention_bwd_ref(q, k, v, do, causal=causal, window=window)
    bad = []
    for name, g, w in zip(("dq", "dk", "dv"), grads, want):
        lim = 2e-4 * w.abs() + 2e-5 * w.abs().max()
        if dtype != torch.float32:
            lim = lim + w.abs() * 2.0 ** -8
        n = int((((g.float() - w).abs() > lim) | ~g.float().isfinite()).sum())
        bad.append(f"{name} max |Δ| {float((g.float() - w).abs().max()):.3g}"
                   + (f" ({n} outside the pin)" if n else ""))
    ok = "FAIL" if any("outside" in b for b in bad) else "ok"
    return (f"{ok}: runs {runs}; o max |Δ| {e_o:.3g}, lse {e_l:.3g}; "
            + ", ".join(bad))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--case", action="append", default=[],
                    help="B,H,Hkv,Lq,Lk,D,causal,window,dtype (window 0: "
                         "none; dtype float32 or bfloat16)")
    ap.add_argument("--runs", type=int, default=None,
                    help="the dk/dv pass's runs of rows (default: the "
                         "wrapper's plan)")
    a = ap.parse_args()
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch

    from repro_torch.kernels.flash_attention import kernel as K
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention import ref

    lib = ctypes.CDLL(build())
    K.load = lambda name: lib
    torch.cuda.current_stream = (
        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    cases = a.case or ["1,2,1,40,40,32,1,0,bfloat16",
                       "1,4,2,24,56,32,1,16,bfloat16",
                       "1,2,2,33,70,64,0,0,bfloat16",
                       "1,2,1,40,40,32,1,0,float32"]
    failed = 0
    for c in cases:
        B, H, Hkv, Lq, Lk, D, causal, window, dt = c.split(",")
        line = run_case(torch, K, ops, ref, int(B), int(H), int(Hkv),
                        int(Lq), int(Lk), int(D), bool(int(causal)),
                        int(window) or None, getattr(torch, dt), a.runs)
        failed += line.startswith("FAIL")
        print(f"{c}: {line}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
