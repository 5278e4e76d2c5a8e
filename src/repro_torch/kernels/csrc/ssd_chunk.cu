// Mamba-2 SSD intra-chunk block for Hopper (sm_90a).
//
// Replaces the TPU kernel of the JAX reference,
// src/repro/kernels/ssd_chunk/kernel.py::ssd_chunk_pallas (body _kernel).
// Per (batch*head bh, chunk c), with Q steps of head width P and state
// width S:
//   s_t        = sum_{u<=t} delta_u                 (delta = A*dt < 0)
//   G[t, u]    = (C_t . B_u) * exp(min(s_t - s_u, 0)) * dt_u   for u <= t
//   y_intra[t] = sum_u G[t, u] x_u                   [Q, P]
//   H_out      = sum_u (B_u * exp(s_{Q-1} - s_u) * dt_u)^T x_u   [S, P]
//   exp_s[t]   = exp(s_t)
// B and C are read per head group, bh -> (bh / H, (bh % H) / hpg), as the
// reference's BlockSpec index map reads them: never repeated in memory.
//
// Design.  One block per (chunk, bh) cell.  The TPU kernel holds the
// chunk's x, B, C tiles and the Q x Q logits tile in VMEM and runs the
// three contractions on the matrix unit; here the same tiles sit in
// shared memory (x [Q][P], B and C [Q][S+1], G [Q][Q+1]: about 98 KB at
// Q = 64, P = 64, S = 128, above the 48 KB a block gets without opting in,
// so the launcher raises the limit with cudaFuncSetAttribute and returns
// its error if the card refuses).  The cumulative sum is one thread's
// sequential loop over Q <= 64 steps.  Then 256 threads, as 16 x 16, each
// compute a register tile of the three products: 4 x 4 of C B^T (masked
// and decayed into G in shared memory), 4 x 4 of G x, and 8 x 4 of
// (B w)^T x.  Q, P and S are taken at run time (Q <= 64, P <= 64,
// S <= 128), so a sequence shorter than a chunk is one short chunk; rows
// and columns past them are computed on clamped addresses and dropped.
// B and C keep one word of row padding so the column-strided reads of
// C B^T hit distinct banks.
//
// Bound.  The function needs C B^T once per (batch, group, chunk) and
// only over the causal triangle of Q(Q+1)/2 pairs, G x over the same
// triangle per cell, and (B w)^T x per cell: at mamba2-1.3b's B = 2,
// L = 1024 (G = 1, 64 heads a group, Q = 64, P = 64, S = 128) that is
// 2.7 Gflop against 138 MB of inputs and outputs, ~20 flops a byte, on
// the card's float32 ridge (67 Tflop/s / 3.35 TB/s = 20): memory and
// float32 arithmetic bound it alike, at ~41 us.  This kernel does more:
// each cell recomputes C B^T for its head although every head of a group
// shares it, and computes the full Q x Q tiles before masking, about
// twice the work needed.  A group-shared C B^T tile and triangular tiles
// are the levers of a redesign; no tensor cores in this first kernel, as
// the reference's tolerance (2e-4) is held in float32.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxQ = 64, kMaxP = 64, kMaxS = 128;

size_t smem_bytes(int Q, int P, int S) {
  return sizeof(float) * (static_cast<size_t>(Q) * P + 2 * Q * (S + 1) +
                          Q * (Q + 1) + 3 * Q);
}

__global__ void __launch_bounds__(kThreads)
ssd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ delta,
                 const float* __restrict__ dtv, const float* __restrict__ Bm,
                 const float* __restrict__ Cm, float* __restrict__ y,
                 float* __restrict__ Hs, float* __restrict__ exp_s, int NC,
                 int Q, int P, int S, int H, int G, int hpg) {
  const int c = blockIdx.x, bh = blockIdx.y;
  const int b = bh / H, g = (bh % H) / hpg;
  const long long cell = static_cast<long long>(bh) * NC + c;
  const float* xg = x + cell * Q * P;
  const long long bc = ((static_cast<long long>(b) * G + g) * NC + c) * Q * S;
  const float* Bg = Bm + bc;
  const float* Cg = Cm + bc;
  const int SS = S + 1, GS = Q + 1;

  extern __shared__ float sm[];
  float* xs = sm;               // [Q][P]
  float* Bs = xs + Q * P;       // [Q][SS]
  float* Cs = Bs + Q * SS;      // [Q][SS]
  float* Gs = Cs + Q * SS;      // [Q][GS]
  float* ss = Gs + Q * GS;      // [Q] cumulative log-decay
  float* dts = ss + Q;          // [Q]
  float* ws = dts + Q;          // [Q] exp(s_{Q-1} - s_u) * dt_u

  const int tid = threadIdx.x;
  for (int i = tid; i < Q * P; i += kThreads) xs[i] = xg[i];
  for (int i = tid; i < Q * S; i += kThreads) {
    const int t = i / S, k = i % S;
    Bs[t * SS + k] = Bg[i];
    Cs[t * SS + k] = Cg[i];
  }
  for (int t = tid; t < Q; t += kThreads) {
    ss[t] = delta[cell * Q + t];
    dts[t] = dtv[cell * Q + t];
  }
  __syncthreads();
  if (tid == 0) {
    float acc = 0.0f;
    for (int t = 0; t < Q; ++t) {
      acc += ss[t];
      ss[t] = acc;
    }
  }
  __syncthreads();
  for (int t = tid; t < Q; t += kThreads) {
    exp_s[cell * Q + t] = expf(ss[t]);
    ws[t] = expf(ss[Q - 1] - ss[t]) * dts[t];
  }

  const int r = tid >> 4, cc = tid & 15;

  // G = (C B^T) * decay mask * dt, a 4 x 4 register tile a thread.
  {
    float acc[4][4] = {};
    int tr[4], ur[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      tr[i] = min(r + 16 * i, Q - 1);
      ur[i] = min(cc + 16 * i, Q - 1);
    }
#pragma unroll 4
    for (int k = 0; k < S; ++k) {
      float cv[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        cv[i] = Cs[tr[i] * SS + k];
        bv[i] = Bs[ur[i] * SS + k];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(cv[i], bv[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = r + 16 * i;
      if (t >= Q) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int u = cc + 16 * j;
        if (u >= Q) continue;
        Gs[t * GS + u] =
            u <= t ? acc[i][j] * expf(fminf(ss[t] - ss[u], 0.0f)) * dts[u]
                   : 0.0f;
      }
    }
  }
  __syncthreads();

  // y_intra = G x, a 4 x 4 register tile a thread.
  {
    float acc[4][4] = {};
    int tr[4], pc[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      tr[i] = min(r + 16 * i, Q - 1);
      pc[i] = min(cc + 16 * i, P - 1);
    }
#pragma unroll 4
    for (int u = 0; u < Q; ++u) {
      float gv[4], xv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        gv[i] = Gs[tr[i] * GS + u];
        xv[i] = xs[u * P + pc[i]];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(gv[i], xv[j], acc[i][j]);
    }
    float* yc = y + cell * Q * P;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = r + 16 * i;
      if (t >= Q) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = cc + 16 * j;
        if (p < P) yc[t * P + p] = acc[i][j];
      }
    }
  }

  // H_out = (B w)^T x, an 8 x 4 register tile a thread.
  {
    float acc[8][4] = {};
    int sr[8], pc[4];
#pragma unroll
    for (int i = 0; i < 8; ++i) sr[i] = min(r + 16 * i, S - 1);
#pragma unroll
    for (int j = 0; j < 4; ++j) pc[j] = min(cc + 16 * j, P - 1);
#pragma unroll 2
    for (int u = 0; u < Q; ++u) {
      const float w = ws[u];
      float bv[8], xv[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) bv[i] = Bs[u * SS + sr[i]] * w;
#pragma unroll
      for (int j = 0; j < 4; ++j) xv[j] = xs[u * P + pc[j]];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(bv[i], xv[j], acc[i][j]);
    }
    float* hc = Hs + cell * S * P;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int s = r + 16 * i;
      if (s >= S) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = cc + 16 * j;
        if (p < P) hc[s * P + p] = acc[i][j];
      }
    }
  }
}

}  // namespace

// x [BH, NC, Q, P], delta/dtv [BH, NC, Q], Bm/Cm [B, G, NC, Q, S] float32
// row-major, BH = B * G * hpg with heads fastest; outputs y [BH, NC, Q, P],
// Hs [BH, NC, S, P], exp_s [BH, NC, Q] float32.  Q <= 64, P <= 64,
// S <= 128.  Launches on `stream` and returns cudaGetLastError() (0 on
// success), the error of the shared-memory opt-in if the card refuses the
// tile, or cudaErrorInvalidValue for shapes it was not built for.
extern "C" int ssd_chunk_launch(const void* x, const void* delta,
                                const void* dtv, const void* Bm,
                                const void* Cm, void* y, void* Hs,
                                void* exp_s, int BH, int NC, int Q, int P,
                                int S, int B, int G, int hpg, void* stream) {
  if (Q < 1 || Q > kMaxQ || P < 1 || P > kMaxP || S < 1 || S > kMaxS ||
      B < 1 || G < 1 || hpg < 1 || BH != B * G * hpg)
    return static_cast<int>(cudaErrorInvalidValue);
  if (NC <= 0) return static_cast<int>(cudaGetLastError());
  const size_t smem = smem_bytes(Q, P, S);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(NC, BH);
  ssd_chunk_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(delta),
      static_cast<const float*>(dtv), static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), static_cast<float*>(y),
      static_cast<float*>(Hs), static_cast<float*>(exp_s), NC, Q, P, S,
      G * hpg, G, hpg);
  return static_cast<int>(cudaGetLastError());
}
