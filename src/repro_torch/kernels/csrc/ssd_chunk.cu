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
// B and C belong to a head group, bh -> (bh / H, (bh % H) / hpg), as the
// reference's BlockSpec index map reads them.
//
// Design.  One block of 512 threads, two teams of 8 warps, per (batch,
// group, chunk, run of nh heads of the group): team 0 takes the first
// half of the run (rounded up), team 1 the rest.  The host picks nh
// (ops.py::plan_k8) so that one block an SM fills the card; the last run
// of a group is short when nh does not divide hpg.  The block reads the
// chunk's B and C once and computes C B^T once, raw (no decay, no dt),
// over the 8 x 4 tiles that reach the diagonal or below it (each half of
// a warp sums half the k range; one shuffle adds them), into shared
// memory, where both teams read it.  Each team then walks its heads with
// barriers of its own, team 1 half a head behind team 0, so that one
// team's latency-bound steps (scan, G_h, y) run beside the other's H.
// Per head, in a team:
//   - every warp scans the deltas with shuffles (lane l holds steps l and
//     l + 32) and forms w_u = exp(s_{Q-1} - s_u) * dt_u; the team's warp
//     0 writes exp_s;
//   - warp w forms just the columns of G_h = C B^T * exp(min(s_t - s_u,
//     0)) * dt_u that its own y reads (u <= t, zero above), 12
//     exponentials a lane, with no barrier but the warp's.  Applying the
//     decay inside y's loop would cost an exponential a multiply-add in
//     each of the 32 lanes that share a row;
//   - y = G_h x: warp w owns rows 4w..4w+3 and 60-4w..63-4w (a short and
//     a long row block of the triangle, so every warp does the same
//     work), G's words broadcast to the warp, a lane two columns; the u
//     loop stops at each block's diagonal;
//   - x*w, one team barrier, then the x (and steps) of the head two on
//     is copied (cp.async) into the dead G_h tile while H runs;
//   - H = B^T (x*w): warp w owns rows 16w..16w+15, whose B words are
//     broadcast to the warp, a lane two columns: four broadcast 128-bit
//     loads and one 64-bit load per 32 FMAs, and a store writes 256
//     contiguous bytes of a row.  Shared memory serves a 128-bit load a
//     quarter warp at a time, so a tile whose lanes load distinct words
//     (8 x 4 a thread: 12 words a lane per 32 FMAs) runs at two thirds
//     of the FMA rate.
// Two team barriers a head.  Every product is float32 fmaf on the FMA
// pipes, each sum in a fixed order (k or u ascending; C B^T's two k
// halves added low + high; no atomics): two calls give bit-identical
// outputs.  Q, P, S are taken at run time (Q <= 64, P <= 64, S <= 128);
// rows and columns past them are computed on in-bounds values and
// dropped.
//
// Shared memory (floats): B [Q][132] and C B^T [Q][68]; a team: four
// [Q][68] tiles (G_h, x*w, this head's x, the next head's; C fills team
// 0's first two until C B^T is done) and two heads' deltas and dt: 192 512
// bytes at Q = 64, one block (16 warps) an SM; the launcher opts in to
// more than 48 KB.  Strides of 132 and 68 words (4 mod 32, odd in
// float4s) keep the 128-bit loads of 8 different rows on 8 different bank
// groups.
//
// Bound.  The function needs C B^T once per (batch, group, chunk) over
// the causal triangle of Q(Q+1)/2 pairs, G x over the same triangle per
// cell, and (B w)^T x per cell: at mamba2-1.3b's B = 2, L = 1024 (G = 1,
// 64 heads a group, Q = 64, P = 64, S = 128) that is 2.7 Gflop against
// 138 MB of inputs and outputs, ~20 flops a byte, on the card's float32
// ridge (67 Tflop/s / 3.35 TB/s = 20): memory and float32 arithmetic
// bound it alike, at ~41 us.  This kernel does that work plus C B^T once
// per run of nh heads instead of once per (batch, group, chunk), the
// upper halves of the diagonal tiles, and rows and columns past Q, P and
// S.  No tensor cores: the reference's tolerance (2e-4) is held in
// float32, and TF32 keeps about three digits.
//
// The backward (ssd_chunk_bwd_launch, at the end of this file) has no TPU
// counterpart: the Pallas kernel has no custom_vjp, and the reference
// trains through its jnp chunk scan (src/repro/models/mamba2.py:30).  Its
// note is with it.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTeams = 2, kTeamThreads = 256;
constexpr int kThreads = kTeams * kTeamThreads;
constexpr int kMaxQ = 64, kMaxP = 64, kMaxS = 128;
constexpr int kLdS = kMaxS + 4;            // row stride of B and C
constexpr int kLdQ = kMaxQ + 4;            // of x, x*w, C B^T and G_h
static_assert(2 * kLdQ >= kLdS, "C must fit in a team's first two tiles");

// A team's words: four [Q][kLdQ] tiles (G_h, x*w, this head's x, the
// next head's x), then two heads' deltas and dt [2][2][kMaxQ].
__host__ __device__ __forceinline__ int team_words(int Q) {
  return 4 * Q * kLdQ + 4 * kMaxQ;
}

size_t smem_bytes(int Q) {
  return sizeof(float) * (static_cast<size_t>(Q) * (kLdS + kLdQ) +
                          static_cast<size_t>(kTeams) * team_words(Q));
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void fma2(float (&acc)[2], float a, float2 v) {
  acc[0] = fmaf(a, v.x, acc[0]);
  acc[1] = fmaf(a, v.y, acc[1]);
}

__device__ __forceinline__ float dot4(float acc, float4 a, float4 b) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float comp(float4 v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Bits of the kernel's `vec` argument: which tiles move in 16-byte (x, B,
// C) or 8-byte (y, H) pieces (the launcher checks widths and alignments).
constexpr int kVecX = 1, kVecBC = 2, kVecY = 4, kVecH = 8;

// Copies 4 or 16 bytes from global to shared memory without staging them
// in registers (cp.async).
template <int kBytes>
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
#ifdef __CUDA_ARCH__
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
#else
  for (int i = 0; i < kBytes / 4; ++i) dst[i] = src[i];
#endif
}

// Closes the thread's current group of copies; cp_async_wait<n>() waits
// until at most n of its groups are in flight.
__device__ __forceinline__ void cp_async_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

template <int kInFlight>
__device__ __forceinline__ void cp_async_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kInFlight) : "memory");
#endif
}

// Named barriers: bar_sync(id, n) waits until n threads have arrived at
// barrier id (0 is __syncthreads'); bar_arrive(id, n) arrives without
// waiting.
__device__ __forceinline__ void bar_sync(int id, int n) {
#ifdef __CUDA_ARCH__
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
#endif
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
#ifdef __CUDA_ARCH__
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
#endif
}

// rows x cols floats (row stride cols) into shared memory (row stride
// ld), by the n threads numbered t = 0..n-1.
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* src,
                                          int rows, int cols, bool vec, int t,
                                          int n) {
  if (vec) {
    const int c4 = cols >> 2;
    for (int i = t; i < rows * c4; i += n) {
      const int r = i / c4, k = (i - r * c4) << 2;
      cp_async<16>(dst + r * ld + k, src + r * cols + k);
    }
  } else {
    for (int i = t; i < rows * cols; i += n) {
      const int r = i / cols;
      cp_async<4>(dst + r * ld + i - r * cols, src + i);
    }
  }
}

// A head's steps as one warp holds them, lane l steps l ("a") and l + 32
// ("b"), zero past Q: the cumulative log-decay s (an inclusive shuffle
// scan of the deltas), dt, and w_u = exp(s_{Q-1} - s_u) * dt_u.
struct Steps {
  float sa, sb, da, db, wa, wb;
};

__device__ __forceinline__ Steps scan_steps(const float* dl, const float* tl,
                                            int Q, int lane) {
  float s0 = lane < Q ? dl[lane] : 0.0f;
  float s1 = lane + 32 < Q ? dl[lane + 32] : 0.0f;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float a0 = __shfl_up_sync(0xffffffffu, s0, off);
    const float a1 = __shfl_up_sync(0xffffffffu, s1, off);
    if (lane >= off) {
      s0 += a0;
      s1 += a1;
    }
  }
  s1 += __shfl_sync(0xffffffffu, s0, 31);
  const float last = __shfl_sync(0xffffffffu, Q > 32 ? s1 : s0, (Q - 1) & 31);
  Steps st;
  st.sa = s0;
  st.sb = s1;
  st.da = lane < Q ? tl[lane] : 0.0f;
  st.db = lane + 32 < Q ? tl[lane + 32] : 0.0f;
  st.wa = expf(last - s0) * st.da;
  st.wb = expf(last - s1) * st.db;
  return st;
}

// Row u of G_h at columns t0..t0+3 from that row of C B^T (cb) and the
// columns' s (st): C B^T * exp(min(s_t - s_u, 0)) * dt_u, zero where
// t < u or t >= Q.
__device__ __forceinline__ float4 g_row(float4 cb, int u, float su, float du,
                                        int t0, const float (&st)[4],
                                        int Q) {
  float v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    v[i] = u <= t0 + i && t0 + i < Q
               ? comp(cb, i) * expf(fminf(st[i] - su, 0.0f)) * du
               : 0.0f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

// blockIdx.x = ((b * G + g) * NC + c) * nblk + hb, with heads
// [hb * nh, min(hb * nh + nh, hpg)) of group g, the first half of them
// (rounded up) to team 0 and the rest to team 1; bh = (b * G + g) * hpg +
// h, so head h + 1's cell is head h's plus NC.
__global__ void __launch_bounds__(kThreads, 1)
ssd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ delta,
                 const float* __restrict__ dtv, const float* __restrict__ Bm,
                 const float* __restrict__ Cm, float* __restrict__ y,
                 float* __restrict__ Hs, float* __restrict__ exp_s, int NC,
                 int Q, int P, int S, int hpg, int nh, int nblk, int vec) {
  const int hb = blockIdx.x % nblk;
  const int bgc = blockIdx.x / nblk;       // (b * G + g) * NC + c
  const int c = bgc % NC, bg = bgc / NC;   // bg = b * G + g
  const int h_first = hb * nh, h_last = min(h_first + nh, hpg);
  const int split = h_first + (h_last - h_first + 1) / 2;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int team = warp / (kTeamThreads / 32), wt = warp % (kTeamThreads / 32);
  const int tt = tid % kTeamThreads;
  const int h_begin = team ? split : h_first, h_end = team ? h_last : split;

  // Bs | CBt | team 0: A W Z N steps | team 1: the same.  C fills team
  // 0's A and W until C B^T is done.  Then each team's W holds x*w, and
  // A, Z and N take turns as a head's G_h, its x and the next head's x:
  // the x two heads on is copied into the dead G_h while H runs.  The
  // deltas and dt of a head live in steps[(h - h_begin) % 2].
  extern __shared__ __align__(16) float sm[];
  float* Bs = sm;                      // [Q][kLdS]
  float* CBt = Bs + Q * kLdS;          // C B^T, u-major: [u][t]
  float* Cs = CBt + Q * kLdQ;          // [Q][kLdS]
  float* W = Cs + team * team_words(Q) + Q * kLdQ;   // x*w [Q][kLdQ]
  float* gcur = W - Q * kLdQ;          // G_h, u-major: [u][t] (A)
  float* xcur = W + Q * kLdQ;          // x of head h, [u][p] (Z)
  float* xnext = xcur + Q * kLdQ;      // x of head h + 1 (N)
  float* steps = xnext + Q * kLdQ;     // [2][2][kMaxQ] deltas, dt
  const long long cell0 =
      (static_cast<long long>(bg) * hpg + h_begin) * NC + c;
  long long cell = cell0;

  // Head j of the team (its x into xs), copied by the team without
  // waiting, as one group of copies: an empty one past the last head.
  const auto load_head = [&](float* xs, int j) {
    if (h_begin + j < h_end) {
      const long long cl = cell0 + static_cast<long long>(j) * NC;
      float* dl = steps + (j & 1) * 2 * kMaxQ;
      load_tile(xs, kLdQ, x + cl * Q * P, Q, P, vec & kVecX, tt,
                kTeamThreads);
      load_tile(dl, kMaxQ, delta + cl * Q, 1, Q, false, tt, kTeamThreads);
      load_tile(dl + kMaxQ, kMaxQ, dtv + cl * Q, 1, Q, false, tt,
                kTeamThreads);
    }
    cp_async_commit();
  };

  // The chunk's B and C (zero from S to S4), then each team's first two
  // heads, which C B^T does not wait for.
  const int S4 = (S + 3) & ~3;
  {
    const long long bc = static_cast<long long>(bgc) * Q * S;
    load_tile(Bs, kLdS, Bm + bc, Q, S, vec & kVecBC, tid, kThreads);
    load_tile(Cs, kLdS, Cm + bc, Q, S, vec & kVecBC, tid, kThreads);
    cp_async_commit();
    load_head(xcur, 0);
    load_head(xnext, 1);
    for (int u = warp; u < Q; u += kThreads / 32)
      for (int k = S + lane; k < S4; k += 32)
        Bs[u * kLdS + k] = Cs[u * kLdS + k] = 0.0f;
  }
  cp_async_wait<2>();
  __syncthreads();

  // C B^T over the tiles of 8 rows t (block tb) by 4 columns u (block ub)
  // that reach the diagonal or below it, ub <= 2 tb + 1, stored u-major.
  // A warp takes 16 tiles: lane l sums k below kmid for tile l % 16 and
  // lane l + 16 the rest, and one shuffle adds the two halves (in a fixed
  // order).
  {
    const int nb = (Q + 7) >> 3, ntiles = nb * (nb + 1);
    const int kmid = (S4 >> 3) << 2, half = lane >> 4;
    const int k0 = half ? kmid : 0, k1 = half ? S4 : kmid;
    for (int base = 16 * warp; base < ntiles; base += kThreads / 2) {
      // tile = tb (tb + 1) + ub
      const int tile = min(base + (lane & 15), ntiles - 1);
      int tb = static_cast<int>((sqrtf(4.0f * tile + 1.0f) - 1.0f) * 0.5f);
      while (tb * (tb + 1) > tile) --tb;
      while ((tb + 1) * (tb + 2) <= tile) ++tb;
      const int ub = tile - tb * (tb + 1);
      int cr[8], br[4];   // row offsets, clamped to the chunk
#pragma unroll
      for (int i = 0; i < 8; ++i) cr[i] = min(8 * tb + i, Q - 1) * kLdS;
#pragma unroll
      for (int j = 0; j < 4; ++j) br[j] = min(4 * ub + j, Q - 1) * kLdS;
      float acc[8][4] = {};
#pragma unroll 2
      for (int k = k0; k < k1; k += 4) {
        float4 cv[8], bv[4];
#pragma unroll
        for (int i = 0; i < 8; ++i) cv[i] = ld4(Cs + cr[i] + k);
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = ld4(Bs + br[j] + k);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = dot4(acc[i][j], cv[i], bv[j]);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float other = __shfl_xor_sync(0xffffffffu, acc[i][j], 16);
          acc[i][j] = half ? other + acc[i][j] : acc[i][j] + other;
        }
      if (half || base + (lane & 15) >= ntiles) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int u = 4 * ub + j;
        if (u >= Q) continue;
        float* row = CBt + u * kLdQ + 8 * tb;
        *reinterpret_cast<float4*>(row) =
            make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
        *reinterpret_cast<float4*>(row + 4) =
            make_float4(acc[4][j], acc[5][j], acc[6][j], acc[7][j]);
      }
    }
  }

  __syncthreads();   // C B^T is in; C is dead

  // Team 1 starts when team 0 has done its first head's y, so that one
  // team's scan, G_h and y overlap the other's H.
  if (team == 1 && h_begin < h_end) bar_sync(3, kThreads);

  // Warp w of a team takes rows 4w..4w+3 and 60-4w..63-4w of y.
  const int tl = 4 * wt, th = kMaxQ - 4 - 4 * wt;
  const int lo_end = min(tl + 4, Q), hi_end = min(th + 4, Q);
  for (int h = h_begin; h < h_end; ++h, cell += NC) {
    const int j = h - h_begin;
    const float* dl = steps + (j & 1) * 2 * kMaxQ;
    cp_async_wait<1>();
    bar_sync(1 + team, kTeamThreads);   // head h's x, deltas, dt are in

    // The columns of G_h that warp w's y reads, rows u < lo_end or
    // hi_end: lane l forms rows l and l + 32, from C B^T rows loaded
    // before the scan.  Only this warp reads them.
    const int u0 = min(lane, Q - 1), u1 = min(lane + 32, Q - 1);
    const float4 c_lo = ld4(CBt + u0 * kLdQ + tl),
                 c_h0 = ld4(CBt + u0 * kLdQ + th),
                 c_h1 = ld4(CBt + u1 * kLdQ + th);
    // Each warp scans the steps itself; the team's warp 0 writes exp(s).
    const Steps st = scan_steps(dl, dl + kMaxQ, Q, lane);
    if (wt == 0) {
      float* eg = exp_s + cell * Q;
      if (lane < Q) eg[lane] = expf(st.sa);
      if (lane + 32 < Q) eg[lane + 32] = expf(st.sb);
    }
    {
      float sl[4], sh[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        sl[i] = __shfl_sync(0xffffffffu, st.sa, tl + i);
        sh[i] = __shfl_sync(0xffffffffu, st.sb, th - 32 + i);
      }
      const float4 g_lo = g_row(c_lo, lane, st.sa, st.da, tl, sl, Q);
      const float4 g_h0 = g_row(c_h0, lane, st.sa, st.da, th, sh, Q);
      const float4 g_h1 = g_row(c_h1, lane + 32, st.sb, st.db, th, sh, Q);
      if (tl < Q && lane < lo_end)
        *reinterpret_cast<float4*>(gcur + lane * kLdQ + tl) = g_lo;
      if (th < Q && lane < hi_end)
        *reinterpret_cast<float4*>(gcur + lane * kLdQ + th) = g_h0;
      if (th < Q && lane + 32 < hi_end)
        *reinterpret_cast<float4*>(gcur + (lane + 32) * kLdQ + th) = g_h1;
    }
    __syncwarp();

    // y = G_h x: rows tl..tl+3 and th..th+3, columns 2 lane, 2 lane + 1.
    {
      const float* xp = xcur + 2 * lane;
      float al[4][2] = {}, ah[4][2] = {};
      int u = 0;
#pragma unroll 8
      for (; u < lo_end; ++u) {
        const float4 gl = ld4(gcur + u * kLdQ + tl);
        const float4 gh = ld4(gcur + u * kLdQ + th);
        const float2 xv = *reinterpret_cast<const float2*>(xp + u * kLdQ);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          fma2(al[i], comp(gl, i), xv);
          fma2(ah[i], comp(gh, i), xv);
        }
      }
#pragma unroll 4
      for (; u < hi_end; ++u) {
        const float4 gh = ld4(gcur + u * kLdQ + th);
        const float2 xv = *reinterpret_cast<const float2*>(xp + u * kLdQ);
#pragma unroll
        for (int i = 0; i < 4; ++i) fma2(ah[i], comp(gh, i), xv);
      }
      float* yc = y + cell * Q * P;
      if (vec & kVecY) {
        if (2 * lane < P)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (tl + i < Q)
              *reinterpret_cast<float2*>(yc + (tl + i) * P + 2 * lane) =
                  make_float2(al[i][0], al[i][1]);
            if (th + i < Q)
              *reinterpret_cast<float2*>(yc + (th + i) * P + 2 * lane) =
                  make_float2(ah[i][0], ah[i][1]);
          }
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int p = 2 * lane + j;
            if (p >= P) continue;
            if (tl + i < Q) yc[(tl + i) * P + p] = al[i][j];
            if (th + i < Q) yc[(th + i) * P + p] = ah[i][j];
          }
      }
    }
    if (team == 0 && h == h_begin && split < h_last)
      bar_arrive(3, kThreads);   // team 1 may start

    // x*w, rows 8w..8w+7.
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int u = 8 * wt + r;
      const float wu = __shfl_sync(0xffffffffu, u < 32 ? st.wa : st.wb, u & 31);
      if (u < Q)
#pragma unroll
        for (int k = 0; k < 2; ++k)
          if (lane + 32 * k < P)
            W[u * kLdQ + lane + 32 * k] = xcur[u * kLdQ + lane + 32 * k] * wu;
    }
    bar_sync(1 + team, kTeamThreads);   // x*w is in; G_h, x, steps dead

    // Head h + 2 into the dead G_h (its steps where head h's were).
    load_head(gcur, j + 2);

    // H = B^T (x*w): warp w owns rows 16w..16w+15, whose B words every
    // lane reads at once (broadcasts), and a lane columns 2 lane and
    // 2 lane + 1; a store writes 256 bytes of a row.
    if (16 * wt < S) {
      const int s0 = 16 * wt;
      float acc[16][2] = {};
#pragma unroll 8
      for (int u = 0; u < Q; ++u) {
        const float* br = Bs + u * kLdS + s0;
        const float4 b0 = ld4(br), b1 = ld4(br + 4), b2 = ld4(br + 8),
                     b3 = ld4(br + 12);
        const float2 xv =
            *reinterpret_cast<const float2*>(W + u * kLdQ + 2 * lane);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          fma2(acc[i], comp(b0, i), xv);
          fma2(acc[4 + i], comp(b1, i), xv);
          fma2(acc[8 + i], comp(b2, i), xv);
          fma2(acc[12 + i], comp(b3, i), xv);
        }
      }
      float* hc = Hs + cell * S * P;
      if (vec & kVecH) {
        if (2 * lane < P)
#pragma unroll
          for (int i = 0; i < 16; ++i)
            if (s0 + i < S)
              *reinterpret_cast<float2*>(hc + (s0 + i) * P + 2 * lane) =
                  make_float2(acc[i][0], acc[i][1]);
      } else {
#pragma unroll
        for (int i = 0; i < 16; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int p = 2 * lane + j;
            if (p >= P || s0 + i >= S) continue;
            hc[(s0 + i) * P + p] = acc[i][j];
          }
      }
    }
    // Head h + 1's x becomes the current one; head h's tile takes G_h.
    float* t = xcur;
    xcur = xnext;
    xnext = gcur;
    gcur = t;
  }
}

}  // namespace

// x [BH, NC, Q, P], delta/dtv [BH, NC, Q], Bm/Cm [B, G, NC, Q, S] float32
// row-major, BH = B * G * hpg with heads fastest; outputs y [BH, NC, Q, P],
// Hs [BH, NC, S, P], exp_s [BH, NC, Q] float32.  Q <= 64, P <= 64,
// S <= 128, 1 <= nh <= hpg heads a block.  Launches on `stream` and
// returns cudaGetLastError() (0 on success), the error of the
// shared-memory opt-in if the card refuses the tile, or
// cudaErrorInvalidValue for shapes it was not built for.
extern "C" int ssd_chunk_launch(const void* x, const void* delta,
                                const void* dtv, const void* Bm,
                                const void* Cm, void* y, void* Hs,
                                void* exp_s, int BH, int NC, int Q, int P,
                                int S, int B, int G, int hpg, int nh,
                                void* stream) {
  if (Q < 1 || Q > kMaxQ || P < 1 || P > kMaxP || S < 1 || S > kMaxS ||
      B < 1 || G < 1 || hpg < 1 || nh < 1 || nh > hpg ||
      BH != B * G * hpg || NC < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (NC == 0) return static_cast<int>(cudaGetLastError());
  const int nblk = (hpg + nh - 1) / nh;
  const long long blocks = static_cast<long long>(B) * G * NC * nblk;
  if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(Q);
  const cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto aligned = [](const void* p, int bytes) {
    return reinterpret_cast<uintptr_t>(p) % bytes == 0;
  };
  const int vec = (P % 4 == 0 && aligned(x, 16) ? kVecX : 0) |
                  (S % 4 == 0 && aligned(Bm, 16) && aligned(Cm, 16) ? kVecBC
                                                                    : 0) |
                  (P % 2 == 0 && aligned(y, 8) ? kVecY : 0) |
                  (P % 2 == 0 && aligned(Hs, 8) ? kVecH : 0);
  ssd_chunk_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(delta),
      static_cast<const float*>(dtv), static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), static_cast<float*>(y),
      static_cast<float*>(Hs), static_cast<float*>(exp_s), NC, Q, P, S, hpg,
      nh, nblk, vec);
  return static_cast<int>(cudaGetLastError());
}

namespace {

// ------------------------------------------------------------- backward
//
// The gradients of the block above for the output gradients dy [Q, P],
// dH [S, P] and des [Q] of one (bh, chunk) cell, with M[t, u] =
// exp(min(s_t - s_u, 0)) [u <= t], CB = C B^T, G = CB * M * dt_u and w_u =
// e_u dt_u, e_u = exp(s_{Q-1} - s_u):
//   dG = dy x^T (on the triangle), F = dG * M, Z = F * dt_u;
//   dx = G^T dy + w * (B dH);
//   dC = Z B,  dB = Z^T C + w * (x dH^T),  summed over the heads of a group;
//   dw_u = B_u . (x dH^T)_u,  ddt_u = sum_{t >= u} F CB [t, u] + dw_u e_u;
//   ds_t = sum_{u < t} E[t, u] - sum_{t' > t} E[t', t] + des_t exp(s_t)
//          + [t = Q-1] sum_{u < Q-1} w_u dw_u - [t < Q-1] w_t dw_t,
// with E = Z * CB strictly below the diagonal (M's row and column terms,
// which cancel on it); ddelta is the reverse cumulative sum of ds.
//
// Bound.  At mamba2-1.3b's B = 2, L = 1024 (G = 1, 64 heads, Q = P = 64,
// S = 128) the products need 5.4 Gflop (C B^T, sum Z B and sum Z^T C on
// the triangle once a (batch, group, chunk); dy x^T and G^T dy on the
// triangle, x dH^T and B dH a cell) against 175 MB moved once (x, dy,
// dx, dH, B, C, dB, dC and the step vectors): 52.1 us of bytes at 3.35
// TB/s, 33 us of operations as three TF32 MMAs a product at 495 T op/s
// (81.1 us on the CUDA cores' float32 67 T op/s), so bytes bound it.
//
// Design.  One block of 512 threads (16 warps) per (batch, group, chunk,
// run of nh heads), the grid of the forward (ops.py::k8_blocks, nh from
// ops.py::plan_k8_bwd).  Since B and C are shared by the heads of a
// group, dC = (sum_h Z_h) B and dB's first term (sum_h Z_h)^T C: the
// block sums Z over its heads in shared memory, in head order (each warp
// adds the same cells of every head), and forms both products once at its
// end; the per-head term w * (x dH^T) of dB is summed in registers (each
// warp owns the same (u, s) cells of every head).  With one run a block
// writes dB and dC; with more, each run writes its partial sums and a
// second kernel adds them in run order.
//
// Every product runs on the tensor cores as m16n8k8 mma.sync, float32
// accurate by 3xTF32 (x = hi + lo, lo.hi + hi.lo + hi.hi, small terms
// first; flash_attention.cu's `split` and `mma_tf32`), each operand split
// into its TF32 parts as its fragment is read from shared memory (no split
// pass, no doubled tiles).  An accumulator starts at zero for each
// product of a head; the sums over heads (sum Z, the dB term) and over
// runs are float32 adds in a fixed order, with no atomics: two calls give
// the same bits.  Warp w = (mi, nj) = (w / 4, w % 4) owns rows 16 mi ..
// 16 mi + 15 of every product:
//   - C B^T (once a block), dG = dy x^T, G and sum Z: the 8-column tiles
//     j of {nj, nj + 4} that reach the causal triangle (j <= 2 mi + 1),
//     20 tiles over 16 warps; the warp forms G (zeros above the diagonal)
//     and F from dG's fragments and stores G for dx;
//   - x dH^T, dB and dC: columns 32 nj .. 32 nj + 31 of S;
//   - dx: columns 16 nj .. 16 nj + 15 of P, G^T read across G's rows
//     over the t >= 16 mi its rows need, after a block barrier.
// Every warp scans the head's deltas itself with shuffles (no barrier, no
// lone warp); the column sums of F CB (ddt, ds) and the row sums of E and
// of B * (x dH^T) (ds, dw) come out of the fragments by shuffles and are
// added over warps in a fixed order from small per-head arrays.  One warp
// (head j's is warp j mod 16) then forms ddt, ds and ddelta of head j
// while the others run head j + 1 (the arrays are double-buffered).  The
// next head's x, dy, dH and steps land by cp.async (16-byte pieces where
// the widths allow) while the current one computes: two block barriers a
// head (head j in; G in).  Rows and columns past Q, P and S are zeros in
// the tiles, so the products run at the full 64 / 128 extents.  What
// outlives a head stays out of registers (sum Z, C B^T, G and the steps
// the finishing warp reads are in shared memory), so the block's 16 warps
// fit 128 registers a thread.
//
// Shared memory (floats), one block an SM: B [64][128], C B^T, G and sum
// Z [64][64], two head buffers of x, dy [64][64], dH [128][64] and three
// step vectors, two sets of per-head sums and steps [17][64]: 223 232
// bytes of the 232 448 a block may opt into.  C lands in the second head
// buffer until C B^T is formed, and again in a dead buffer at the end.
// The tiles are unpadded, element (r, c) at r * W + (c ^ swz(r)): every
// fragment read, along a row (rows g, columns t) or across rows (rows t,
// columns g), falls on 32 distinct banks.

constexpr int kBwdThreads = 512;           // 16 warps
constexpr int kSumThreads = 256;           // the runs' sum
// A head's words: x, dy [Q][P], dH [S][P], then delta, dt, des.
constexpr int kHeadWords = 2 * kMaxQ * kMaxP + kMaxS * kMaxP + 3 * kMaxQ;
// A head's sums over warps and steps for the warp that finishes it
// (kPart* below).
constexpr int kPartWords = 17 * kMaxQ;
constexpr int kBwdWords =
    kMaxQ * kMaxS + 3 * kMaxQ * kMaxQ + 2 * kHeadWords + 2 * kPartWords;
static_assert(2 * kMaxQ * kMaxP >= kMaxQ * kMaxS,
              "C fits a head buffer's x and dy");

// x rounded to TF32, to nearest with ties away from zero, and x = hi + lo
// (flash_attention.cu's tf32_rna and split).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// c += A (16 x 8, row) * B (8 x 8, col), TF32 in, float32 accumulate.
// Lane (g, t) = (lane / 4, lane % 4) holds a = {A[g][t], A[g+8][t],
// A[g][t+4], A[g+8][t+4]}, b = {B[t][g], B[t+4][g]} and c = {C[g][2t],
// C[g][2t+1], C[g+8][2t], C[g+8][2t+1]}.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
#ifdef __CUDA_ARCH__
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
#else
  // The same product from the lanes' fragments, gathered by shuffles; the
  // tensor cores read the top 19 bits of each operand.
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const uint32_t m19 = 0xffffe000u;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int kk = 0; kk < 8; ++kk) {
    const int src = kk & 3, hi = kk >> 2;
    const float a_g = __uint_as_float(
        __shfl_sync(0xffffffffu, a[hi ? 2 : 0], g * 4 + src) & m19);
    const float a_g8 = __uint_as_float(
        __shfl_sync(0xffffffffu, a[hi ? 3 : 1], g * 4 + src) & m19);
    const float b_0 = __uint_as_float(
        __shfl_sync(0xffffffffu, hi ? b1 : b0, (2 * t) * 4 + src) & m19);
    const float b_1 = __uint_as_float(
        __shfl_sync(0xffffffffu, hi ? b1 : b0, (2 * t + 1) * 4 + src) & m19);
    acc[0] += a_g * b_0;
    acc[1] += a_g * b_1;
    acc[2] += a_g8 * b_0;
    acc[3] += a_g8 * b_1;
  }
  for (int i = 0; i < 4; ++i) c[i] += acc[i];
#endif
}

// An A fragment split into its TF32 parts.
struct FragA {
  uint32_t h[4], l[4];
  __device__ __forceinline__ explicit FragA(const float (&a)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) split(a[i], h[i], l[i]);
  }
};

// c += A B, float32-accurate: lo_a hi_b + hi_a lo_b + hi_a hi_b, B's
// fragment {b[0], b[1]} split as it is used.
__device__ __forceinline__ void mma3(float (&c)[4], const FragA& a,
                                     const float (&b)[2]) {
  uint32_t h0, l0, h1, l1;
  split(b[0], h0, l0);
  split(b[1], h1, l1);
  mma_tf32(c, a.l, h0, h1);
  mma_tf32(c, a.h, l0, l1);
  mma_tf32(c, a.h, h0, h1);
}

// The swizzle of row r: bits 2..4 of a column XORed with a permutation of
// r mod 8 whose halves (r mod 8 < 4, >= 4) differ in their top two bits.
__device__ __forceinline__ int swz(int r) {
  return (((r & 3) << 1) | ((r >> 2) & 1)) << 2;
}

// Element (r, c) of a swizzled tile of row width W (a multiple of 32).
template <int W>
__device__ __forceinline__ int sw(int r, int c) {
  return r * W + (c ^ swz(r));
}

// A fragments of rows m0 .. m0 + 15 and k-step columns k0 .. k0 + 7 of a
// tile holding A (row m) or A^T (row k); B fragments of columns n0 .. n0
// + 7 from a tile holding B^T (row n) or B (row k).
template <int W>
__device__ __forceinline__ void frag_a(const float* T, int m0, int k0,
                                       int g, int t, float (&a)[4]) {
  a[0] = T[sw<W>(m0 + g, k0 + t)];
  a[1] = T[sw<W>(m0 + g + 8, k0 + t)];
  a[2] = T[sw<W>(m0 + g, k0 + t + 4)];
  a[3] = T[sw<W>(m0 + g + 8, k0 + t + 4)];
}
template <int W>
__device__ __forceinline__ void frag_at(const float* T, int m0, int k0,
                                        int g, int t, float (&a)[4]) {
  a[0] = T[sw<W>(k0 + t, m0 + g)];
  a[1] = T[sw<W>(k0 + t, m0 + g + 8)];
  a[2] = T[sw<W>(k0 + t + 4, m0 + g)];
  a[3] = T[sw<W>(k0 + t + 4, m0 + g + 8)];
}
template <int W>
__device__ __forceinline__ void frag_bn(const float* T, int n0, int k0,
                                        int g, int t, float (&b)[2]) {
  b[0] = T[sw<W>(n0 + g, k0 + t)];
  b[1] = T[sw<W>(n0 + g, k0 + t + 4)];
}
template <int W>
__device__ __forceinline__ void frag_bk(const float* T, int n0, int k0,
                                        int g, int t, float (&b)[2]) {
  b[0] = T[sw<W>(k0 + t, n0 + g)];
  b[1] = T[sw<W>(k0 + t + 4, n0 + g)];
}

// Rows x cols floats (row stride cols) into a swizzled tile of width W by
// cp.async (16-byte pieces with vec), by the n threads numbered t.
template <int W>
__device__ __forceinline__ void load_sw(float* dst, const float* src,
                                        int rows, int cols, bool vec, int t,
                                        int n) {
  if (vec) {
    const int c4 = cols >> 2;
    for (int i = t; i < rows * c4; i += n) {
      const int r = i / c4, k = (i - r * c4) << 2;
      cp_async<16>(dst + sw<W>(r, k), src + r * cols + k);
    }
  } else {
    for (int i = t; i < rows * cols; i += n) {
      const int r = i / cols;
      cp_async<4>(dst + sw<W>(r, i - r * cols), src + i);
    }
  }
}

// Zeros at the elements (r, c) of an R x W swizzled tile with r >= rows
// or c >= cols (never where load_sw writes).
template <int R, int W>
__device__ __forceinline__ void zero_pad(float* dst, int rows, int cols,
                                         int t, int n) {
  for (int i = t; i < R * W; i += n) {
    const int r = i / W, c = i - r * W;
    if (r >= rows || c >= cols) dst[sw<W>(r, c)] = 0.0f;
  }
}

// Step i's value of a head as a warp's lanes hold it (lane l: steps l in
// va and l + 32 in vb), on every lane for its own i.
__device__ __forceinline__ float step_of(float va, float vb, int i) {
  const float a = __shfl_sync(0xffffffffu, va, i & 31);
  const float b = __shfl_sync(0xffffffffu, vb, i & 31);
  return i < 32 ? a : b;
}

// The warp's sum of v in a fixed order, lane 0's, on every lane.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return __shfl_sync(0xffffffffu, v, 0);
}

// A head's sums over warps and its steps, which the warp that finishes
// the head reads (word offsets into a part): F CB's strict column sums
// [4 mi][Q], its diagonal [Q], E's row sums [4 nj][Q], dw's [4 nj][Q], then
// the steps s, dt, exp(s_{Q-1} - s) and des [Q] each.
constexpr int kPartCol = 0, kPartDiag = 4 * kMaxQ, kPartRow = 5 * kMaxQ,
              kPartDw = 9 * kMaxQ, kPartS = 13 * kMaxQ, kPartDt = 14 * kMaxQ,
              kPartE = 15 * kMaxQ, kPartDes = 16 * kMaxQ;

// ddt, ds and its reverse cumulative sum ddelta of the head at `cell`,
// from its part, by one warp, lane l steps l and l + 32; each sum over
// warps added in warp order.
__device__ __forceinline__ void bwd_finish(const float* part, long long cell,
                                           int Q, int lane,
                                           float* __restrict__ ddt,
                                           float* __restrict__ ddelta) {
  float ds[2] = {0.0f, 0.0f}, wdw[2] = {0.0f, 0.0f};
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int t = lane + 32 * k;
    if (t >= Q) continue;
    float col = 0.0f;   // sum_{t' > t} F CB [t', t]
    for (int mi = t >> 4; mi < 4; ++mi) col += part[kPartCol + mi * kMaxQ + t];
    float row = 0.0f, dw = 0.0f;
#pragma unroll
    for (int nj = 0; nj < 4; ++nj) {
      row += part[kPartRow + nj * kMaxQ + t];
      dw += part[kPartDw + nj * kMaxQ + t];
    }
    const float s = part[kPartS + t], dt = part[kPartDt + t];
    const float e = part[kPartE + t], des = part[kPartDes + t];
    ddt[cell * Q + t] = (col + part[kPartDiag + t]) + dw * e;
    wdw[k] = (e * dt) * dw;
    float d = row - dt * col + des * expf(s);
    if (t < Q - 1) d -= wdw[k];
    ds[k] = d;
  }
  const float wsum = warp_sum((lane < Q - 1 ? wdw[0] : 0.0f) +
                              (lane + 32 < Q - 1 ? wdw[1] : 0.0f));
#pragma unroll
  for (int k = 0; k < 2; ++k)
    if (lane + 32 * k == Q - 1) ds[k] += wsum;
  // Suffix sums: within each half by shuffles, then the second half's
  // total added to the first.
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float a0 = __shfl_down_sync(0xffffffffu, ds[0], off);
    const float a1 = __shfl_down_sync(0xffffffffu, ds[1], off);
    if (lane + off < 32) {
      ds[0] += a0;
      ds[1] += a1;
    }
  }
  ds[0] += __shfl_sync(0xffffffffu, ds[1], 0);
  if (lane < Q) ddelta[cell * Q + lane] = ds[0];
  if (lane + 32 < Q) ddelta[cell * Q + lane + 32] = ds[1];
}

// Bits of the backward's `vec` argument: x, dy, dH and B, C copied in
// 16-byte pieces; dx and dB, dC stored in 8-byte ones.
constexpr int kVecXH = 1, kVecBCB = 2, kVecDX = 4, kVecDBC = 8;

// blockIdx.x as in ssd_chunk_kernel.  dB and dC go to oB, oC plus hb *
// run_stride (the run's partial sums, or the gradients with one run).
__global__ void __launch_bounds__(kBwdThreads, 1)
ssd_chunk_bwd_kernel(const float* __restrict__ x,
                     const float* __restrict__ delta,
                     const float* __restrict__ dtv,
                     const float* __restrict__ Bm,
                     const float* __restrict__ Cm,
                     const float* __restrict__ dy,
                     const float* __restrict__ dH,
                     const float* __restrict__ des, float* __restrict__ dx,
                     float* __restrict__ ddelta, float* __restrict__ ddt,
                     float* __restrict__ oB, float* __restrict__ oC, int NC,
                     int Q, int P, int S, int hpg, int nh, int nblk,
                     long long run_stride, int vec) {
  const int hb = blockIdx.x % nblk;
  const int bgc = blockIdx.x / nblk;       // (b * G + g) * NC + c
  const int c = bgc % NC, bg = bgc / NC;
  const int h_first = hb * nh, nheads = min(h_first + nh, hpg) - h_first;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int mi = warp >> 2, nj = warp & 3;
  const int r0 = 16 * mi;                  // the warp's rows
  // The warp's 8-column tiles of C B^T, dG, G and sum Z: nj and nj + 4
  // where they reach the triangle.
  const bool has[2] = {nj <= 2 * mi + 1, nj + 4 <= 2 * mi + 1};

  extern __shared__ __align__(16) float sm[];
  float* Bs = sm;                          // [64][128] B (row u)
  float* CBs = Bs + kMaxQ * kMaxS;         // [64][64] C B^T (row t)
  float* Gs = CBs + kMaxQ * kMaxQ;         // [64][64] the head's G (row t)
  float* Zs = Gs + kMaxQ * kMaxQ;          // [64][64] sum Z (row t)
  float* hbuf[2] = {Zs + kMaxQ * kMaxQ, Zs + kMaxQ * kMaxQ + kHeadWords};
  float* parts = hbuf[1] + kHeadWords;     // [2][kPartWords]
  float* Cs = hbuf[1];                     // [64][128] C (row t), at first
  const long long cell0 = (static_cast<long long>(bg) * hpg + h_first) * NC + c;

  // Head j of the run into buffer j % 2, as one group of copies (an
  // empty one past the last head).
  const auto load_head = [&](int j) {
    if (j < nheads) {
      const long long cl = cell0 + static_cast<long long>(j) * NC;
      float* hbj = hbuf[j & 1];
      load_sw<kMaxP>(hbj, x + cl * Q * P, Q, P, vec & kVecXH, tid,
                     kBwdThreads);
      load_sw<kMaxP>(hbj + kMaxQ * kMaxP, dy + cl * Q * P, Q, P,
                     vec & kVecXH, tid, kBwdThreads);
      load_sw<kMaxP>(hbj + 2 * kMaxQ * kMaxP, dH + cl * S * P, S, P,
                     vec & kVecXH, tid, kBwdThreads);
      float* stp = hbj + 2 * kMaxQ * kMaxP + kMaxS * kMaxP;
      if (tid < Q) {
        cp_async<4>(stp + tid, delta + cl * Q + tid);
        cp_async<4>(stp + kMaxQ + tid, dtv + cl * Q + tid);
        cp_async<4>(stp + 2 * kMaxQ + tid, des + cl * Q + tid);
      }
    }
    cp_async_commit();
  };
  const auto zero_head = [&](float* hbj) {
    zero_pad<kMaxQ, kMaxP>(hbj, Q, P, tid, kBwdThreads);
    zero_pad<kMaxQ, kMaxP>(hbj + kMaxQ * kMaxP, Q, P, tid, kBwdThreads);
    zero_pad<kMaxS, kMaxP>(hbj + 2 * kMaxQ * kMaxP, S, P, tid, kBwdThreads);
  };
  // Element e of the warp's C fragment of 8-column tile q: row r0 + g +
  // 8 (e >> 1), column 8 (nj + 4 q) + 2t + (e & 1); a pair e, e + 1 is one
  // 8-byte word of a swizzled tile.
  const auto at_pair = [&](int q, int i) {
    return sw<kMaxQ>(r0 + g + 8 * i, 8 * (nj + 4 * q) + 2 * t);
  };

  // The chunk's B and C and the first head; zeros past Q, P and S.
  const long long bc = static_cast<long long>(bgc) * Q * S;
  load_sw<kMaxS>(Bs, Bm + bc, Q, S, vec & kVecBCB, tid, kBwdThreads);
  load_sw<kMaxS>(Cs, Cm + bc, Q, S, vec & kVecBCB, tid, kBwdThreads);
  load_head(0);
  zero_pad<kMaxQ, kMaxS>(Bs, Q, S, tid, kBwdThreads);
  zero_pad<kMaxQ, kMaxS>(Cs, Q, S, tid, kBwdThreads);
  zero_head(hbuf[0]);
  cp_async_wait<0>();
  __syncthreads();

  // C B^T over the warp's tiles, reduced over S, into shared memory; sum
  // Z's tiles start at zero.
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    if (!has[q]) continue;
    float cb[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
    for (int ks = 0; ks < kMaxS / 8; ++ks) {
      float af[4], b[2];
      frag_a<kMaxS>(Cs, r0, 8 * ks, g, t, af);
      frag_bn<kMaxS>(Bs, 8 * (nj + 4 * q), 8 * ks, g, t, b);
      mma3(cb, FragA(af), b);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      *reinterpret_cast<float2*>(CBs + at_pair(q, i)) =
          make_float2(cb[2 * i], cb[2 * i + 1]);
      *reinterpret_cast<float2*>(Zs + at_pair(q, i)) = make_float2(0.0f, 0.0f);
    }
  }

  float dbh[4][4] = {};    // (u, s): sum over heads of w * (x dH^T)
  for (int j = 0; j < nheads; ++j) {
    cp_async_wait<0>();
    __syncthreads();   // head j is in; every warp is done with head j - 1
    if (j == 0) zero_head(hbuf[1]);   // C is dead
    load_head(j + 1);
    float* part = parts + (j & 1) * kPartWords;
    const long long cell = cell0 + static_cast<long long>(j) * NC;
    if (j > 0 && warp == ((j - 1) & 15))
      bwd_finish(parts + ((j - 1) & 1) * kPartWords, cell - NC, Q, lane, ddt,
                 ddelta);

    const float* xs = hbuf[j & 1];
    const float* ys = xs + kMaxQ * kMaxP;
    const float* hs = ys + kMaxQ * kMaxP;
    const float* stp = hs + kMaxS * kMaxP;
    const Steps st = scan_steps(stp, stp + kMaxQ, Q, lane);
    if (warp == 0) {   // the steps the finishing warp reads
      const float last =
          __shfl_sync(0xffffffffu, Q > 32 ? st.sb : st.sa, (Q - 1) & 31);
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int i = lane + 32 * k;
        if (i >= Q) continue;
        const float s = k ? st.sb : st.sa;
        part[kPartS + i] = s;
        part[kPartDt + i] = k ? st.db : st.da;
        part[kPartE + i] = expf(last - s);
        part[kPartDes + i] = stp[2 * kMaxQ + i];
      }
    }
    // The steps of the warp's rows r0 + g and r0 + g + 8.
    const float s_r[2] = {step_of(st.sa, st.sb, r0 + g),
                          step_of(st.sa, st.sb, r0 + g + 8)};
    const float w_r[2] = {step_of(st.wa, st.wb, r0 + g),
                          step_of(st.wa, st.wb, r0 + g + 8)};

    // dG = dy x^T on the warp's tiles (rows t, columns u), reduced over
    // P; then G and F (M on the triangle), Z into sum Z, and F CB's column
    // sums (strict, and the diagonal) and E's row sums.
    {
      float rows[2] = {0.0f, 0.0f};
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (!has[q]) continue;
        float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int ks = 0; ks < kMaxP / 8; ++ks) {
          float af[4], b[2];
          frag_a<kMaxP>(ys, r0, 8 * ks, g, t, af);
          frag_bn<kMaxP>(xs, 8 * (nj + 4 * q), 8 * ks, g, t, b);
          mma3(acc, FragA(af), b);
        }
        const int u0 = 8 * (nj + 4 * q) + 2 * t;
        const float su[2] = {step_of(st.sa, st.sb, u0),
                             step_of(st.sa, st.sb, u0 + 1)};
        const float du[2] = {step_of(st.da, st.db, u0),
                             step_of(st.da, st.db, u0 + 1)};
        float cols[2] = {0.0f, 0.0f};
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int tr = r0 + g + 8 * i;
          const float2 cb = *reinterpret_cast<const float2*>(CBs +
                                                            at_pair(q, i));
          float2* zp = reinterpret_cast<float2*>(Zs + at_pair(q, i));
          float2 z = *zp;
          float gv[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int u = u0 + e;
            const float cbe = e ? cb.y : cb.x;
            float zz = 0.0f, fcb = 0.0f;
            gv[e] = 0.0f;
            if (u <= tr) {
              const float m = expf(fminf(s_r[i] - su[e], 0.0f));
              const float f = acc[2 * i + e] * m;
              zz = f * du[e];
              fcb = f * cbe;
              gv[e] = cbe * m * du[e];
            }
            (e ? z.y : z.x) += zz;
            if (u < tr) {
              cols[e] += fcb;
              rows[i] += fcb * du[e];
            } else if (u == tr) {
              part[kPartDiag + u] = fcb;
            }
          }
          *zp = z;
          *reinterpret_cast<float2*>(Gs + at_pair(q, i)) =
              make_float2(gv[0], gv[1]);
        }
        // Sum the columns over the tile's 16 rows (lanes g), in order.
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          cols[0] += __shfl_xor_sync(0xffffffffu, cols[0], off);
          cols[1] += __shfl_xor_sync(0xffffffffu, cols[1], off);
        }
        if (g == 0) {
          part[kPartCol + mi * kMaxQ + u0] = cols[0];
          part[kPartCol + mi * kMaxQ + u0 + 1] = cols[1];
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        rows[i] += __shfl_xor_sync(0xffffffffu, rows[i], 1);
        rows[i] += __shfl_xor_sync(0xffffffffu, rows[i], 2);
      }
      if (t == 0) {
        part[kPartRow + nj * kMaxQ + r0 + g] = rows[0];
        part[kPartRow + nj * kMaxQ + r0 + g + 8] = rows[1];
      }
    }

    // x dH^T (rows u, columns s of 32 nj + 8 n), reduced over P: dw's
    // row sums with B, and w * (x dH^T) into dbh.
    {
      float acc[4][4] = {};
#pragma unroll
      for (int ks = 0; ks < kMaxP / 8; ++ks) {
        float af[4];
        frag_a<kMaxP>(xs, r0, 8 * ks, g, t, af);
        const FragA a(af);
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          float b[2];
          frag_bn<kMaxP>(hs, 32 * nj + 8 * n, 8 * ks, g, t, b);
          mma3(acc[n], a, b);
        }
      }
      float dw[2] = {0.0f, 0.0f};
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int s0 = 32 * nj + 8 * n + 2 * t;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float2 bv = *reinterpret_cast<const float2*>(
              Bs + sw<kMaxS>(r0 + g + 8 * i, s0));
          dw[i] = fmaf(bv.x, acc[n][2 * i], dw[i]);
          dw[i] = fmaf(bv.y, acc[n][2 * i + 1], dw[i]);
#pragma unroll
          for (int e = 0; e < 2; ++e)
            dbh[n][2 * i + e] = fmaf(w_r[i], acc[n][2 * i + e],
                                     dbh[n][2 * i + e]);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        dw[i] += __shfl_xor_sync(0xffffffffu, dw[i], 1);
        dw[i] += __shfl_xor_sync(0xffffffffu, dw[i], 2);
      }
      if (t == 0) {
        part[kPartDw + nj * kMaxQ + r0 + g] = dw[0];
        part[kPartDw + nj * kMaxQ + r0 + g + 8] = dw[1];
      }
    }
    __syncthreads();   // G is in

    // dx = G^T dy + w * (B dH): rows u, columns p of 16 nj + 8 n; G^T's
    // fragments over t >= r0.
    {
      float a1[2][4] = {}, a2[2][4] = {};
#pragma unroll
      for (int ks = 0; ks < kMaxQ / 8; ++ks) {
        if (ks < 2 * mi) continue;
        float af[4];
        frag_at<kMaxQ>(Gs, r0, 8 * ks, g, t, af);
        const FragA a(af);
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          float b[2];
          frag_bk<kMaxP>(ys, 16 * nj + 8 * n, 8 * ks, g, t, b);
          mma3(a1[n], a, b);
        }
      }
#pragma unroll 4
      for (int ks = 0; ks < kMaxS / 8; ++ks) {
        float af[4];
        frag_a<kMaxS>(Bs, r0, 8 * ks, g, t, af);
        const FragA a(af);
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          float b[2];
          frag_bk<kMaxP>(hs, 16 * nj + 8 * n, 8 * ks, g, t, b);
          mma3(a2[n], a, b);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int u = r0 + g + 8 * i;
        if (u >= Q) continue;
        float* dxr = dx + (cell * Q + u) * P;
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const int p = 16 * nj + 8 * n + 2 * t;
          const float v0 = fmaf(w_r[i], a2[n][2 * i], a1[n][2 * i]);
          const float v1 = fmaf(w_r[i], a2[n][2 * i + 1], a1[n][2 * i + 1]);
          if ((vec & kVecDX) && p < P) {
            *reinterpret_cast<float2*>(dxr + p) = make_float2(v0, v1);
          } else {
            if (p < P) dxr[p] = v0;
            if (p + 1 < P) dxr[p + 1] = v1;
          }
        }
      }
    }
  }
  __syncthreads();   // every head's sums and sum Z are in; buffers dead

  // The last head's finish, and C (row t) into a dead buffer.
  if (warp == ((nheads - 1) & 15))
    bwd_finish(parts + ((nheads - 1) & 1) * kPartWords,
               cell0 + static_cast<long long>(nheads - 1) * NC, Q, lane, ddt,
               ddelta);
  float* C2 = hbuf[0];
  load_sw<kMaxS>(C2, Cm + bc, Q, S, vec & kVecBCB, tid, kBwdThreads);
  cp_async_commit();
  zero_pad<kMaxQ, kMaxS>(C2, Q, S, tid, kBwdThreads);
  cp_async_wait<0>();
  __syncthreads();

  // dC = sum Z B (rows t, u <= t) and dB = sum Z^T C (rows u, t >= u)
  // plus dbh, columns s of 32 nj + 8 n.
  {
    float ac[4][4] = {}, ab[4][4] = {};
#pragma unroll
    for (int ks = 0; ks < kMaxQ / 8; ++ks) {
      if (ks <= 2 * mi + 1) {
        float af[4];
        frag_a<kMaxQ>(Zs, r0, 8 * ks, g, t, af);
        const FragA a(af);
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          float b[2];
          frag_bk<kMaxS>(Bs, 32 * nj + 8 * n, 8 * ks, g, t, b);
          mma3(ac[n], a, b);
        }
      }
      if (ks >= 2 * mi) {
        float af[4];
        frag_at<kMaxQ>(Zs, r0, 8 * ks, g, t, af);
        const FragA a(af);
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          float b[2];
          frag_bk<kMaxS>(C2, 32 * nj + 8 * n, 8 * ks, g, t, b);
          mma3(ab[n], a, b);
        }
      }
    }
    const long long base = hb * run_stride + bc;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + g + 8 * i;
      if (r >= Q) continue;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int s = 32 * nj + 8 * n + 2 * t;
        const float c0 = ac[n][2 * i], c1 = ac[n][2 * i + 1];
        const float b0 = ab[n][2 * i] + dbh[n][2 * i];
        const float b1 = ab[n][2 * i + 1] + dbh[n][2 * i + 1];
        float* pc = oC + base + r * S + s;
        float* pb = oB + base + r * S + s;
        if ((vec & kVecDBC) && s < S) {
          *reinterpret_cast<float2*>(pc) = make_float2(c0, c1);
          *reinterpret_cast<float2*>(pb) = make_float2(b0, b1);
        } else {
          if (s < S) {
            pc[0] = c0;
            pb[0] = b0;
          }
          if (s + 1 < S) {
            pc[1] = c1;
            pb[1] = b1;
          }
        }
      }
    }
  }
}

// dB, dC = the runs' partial sums (part: runs of dB, then runs of dC, n
// values each), each element's runs added in run order.
__global__ void __launch_bounds__(kSumThreads)
ssd_chunk_bwd_sum_kernel(const float* __restrict__ part,
                         float* __restrict__ dB, float* __restrict__ dC,
                         int runs, long long n) {
  const long long e =
      static_cast<long long>(blockIdx.x) * kSumThreads + threadIdx.x;
  if (e >= n) return;
  float sb = 0.0f, sc = 0.0f;
  for (int r = 0; r < runs; ++r) {
    sb += part[r * n + e];
    sc += part[(runs + r) * n + e];
  }
  dB[e] = sb;
  dC[e] = sc;
}

}  // namespace

// The backward of ssd_chunk_launch's function: the forward's inputs x,
// delta, dtv, Bm, Cm and the gradients dy [BH, NC, Q, P], dH [BH, NC, S,
// P], des [BH, NC, Q] of its outputs, contiguous float32; writes dx [BH,
// NC, Q, P], ddelta, ddt [BH, NC, Q] and dB, dC [B, G, NC, Q, S] (summed
// over the heads of each group).  nh heads a block (1 <= nh <= hpg), so
// ceil(hpg / nh) runs a group; with more than one, `part` is float32
// scratch of 2 * runs * B * G * NC * Q * S values and a second kernel adds
// the runs.  Q <= 64, P <= 64, S <= 128.  Launches on `stream` and returns
// cudaGetLastError() (0 on success), the error of the shared-memory
// opt-in, or cudaErrorInvalidValue for arguments it does not take.
extern "C" int ssd_chunk_bwd_launch(
    const void* x, const void* delta, const void* dtv, const void* Bm,
    const void* Cm, const void* dy, const void* dH, const void* des,
    void* dx, void* ddelta, void* ddt, void* dB, void* dC, void* part,
    int BH, int NC, int Q, int P, int S, int B, int G, int hpg, int nh,
    void* stream) {
  if (Q < 1 || Q > kMaxQ || P < 1 || P > kMaxP || S < 1 || S > kMaxS ||
      B < 1 || G < 1 || hpg < 1 || nh < 1 || nh > hpg ||
      BH != B * G * hpg || NC < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nblk = (hpg + nh - 1) / nh;
  if (nblk > 1 && part == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (NC == 0) return static_cast<int>(cudaGetLastError());
  const long long blocks = static_cast<long long>(B) * G * NC * nblk;
  if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * kBwdWords;
  const cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n = static_cast<long long>(B) * G * NC * Q * S;
  float* pf = static_cast<float*>(part);
  float* oB = nblk > 1 ? pf : static_cast<float*>(dB);
  float* oC = nblk > 1 ? pf + nblk * n : static_cast<float*>(dC);
  const auto aligned = [](const void* p, int bytes) {
    return reinterpret_cast<uintptr_t>(p) % bytes == 0;
  };
  const int vec =
      (P % 4 == 0 && aligned(x, 16) && aligned(dy, 16) && aligned(dH, 16)
           ? kVecXH : 0) |
      (S % 4 == 0 && aligned(Bm, 16) && aligned(Cm, 16) ? kVecBCB : 0) |
      (P % 2 == 0 && aligned(dx, 8) ? kVecDX : 0) |
      (S % 2 == 0 && aligned(oB, 8) && aligned(oC, 8) ? kVecDBC : 0);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  ssd_chunk_bwd_kernel<<<static_cast<unsigned>(blocks), kBwdThreads, smem,
                         s>>>(
      static_cast<const float*>(x), static_cast<const float*>(delta),
      static_cast<const float*>(dtv), static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), static_cast<const float*>(dy),
      static_cast<const float*>(dH), static_cast<const float*>(des),
      static_cast<float*>(dx), static_cast<float*>(ddelta),
      static_cast<float*>(ddt), oB, oC, NC, Q, P, S, hpg, nh, nblk,
      nblk > 1 ? n : 0, vec);
  int e = static_cast<int>(cudaGetLastError());
  if (e != 0 || nblk == 1) return e;
  ssd_chunk_bwd_sum_kernel<<<static_cast<unsigned>((n + kSumThreads - 1) /
                                                   kSumThreads),
                             kSumThreads, 0, s>>>(
      pf, static_cast<float*>(dB), static_cast<float*>(dC), nblk, n);
  return static_cast<int>(cudaGetLastError());
}
