// Batched Eq.-1 RL score matrix for Hopper (sm_90a).
//
// Replaces the TPU kernel of the JAX reference,
// src/repro/kernels/rl_score/kernel.py::rl_score_pallas (body _kernel):
//   score[t, j] = (r_t . L_j) * inv_j,   inv_j = 1 / sum_k C[j, k]^2,
// for a block of T tasks against N servers, K resource dimensions.
//
// Design.  The TPU kernel pads T and N to 128x128 tiles and runs the
// K-long contraction on the matrix unit, with inv computed by its wrapper.
// K is 1 to 8, so this is a scaled outer product, not tensor-core work:
// every output costs K multiply-adds and 4 bytes of store.  One launch
// does everything.  The output is cut into column tiles of G groups of 4
// servers and row tiles of R * rpt tasks; a block of R * G threads owns
// one (row tile, column tile), and the blocks take the column tile
// fastest, so the blocks in flight together cover whole rows.  A block's
// prologue computes inv for the tile's 4G + 3 columns into shared memory
// (the 3 extra columns are the shift below) and copies their L there,
// while each thread loads the demands of its first rows; after one
// barrier each thread takes its 4 columns' L and inv into registers and
// writes its rpt rows, R apart, 4 at a time as independent stores with
// the next 4 rows' demands already loading.  ops.plan_k6 sizes G to the
// row (G = ceil(N/4) up to 32 groups, one warp-width of float4s, so at
// N = 100 a row is 25 threads and a 250-thread block holds 10 rows) and
// rpt: 4 where the grid still fills one wave of blocks (the 10^4-server
// shapes), else 2.
//
// Aligned stores whatever N is.  Row t starts at flat index t*N, which is
// 16-byte aligned only when t*N % 4 == 0.  With s = t*N % 4, a row's
// groups are its columns [4i - s, 4i - s + 4): every group is 16-byte
// aligned, the first is a scalar head of 4 - s columns when s > 0, the
// last a scalar tail when it runs past N, and the rest are float4 stores.
// A thread's rows are R apart and R * N % 4 == 0 (the plan's choice of R),
// so s, and the thread's 4 columns, are the same on all its rows.
//
// Bound.  The function reads (T + 2N) * K floats and writes T * N: at the
// main path's 10^4-server shapes the T x N store dominates (20.5 MB at
// T = 500, 41 MB at T = 1024; 6.0 and 12.3 us at 3.35 TB/s), so the
// kernel is bounded by memory bandwidth on its writes.  The prologue
// re-reads C and L once a row tile: ceil(T / (R * rpt)) * N * 2K * 4
// bytes, 5.1 MB at (1024, 10^4) with R * rpt = 32 (C alone 2.6 MB), from
// L2, against the 41 MB written.  At N = 100
// and T <= 2048 the output is under 1 MB and the kernel is bounded by its
// launch.  Measured against variants (tools/ablate_library_kernels.py on
// an H100, PERF.md section 6): the 16-byte stores are streaming
// stores (__stcs, st.global.cs), 3 to 6 us faster than plain ones at the
// 10^4-server shapes and no slower elsewhere; the shared prologue is 2.4
// to 2.7 us faster there (3.5 us at T = 384, N = 257, K = 8) than each
// thread reading its own columns from global memory, and the
// column-tile-fastest order 0.3 to 0.6 us faster than row tile fastest.
//
// Arithmetic.  As the reference's jitted wrapper computes it on XLA:CPU:
// the dot is a fused multiply-add chain in k order starting from r0 * L0,
// scaled by inv with one rounding, and inv is the IEEE reciprocal of
// sum(C^2).  The wrapper reduces sum(C^2) outside the Pallas kernel, and
// at K >= 5 XLA vectorises that reduction across servers: the servers
// j < nvec (ops: ref.unfused_columns, by N) sum their squares rounded,
// left to right, and the rest are the same fused chain as the dot.  The
// build passes -fmad=false so that no other product is contracted.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxG = 32;              // groups of 4 servers a column tile
constexpr int kMaxThreads = 256;       // R * G
constexpr int kCols = 4 * kMaxG + 3;   // columns a tile stages
constexpr int kUnroll = 4;             // rows a thread stores back to back

// The demands of rows t0 + (i0 + u) * R, u < kUnroll, of the thread's
// rows i < rpt (0 past them or past T).
template <int K>
__device__ __forceinline__ void load_rows(float (&rt)[kUnroll][K],
                                          const float* __restrict__ r,
                                          long long t0, int i0, int rpt,
                                          int R, int T) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long t = t0 + static_cast<long long>(i0 + u) * R;
    const bool live = i0 + u < rpt && t < T;
#pragma unroll
    for (int k = 0; k < K; ++k) rt[u][k] = live ? r[t * K + k] : 0.0f;
  }
}

// Server j's loads into l and its reciprocal norm 1 / sum_k C[j, k]^2
// (0 and 0 for j outside [0, N)); the squares of a server j < nvec are
// rounded and added left to right, the others fused.
template <int K>
__device__ __forceinline__ float load_column(const float* __restrict__ L,
                                             const float* __restrict__ C,
                                             int j, int N, int nvec,
                                             float (&l)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) l[k] = 0.0f;
  if (j < 0 || j >= N) return 0.0f;
  const float* c = C + static_cast<long long>(j) * K;
  float acc = c[0] * c[0];
  if (j < nvec) {
#pragma unroll
    for (int k = 1; k < K; ++k) acc = acc + c[k] * c[k];
  } else {
#pragma unroll
    for (int k = 1; k < K; ++k) acc = fmaf(c[k], c[k], acc);
  }
#pragma unroll
  for (int k = 0; k < K; ++k) l[k] = L[static_cast<long long>(j) * K + k];
  return 1.0f / acc;
}

template <int K>
__global__ void __launch_bounds__(kMaxThreads)
rl_score_kernel(const float* __restrict__ r, const float* __restrict__ L,
                const float* __restrict__ C, int T, int N, int G, int R,
                int rpt, int nvec, int col_tiles, float* __restrict__ out) {
  __shared__ float inv_s[kCols];
  __shared__ float l_s[K][kCols];
  const int tid = threadIdx.x;
  // Column tile fastest: the blocks in flight together cover whole rows.
  const int col_tile = static_cast<int>(blockIdx.x % col_tiles);
  const long long row_tile = blockIdx.x / col_tiles;
  const int W = 4 * G + 3;
  const int col0 = 4 * G * col_tile - 3;
  // Prologue: the tile's reciprocal norms and loads.
  for (int i = tid; i < W; i += blockDim.x) {
    float l[K];
    inv_s[i] = load_column<K>(L, C, col0 + i, N, nvec, l);
#pragma unroll
    for (int k = 0; k < K; ++k) l_s[k][i] = l[k];
  }
  // The thread's rows t0, t0 + R, ..., t0 + (rpt - 1) R; the demands of
  // the first kUnroll load before the barrier, overlapping the prologue.
  const int slot = tid / G;
  const int g = tid - slot * G;
  const long long t0 = row_tile * R * rpt + slot;
  float rt[kUnroll][K];
  load_rows<K>(rt, r, t0, 0, rpt, R, T);
  __syncthreads();
  if (t0 >= T) return;
  const int s = static_cast<int>((t0 * N) & 3);
  const int jb = 4 * (col_tile * G + g) - s;
  if (jb >= N) return;
  const int sb = 4 * g - s + 3;          // jb's place in the tile
  float lc[4][K];
  float ic[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    ic[c] = inv_s[sb + c];
#pragma unroll
    for (int k = 0; k < K; ++k) lc[c][k] = l_s[k][sb + c];
  }
  const bool full = jb >= 0 && jb + 4 <= N;
  for (int i0 = 0; i0 < rpt; i0 += kUnroll) {
    float rn[kUnroll][K];                // the next rows' demands
    if (i0 + kUnroll < rpt) load_rows<K>(rn, r, t0, i0 + kUnroll, rpt, R, T);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long t = t0 + static_cast<long long>(i0 + u) * R;
      if (i0 + u >= rpt || t >= T) break;
      float o[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float acc = rt[u][0] * lc[c][0];
#pragma unroll
        for (int k = 1; k < K; ++k) acc = fmaf(rt[u][k], lc[c][k], acc);
        o[c] = acc * ic[c];
      }
      float* row = out + t * N;
      if (full) {
        __stcs(reinterpret_cast<float4*>(row + jb),
               make_float4(o[0], o[1], o[2], o[3]));
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (jb + c >= 0 && jb + c < N) row[jb + c] = o[c];
      }
    }
    if (i0 + kUnroll < rpt) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int k = 0; k < K; ++k) rt[u][k] = rn[u][k];
    }
  }
}

}  // namespace

// r [T, K], L [N, K], C [N, K] float32 row-major; out [T, N] float32,
// 16-byte aligned.  K in 1..8.  The plan: G groups of 4 servers a column
// tile (1..32), R rows a block (R * G <= 256, R * N % 4 == 0) and rpt >= 1
// rows a thread; nvec the servers whose sum(C^2) is unfused.  Launches
// one kernel on `stream`; returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a K,
// plan or alignment it does not take.
extern "C" int rl_score_launch(const void* r, const void* L, const void* C,
                               void* out, int T, int N, int K, int G, int R,
                               int rpt, int nvec, void* stream) {
  if (K < 1 || K > 8 || G < 1 || G > kMaxG || R < 1 ||
      R * G > kMaxThreads || (static_cast<long long>(R) * N) % 4 != 0 ||
      rpt < 1 || reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (T <= 0 || N <= 0) return static_cast<int>(cudaGetLastError());
  // The widest row shift s any row has (0 when every row is aligned).
  const int max_s = (N % 4 == 0 || T == 1) ? 0 : (N % 2 == 0 ? 2 : 3);
  const int groups = (N + max_s + 3) / 4;
  const long long rows = static_cast<long long>(R) * rpt;
  const long long row_tiles = (static_cast<long long>(T) + rows - 1) / rows;
  const int col_tiles = (groups + G - 1) / G;
  if (row_tiles * col_tiles > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(row_tiles * col_tiles));
  const dim3 block(R * G);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* rf = static_cast<const float*>(r);
  const float* Lf = static_cast<const float*>(L);
  const float* Cf = static_cast<const float*>(C);
  float* of = static_cast<float*>(out);
  switch (K) {
#define REPRO_K6_CASE(KK)                                                   \
  case KK:                                                                  \
    rl_score_kernel<KK><<<grid, block, 0, s>>>(rf, Lf, Cf, T, N, G, R, rpt, \
                                               nvec, col_tiles, of);        \
    break;
    REPRO_K6_CASE(1)
    REPRO_K6_CASE(2)
    REPRO_K6_CASE(3)
    REPRO_K6_CASE(4)
    REPRO_K6_CASE(5)
    REPRO_K6_CASE(6)
    REPRO_K6_CASE(7)
    REPRO_K6_CASE(8)
#undef REPRO_K6_CASE
  }
  return static_cast<int>(cudaGetLastError());
}
