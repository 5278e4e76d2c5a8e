// Batched Eq.-1 RL score matrix for Hopper (sm_90a).
//
// Replaces the TPU kernel of the JAX reference,
// src/repro/kernels/rl_score/kernel.py::rl_score_pallas (body _kernel):
//   score[t, j] = (r_t . L_j) * inv_j,   inv_j = 1 / sum_k C[j, k]^2,
// for a block of T tasks against N servers, K resource dimensions.
//
// Design.  The TPU kernel pads T and N to 128x128 tiles and runs the
// K-long contraction on the matrix unit.  K is 2 to 8, so this is a
// scaled outer product, not tensor-core work: every output costs K
// multiply-adds and 4 bytes of store.  A first small kernel computes inv
// once per call (one thread per server); the score kernel gives each
// thread kCols consecutive servers, whose K loads and inv stay in
// registers, and walks kRows tasks, reading each task's K demands (the
// same address across the warp: one broadcast load) and writing its
// kCols scores with one 16-byte store when the row is 16-byte aligned.
//
// Bound.  The function reads (T + 2N) * K + N floats and writes T * N:
// at the main path's shapes (T * N >= 2e5) the T x N store dominates, so
// the kernel is bounded by memory bandwidth on its writes.
//
// Arithmetic.  As the reference's interpret lowering computes it on
// XLA:CPU: the dot is a fused multiply-add chain in k order starting from
// r0 * L0, scaled by inv with one rounding; sum(C^2) is the same chain,
// and inv its IEEE reciprocal.  The build passes -fmad=false so that no
// other product is contracted.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 4;   // servers per thread (one float4 store)
constexpr int kRows = 16;  // tasks per block

__global__ void __launch_bounds__(kThreads)
inv_norm_kernel(const float* __restrict__ C, int N, int K,
                float* __restrict__ inv) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= N) return;
  const float* c = C + static_cast<long long>(j) * K;
  float acc = c[0] * c[0];
  for (int k = 1; k < K; ++k) acc = fmaf(c[k], c[k], acc);
  inv[j] = 1.0f / acc;
}

template <int K>
__global__ void __launch_bounds__(kThreads)
rl_score_kernel(const float* __restrict__ r, const float* __restrict__ L,
                const float* __restrict__ inv, int T, int N,
                float* __restrict__ out) {
  const int j0 = (blockIdx.x * blockDim.x + threadIdx.x) * kCols;
  if (j0 >= N) return;
  const int t0 = blockIdx.y * kRows;
  const int t1 = min(T, t0 + kRows);
  const int ncol = min(kCols, N - j0);
  float l[kCols][K];
  float s[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const int j = c < ncol ? j0 + c : j0;  // past the edge: a dummy copy
    s[c] = inv[j];
#pragma unroll
    for (int k = 0; k < K; ++k) l[c][k] = L[static_cast<long long>(j) * K + k];
  }
  const bool vec = ncol == kCols && (N % 4) == 0;
  for (int t = t0; t < t1; ++t) {
    float rt[K];
#pragma unroll
    for (int k = 0; k < K; ++k) rt[k] = r[static_cast<long long>(t) * K + k];
    float o[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      float acc = rt[0] * l[c][0];
#pragma unroll
      for (int k = 1; k < K; ++k) acc = fmaf(rt[k], l[c][k], acc);
      o[c] = acc * s[c];
    }
    float* row = out + static_cast<long long>(t) * N + j0;
    if (vec) {
      *reinterpret_cast<float4*>(row) = make_float4(o[0], o[1], o[2], o[3]);
    } else {
      for (int c = 0; c < ncol; ++c) row[c] = o[c];
    }
  }
}

template <int K>
void launch_scores(const float* r, const float* L, const float* inv, int T,
                   int N, float* out, cudaStream_t stream) {
  const int per_block = kThreads * kCols;
  const dim3 grid((N + per_block - 1) / per_block, (T + kRows - 1) / kRows);
  rl_score_kernel<K><<<grid, kThreads, 0, stream>>>(r, L, inv, T, N, out);
}

}  // namespace

// r [T, K], L [N, K], C [N, K] float32 row-major; inv [N] float32 scratch;
// out [T, N] float32.  K in 1..8.  Launches the reciprocal norms and the
// scores on `stream`; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a K it was not built for.
extern "C" int rl_score_launch(const void* r, const void* L, const void* C,
                               void* inv, void* out, int T, int N, int K,
                               void* stream) {
  if (K < 1 || K > 8) return static_cast<int>(cudaErrorInvalidValue);
  if (T <= 0 || N <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* rf = static_cast<const float*>(r);
  const float* Lf = static_cast<const float*>(L);
  float* invf = static_cast<float*>(inv);
  float* of = static_cast<float*>(out);
  inv_norm_kernel<<<(N + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      static_cast<const float*>(C), N, K, invf);
  switch (K) {
    case 1: launch_scores<1>(rf, Lf, invf, T, N, of, s); break;
    case 2: launch_scores<2>(rf, Lf, invf, T, N, of, s); break;
    case 3: launch_scores<3>(rf, Lf, invf, T, N, of, s); break;
    case 4: launch_scores<4>(rf, Lf, invf, T, N, of, s); break;
    case 5: launch_scores<5>(rf, Lf, invf, T, N, of, s); break;
    case 6: launch_scores<6>(rf, Lf, invf, T, N, of, s); break;
    case 7: launch_scores<7>(rf, Lf, invf, T, N, of, s); break;
    default: launch_scores<8>(rf, Lf, invf, T, N, of, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}
