// Flash attention (online softmax) for Hopper (sm_90a).
//
// Replaces the TPU kernel of the JAX reference,
// src/repro/kernels/flash_attention/kernel.py::flash_attention_pallas
// (body _kernel) together with the GQA loop and padding of its wrapper
// (flash_attention/ops.py):
//   o[b, h, i] = softmax_j(q[b, h, i] . k[b, h / rep, j] * scale
//                          masked) @ v[b, h / rep],
// with query i right-aligned against the keys (absolute position
// i + Lk - Lq), an optional causal mask (j <= pos) and an optional local
// window (j > pos - window).
//
// Design.  The TPU kernel carries the running max m, sum l and the
// accumulator across a sequential k grid axis.  Blocks on Hopper run in no
// order, so one block owns a tile of query rows and walks the key tiles in
// a loop, keeping m, l and its share of the accumulator in registers.  A
// block serves the rows of ONE key/value head: the rep query heads that
// share it (GQA) are flattened with the query positions into rep * Lq
// rows, so K and V tiles are read once for the whole group and never
// repeated in memory.  A decode launch (Lq = 1) therefore puts the rep
// heads of a group into one 16-row block instead of wasting a 64-row
// tile.  The ragged edges (Lq, Lk not multiples of the tiles) are masked
// here, so the wrapper pads nothing.  Key tiles wholly outside the causal
// and window extent of the block's rows are skipped, as
// models/common.py::attention bounds its scan.  Masked logits are -1e30,
// never -inf (inf - inf is NaN), and contribute exactly 0: a row whose
// first tiles are fully masked keeps l = 0 and acc = 0 until a valid tile
// arrives, which is what the reference's exp(0) garbage becomes once its
// correction factor exp(-1e30 - m) zeroes it.  q is float32 or bfloat16
// and k, v either type: the keys and values are read in q's type (widened,
// or rounded, as the reference casts its cache to the activations' type),
// every product and sum is float32, and the output has q's type.  A decode
// against a bfloat16 cache thus reads the cache in place with a float32
// query; its own step's key and value, which the reference holds unrounded
// at the last slot, come in as an optional last row (kl, vl, in q's type)
// that takes the place of key Lk - 1.
//
// Thread layout: 256 threads as 16 row groups x 16 column groups.  A
// thread holds RM query rows (16 * RM rows a block) by 4 keys of the
// 64-key logits tile, and RM rows by D / 16 columns of the accumulator.
// Row maxima and sums are reduced across the 16 lanes of a half warp with
// shuffles.  Q, K, V and the probability tile live in shared memory, K
// and P with one word of row padding so that the column-strided reads hit
// distinct banks.
//
// Bound.  The logits and the PV product cost 4 * Lq * Lk * D flops a head
// (about half under a causal mask) against (2 Lq + 2 Lk) * D values
// moved: at a prefill (Lq = Lk = 1024, D = 64) that is ~500 flops a byte,
// so it is bounded by float32 arithmetic (no tensor cores in this first
// kernel; TF32 would lose the reference's float32 accuracy).  A decode
// launch (Lq = 1) reads the whole cache for 4 * rep flops a key, and is
// bounded by memory; with 16 blocks for a whole layer it is latency-bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 64;          // keys per tile
constexpr float kNeg = -1e30f;   // the reference's masked logit

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const void* kl;  // nullptr, or [B, Hkv, D] in q's type: key Lk - 1
  const void* vl;  // likewise the value of key Lk - 1
  int B, H, Hkv, Lq, Lk;
  long long qsb, qsh, qsl, ksb, ksh, ksl, vsb, vsh, vsl;
  long long klsb, klsh, vlsb, vlsh;
  int causal, window;  // window <= 0: none
  float scale;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
// A key or value of type TKV as the reference reads it: cast to q's type
// TQ, then widened to float32.
template <typename TQ, typename TKV>
__device__ __forceinline__ float as_q(TKV x) {
  return to_f(from_f<TQ>(to_f(x)));
}

template <int D, int RM>
constexpr size_t smem_bytes() {
  return sizeof(float) * (16 * RM * (D + 1) + kBK * (D + 1) + kBK * D +
                          16 * RM * (kBK + 1));
}

template <typename TQ, typename TKV, int D, int RM>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const Args a) {
  constexpr int BQ = 16 * RM;    // query rows a block
  constexpr int DJ = D / 16;     // accumulator columns a thread
  constexpr int QS = D + 1;      // padded row strides
  constexpr int PS = kBK + 1;
  extern __shared__ float smem[];
  float* Qs = smem;                 // [BQ][QS]
  float* Ks = Qs + BQ * QS;         // [kBK][QS]
  float* Vs = Ks + kBK * QS;        // [kBK][D]
  float* Ps = Vs + kBK * D;         // [BQ][PS]

  const int tid = threadIdx.x;
  const int r = tid >> 4;
  const int c = tid & 15;
  const int rep = a.H / a.Hkv;
  const int b = blockIdx.y / a.Hkv;
  const int hk = blockIdx.y % a.Hkv;
  const int rows = rep * a.Lq;                 // (head in group, position)
  const int f0 = blockIdx.x * BQ;
  const int f1 = min(f0 + BQ, rows) - 1;
  const int off = a.Lk - a.Lq;
  const TQ* q = static_cast<const TQ*>(a.q);
  const TKV* k = static_cast<const TKV*>(a.k) + b * a.ksb + hk * a.ksh;
  const TKV* v = static_cast<const TKV*>(a.v) + b * a.vsb + hk * a.vsh;
  const TQ* kl = a.kl == nullptr ? nullptr
      : static_cast<const TQ*>(a.kl) + b * a.klsb + hk * a.klsh;
  const TQ* vl = a.vl == nullptr ? nullptr
      : static_cast<const TQ*>(a.vl) + b * a.vlsb + hk * a.vlsh;

  // The query tile: row f is head hk * rep + f / Lq at position f % Lq.
  for (int idx = tid; idx < BQ * D; idx += kThreads) {
    const int row = idx / D, d = idx % D, f = f0 + row;
    float x = 0.0f;
    if (f < rows) {
      const int h = hk * rep + f / a.Lq, i = f % a.Lq;
      x = to_f(q[b * a.qsb + h * a.qsh + i * a.qsl + d]);
    }
    Qs[row * QS + d] = x;
  }

  int qpos[RM];
  bool live[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int f = f0 + r * RM + i;
    live[i] = f < rows;
    qpos[i] = (live[i] ? f % a.Lq : 0) + off;
  }

  // The keys any row of the block may see.
  int imin = 0, imax = a.Lq - 1;
  if (f0 / a.Lq == f1 / a.Lq) {
    imin = f0 % a.Lq;
    imax = f1 % a.Lq;
  }
  const int hi = a.causal ? min(a.Lk, imax + off + 1) : a.Lk;
  const int lo = a.window > 0 ? max(0, imin + off - a.window + 1) : 0;

  float m[RM], l[RM], acc[RM][DJ];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = kNeg;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.0f;
  }

  for (int kt = (lo / kBK) * kBK; kt < hi; kt += kBK) {
    __syncthreads();   // the previous tile's K, V and P are consumed
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int j = idx / D, d = idx % D, kj = kt + j;
      float kx = 0.0f, vx = 0.0f;
      if (kl != nullptr && kj == a.Lk - 1) {
        kx = to_f(kl[d]);
        vx = to_f(vl[d]);
      } else if (kj < a.Lk) {
        kx = as_q<TQ>(k[kj * a.ksl + d]);
        vx = as_q<TQ>(v[kj * a.vsl + d]);
      }
      Ks[j * QS + d] = kx;
      Vs[j * D + d] = vx;
    }
    __syncthreads();

    float s[RM][4];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[RM], kv[4];
#pragma unroll
      for (int i = 0; i < RM; ++i) qv[i] = Qs[(r * RM + i) * QS + d];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) kv[jj] = Ks[(c + 16 * jj) * QS + d];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) s[i][jj] = fmaf(qv[i], kv[jj], s[i][jj]);
    }

#pragma unroll
    for (int i = 0; i < RM; ++i) {
      bool ok[4];
      float mx = kNeg;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int kj = kt + c + 16 * jj;
        ok[jj] = live[i] && kj < a.Lk && (!a.causal || kj <= qpos[i]) &&
                 (a.window <= 0 || kj > qpos[i] - a.window);
        s[i][jj] = ok[jj] ? s[i][jj] * a.scale : kNeg;
        mx = fmaxf(mx, s[i][jj]);
      }
#pragma unroll
      for (int w = 1; w < 16; w <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float p = ok[jj] ? expf(s[i][jj] - m_new) : 0.0f;
        Ps[(r * RM + i) * PS + c + 16 * jj] = p;
        sum += p;
      }
#pragma unroll
      for (int w = 1; w < 16; w <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, w);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

    const int kn = min(kBK, a.Lk - kt);
#pragma unroll 4
    for (int kk = 0; kk < kn; ++kk) {
      float pv[RM], vv[DJ];
#pragma unroll
      for (int i = 0; i < RM; ++i) pv[i] = Ps[(r * RM + i) * PS + kk];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = Vs[kk * D + c + 16 * j];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  TQ* o = static_cast<TQ*>(a.o);
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    if (!live[i]) continue;
    const int f = f0 + r * RM + i;
    const int h = hk * rep + f / a.Lq, pos = f % a.Lq;
    const float inv_l = 1.0f / fmaxf(l[i], 1e-30f);
    TQ* orow = o + ((static_cast<long long>(b) * a.H + h) * a.Lq + pos) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) orow[c + 16 * j] = from_f<TQ>(acc[i][j] * inv_l);
  }
}

template <typename TQ, typename TKV, int D, int RM>
int launch(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D, RM>();
  auto kern = flash_attention_kernel<TQ, TKV, D, RM>;
  // Above 48 KB a block's dynamic shared memory must be opted into.
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = (a.H / a.Hkv) * a.Lq;
  const dim3 grid((rows + 16 * RM - 1) / (16 * RM), a.B * a.Hkv);
  kern<<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TKV, int D>
int launch_rows(const Args& a, cudaStream_t stream) {
  // A group of at most 16 rows (decode: rep heads at Lq = 1) takes the
  // 16-row block; longer groups the 64-row one.
  if ((a.H / a.Hkv) * a.Lq <= 16) return launch<TQ, TKV, D, 1>(a, stream);
  return launch<TQ, TKV, D, 4>(a, stream);
}

template <typename TQ, typename TKV>
int launch_dtype(const Args& a, int D, cudaStream_t stream) {
  switch (D) {
    case 32: return launch_rows<TQ, TKV, 32>(a, stream);
    case 64: return launch_rows<TQ, TKV, 64>(a, stream);
    case 128: return launch_rows<TQ, TKV, 128>(a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename TQ>
int launch_kv(const Args& a, int D, int kv_bf16, cudaStream_t stream) {
  return kv_bf16 ? launch_dtype<TQ, __nv_bfloat16>(a, D, stream)
                 : launch_dtype<TQ, float>(a, D, stream);
}

}  // namespace

// q [B, H, Lq, D], k/v [B, Hkv, Lk, D] with unit stride along D and the
// given element strides for batch, head and position (a slice of a
// preallocated cache is taken as it lies); o [B, H, Lq, D] contiguous, of
// q's type (float32, or bfloat16 when q_bf16 != 0).  k and v share a type
// (bfloat16 when kv_bf16 != 0) and are read in q's type.  kl, vl: nullptr,
// or rows [B, Hkv, D] of q's type, unit stride along D, that take the
// place of key and value Lk - 1.  D in {32, 64, 128}; H a multiple of Hkv;
// window <= 0 for none.  Launches on `stream` and returns
// cudaGetLastError() (0 on success), or the error of the shared-memory
// opt-in, or cudaErrorInvalidValue for a D it was not built for.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, const void* kl,
    const void* vl, int B, int H, int Hkv, int Lq, int Lk, int D,
    long long qsb, long long qsh, long long qsl, long long ksb,
    long long ksh, long long ksl, long long vsb, long long vsh,
    long long vsl, long long klsb, long long klsh, long long vlsb,
    long long vlsh, int causal, int window, float scale, int q_bf16,
    int kv_bf16, void* stream) {
  if (Hkv <= 0 || H % Hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  if ((kl == nullptr) != (vl == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || Lq <= 0) return static_cast<int>(cudaGetLastError());
  const Args a{q, k, v, o, kl, vl, B, H, Hkv, Lq, Lk, qsb, qsh, qsl, ksb,
               ksh, ksl, vsb, vsh, vsl, klsb, klsh, vlsb, vlsh, causal,
               window, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return q_bf16 ? launch_kv<__nv_bfloat16>(a, D, kv_bf16, s)
                : launch_kv<float>(a, D, kv_bf16, s);
}
