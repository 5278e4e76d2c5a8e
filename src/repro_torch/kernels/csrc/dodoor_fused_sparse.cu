// Sparse-gather Dodoor decision kernels for Hopper (sm_90a).
//
// Replaces the TPU kernels of the JAX reference,
// src/repro/kernels/dodoor_choice/kernel.py:
//   K1 dodoor_fused_sparse_pallas         (unmasked),
//   K2 dodoor_fused_sparse_masked_pallas  (down-window availability), and
//   K3 either of them with the locality operands psrv/pbytes,
// all with the body _fused_sparse_kernel.  For every task of a decision
// block they compute what sample_feasible_batch followed by the two-stage
// Algorithm-1 score computes in the reference:
//   prefilter -> inclusive prefix count -> two threefry uniforms
//   -> inverse-CDF ranks (uniform over all N when nothing is admissible)
//   -> candidate rows and d_types[t, node_type[c]] -> loadScore
//   -> (K3) + gamma_bw * remote parent MB -> choice.
// The prefilter is the capacity test, and for K2 also availability: server
// j is up at the task's time now_t iff no window w of its [N, Wd] planes
// has down0[j,w] <= now_t < down1[j,w] (+inf pads match nothing).  All
// kernels are one template, instantiated on the availability predicate
// and on the locality term; K2 evaluates availability in the warp's
// stride, so no [T, N] availability plane exists on the card.
//
// Design.  One warp per task.  The TPU kernel gathers candidate rows with
// a one-hot matmul because the TPU has no usable gather unit; here lane 0
// simply loads the two rows.  The warp walks the capacity column in
// strides of 32 servers and counts feasible ones with __ballot_sync and
// __popc (that gives kk and the two ranks), then walks again until the
// running inclusive count (the in-warp prefix is __popc(ballot &
// lanemask_lt)) reaches each rank.
//
// Bound.  Per task the work is O(N*K) compares plus up to two passes over
// N (K2: 2*Wd more compares a server; K3: a compare and a sum per parent
// and candidate); the bytes are the server arrays (L, D, C, node_type:
// 24 B a server; K2: 8*Wd B of windows), which stay resident in the 50 MB
// L2 across the block's tasks, plus about 60 B of task input and output
// (K3: 8*P B more).  At the main path's shapes the kernels are bounded by
// the compare/count work, not by memory traffic.
//
// Arithmetic.  The score follows the reference as XLA:CPU executes it:
// r.L and sum(C^2) are fused multiply-add chains, RL_a/(RL_a+RL_b+eps) is
// evaluated as (r.L_a) / (sum(C_a^2) * (RL_a+RL_b+eps)), the alpha-mix is
// one fused multiply-add (on the duration term when the RL term falls back
// to 0.5), and divisions are IEEE.  The build passes
// -fmad=false so that no other product is contracted, and fmaf marks the
// places where the reference contracts.  K3's penalty is one more such
// place: s = fmaf(gamma_bw, rem, s), with rem summed over the P parents in
// the reference's row order (repro_torch/_arith.py row_sum).  With
// gamma_bw = 0 that adds +0, so K3 then equals K1/K2 bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kEps = 1e-9f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ uint32_t rotl32(uint32_t v, int r) {
  return (v << r) | (v >> (32 - r));
}

// 20-round threefry2x32 (Salmon et al.), as jax.random computes it.
__device__ __forceinline__ uint32_t threefry_bits(uint32_t k0, uint32_t k1,
                                                  uint32_t x0, uint32_t x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  uint32_t a = x0 + ks[0];
  uint32_t b = x1 + ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      a += b;
      b = rotl32(b, rot[i & 1][j]) ^ a;
    }
    a += ks[(i + 1) % 3];
    b += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
  // jax_threefry_partitionable: a 32-bit draw is the xor of both words.
  return a ^ b;
}

// uint32 -> float32 in [0, 1) by mantissa fill, as jax.random.uniform.
__device__ __forceinline__ float unit_float(uint32_t bits) {
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

// The down-window planes of K2 ([N, Wd] row-major) and the tasks' times.
struct Windows {
  const float* down0;
  const float* down1;
  const float* now;
  int Wd;
};

// Availability predicates, bound to one task.  K1: every server is up.
struct AllUp {
  __device__ AllUp(const Windows&, long long) {}
  __device__ bool operator()(int) const { return true; }
};

// K2: up iff no down window covers the task's time (IEEE compares, so the
// +inf pads and a leave's +inf end behave as in the reference).
struct WindowsUp {
  const float* d0;
  const float* d1;
  float now;
  int Wd;
  __device__ WindowsUp(const Windows& w, long long t)
      : d0(w.down0), d1(w.down1), now(w.now[t]), Wd(w.Wd) {}
  __device__ bool operator()(int j) const {
    const float* a = d0 + static_cast<long long>(j) * Wd;
    const float* b = d1 + static_cast<long long>(j) * Wd;
    bool down = false;
    for (int w = 0; w < Wd; ++w) down |= (a[w] <= now) && (now < b[w]);
    return !down;
  }
};

// The parent planes of K3 ([T, P] row-major: server ids with -1 pads and
// output MB with 0 pads) and the penalty per remote MB.
struct ParentPlanes {
  const int* psrv;
  const float* pbytes;
  int P;
  float gamma_bw;
};

// Locality terms, bound to one task.  K1 and K2: none.
struct NoParents {
  __device__ NoParents(const ParentPlanes&, long long) {}
  __device__ float operator()(int, float s) const { return s; }
};

// Levels of XLA:CPU's tree reduction: a row of more than 32 values becomes
// the totals of 32-wide windows over the row padded evenly on both sides
// (lo zeros in front), until at most 32 values are left.  32^6 > 2^30.
constexpr int kMaxLevels = 6;

// K3: the candidate's score plus gamma_bw times the MB of parent output
// held on other servers (a -1 pad never equals a candidate, and adds 0).
// The P terms are summed in the reference's order (repro_torch/_arith.py
// row_sum): each level-0 window left to right, and the window totals fed
// in order through the upper levels (an upper window is closed at its
// last element), the last level left to right.  Up to 32 parents are one
// window; up to 1024 need no upper level.
struct Parents {
  const int* ps;
  const float* pb;
  int P;
  float g;
  int levels;             // windowed levels (rows longer than 32)
  int width[kMaxLevels];  // row length at each windowed level
  int lo[kMaxLevels];     // front padding at each windowed level
  __device__ Parents(const ParentPlanes& p, long long t)
      : ps(p.psrv + t * p.P), pb(p.pbytes + t * p.P), P(p.P),
        g(p.gamma_bw), levels(0) {
    for (int w = P; w > 32 && levels < kMaxLevels; w = (w + 31) / 32) {
      width[levels] = w;
      lo[levels] = (((w + 31) / 32) * 32 - w) / 2;
      ++levels;
    }
  }
  __device__ float term(int i, int c) const {
    return pb[i] * static_cast<float>(ps[i] != c);
  }
  __device__ float operator()(int c, float s) const {
    const int span = levels ? 32 : P;
    const int lo0 = levels ? lo[0] : 0;
    float acc[kMaxLevels];
    float total = 0.0f;
    for (int a = 0, k = 0; a < P; ++k) {
      const int b = min(P, (k + 1) * span - lo0);
      float v = term(a, c);
      for (int i = a + 1; i < b; ++i) v = v + term(i, c);
      a = b;
      int idx = k;  // v is element k of level 1
      int l = 1;
      for (; l < levels; ++l) {
        const int pos = idx + lo[l];
        acc[l] = (idx == 0 || pos % 32 == 0) ? v : acc[l] + v;
        if (idx != width[l] - 1 && (pos + 1) % 32 != 0) break;
        v = acc[l];
        idx = pos / 32;
      }
      if (l >= levels) total = idx == 0 ? v : total + v;
    }
    return fmaf(g, total, s);
  }
};

template <class Up>
__device__ __forceinline__ bool admissible(const float2* C, const Up& up,
                                           int j, int N, float r0,
                                           float r1) {
  if (j >= N) return false;
  const float2 c = C[j];
  return r0 <= c.x && r1 <= c.y && up(j);
}

template <class Up, class Loc>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
dodoor_fused_sparse_kernel(const long long* __restrict__ keys,
                           const float* __restrict__ r,
                           const float* __restrict__ d_types,
                           const int* __restrict__ node_type,
                           const float* __restrict__ L,
                           const float* __restrict__ D,
                           const float* __restrict__ C,
                           Windows windows, ParentPlanes parents,
                           int T, int N, int TT, float alpha,
                           int* __restrict__ choice,
                           int* __restrict__ cand,
                           float* __restrict__ scores) {
  const int lane = threadIdx.x & 31;
  const long long t =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  if (t >= T) return;  // the whole warp leaves together
  const float2* C2 = reinterpret_cast<const float2*>(C);
  const float r0 = r[2 * t];
  const float r1 = r[2 * t + 1];
  const Up up(windows, t);

  // Pass 1: number of admissible servers.
  int count = 0;
  for (int base = 0; base < N; base += 32) {
    const bool ok = admissible(C2, up, base + lane, N, r0, r1);
    count += __popc(__ballot_sync(kFull, ok));
  }
  const bool any_ok = count > 0;
  const int kk = any_ok ? count : N;

  // Two uniforms: counters (0, 0) and (0, 1) of the task's key.
  const uint32_t k0 = static_cast<uint32_t>(keys[2 * t]);
  const uint32_t k1 = static_cast<uint32_t>(keys[2 * t + 1]);
  const float u0 = unit_float(threefry_bits(k0, k1, 0u, 0u));
  const float u1 = unit_float(threefry_bits(k0, k1, 0u, 1u));
  const float kkf = static_cast<float>(kk);
  const int tgt0 = min(static_cast<int>(u0 * kkf), kk - 1) + 1;
  const int tgt1 = min(static_cast<int>(u1 * kkf), kk - 1) + 1;

  // Pass 2: the server where the inclusive admissible count reaches each
  // rank.  With nothing admissible the count is the position itself.
  int c0 = tgt0 - 1;
  int c1 = tgt1 - 1;
  if (any_ok) {
    c0 = -1;
    c1 = -1;
    const unsigned lanemask_lt = (1u << lane) - 1u;
    int seen = 0;
    for (int base = 0; base < N && (c0 < 0 || c1 < 0); base += 32) {
      const bool ok = admissible(C2, up, base + lane, N, r0, r1);
      const unsigned m = __ballot_sync(kFull, ok);
      const int incl = seen + __popc(m & lanemask_lt) + 1;
      const unsigned h0 = __ballot_sync(kFull, ok && incl == tgt0);
      const unsigned h1 = __ballot_sync(kFull, ok && incl == tgt1);
      if (h0) c0 = base + __ffs(h0) - 1;
      if (h1) c1 = base + __ffs(h1) - 1;
      seen += __popc(m);
    }
  }
  if (lane != 0) return;

  // Candidate rows and Algorithm 1's LOADSCORE.
  const float d_a = d_types[t * TT + node_type[c0]];
  const float d_b = d_types[t * TT + node_type[c1]];
  const float num_a = fmaf(r1, L[2 * c0 + 1], r0 * L[2 * c0]);
  const float num_b = fmaf(r1, L[2 * c1 + 1], r0 * L[2 * c1]);
  const float2 ca = C2[c0];
  const float2 cb = C2[c1];
  const float den_a = fmaf(ca.y, ca.y, ca.x * ca.x);
  const float den_b = fmaf(cb.y, cb.y, cb.x * cb.x);
  const float rl_sum = num_a / den_a + num_b / den_b;
  const float Da = D[c0] + d_a;
  const float Db = D[c1] + d_b;
  const float d_sum = Da + Db;
  const float dfa = d_sum > kEps ? Da / (d_sum + kEps) : 0.5f;
  const float dfb = d_sum > kEps ? Db / (d_sum + kEps) : 0.5f;
  const float one_m_alpha = 1.0f - alpha;
  float sa, sb;
  if (rl_sum > kEps) {
    const float rfa = num_a / (den_a * (rl_sum + kEps));
    const float rfb = num_b / (den_b * (rl_sum + kEps));
    sa = fmaf(rfa, one_m_alpha, dfa * alpha);
    sb = fmaf(rfb, one_m_alpha, dfb * alpha);
  } else {  // RL term falls back to 0.5: the reference folds 0.5*(1-alpha)
    const float half_rest = 0.5f * one_m_alpha;
    sa = fmaf(dfa, alpha, half_rest);
    sb = fmaf(dfb, alpha, half_rest);
  }
  const Loc loc(parents, t);
  sa = loc(c0, sa);
  sb = loc(c1, sb);
  cand[2 * t] = c0;
  cand[2 * t + 1] = c1;
  scores[2 * t] = sa;
  scores[2 * t + 1] = sb;
  choice[t] = sa > sb ? c1 : c0;  // Algorithm 1, line 11: ties keep A
}

template <class Up, class Loc>
int launch(const void* keys, const void* r, const void* d_types,
           const void* node_type, const void* L, const void* D,
           const void* C, Windows windows, ParentPlanes parents, int T,
           int N, int TT, float alpha, void* choice, void* cand,
           void* scores, void* stream) {
  if (T > 0) {
    const int threads = kWarpsPerBlock * 32;
    const int blocks = (T + kWarpsPerBlock - 1) / kWarpsPerBlock;
    dodoor_fused_sparse_kernel<Up, Loc><<<
        blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const long long*>(keys), static_cast<const float*>(r),
        static_cast<const float*>(d_types),
        static_cast<const int*>(node_type), static_cast<const float*>(L),
        static_cast<const float*>(D), static_cast<const float*>(C), windows,
        parents, T, N, TT, alpha, static_cast<int*>(choice),
        static_cast<int*>(cand), static_cast<float*>(scores));
  }
  return static_cast<int>(cudaGetLastError());
}

constexpr Windows kNoWindows{nullptr, nullptr, nullptr, 0};
constexpr ParentPlanes kNoParents{nullptr, nullptr, 0, 0.0f};

Windows windows_of(const void* down0, const void* down1, const void* now,
                   int Wd) {
  return Windows{static_cast<const float*>(down0),
                 static_cast<const float*>(down1),
                 static_cast<const float*>(now), Wd};
}

ParentPlanes parents_of(const void* psrv, const void* pbytes, int P,
                        float gamma_bw) {
  return ParentPlanes{static_cast<const int*>(psrv),
                      static_cast<const float*>(pbytes), P, gamma_bw};
}

}  // namespace

// K1.  Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int dodoor_fused_sparse_launch(
    const void* keys, const void* r, const void* d_types,
    const void* node_type, const void* L, const void* D, const void* C,
    int T, int N, int TT, float alpha, void* choice, void* cand,
    void* scores, void* stream) {
  return launch<AllUp, NoParents>(keys, r, d_types, node_type, L, D, C,
                                  kNoWindows, kNoParents, T, N, TT, alpha,
                                  choice, cand, scores, stream);
}

// K2: K1 with down0, down1 [N, Wd] and now [T] (float32) in the prefilter.
extern "C" int dodoor_fused_sparse_masked_launch(
    const void* keys, const void* r, const void* d_types,
    const void* node_type, const void* L, const void* D, const void* C,
    const void* down0, const void* down1, const void* now, int T, int N,
    int TT, int Wd, float alpha, void* choice, void* cand, void* scores,
    void* stream) {
  return launch<WindowsUp, NoParents>(
      keys, r, d_types, node_type, L, D, C,
      windows_of(down0, down1, now, Wd), kNoParents, T, N, TT, alpha,
      choice, cand, scores, stream);
}

// K3 on K1: psrv [T, P] int32 and pbytes [T, P] float32, gamma_bw the
// penalty per remote MB.
extern "C" int dodoor_fused_sparse_locality_launch(
    const void* keys, const void* r, const void* d_types,
    const void* node_type, const void* L, const void* D, const void* C,
    const void* psrv, const void* pbytes, int T, int N, int TT, int P,
    float alpha, float gamma_bw, void* choice, void* cand, void* scores,
    void* stream) {
  return launch<AllUp, Parents>(
      keys, r, d_types, node_type, L, D, C, kNoWindows,
      parents_of(psrv, pbytes, P, gamma_bw), T, N, TT, alpha,
      choice, cand, scores, stream);
}

// K3 on K2: the down windows and the parent planes together.
extern "C" int dodoor_fused_sparse_masked_locality_launch(
    const void* keys, const void* r, const void* d_types,
    const void* node_type, const void* L, const void* D, const void* C,
    const void* down0, const void* down1, const void* now, const void* psrv,
    const void* pbytes, int T, int N, int TT, int Wd, int P, float alpha,
    float gamma_bw, void* choice, void* cand, void* scores, void* stream) {
  return launch<WindowsUp, Parents>(
      keys, r, d_types, node_type, L, D, C,
      windows_of(down0, down1, now, Wd),
      parents_of(psrv, pbytes, P, gamma_bw), T, N, TT, alpha,
      choice, cand, scores, stream);
}
