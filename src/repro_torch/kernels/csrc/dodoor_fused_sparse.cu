// Dodoor decision kernels for Hopper (sm_90a).
//
// Replaces the TPU kernels of the JAX reference,
// src/repro/kernels/dodoor_choice/kernel.py:
//   K1 dodoor_fused_sparse_pallas         (unmasked),
//   K2 dodoor_fused_sparse_masked_pallas  (down-window availability),
//   K3 either of them with the locality operands psrv/pbytes,
//      all three with the body _fused_sparse_kernel;
//   K4 dodoor_fused_pallas and dodoor_fused_masked_pallas (body
//      _fused_kernel): the dense form, with a [T, N] duration plane and,
//      masked, a [T, N] availability plane;
//   K5 dodoor_choice_pallas (body _kernel, _pair_scores): score and
//      select for pre-sampled candidate pairs.
// K1-K4 compute, for every task of a decision block, what
// sample_feasible_batch followed by the two-stage Algorithm-1 score
// computes in the reference:
//   prefilter -> inclusive prefix count -> two threefry uniforms
//   -> inverse-CDF ranks (uniform over all N when nothing is admissible)
//   -> candidate rows and the task's durations there -> loadScore
//   -> (K3) + gamma_bw * remote parent MB -> choice.
// The prefilter is the capacity test, and also availability: for K2
// server j is up at the task's time now_t iff no window w of its [N, Wd]
// planes has down0[j,w] <= now_t < down1[j,w] (+inf pads match nothing);
// for K4-masked iff avail[t, j] > 0.  K1-K4 are one template,
// instantiated on the availability predicate, on where a candidate's
// duration comes from (d_types[t, node_type[c]] or d[t, c]) and on the
// locality term.  K2 evaluates availability in the warp's stride, so no
// [T, N] availability plane exists on the card; K4-masked reads its plane
// in that stride, coalesced, and the dense K4 reads only the two
// durations of its candidates, not the task's whole row.
//
// Design.  One warp per task.  The TPU kernel gathers candidate rows with
// a one-hot matmul because the TPU has no usable gather unit; here lane 0
// simply loads the two rows.  The warp walks the capacity column in
// strides of 32 servers and counts feasible ones with __ballot_sync and
// __popc (that gives kk and the two ranks), then walks again until the
// running inclusive count (the in-warp prefix is __popc(ballot &
// lanemask_lt)) reaches each rank.  K5 has no sampling: one thread per
// task loads the pair's rows and scores them.
//
// Bound.  Per task the work is O(N*K) compares plus up to two passes over
// N (K2: 2*Wd more compares a server; K3: a compare and a sum per parent
// and candidate); the bytes are the server arrays (L, D, C, node_type:
// 24 B a server; K2: 8*Wd B of windows), which stay resident in the 50 MB
// L2 across the block's tasks, plus about 60 B of task input and output
// (K3: 8*P B more; K4: 8 B of durations; K4-masked: the 4*N B
// availability row).  At the main path's shapes the kernels are bounded
// by the compare/count work, not by memory traffic; K4-masked at large N
// by its availability plane.  K5 moves about 60 B a task plus two server
// rows and is bounded by its launch.
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
// gamma_bw = 0 that adds +0, so K3 then equals K1/K2 bit for bit.  K5
// follows the reference's Pallas kernel instead, in reciprocal form, as
// its interpret lowering runs on XLA:CPU (see dodoor_choice_ref in
// repro_torch/kernels/dodoor_choice/ref.py): RL_j = (r.L_j) * (1 /
// sum(C_j^2)), the sum in A's fraction fmaf(r.L_b, inv_b, RL_a) (B's
// symmetrically), and the alpha-mix two products and an add.
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

// The availability operands: K2's down-window planes ([N, Wd] row-major)
// and the tasks' times, or K4-masked's [T, N] plane (N its row length).
struct Windows {
  const float* down0;
  const float* down1;
  const float* now;
  int Wd;
  const float* avail;
  int N;
};

// Availability predicates, bound to one task.  K1: every server is up.
struct AllUp {
  __device__ AllUp(const Windows&, long long) {}
  __device__ bool operator()(int) const { return true; }
};

// K4-masked: up iff the task's entry of the plane is > 0.  The warp's
// lanes read 32 neighbouring entries of the row at once.
struct AvailPlane {
  const float* row;
  __device__ AvailPlane(const Windows& w, long long t)
      : row(w.avail + t * w.N) {}
  __device__ bool operator()(int j) const { return row[j] > 0.0f; }
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

// Where a candidate's duration comes from: K1-K3 a [T, TT] table of
// durations per node type and the servers' types, K4 a [T, N] plane.
struct Durations {
  const float* d;
  const int* node_type;
  int width;  // row length of d: TT, or N
};

struct TypeDurations {
  const float* row;
  const int* node_type;
  __device__ TypeDurations(const Durations& d, long long t)
      : row(d.d + t * d.width), node_type(d.node_type) {}
  __device__ float operator()(int c) const { return row[node_type[c]]; }
};

struct DenseDurations {
  const float* row;
  __device__ DenseDurations(const Durations& d, long long t)
      : row(d.d + t * d.width) {}
  __device__ float operator()(int c) const { return row[c]; }
};

template <class Up>
__device__ __forceinline__ bool admissible(const float2* C, const Up& up,
                                           int j, int N, float r0,
                                           float r1) {
  if (j >= N) return false;
  const float2 c = C[j];
  return r0 <= c.x && r1 <= c.y && up(j);
}

template <class Up, class Dur, class Loc>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
dodoor_fused_sparse_kernel(const long long* __restrict__ keys,
                           const float* __restrict__ r,
                           Durations durations,
                           const float* __restrict__ L,
                           const float* __restrict__ D,
                           const float* __restrict__ C,
                           Windows windows, ParentPlanes parents,
                           int T, int N, float alpha,
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
  const Dur dur(durations, t);
  const float d_a = dur(c0);
  const float d_b = dur(c1);
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

template <class Up, class Dur, class Loc>
int launch(const void* keys, const void* r, Durations durations,
           const void* L, const void* D, const void* C, Windows windows,
           ParentPlanes parents, int T, int N, float alpha, void* choice,
           void* cand, void* scores, void* stream) {
  if (T > 0) {
    const int threads = kWarpsPerBlock * 32;
    const int blocks = (T + kWarpsPerBlock - 1) / kWarpsPerBlock;
    dodoor_fused_sparse_kernel<Up, Dur, Loc><<<
        blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const long long*>(keys), static_cast<const float*>(r),
        durations, static_cast<const float*>(L),
        static_cast<const float*>(D), static_cast<const float*>(C), windows,
        parents, T, N, alpha, static_cast<int*>(choice),
        static_cast<int*>(cand), static_cast<float*>(scores));
  }
  return static_cast<int>(cudaGetLastError());
}

// K1-K3 sparse launches: durations by node type.
template <class Up, class Loc>
int launch_sparse(const void* keys, const void* r, const void* d_types,
                  const void* node_type, const void* L, const void* D,
                  const void* C, Windows windows, ParentPlanes parents,
                  int T, int N, int TT, float alpha, void* choice,
                  void* cand, void* scores, void* stream) {
  const Durations dur{static_cast<const float*>(d_types),
                      static_cast<const int*>(node_type), TT};
  return launch<Up, TypeDurations, Loc>(keys, r, dur, L, D, C, windows,
                                        parents, T, N, alpha, choice, cand,
                                        scores, stream);
}

constexpr Windows kNoWindows{nullptr, nullptr, nullptr, 0, nullptr, 0};
constexpr ParentPlanes kNoParents{nullptr, nullptr, 0, 0.0f};

Windows windows_of(const void* down0, const void* down1, const void* now,
                   int Wd) {
  return Windows{static_cast<const float*>(down0),
                 static_cast<const float*>(down1),
                 static_cast<const float*>(now), Wd, nullptr, 0};
}

ParentPlanes parents_of(const void* psrv, const void* pbytes, int P,
                        float gamma_bw) {
  return ParentPlanes{static_cast<const int*>(psrv),
                      static_cast<const float*>(pbytes), P, gamma_bw};
}

// K5: one thread per task scores its pre-sampled pair (cand [T, 2]) with
// the task's durations there (d_cand [T, 2]) in the reference kernel's
// reciprocal form, and picks: B only on a strict >, so ties keep A.
__global__ void __launch_bounds__(256)
dodoor_choice_kernel(const float* __restrict__ r,
                     const int* __restrict__ cand,
                     const float* __restrict__ d_cand,
                     const float* __restrict__ L,
                     const float* __restrict__ D,
                     const float* __restrict__ C, int T, float alpha,
                     float one_m_alpha, int* __restrict__ choice,
                     float* __restrict__ scores) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (t >= T) return;
  const float2 rt = reinterpret_cast<const float2*>(r)[t];
  const int2 c = reinterpret_cast<const int2*>(cand)[t];
  const float2 dc = reinterpret_cast<const float2*>(d_cand)[t];
  const float2* L2 = reinterpret_cast<const float2*>(L);
  const float2* C2 = reinterpret_cast<const float2*>(C);
  const float2 la = L2[c.x], lb = L2[c.y];
  const float2 ca = C2[c.x], cb = C2[c.y];
  const float inv_a = 1.0f / fmaf(ca.y, ca.y, ca.x * ca.x);
  const float inv_b = 1.0f / fmaf(cb.y, cb.y, cb.x * cb.x);
  const float dot_a = fmaf(rt.y, la.y, rt.x * la.x);
  const float dot_b = fmaf(rt.y, lb.y, rt.x * lb.x);
  const float rl_a = dot_a * inv_a;
  const float rl_b = dot_b * inv_b;
  const bool rl_ok = rl_a + rl_b > kEps;
  const float rfa = rl_ok ? rl_a / (fmaf(dot_b, inv_b, rl_a) + kEps) : 0.5f;
  const float rfb = rl_ok ? rl_b / (fmaf(dot_a, inv_a, rl_b) + kEps) : 0.5f;
  const float Da = D[c.x] + dc.x;
  const float Db = D[c.y] + dc.y;
  const float d_sum = Da + Db;
  const float dfa = d_sum > kEps ? Da / (d_sum + kEps) : 0.5f;
  const float dfb = d_sum > kEps ? Db / (d_sum + kEps) : 0.5f;
  const float sa = rfa * one_m_alpha + dfa * alpha;
  const float sb = rfb * one_m_alpha + dfb * alpha;
  reinterpret_cast<float2*>(scores)[t] = make_float2(sa, sb);
  choice[t] = sa > sb ? c.y : c.x;
}

}  // namespace

// K1.  Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int dodoor_fused_sparse_launch(
    const void* keys, const void* r, const void* d_types,
    const void* node_type, const void* L, const void* D, const void* C,
    int T, int N, int TT, float alpha, void* choice, void* cand,
    void* scores, void* stream) {
  return launch_sparse<AllUp, NoParents>(
      keys, r, d_types, node_type, L, D, C, kNoWindows, kNoParents, T, N,
      TT, alpha, choice, cand, scores, stream);
}

// K2: K1 with down0, down1 [N, Wd] and now [T] (float32) in the prefilter.
extern "C" int dodoor_fused_sparse_masked_launch(
    const void* keys, const void* r, const void* d_types,
    const void* node_type, const void* L, const void* D, const void* C,
    const void* down0, const void* down1, const void* now, int T, int N,
    int TT, int Wd, float alpha, void* choice, void* cand, void* scores,
    void* stream) {
  return launch_sparse<WindowsUp, NoParents>(
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
  return launch_sparse<AllUp, Parents>(
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
  return launch_sparse<WindowsUp, Parents>(
      keys, r, d_types, node_type, L, D, C,
      windows_of(down0, down1, now, Wd),
      parents_of(psrv, pbytes, P, gamma_bw), T, N, TT, alpha,
      choice, cand, scores, stream);
}

// K4: keys [T, 2] int64, r [T, 2], d [T, N] per-server durations, L [N, 2],
// D [N], C [N, 2]; the arithmetic of K1.
extern "C" int dodoor_fused_launch(const void* keys, const void* r,
                                   const void* d, const void* L,
                                   const void* D, const void* C, int T, int N,
                                   float alpha, void* choice, void* cand,
                                   void* scores, void* stream) {
  const Durations dur{static_cast<const float*>(d), nullptr, N};
  return launch<AllUp, DenseDurations, NoParents>(
      keys, r, dur, L, D, C, kNoWindows, kNoParents, T, N, alpha, choice,
      cand, scores, stream);
}

// K4-masked: K4 with avail [T, N] float32 in the prefilter (> 0 is up).
extern "C" int dodoor_fused_masked_launch(const void* keys, const void* r,
                                          const void* d, const void* avail,
                                          const void* L, const void* D,
                                          const void* C, int T, int N,
                                          float alpha, void* choice,
                                          void* cand, void* scores,
                                          void* stream) {
  const Durations dur{static_cast<const float*>(d), nullptr, N};
  const Windows plane{nullptr, nullptr, nullptr, 0,
                      static_cast<const float*>(avail), N};
  return launch<AvailPlane, DenseDurations, NoParents>(
      keys, r, dur, L, D, C, plane, kNoParents, T, N, alpha, choice, cand,
      scores, stream);
}

// K5: r [T, 2], cand [T, 2] int32 (each in [0, N)), d_cand [T, 2], L [N, 2],
// D [N], C [N, 2]; alpha and 1 - alpha as the caller rounded them.
extern "C" int dodoor_choice_launch(const void* r, const void* cand,
                                    const void* d_cand, const void* L,
                                    const void* D, const void* C, int T,
                                    float alpha, float one_m_alpha,
                                    void* choice, void* scores,
                                    void* stream) {
  if (T > 0) {
    dodoor_choice_kernel<<<(T + 255) / 256, 256, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(r), static_cast<const int*>(cand),
        static_cast<const float*>(d_cand), static_cast<const float*>(L),
        static_cast<const float*>(D), static_cast<const float*>(C), T, alpha,
        one_m_alpha, static_cast<int*>(choice), static_cast<float*>(scores));
  }
  return static_cast<int>(cudaGetLastError());
}
