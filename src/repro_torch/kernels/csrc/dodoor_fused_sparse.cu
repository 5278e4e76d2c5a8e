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
// server j is up at the task's time now_t iff no window w of its planes
// has down0[w, j] <= now_t < down1[w, j] (+inf pads match nothing); for
// K4-masked iff avail[t, j] > 0.  K1-K4 are one template, instantiated on
// the availability predicate, on where a candidate's duration comes from
// (d_types[t, node_type[c]] or d[t, c]) and on the locality term.  K2
// evaluates availability as it walks, so no [T, N] availability plane
// exists on the card; K4-masked reads its plane row in the same walk, and
// the dense K4 reads only the two durations of its candidates.
//
// Design.  The TPU kernel gathers candidate rows with a one-hot matmul
// because the TPU has no usable gather unit; here the rank search is a
// two-pass count over N, and one thread loads the two rows.  A task gets
// Wt warps (1, 2, 4 or 8, sized by N on the host; a 256-thread CTA holds
// 8 / Wt tasks, so the 100-server testbed packs 8 tasks a CTA and 10^4
// servers give each task a CTA of its own).  The servers are cut into
// segments of g ballots of 32 servers (g = 1 up to 4096 segments a task's
// share of the shared table, larger g beyond).
//   Pass 1: each warp takes kUnroll segments at a time (8 for K1 and
//   K4-masked, 4 for K2, whose servers carry 2*Wd window loads) and
//   issues every load of their servers (C, and K2's window values or
//   K4-masked's plane entry) before any compare; __ballot_sync/__popc give
//   each segment's admissible count, which lane 0 writes to the table in
//   shared memory.
//   Scan: one exclusive scan of the table over the task's threads gives
//   kk and each thread's offset; the thread whose slice of the table
//   holds a rank finds the rank's segment and its rank inside it.
//   Pass 2: the task's first warp re-evaluates only those two segments,
//   both at once, and picks the server where the in-segment inclusive
//   count (__popc(ballot & lanemask_lt)) reaches each rank.  No second
//   walk over N.
// Lane 0 of that warp, the task's thread 0, then scores.  A task of one
// warp (N <= 256 for K1, 128 for K2) covers its row in one step: its
// ballot masks stay in registers and give both ranks directly, with no
// table, scan or barrier.  K5 has no sampling: one thread per
// task loads its pair's rows (all six gathers issued together) and
// scores them; ops.plan_k5 sizes the blocks, so that small T runs as one
// lean block and T = 2048 spreads over 32 blocks.  Staging the server
// table in shared memory with cp.async (one trip to memory fewer, a wait
// and a barrier more) measured 0.1 to 0.3 us slower on the testbed's
// 100 servers (tools/ablate_library_kernels.py on an H100, PERF.md
// section 6) and is not kept: the kernel sits within 1 us of
// the 4.7 us launch floor of that harness.
//
// Bound.  Per task the work is O(N*K) compares and a count per server (K2:
// 2*Wd more compares; K3: a compare and a sum per parent and candidate);
// the bytes are the server arrays (L, D, C, node_type: 24 B a server; K2:
// 8*Wd B of windows), which stay resident in the 50 MB L2 across the
// block's tasks, plus about 60 B of task input and output (K3: 8*P B
// more; K4: 8 B of durations; K4-masked: the 4*N B availability row).
// Read once per task from L2, C alone is 8*N*T B (40 MB at T = 500, N =
// 10^4) and K2's windows 40*N*T B at Wd = 5: the kernels are bounded by
// L2 traffic and latency, which the loads in flight and the CTA per task
// address; the roofline bound counts each input once from memory.  K5
// moves about 36 B a task plus two server rows: at the main path's
// shapes its bound is under 0.03 us, and it is bounded by its launch and
// its two dependent trips to memory (cand, then the rows).
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
// symmetrically), and the alpha-mix two products and an add.  Counts and
// ranks are integers, so the rank search changes no output bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kEps = 1e-9f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;           // one CTA: 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTable = 4096;            // segment counts a CTA holds
constexpr int kMaxWd = 8;               // K2's windows unrolled up to this

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

// The availability operands: K2's window-major down-window planes
// ([Wd, N], contiguous, so the 32 lanes of a warp read one line per
// window) and the tasks' times, or K4-masked's [T, N] plane.
struct Windows {
  const float* down0;
  const float* down1;
  const float* now;
  int Wd;
  const float* avail;
  int N;
};

// Availability predicates, bound to one task.  load() issues the loads
// for U servers (indices already in [0, N)) and up() compares, so that
// every load of a walk step is in flight before the first compare.
// K1: every server is up.
struct AllUp {
  static constexpr int kUnroll = 8;     // segments a warp evaluates at once
  template <int U> struct Loaded {};
  __device__ AllUp(const Windows&, long long) {}
  template <int U>
  __device__ void load(const int (&)[U], Loaded<U>&) const {}
  template <int U>
  __device__ bool up(const Loaded<U>&, int) const { return true; }
};

// K4-masked: up iff the task's entry of the plane is > 0.
struct AvailPlane {
  static constexpr int kUnroll = 8;
  template <int U> struct Loaded { float v[U]; };
  const float* row;
  __device__ AvailPlane(const Windows& w, long long t)
      : row(w.avail + t * w.N) {}
  template <int U>
  __device__ void load(const int (&j)[U], Loaded<U>& l) const {
#pragma unroll
    for (int u = 0; u < U; ++u) l.v[u] = row[j[u]];
  }
  template <int U>
  __device__ bool up(const Loaded<U>& l, int u) const {
    return l.v[u] > 0.0f;
  }
};

// K2 with exactly WD windows (1 <= WD <= kMaxWd): up iff no down window
// covers the task's time.  The compares are the reference's IEEE ones,
// so the +inf pads and a leave's +inf end behave as there; both are
// evaluated (no short circuit), after all 2*WD loads.
template <int WD>
struct WindowsUp {
  static constexpr int kUnroll = 4;     // 2*WD loads a server in flight
  template <int U> struct Loaded { float a[U][WD], b[U][WD]; };
  const float* d0;
  const float* d1;
  float now;
  long long N;
  __device__ WindowsUp(const Windows& w, long long t)
      : d0(w.down0), d1(w.down1), now(w.now[t]), N(w.N) {}
  template <int U>
  __device__ void load(const int (&j)[U], Loaded<U>& l) const {
#pragma unroll
    for (int w = 0; w < WD; ++w) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        l.a[u][w] = d0[w * N + j[u]];
        l.b[u][w] = d1[w * N + j[u]];
      }
    }
  }
  template <int U>
  __device__ bool up(const Loaded<U>& l, int u) const {
    bool down = false;
#pragma unroll
    for (int w = 0; w < WD; ++w)
      down |= (l.a[u][w] <= now) & (now < l.b[u][w]);
    return !down;
  }
};

// K2 above kMaxWd windows: a loop over the windows, each step's loads for
// the U servers in flight together.
template <>
struct WindowsUp<0> {
  static constexpr int kUnroll = 4;
  template <int U> struct Loaded { bool down[U]; };
  const float* d0;
  const float* d1;
  float now;
  long long N;
  int Wd;
  __device__ WindowsUp(const Windows& w, long long t)
      : d0(w.down0), d1(w.down1), now(w.now[t]), N(w.N), Wd(w.Wd) {}
  template <int U>
  __device__ void load(const int (&j)[U], Loaded<U>& l) const {
#pragma unroll
    for (int u = 0; u < U; ++u) l.down[u] = false;
    for (int w = 0; w < Wd; ++w) {
      float a[U], b[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        a[u] = d0[w * N + j[u]];
        b[u] = d1[w * N + j[u]];
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
        l.down[u] |= (a[u] <= now) & (now < b[u]);
    }
  }
  template <int U>
  __device__ bool up(const Loaded<U>& l, int u) const { return !l.down[u]; }
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

// Whether servers srv[0..U) (srv >= N: past the end) are admissible:
// every load first (indices clamped into [0, N)), then the compares.
template <int U, class Up>
__device__ __forceinline__ void admissible(const float2* C2, const Up& up,
                                           const long long (&srv)[U], int N,
                                           float r0, float r1,
                                           bool (&ok)[U]) {
  int j[U];
#pragma unroll
  for (int u = 0; u < U; ++u)
    j[u] = static_cast<int>(srv[u] < N ? srv[u] : N - 1);
  float2 c[U];
#pragma unroll
  for (int u = 0; u < U; ++u) c[u] = C2[j[u]];
  typename Up::template Loaded<U> l;
  up.load(j, l);
#pragma unroll
  for (int u = 0; u < U; ++u)
    ok[u] = (srv[u] < N) & (r0 <= c[u].x) & (r1 <= c[u].y) & up.up(l, u);
}

// The task's two inverse-CDF ranks (1-based) over kk servers, from the
// uniforms at counters (0, 0) and (0, 1) of its key.
__device__ __forceinline__ void draw_ranks(const long long* keys,
                                           long long t, int kk,
                                           int (&tgt)[2]) {
  const uint32_t k0 = static_cast<uint32_t>(keys[2 * t]);
  const uint32_t k1 = static_cast<uint32_t>(keys[2 * t + 1]);
  const float kkf = static_cast<float>(kk);
  const float u0 = unit_float(threefry_bits(k0, k1, 0u, 0u));
  const float u1 = unit_float(threefry_bits(k0, k1, 0u, 1u));
  tgt[0] = min(static_cast<int>(u0 * kkf), kk - 1) + 1;
  tgt[1] = min(static_cast<int>(u1 * kkf), kk - 1) + 1;
}

// Warp-collective: the lane of the k-th (1-based) set bit of the ballot
// mask m, where the in-warp inclusive count (__popc(m & lanemask_lt) + 1)
// reaches k.
__device__ __forceinline__ int kth_lane(unsigned m, int k, int lane) {
  const bool hit =
      ((m >> lane) & 1u) && __popc(m & ((1u << lane) - 1u)) + 1 == k;
  return __ffs(__ballot_sync(kFull, hit)) - 1;
}

// Candidate rows and Algorithm 1's LOADSCORE for task t, and the pick.
template <class Dur, class Loc>
__device__ __forceinline__ void score_and_pick(
    long long t, int c0, int c1, float r0, float r1,
    const Durations& durations, const float* L, const float* D,
    const float2* C2, const ParentPlanes& parents, float alpha, int* choice,
    int* cand, float* scores) {
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
__global__ void __launch_bounds__(kThreads)
dodoor_fused_sparse_kernel(const long long* __restrict__ keys,
                           const float* __restrict__ r,
                           Durations durations,
                           const float* __restrict__ L,
                           const float* __restrict__ D,
                           const float* __restrict__ C,
                           Windows windows, ParentPlanes parents,
                           int T, int N, int Wt, float alpha,
                           int* __restrict__ choice,
                           int* __restrict__ cand,
                           float* __restrict__ scores) {
  constexpr int kUnroll = Up::kUnroll;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int G = kWarps / Wt;             // tasks in this CTA
  const int grp = warp / Wt;             // this thread's task in the CTA
  const int w = warp - grp * Wt;         // warp within the task
  const long long t = static_cast<long long>(blockIdx.x) * G + grp;
  const bool active = t < T;             // an idle task still meets barriers
  const long long tt = active ? t : 0;
  const float2* C2 = reinterpret_cast<const float2*>(C);
  const float r0 = r[2 * tt];
  const float r1 = r[2 * tt + 1];
  const Up up(windows, tt);
  int found[2];                          // the candidates

  if (Wt == 1) {
    // The row fits one step of one warp (N <= 32 * kUnroll): its ballot
    // masks stay in registers and give both ranks; no table, no barrier.
    if (!active) return;
    long long srv[kUnroll];
    bool ok[kUnroll];
    unsigned msk[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) srv[u] = u * 32 + lane;
    admissible(C2, up, srv, N, r0, r1, ok);
    int count = 0;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      msk[u] = __ballot_sync(kFull, ok[u]);
      count += __popc(msk[u]);
    }
    int tgt[2];
    draw_ranks(keys, t, count > 0 ? count : N, tgt);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      found[q] = tgt[q] - 1;             // nothing admissible: the position
      if (count > 0) {
        int acc = 0;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int c = __popc(msk[u]);
          if (acc < tgt[q] && tgt[q] <= acc + c)
            found[q] = u * 32 + kth_lane(msk[u], tgt[q] - acc, lane);
          acc += c;
        }
      }
    }
  } else {
    __shared__ int table[kTable];
    __shared__ int warp_sum[kWarps];
    __shared__ int found_seg[kWarps][2];
    __shared__ int found_rank[kWarps][2];
    const int gt = threadIdx.x - grp * Wt * 32;
    const int cap = kTable / G;
    int* tab = table + grp * cap;
    const int nball = (N + 31) / 32;
    const int g = (nball + cap - 1) / cap;  // ballots per segment
    const int nseg = (nball + g - 1) / g;

    // Pass 1: each segment's admissible count.
    if (active) {
      for (int s0 = w * kUnroll; s0 < nseg; s0 += Wt * kUnroll) {
        int cnt[kUnroll] = {};
        for (int i = 0; i < g; ++i) {
          long long srv[kUnroll];
          bool ok[kUnroll];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u)
            srv[u] = (static_cast<long long>(s0 + u) * g + i) * 32 + lane;
          admissible(C2, up, srv, N, r0, r1, ok);
#pragma unroll
          for (int u = 0; u < kUnroll; ++u)
            cnt[u] += __popc(__ballot_sync(kFull, ok[u]));
        }
        if (lane == 0) {
#pragma unroll
          for (int u = 0; u < kUnroll; ++u)
            if (s0 + u < nseg) tab[s0 + u] = cnt[u];
        }
      }
    }
    __syncthreads();

    // Exclusive scan of the table: each of the task's threads sums a
    // slice, a warp scan and the warps' totals give its offset.
    const int per = (nseg + Wt * 32 - 1) / (Wt * 32);
    const int e0 = min(gt * per, nseg);
    const int e1 = min(e0 + per, nseg);
    int local = 0;
    if (active)
      for (int e = e0; e < e1; ++e) local += tab[e];
    int incl = local;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += v;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    int count = 0;
    int before = 0;
    for (int k = 0; k < Wt; ++k) {
      const int v = warp_sum[grp * Wt + k];
      if (k < w) before += v;
      count += v;
    }
    const int excl = before + incl - local;
    int tgt[2];
    draw_ranks(keys, tt, count > 0 ? count : N, tgt);

    // The segment that holds each rank, and the rank inside it.
    if (active && count > 0) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (excl < tgt[q] && tgt[q] <= excl + local) {
          int acc = excl;
          for (int e = e0; e < e1; ++e) {
            if (acc + tab[e] >= tgt[q]) {
              found_seg[grp][q] = e;
              found_rank[grp][q] = tgt[q] - acc;
              break;
            }
            acc += tab[e];
          }
        }
      }
    }
    __syncthreads();

    // Pass 2: the task's first warp walks only the two ranks' segments,
    // both at once, to the server where the inclusive admissible count
    // reaches each rank.  Its lane 0 is the task's thread 0.
    if (!active || w != 0) return;
    found[0] = tgt[0] - 1;               // nothing admissible: the position
    found[1] = tgt[1] - 1;
    if (count > 0) {
      const int seg[2] = {found_seg[grp][0], found_seg[grp][1]};
      const int rank[2] = {found_rank[grp][0], found_rank[grp][1]};
      int seen[2] = {0, 0};
      found[0] = found[1] = -1;
      for (int i = 0; i < g && (found[0] < 0 || found[1] < 0); ++i) {
        long long srv[2];
        bool ok[2];
#pragma unroll
        for (int q = 0; q < 2; ++q)
          srv[q] = (static_cast<long long>(seg[q]) * g + i) * 32 + lane;
        admissible(C2, up, srv, N, r0, r1, ok);
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const unsigned m = __ballot_sync(kFull, ok[q]);
          const int c = __popc(m);
          if (found[q] < 0 && seen[q] < rank[q] && rank[q] <= seen[q] + c)
            found[q] = static_cast<int>(srv[q] - lane) +
                       kth_lane(m, rank[q] - seen[q], lane);
          seen[q] += c;
        }
      }
    }
  }
  if (lane != 0) return;
  score_and_pick<Dur, Loc>(t, found[0], found[1], r0, r1, durations, L, D,
                           C2, parents, alpha, choice, cand, scores);
}

// Warps a task gets: enough for one step of `unroll` ballots each to
// cover N, as a power of two up to a whole CTA.
int warps_per_task(int N, int unroll) {
  const int need = ((N + 31) / 32 + unroll - 1) / unroll;
  int wt = 1;
  while (wt < need && wt < kWarps) wt <<= 1;
  return wt;
}

template <class Up, class Dur, class Loc>
int launch(const void* keys, const void* r, Durations durations,
           const void* L, const void* D, const void* C, Windows windows,
           ParentPlanes parents, int T, int N, float alpha, void* choice,
           void* cand, void* scores, void* stream) {
  if (T > 0) {
    const int wt = warps_per_task(N, Up::kUnroll);
    const int tasks = kWarps / wt;
    const int blocks = (T + tasks - 1) / tasks;
    dodoor_fused_sparse_kernel<Up, Dur, Loc><<<
        blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const long long*>(keys), static_cast<const float*>(r),
        durations, static_cast<const float*>(L),
        static_cast<const float*>(D), static_cast<const float*>(C), windows,
        parents, T, N, wt, alpha, static_cast<int*>(choice),
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
                   int Wd, int N) {
  return Windows{static_cast<const float*>(down0),
                 static_cast<const float*>(down1),
                 static_cast<const float*>(now), Wd, nullptr, N};
}

// K2's launches, instantiated on the window count up to kMaxWd.
template <class Loc>
int launch_masked(const void* keys, const void* r, const void* d_types,
                  const void* node_type, const void* L, const void* D,
                  const void* C, Windows windows, ParentPlanes parents,
                  int T, int N, int TT, float alpha, void* choice,
                  void* cand, void* scores, void* stream) {
#define REPRO_K2_CASE(WD)                                                   \
  case WD:                                                                  \
    return launch_sparse<WindowsUp<WD>, Loc>(                               \
        keys, r, d_types, node_type, L, D, C, windows, parents, T, N, TT,  \
        alpha, choice, cand, scores, stream);
  static_assert(kMaxWd == 8, "one case per unrolled window count");
  switch (windows.Wd) {
    REPRO_K2_CASE(1)
    REPRO_K2_CASE(2)
    REPRO_K2_CASE(3)
    REPRO_K2_CASE(4)
    REPRO_K2_CASE(5)
    REPRO_K2_CASE(6)
    REPRO_K2_CASE(7)
    REPRO_K2_CASE(8)
    default:
      return launch_sparse<WindowsUp<0>, Loc>(
          keys, r, d_types, node_type, L, D, C, windows, parents, T, N, TT,
          alpha, choice, cand, scores, stream);
  }
#undef REPRO_K2_CASE
}

ParentPlanes parents_of(const void* psrv, const void* pbytes, int P,
                        float gamma_bw) {
  return ParentPlanes{static_cast<const int*>(psrv),
                      static_cast<const float*>(pbytes), P, gamma_bw};
}

// K5: one thread per task scores its pre-sampled pair (cand [T, 2]) with
// the task's durations there (d_cand [T, 2]) in the reference kernel's
// reciprocal form, and picks: B only on a strict >, so ties keep A.  The
// six gathers at the candidates (L, C as float2, D) issue together once
// cand has arrived.
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
  const float Dxa = D[c.x], Dxb = D[c.y];
  const float inv_a = 1.0f / fmaf(ca.y, ca.y, ca.x * ca.x);
  const float inv_b = 1.0f / fmaf(cb.y, cb.y, cb.x * cb.x);
  const float dot_a = fmaf(rt.y, la.y, rt.x * la.x);
  const float dot_b = fmaf(rt.y, lb.y, rt.x * lb.x);
  const float rl_a = dot_a * inv_a;
  const float rl_b = dot_b * inv_b;
  const bool rl_ok = rl_a + rl_b > kEps;
  const float rfa = rl_ok ? rl_a / (fmaf(dot_b, inv_b, rl_a) + kEps) : 0.5f;
  const float rfb = rl_ok ? rl_b / (fmaf(dot_a, inv_a, rl_b) + kEps) : 0.5f;
  const float Da = Dxa + dc.x;
  const float Db = Dxb + dc.y;
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

// K2: K1 with the window-major planes down0, down1 [Wd, N] (Wd >= 1)
// and now [T] (float32) in the prefilter.
extern "C" int dodoor_fused_sparse_masked_launch(
    const void* keys, const void* r, const void* d_types,
    const void* node_type, const void* L, const void* D, const void* C,
    const void* down0, const void* down1, const void* now, int T, int N,
    int TT, int Wd, float alpha, void* choice, void* cand, void* scores,
    void* stream) {
  return launch_masked<NoParents>(
      keys, r, d_types, node_type, L, D, C,
      windows_of(down0, down1, now, Wd, N), kNoParents, T, N, TT, alpha,
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

// K3 on K2: the window-major planes and the parent planes together.
extern "C" int dodoor_fused_sparse_masked_locality_launch(
    const void* keys, const void* r, const void* d_types,
    const void* node_type, const void* L, const void* D, const void* C,
    const void* down0, const void* down1, const void* now, const void* psrv,
    const void* pbytes, int T, int N, int TT, int Wd, int P, float alpha,
    float gamma_bw, void* choice, void* cand, void* scores, void* stream) {
  return launch_masked<Parents>(
      keys, r, d_types, node_type, L, D, C,
      windows_of(down0, down1, now, Wd, N),
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
// D [N], C [N, 2]; alpha and 1 - alpha as the caller rounded them; `tpb`
// tasks a block (32..256, a multiple of 32).  Returns cudaGetLastError()
// (0 on success), or cudaErrorInvalidValue for a tpb it does not take.
extern "C" int dodoor_choice_launch(const void* r, const void* cand,
                                    const void* d_cand, const void* L,
                                    const void* D, const void* C, int T,
                                    float alpha, float one_m_alpha, int tpb,
                                    void* choice, void* scores,
                                    void* stream) {
  if (tpb < 32 || tpb > 256 || tpb % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (T > 0) {
    dodoor_choice_kernel<<<(T + tpb - 1) / tpb, tpb, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(r), static_cast<const int*>(cand),
        static_cast<const float*>(d_cand), static_cast<const float*>(L),
        static_cast<const float*>(D), static_cast<const float*>(C), T, alpha,
        one_m_alpha, static_cast<int*>(choice), static_cast<float*>(scores));
  }
  return static_cast<int>(cudaGetLastError());
}
