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
// What is kept from the TPU kernel.  It carries the running max m, sum l
// and the accumulator across a sequential k grid axis.  Blocks on Hopper
// run in no order, so a block walks its key tiles in a loop and keeps m, l
// and the accumulator in registers.  A block serves the rows of ONE
// key/value head: the rep query heads that share it (GQA) are flattened
// with the query positions into rep * Lq rows, position-major (row f is
// position f / rep of head hk * rep + f % rep), so K and V are read once
// for the whole group and a block's rows cover consecutive positions.
// The ragged edges are masked here, so the wrapper pads nothing.  Key
// tiles wholly outside the causal and window extent of a block's rows are
// skipped, as models/common.py::attention bounds its scan.  Masked logits
// are -1e30, never -inf (inf - inf is NaN), and contribute exactly 0: a
// row whose first tiles are fully masked keeps l = 0 and acc = 0 until a
// valid tile arrives, which is what the reference's exp(0) garbage
// becomes once its correction factor exp(-1e30 - m) zeroes it.  q is
// float32 or bfloat16 and k, v either type: the keys and values are read
// in q's type (widened, or rounded, as the reference casts its cache to
// the activations' type), products and sums are float32-accurate, and the
// output has q's type.  A decode against a bfloat16 cache reads the cache
// in place with a float32 query; its own step's key and value, which the
// reference holds unrounded at the last slot, come in as an optional last
// row (kl, vl, in q's type) that takes the place of key Lk - 1.
//
// Bound on this card, and the two regimes.  The logits and the PV product
// cost 4 * D flops per unmasked (query, key) pair against q, k, v and o
// moved once.
//
// A. Prefill, and every call with rep * Lq > 16 rows a group: ~500 flops a
//    byte at tinyllama's prefill, so bounded by arithmetic.  On the
//    float32 FMA pipes (67 T op/s) that bound is 256.7 us there; the tensor
//    cores run TF32 at 495 T op/s, but TF32 keeps 10 bits of mantissa and
//    the reference pins float32 (rtol 2e-4).  So every product is split
//    3xTF32: x = hi + lo with hi = tf32_rna(x) and lo = tf32_rna(x - hi),
//    and x * y = lo_x hi_y + hi_x lo_y + hi_x hi_y (lo lo dropped, ~2^-22
//    relative), three m16n8k8 MMAs into a float32 accumulator, small
//    terms first.  A bfloat16 value is exact in TF32: its lo is 0, and the
//    MMAs that would carry it are not issued (a bf16 q drops lo_q hi_k;
//    k and v read as bf16, without a float32 last row, drop hi_q lo_k and
//    hi_p lo_v).  The bound of this route is 3 x the flops at 495 T op/s
//    (104 us at tinyllama's prefill).  A block is 4 warps and 64 rows;
//    each warp runs its 16 x 32 logits tile and its 16 x D accumulator as
//    MMA fragments.  Q's hi and lo fragments are made once a block
//    (registers at D <= 64; at D >= 128 a lane-private copy in shared
//    memory, read back each key tile).  K and V come in tiles of 32 keys
//    (a 51.7 KB block at D = 64 and at most 168 registers a thread, so
//    three blocks share an SM; at D = 256 tiles of 16 keys, since 32 keys
//    and Q's copy would take 330 KB against the 227 KB a block may opt
//    into): a tile's raw rows land by 16-byte cp.async
//    while the previous tile is computed, then one pass of the block
//    splits them, read in q's type, into hi/lo tiles (once a block instead
//    of once a warp), laid out so that a lane's K fragment is one 16-byte
//    load and each V value one 8-byte load, with row paddings that keep
//    both free of bank conflicts.  The MMA's reduction index is permuted
//    so that no fragment needs a shuffle: in QK^T lane t's columns t and
//    t + 4 of k-step s are d = 8s + 2t and 8s + 2t + 1, and in P.V they are
//    keys 8j + 2t and 8j + 2t + 1 -- exactly the two columns of the logits
//    fragment the lane already holds, so P goes from the C fragment of
//    QK^T to the A fragment of P.V in place.  The online softmax runs on
//    the fragments, on logits scaled by scale * log2(e) (exp2f), a row's
//    max and sum over the 4 lanes of a quad by shuffles.  Masks are
//    applied only on tiles that cross the causal diagonal, a window edge
//    or the ragged end.  Under a causal mask the blocks are issued
//    heaviest first (the last query tiles), so the tail of the grid holds
//    the short ones.
//
// B. Decode, rep * Lq <= 16 rows a group: 4 * rep flops a key read, so
//    bounded by memory (8.4 MB at tinyllama's decode at Lk = 1024: 2.5 us
//    at 3.35 TB/s).  One block of one group walking the whole cache keeps
//    16 blocks busy on 132 SMs, so the keys [lo, hi) the group's rows may
//    see are cut into `splits` contiguous runs of whole 64-key tiles (the
//    last one ragged), one block per (b, hk, split), and the runs' partial
//    (m, l, acc) go to a float32 scratch.  A second kernel, launched right
//    after on the same stream, merges them per row in increasing split
//    order: m = max m_s, each run scaled by 2^(m_s - m) (a run with no
//    valid key, m_s = -1e30 and l_s = 0, adds exactly 0), o = acc / l in
//    q's type.  With splits = 1 the block writes o itself and there is no
//    scratch and no second launch.  The arithmetic is float32 FMA (the
//    tensor cores do not pay at 4 * rep flops a key): 256 threads as 8
//    rows x 32 lanes (one warp a row) for groups of at most 8 rows, else
//    16 x 16, the keys of a tile staged through registers with 16-byte
//    loads one tile ahead and stored to shared memory as float32 in q's
//    type.
//
// No atomics and a fixed order of every sum: two calls give the same bits.
//
// The backward (flash_attention_bwd_launch, float32, D <= 128) is four
// more kernels at the end of this file; its note is there.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBK = 64;          // regime B: keys a tile (and a run's unit)
constexpr int kBKA = 32;         // regime A: keys a tile at D <= 128
constexpr float kNeg = -1e30f;   // the reference's masked logit
constexpr int kRowsB = 16;       // the most rows a group regime B takes
constexpr int kThreadsA = 128;   // regime A: 4 warps x 16 rows
constexpr int kBQ = 64;          // regime A: rows a block
constexpr int kThreadsB = 256;   // regime B: row groups x column groups

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const void* kl;  // nullptr, or [B, Hkv, D] in q's type: key Lk - 1
  const void* vl;  // likewise the value of key Lk - 1
  float* part;     // regime B with splits > 1: the runs' partials
  int B, H, Hkv, Lq, Lk;
  long long qsb, qsh, qsl, ksb, ksh, ksl, vsb, vsh, vsl;
  long long klsb, klsh, vlsb, vlsh;
  int causal, window;  // window <= 0: none
  float scale;
  int splits;  // regime B: runs of keys a group (1 in regime A)
  int vec;     // k and v rows may be copied in 16-byte pieces
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
// A float32 value as q's type TQ reads it (rounded to bf16 for a bf16 q).
template <typename TQ>
__device__ __forceinline__ float q_round(float x) {
  return sizeof(TQ) == 4 ? x : to_f(from_f<__nv_bfloat16>(x));
}
// Two bf16 values packed in a 32-bit word, widened (exactly).
__device__ __forceinline__ float bf_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// ------------------------------------------------------------ arithmetic

constexpr float kLog2e = 1.4426950408889634f;

// x rounded to TF32 (10 bits of mantissa), to nearest with ties away from
// zero: half a TF32 ulp added to the magnitude bits, the 13 bits below it
// cleared.  For finite x these are the bits of cvt.rna.tf32.f32, which on
// sm_90 lowers to a longer compare-and-select sequence: with it the
// prefill at tinyllama's shape took 466-470 us against 435-438 us on an
// H100 80GB HBM3 at 700 W (tools/ablate_flash_attention.py, variant
// "cvt").  A NaN x still gives a NaN lo (x - hi), so NaNs reach the
// output.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo, both TF32.
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

// Copies 16 bytes from global to shared memory without staging them in
// registers (cp.async).
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
#ifdef __CUDA_ARCH__
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
#else
  *static_cast<uint4*>(dst) = *static_cast<const uint4*>(src);
#endif
}

// Closes the thread's current group of copies; cp_async_wait0() waits
// until all of them have landed.
__device__ __forceinline__ void cp_async_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

__device__ __forceinline__ void cp_async_wait0() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
#endif
}

// The keys any row of rows [f0, f1] (position-major) may see: [lo, hi).
struct KeyRange {
  int imin, imax, off, lo, hi;
};
__device__ __forceinline__ KeyRange key_range(const Args& a, int rep, int f0,
                                              int f1) {
  KeyRange r;
  r.imin = f0 / rep;
  r.imax = f1 / rep;
  r.off = a.Lk - a.Lq;
  r.hi = a.causal ? min(a.Lk, r.imax + r.off + 1) : a.Lk;
  r.lo = a.window > 0 ? max(0, r.imin + r.off - a.window + 1) : 0;
  return r;
}

// Whether key kj is valid for a row at absolute position qpos (keys below
// `kend` only).
__device__ __forceinline__ bool key_ok(const Args& a, int kj, int kend,
                                       int qpos) {
  return kj < kend && (!a.causal || kj <= qpos) &&
         (a.window <= 0 || kj > qpos - a.window);
}

// Whether no key of [kt, kt + n) needs a mask for rows at positions
// [imin, imax] + off: inside [0, kend), below the diagonal of the first
// row and inside the window of the last.
__device__ __forceinline__ bool tile_full(const Args& a, const KeyRange& r,
                                          int kt, int n, int kend) {
  return kt + n <= kend && (!a.causal || kt + n - 1 <= r.imin + r.off) &&
         (a.window <= 0 || kt > r.imax + r.off - a.window);
}

// Four consecutive values of a raw k or v row, widened.
__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&x)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  x[0] = bf_lo(v.x); x[1] = bf_hi(v.x); x[2] = bf_lo(v.y); x[3] = bf_hi(v.y);
}

// ----------------------------------------------------- regime A: prefill

// Row strides (32-bit words) of the split tiles.  K: per pair of dims d =
// 2p, 2p + 1, the words hi(2p), hi(2p + 1), lo(2p), lo(2p + 1), so a lane's
// B fragment (rows g, dims 2t, 2t + 1) is one 16-byte load; 2D + 16 words
// a row put the quarter warp's two rows on opposite bank halves.  V: per
// element the words hi, lo (a lane's b0 or b1 is one 8-byte load);
// 2D + 4 words a row spread the half warp's four rows 2t over the banks.
template <int D>
__host__ __device__ constexpr int ksp_stride() { return 2 * D + 16; }
template <int D>
__host__ __device__ constexpr int vsp_stride() { return 2 * D + 4; }

// Regime A's keys a tile: kBKA, or half of it at D = 256, where a 32-key
// tile and Q's shared copy (330 240 B with float32 keys) exceed the
// 232 448 B a block may opt into; 16 keys make 230 656 B.
template <int D>
__host__ __device__ constexpr int bka() { return D > 128 ? kBKA / 2 : kBKA; }

template <typename TKV, int D>
__host__ __device__ constexpr size_t smem_a() {
  return bka<D>() * (2 * D * sizeof(TKV) +
                     (ksp_stride<D>() + vsp_stride<D>()) * 4) +
         (D > 64 ? 2 * (D / 8) * kThreadsA * sizeof(uint4) : 0);
}

// Enqueues the raw rows of key tile [kt, kt + bka<D>()) of K and V:
// cp.async in 16-byte pieces (vec), or copies by the threads.  Rows at or
// past kend and the last row, where one is given, are left to the split
// pass.
template <typename TKV, int D>
__device__ __forceinline__ void issue_raw(TKV* Kr, TKV* Vr, const TKV* k,
                                          const TKV* v, bool last,
                                          const Args& a, int kt, int kend) {
  constexpr int BK = bka<D>();
  const int tid = threadIdx.x;
  if (a.vec) {
    constexpr int EPV = 16 / sizeof(TKV);
    constexpr int PPR = D / EPV;
    for (int idx = tid; idx < BK * PPR; idx += kThreadsA) {
      const int j = idx / PPR, e = (idx % PPR) * EPV, kj = kt + j;
      if (kj < kend && !(last && kj == a.Lk - 1)) {
        cp_async16(Kr + j * D + e, k + kj * a.ksl + e);
        cp_async16(Vr + j * D + e, v + kj * a.vsl + e);
      }
    }
  } else {
    for (int idx = tid; idx < BK * D; idx += kThreadsA) {
      const int j = idx / D, d = idx % D, kj = kt + j;
      if (kj < kend && !(last && kj == a.Lk - 1)) {
        Kr[j * D + d] = k[kj * a.ksl + d];
        Vr[j * D + d] = v[kj * a.vsl + d];
      }
    }
  }
}

// The split pass: the raw tile, read in q's type (zeros at or past kend,
// the given last row at Lk - 1), into the hi/lo tiles the fragments load.
template <typename TQ, typename TKV, int D>
__device__ __forceinline__ void split_tile(uint32_t* Ksp, uint32_t* Vsp,
                                           const TKV* Kr, const TKV* Vr,
                                           const TQ* kl, const TQ* vl,
                                           const Args& a, int kt, int kend) {
  constexpr int KSP = ksp_stride<D>(), VSP = vsp_stride<D>();
  for (int idx = threadIdx.x; idx < bka<D>() * D / 4; idx += kThreadsA) {
    const int j = idx / (D / 4), d = (idx % (D / 4)) * 4, kj = kt + j;
    float kx[4] = {0.0f, 0.0f, 0.0f, 0.0f}, vx[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (kj >= kend) {
    } else if (kl != nullptr && kj == a.Lk - 1) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        kx[u] = to_f(kl[d + u]);
        vx[u] = to_f(vl[d + u]);
      }
    } else {
      load4(Kr + j * D + d, kx);
      load4(Vr + j * D + d, vx);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        kx[u] = q_round<TQ>(kx[u]);
        vx[u] = q_round<TQ>(vx[u]);
      }
    }
    uint32_t kh[4], klo[4], vh[4], vlo[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      split(kx[u], kh[u], klo[u]);
      split(vx[u], vh[u], vlo[u]);
    }
    uint4* kd = reinterpret_cast<uint4*>(Ksp + j * KSP + 2 * d);
    kd[0] = make_uint4(kh[0], kh[1], klo[0], klo[1]);
    kd[1] = make_uint4(kh[2], kh[3], klo[2], klo[3]);
    uint4* vd = reinterpret_cast<uint4*>(Vsp + j * VSP + 2 * d);
    vd[0] = make_uint4(vh[0], vlo[0], vh[1], vlo[1]);
    vd[1] = make_uint4(vh[2], vlo[2], vh[3], vlo[3]);
  }
}

template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(kThreadsA, D <= 64 ? 3 : 1)
attn_tc_kernel(const Args a) {
  constexpr int BK = bka<D>();                         // keys a tile
  constexpr int NT = BK / 8;                           // key fragments
  constexpr bool kLoQ = sizeof(TQ) == 4;               // q has a lo part
  constexpr bool kQReg = D <= 64;                      // Q kept in registers
  constexpr int KSP = ksp_stride<D>(), VSP = vsp_stride<D>();
  constexpr int NS = D / 8;                            // k-steps over d
  constexpr int NN = D / 8;                            // 8-column tiles of o
  extern __shared__ uint4 smem_u4[];
  uint32_t* Ksp = reinterpret_cast<uint32_t*>(smem_u4);  // [BK][KSP]
  uint32_t* Vsp = Ksp + BK * KSP;                        // [BK][VSP]
  TKV* Kr = reinterpret_cast<TKV*>(Vsp + BK * VSP);      // [BK][D]
  TKV* Vr = Kr + BK * D;                                 // [BK][D]
  uint4* Qf = reinterpret_cast<uint4*>(Vr + BK * D);     // D > 64 only

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rep = a.H / a.Hkv;
  const int rows = rep * a.Lq;
  const int nqt = (rows + kBQ - 1) / kBQ;
  const int BHkv = a.B * a.Hkv;
  const int bh = blockIdx.x % BHkv;
  const int x = blockIdx.x / BHkv;
  const int qt = a.causal ? nqt - 1 - x : x;   // heaviest first
  const int b = bh / a.Hkv, hk = bh % a.Hkv;
  const int f0 = qt * kBQ;
  const int f1 = min(f0 + kBQ, rows) - 1;
  const KeyRange kr = key_range(a, rep, f0, f1);
  const int kt0 = (kr.lo / BK) * BK;
  const int ntiles = kr.hi > kt0 ? (kr.hi - kt0 + BK - 1) / BK : 0;
  const float sl2 = a.scale * kLog2e;          // logits in log2 units

  const TQ* q = static_cast<const TQ*>(a.q);
  const TKV* k = static_cast<const TKV*>(a.k) + b * a.ksb + hk * a.ksh;
  const TKV* v = static_cast<const TKV*>(a.v) + b * a.vsb + hk * a.vsh;
  const TQ* kl = a.kl == nullptr ? nullptr
      : static_cast<const TQ*>(a.kl) + b * a.klsb + hk * a.klsh;
  const TQ* vl = a.vl == nullptr ? nullptr
      : static_cast<const TQ*>(a.vl) + b * a.vlsb + hk * a.vlsh;
  // k and v read in float32 (and the last row, in q's type) have lo parts.
  const bool lo_kv = kLoQ && (sizeof(TKV) == 4 || kl != nullptr);

  // The first tile's copies go out before Q is read.
  if (ntiles > 0)
    issue_raw<TKV, D>(Kr, Vr, k, v, kl != nullptr, a, kt0, kr.hi);
  cp_async_commit();

  // This lane's rows: fr[0] = row g, fr[1] = row g + 8 of the warp's 16.
  // A warp with no live row only copies and splits tiles.
  const bool warp_live = f0 + 16 * warp < rows;
  int fr[2], qpos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    fr[i] = f0 + 16 * warp + g + 8 * i;
    qpos[i] = (fr[i] < rows ? fr[i] / rep : kr.imax) + kr.off;
  }

  // Q's hi and lo fragments, made once: k-step s holds d = 8s + 2t (A
  // columns t) and 8s + 2t + 1 (columns t + 4) of rows g and g + 8.
  uint32_t qh[kQReg ? NS : 1][4], ql[kQReg ? NS : 1][4];
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    float x0[2] = {0.0f, 0.0f}, x1[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (fr[i] < rows) {
        const int h = hk * rep + fr[i] % rep, pos = fr[i] / rep;
        const TQ* qrow = q + b * a.qsb + h * a.qsh + pos * a.qsl;
        x0[i] = to_f(qrow[8 * s + 2 * t]);
        x1[i] = to_f(qrow[8 * s + 2 * t + 1]);
      }
    }
    uint32_t h4[4], l4[4];
    split(x0[0], h4[0], l4[0]);
    split(x0[1], h4[1], l4[1]);
    split(x1[0], h4[2], l4[2]);
    split(x1[1], h4[3], l4[3]);
    if constexpr (kQReg) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qh[s][i] = h4[i];
        ql[s][i] = l4[i];
      }
    } else {
      Qf[(2 * s) * kThreadsA + tid] = make_uint4(h4[0], h4[1], h4[2], h4[3]);
      Qf[(2 * s + 1) * kThreadsA + tid] =
          make_uint4(l4[0], l4[1], l4[2], l4[3]);
    }
  }

  float m[2] = {kNeg, kNeg}, l[2] = {0.0f, 0.0f};
  float acc[NN][4];
#pragma unroll
  for (int n = 0; n < NN; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.0f;

  for (int it = 0; it < ntiles; ++it) {
    const int kt = kt0 + it * BK;
    cp_async_wait0();
    __syncthreads();   // tile it landed; every warp is done with tile it - 1
    split_tile<TQ, TKV, D>(Ksp, Vsp, Kr, Vr, kl, vl, a, kt, kr.hi);
    __syncthreads();   // the split tile is in place; the raw one is free
    if (it + 1 < ntiles)
      issue_raw<TKV, D>(Kr, Vr, k, v, kl != nullptr, a, kt + BK, kr.hi);
    cp_async_commit();
    if (!warp_live) continue;

    // S = Q K^T: 8 key columns a fragment.
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[n][c] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < NS; ++ks) {
      uint32_t ah[4], al[4];
      if constexpr (kQReg) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ah[i] = qh[ks][i];
          al[i] = ql[ks][i];
        }
      } else {
        const uint4 hv = Qf[(2 * ks) * kThreadsA + tid];
        const uint4 lv = Qf[(2 * ks + 1) * kThreadsA + tid];
        ah[0] = hv.x; ah[1] = hv.y; ah[2] = hv.z; ah[3] = hv.w;
        al[0] = lv.x; al[1] = lv.y; al[2] = lv.z; al[3] = lv.w;
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const uint4 kf = *reinterpret_cast<const uint4*>(
            Ksp + (8 * n + g) * KSP + 4 * (4 * ks + t));
        if (kLoQ) mma_tf32(s[n], al, kf.x, kf.y);
        if (lo_kv) mma_tf32(s[n], ah, kf.z, kf.w);
        mma_tf32(s[n], ah, kf.x, kf.y);
      }
    }

    // Scale to log2 units, mask (edge tiles only), online softmax over the
    // quad's rows.
    const bool full = tile_full(a, kr, kt, BK, kr.hi);
    uint32_t okbits = 0xffffffffu;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[n][c] *= sl2;
        if (!full) {
          const int kj = kt + 8 * n + 2 * t + (c & 1);
          if (!key_ok(a, kj, kr.hi, qpos[c >> 1])) {
            s[n][c] = kNeg;
            okbits &= ~(1u << (4 * n + c));
          }
        }
      }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = kNeg;
#pragma unroll
      for (int n = 0; n < NT; ++n)
        mx = fmaxf(mx, fmaxf(s[n][2 * i], s[n][2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[i], mx);
      corr[i] = exp2f(m[i] - m_new);
      m[i] = m_new;
    }
    float sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const bool ok = (okbits >> (4 * n + c)) & 1u;
        s[n][c] = ok ? exp2f(s[n][c] - m[c >> 1]) : 0.0f;   // p
        sum[c >> 1] += s[n][c];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
      l[i] = l[i] * corr[i] + sum[i];
    }
#pragma unroll
    for (int n = 0; n < NN; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[n][c] *= corr[c >> 1];

    // O += P V: k-step j takes keys 8j + 2t (A columns t) and 8j + 2t + 1
    // (columns t + 4), which are the logits fragment's own columns.
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t ph[4], pl[4];
      split(s[j][0], ph[0], pl[0]);
      split(s[j][2], ph[1], pl[1]);
      split(s[j][1], ph[2], pl[2]);
      split(s[j][3], ph[3], pl[3]);
      const uint32_t* v0 = Vsp + (8 * j + 2 * t) * VSP + 2 * g;
#pragma unroll
      for (int n = 0; n < NN; ++n) {
        const uint2 b0 = *reinterpret_cast<const uint2*>(v0 + 16 * n);
        const uint2 b1 = *reinterpret_cast<const uint2*>(v0 + VSP + 16 * n);
        mma_tf32(acc[n], pl, b0.x, b1.x);
        if (lo_kv) mma_tf32(acc[n], ph, b0.y, b1.y);
        mma_tf32(acc[n], ph, b0.x, b1.x);
      }
    }
  }

  TQ* o = static_cast<TQ*>(a.o);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (fr[i] >= rows) continue;
    const int h = hk * rep + fr[i] % rep, pos = fr[i] / rep;
    const float inv_l = 1.0f / fmaxf(l[i], 1e-30f);
    TQ* orow = o + ((static_cast<long long>(b) * a.H + h) * a.Lq + pos) * D;
#pragma unroll
    for (int n = 0; n < NN; ++n) {
      orow[8 * n + 2 * t] = from_f<TQ>(acc[n][2 * i] * inv_l);
      orow[8 * n + 2 * t + 1] = from_f<TQ>(acc[n][2 * i + 1] * inv_l);
    }
  }
}

// ------------------------------------------------ regime B: split decode

// 256 threads as RG row groups x CG column groups: RG = 8 for groups of
// at most 8 rows (one warp a row), else 16 (half a warp a row).
template <int D, int RG>
__host__ __device__ constexpr size_t smem_b() {
  return sizeof(float) * (RG * (D + 4) + kBK * (D + 4) + kBK * D +
                          RG * (kBK + 4));
}

// The keys [s_lo, s_hi) of run `split` of `splits` over [lo, hi): runs of
// ceil(tiles / splits) whole 64-key tiles; the last is ragged, and runs
// past the end are empty.
__device__ __forceinline__ void split_range(int lo, int hi, int splits,
                                            int split, int& s_lo,
                                            int& s_hi) {
  const int tiles = (hi - lo + kBK - 1) / kBK;
  const int per = (tiles + splits - 1) / splits;
  s_lo = min(hi, lo + split * per * kBK);
  s_hi = min(hi, s_lo + per * kBK);
}

// A thread's share of one K and V tile, staged in registers: NV 16-byte
// pieces of each (k and v rows may be copied in 16-byte pieces).
template <typename TKV, int D>
struct Staged {
  static constexpr int EPV = 16 / sizeof(TKV);
  static constexpr int PPR = D / EPV;
  static constexpr int NV = kBK * PPR / kThreadsB;
  uint4 k[NV], v[NV];
};

// DJ consecutive floats of a shared row.
template <int DJ>
__device__ __forceinline__ void load_cols(const float* p, float (&x)[DJ]) {
  if constexpr (DJ % 4 == 0) {
#pragma unroll
    for (int j = 0; j < DJ; j += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + j);
      x[j] = v.x; x[j + 1] = v.y; x[j + 2] = v.z; x[j + 3] = v.w;
    }
  } else if constexpr (DJ == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    x[0] = v.x; x[1] = v.y;
  } else {
    x[0] = *p;
  }
}

// Two blocks an SM; one at D = 256, whose staged tile alone is 128
// registers a thread with float32 keys.
template <typename TQ, typename TKV, int D, int RG>
__global__ void __launch_bounds__(kThreadsB, D > 128 ? 1 : 2)
attn_split_kernel(const Args a) {
  constexpr int CG = kThreadsB / RG;   // lanes a row
  constexpr int KPT = kBK / CG;        // keys a thread
  constexpr int DJ = D / CG;           // accumulator columns a thread
  constexpr int QS = D + 4, KS = D + 4, VS = D, PS = kBK + 4;
  using St = Staged<TKV, D>;
  extern __shared__ uint4 smem_u4[];
  float* Qs = reinterpret_cast<float*>(smem_u4);  // [RG][QS]
  float* Ks = Qs + RG * QS;                      // [kBK][KS]
  float* Vs = Ks + kBK * KS;                     // [kBK][VS]
  float* Ps = Vs + kBK * VS;                     // [RG][PS]

  const int tid = threadIdx.x;
  const int r = tid / CG;
  const int c = tid % CG;
  const int rep = a.H / a.Hkv;
  const int rows = rep * a.Lq;                   // <= RG
  const int split = blockIdx.x % a.splits;
  const int bh = blockIdx.x / a.splits;
  const int b = bh / a.Hkv, hk = bh % a.Hkv;
  const KeyRange kr = key_range(a, rep, 0, rows - 1);
  const float sl2 = a.scale * kLog2e;            // logits in log2 units
  int s_lo, s_hi;
  split_range(kr.lo, kr.hi, a.splits, split, s_lo, s_hi);

  const TQ* q = static_cast<const TQ*>(a.q);
  const TKV* k = static_cast<const TKV*>(a.k) + b * a.ksb + hk * a.ksh;
  const TKV* v = static_cast<const TKV*>(a.v) + b * a.vsb + hk * a.vsh;
  const TQ* kl = a.kl == nullptr ? nullptr
      : static_cast<const TQ*>(a.kl) + b * a.klsb + hk * a.klsh;
  const TQ* vl = a.vl == nullptr ? nullptr
      : static_cast<const TQ*>(a.vl) + b * a.vlsb + hk * a.vlsh;

  // Loads of tile kt into registers (16-byte pieces; the last row and rows
  // past s_hi are filled in when the tile is stored).
  St st;
  auto fetch = [&](int kt) {
    if (!a.vec) return;
#pragma unroll
    for (int i = 0; i < St::NV; ++i) {
      const int idx = tid + i * kThreadsB;
      const int j = idx / St::PPR, e = (idx % St::PPR) * St::EPV;
      const int kj = kt + j;
      if (kj < s_hi && !(kl != nullptr && kj == a.Lk - 1)) {
        st.k[i] = *reinterpret_cast<const uint4*>(k + kj * a.ksl + e);
        st.v[i] = *reinterpret_cast<const uint4*>(v + kj * a.vsl + e);
      }
    }
  };
  // Tile kt into shared memory as float32 in q's type.
  auto store = [&](int kt) {
    if (a.vec) {
#pragma unroll
      for (int i = 0; i < St::NV; ++i) {
        const int idx = tid + i * kThreadsB;
        const int j = idx / St::PPR, e = (idx % St::PPR) * St::EPV;
        const int kj = kt + j;
        float kx[St::EPV], vx[St::EPV];
        if (kj >= s_hi) {
#pragma unroll
          for (int u = 0; u < St::EPV; ++u) kx[u] = vx[u] = 0.0f;
        } else if (kl != nullptr && kj == a.Lk - 1) {
#pragma unroll
          for (int u = 0; u < St::EPV; ++u) {
            kx[u] = to_f(kl[e + u]);
            vx[u] = to_f(vl[e + u]);
          }
        } else {
          const uint32_t kw[4] = {st.k[i].x, st.k[i].y, st.k[i].z, st.k[i].w};
          const uint32_t vw[4] = {st.v[i].x, st.v[i].y, st.v[i].z, st.v[i].w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            if constexpr (sizeof(TKV) == 4) {
              kx[u] = q_round<TQ>(__uint_as_float(kw[u]));
              vx[u] = q_round<TQ>(__uint_as_float(vw[u]));
            } else {
              kx[2 * u] = bf_lo(kw[u]);
              kx[2 * u + 1] = bf_hi(kw[u]);
              vx[2 * u] = bf_lo(vw[u]);
              vx[2 * u + 1] = bf_hi(vw[u]);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < St::EPV; u += 4) {
          *reinterpret_cast<float4*>(Ks + j * KS + e + u) =
              make_float4(kx[u], kx[u + 1], kx[u + 2], kx[u + 3]);
          *reinterpret_cast<float4*>(Vs + j * VS + e + u) =
              make_float4(vx[u], vx[u + 1], vx[u + 2], vx[u + 3]);
        }
      }
    } else {
      for (int idx = tid; idx < kBK * D; idx += kThreadsB) {
        const int j = idx / D, d = idx % D, kj = kt + j;
        float kx = 0.0f, vx = 0.0f;
        if (kj >= s_hi) {
        } else if (kl != nullptr && kj == a.Lk - 1) {
          kx = to_f(kl[d]);
          vx = to_f(vl[d]);
        } else {
          kx = q_round<TQ>(to_f(k[kj * a.ksl + d]));
          vx = q_round<TQ>(to_f(v[kj * a.vsl + d]));
        }
        Ks[j * KS + d] = kx;
        Vs[j * VS + d] = vx;
      }
    }
  };

  if (s_lo < s_hi) fetch(s_lo);

  // The query rows: row f is head hk * rep + f % rep at position f / rep.
  for (int idx = tid; idx < RG * D; idx += kThreadsB) {
    const int f = idx / D, d = idx % D;
    float x = 0.0f;
    if (f < rows) {
      const int h = hk * rep + f % rep, i = f / rep;
      x = to_f(q[b * a.qsb + h * a.qsh + i * a.qsl + d]);
    }
    Qs[f * QS + d] = x;
  }
  const bool live = r < rows;
  const int qpos = (live ? r / rep : kr.imax) + kr.off;
  // The first row of the thread's warp is live.
  const bool warp_live = (tid >> 5) * (32 / CG) < rows;

  float m = kNeg, l = 0.0f, acc[DJ];
#pragma unroll
  for (int j = 0; j < DJ; ++j) acc[j] = 0.0f;

  for (int kt = s_lo; kt < s_hi; kt += kBK) {
    __syncthreads();   // the previous tile is consumed
    store(kt);
    __syncthreads();
    if (kt + kBK < s_hi) fetch(kt + kBK);
    if (!warp_live) continue;

    float s[KPT];
#pragma unroll
    for (int jj = 0; jj < KPT; ++jj) s[jj] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 qv = *reinterpret_cast<const float4*>(Qs + r * QS + d);
#pragma unroll
      for (int jj = 0; jj < KPT; ++jj) {
        const float4 kv =
            *reinterpret_cast<const float4*>(Ks + (c + CG * jj) * KS + d);
        s[jj] = fmaf(qv.x, kv.x, s[jj]);
        s[jj] = fmaf(qv.y, kv.y, s[jj]);
        s[jj] = fmaf(qv.z, kv.z, s[jj]);
        s[jj] = fmaf(qv.w, kv.w, s[jj]);
      }
    }
    const bool full = tile_full(a, kr, kt, kBK, s_hi);
    bool ok[KPT];
    float mx = kNeg;
#pragma unroll
    for (int jj = 0; jj < KPT; ++jj) {
      ok[jj] = full || key_ok(a, kt + c + CG * jj, s_hi, qpos);
      s[jj] = ok[jj] ? s[jj] * sl2 : kNeg;
      mx = fmaxf(mx, s[jj]);
    }
#pragma unroll
    for (int w = 1; w < CG; w <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
    const float m_new = fmaxf(m, mx);
    const float corr = exp2f(m - m_new);
    float sum = 0.0f;
#pragma unroll
    for (int jj = 0; jj < KPT; ++jj) {
      const float p = ok[jj] ? exp2f(s[jj] - m_new) : 0.0f;
      Ps[r * PS + c + CG * jj] = p;
      sum += p;
    }
#pragma unroll
    for (int w = 1; w < CG; w <<= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, w);
    l = l * corr + sum;
    m = m_new;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[j] *= corr;
    __syncwarp();      // row r's P is written and read by its own lanes

    const int kn = min(kBK, s_hi - kt);
    for (int kk = 0; kk < kn; kk += 4) {
      const float4 p4 = *reinterpret_cast<const float4*>(Ps + r * PS + kk);
      const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float vv[DJ];
        load_cols<DJ>(Vs + (kk + u) * VS + c * DJ, vv);
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[j] = fmaf(pv[u], vv[j], acc[j]);
      }
    }
    __syncwarp();
  }

  if (!live) return;
  if (a.splits == 1) {
    const int h = hk * rep + r % rep, pos = r / rep;
    const float inv_l = 1.0f / fmaxf(l, 1e-30f);
    TQ* orow = static_cast<TQ*>(a.o) +
               ((static_cast<long long>(b) * a.H + h) * a.Lq + pos) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) orow[c * DJ + j] = from_f<TQ>(acc[j] * inv_l);
    return;
  }
  // Partials: acc [B*Hkv][splits][rows][D], then (m, l) [..][rows][2].
  const long long cell = (static_cast<long long>(bh) * a.splits + split) *
                         rows + r;
  float* pacc = a.part + cell * D + c * DJ;
#pragma unroll
  for (int j = 0; j < DJ; ++j) pacc[j] = acc[j];
  if (c == 0) {
    float* pml = a.part + static_cast<long long>(a.B) * a.Hkv * a.splits *
                              rows * D + cell * 2;
    pml[0] = m;
    pml[1] = l;
  }
}

// Merges a row's runs in increasing split order; one block per (b, hk,
// row), one thread per column.  The runs' m and l are read by the lanes
// of warp 0 at once and their weights 2^(m_s - m) kept in shared memory
// (2 * splits floats), so the sums wait on no chain of loads.
template <typename TQ, int D>
__global__ void __launch_bounds__(D) attn_combine_kernel(const Args a) {
  extern __shared__ uint4 smem_u4[];
  float* w = reinterpret_cast<float*>(smem_u4);   // [splits] weights
  float* ls = w + a.splits;                       // [splits] l
  const int rep = a.H / a.Hkv;
  const int rows = rep * a.Lq;
  const int bh = blockIdx.x / rows, r = blockIdx.x % rows;
  const int d = threadIdx.x;
  const int b = bh / a.Hkv, hk = bh % a.Hkv;
  const long long cell0 = static_cast<long long>(bh) * a.splits * rows + r;
  const float* pacc = a.part + cell0 * D + d;
  const float* pml = a.part + static_cast<long long>(a.B) * a.Hkv *
                                  a.splits * rows * D + cell0 * 2;
  if (d < 32) {
    float m = kNeg;
    for (int s = d; s < a.splits; s += 32) m = fmaxf(m, pml[s * rows * 2]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    for (int s = d; s < a.splits; s += 32) {
      w[s] = exp2f(pml[s * rows * 2] - m);
      ls[s] = pml[s * rows * 2 + 1];
    }
  }
  __syncthreads();
  float l = 0.0f, acc = 0.0f;
#pragma unroll 8
  for (int s = 0; s < a.splits; ++s) {
    l = l + ls[s] * w[s];
    acc = acc + pacc[static_cast<long long>(s) * rows * D] * w[s];
  }
  const int h = hk * rep + r % rep, pos = r / rep;
  TQ* orow = static_cast<TQ*>(a.o) +
             ((static_cast<long long>(b) * a.H + h) * a.Lq + pos) * D;
  orow[d] = from_f<TQ>(acc * (1.0f / fmaxf(l, 1e-30f)));
}

// -------------------------------------------------------------- launchers

template <typename Kern>
int opt_in(Kern kern, size_t smem) {
  // Above 48 KB a block's dynamic shared memory must be opted into.
  return static_cast<int>(cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

template <typename TQ, typename TKV, int D>
int launch_tc(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = smem_a<TKV, D>();
  auto kern = attn_tc_kernel<TQ, TKV, D>;
  const int err = opt_in(kern, smem);
  if (err != 0) return err;
  const int rows = (a.H / a.Hkv) * a.Lq;
  const int grid = ((rows + kBQ - 1) / kBQ) * a.B * a.Hkv;
  kern<<<grid, kThreadsA, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TKV, int D, int RG>
int launch_split(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = smem_b<D, RG>();
  auto kern = attn_split_kernel<TQ, TKV, D, RG>;
  int err = opt_in(kern, smem);
  if (err != 0) return err;
  const int grid = a.B * a.Hkv * a.splits;
  kern<<<grid, kThreadsB, smem, stream>>>(a);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0 || a.splits == 1) return err;
  auto comb = attn_combine_kernel<TQ, D>;
  const size_t csmem = 2 * sizeof(float) * a.splits;
  err = opt_in(comb, csmem);
  if (err != 0) return err;
  const int cgrid = a.B * a.Hkv * (a.H / a.Hkv) * a.Lq;
  comb<<<cgrid, D, csmem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TKV, int D>
int launch_regime(const Args& a, cudaStream_t stream) {
  const int rows = (a.H / a.Hkv) * a.Lq;
  if (rows <= 8) return launch_split<TQ, TKV, D, 8>(a, stream);
  if (rows <= kRowsB) return launch_split<TQ, TKV, D, 16>(a, stream);
  return launch_tc<TQ, TKV, D>(a, stream);
}

template <typename TQ, typename TKV>
int launch_dtype(const Args& a, int D, cudaStream_t stream) {
  switch (D) {
    case 32: return launch_regime<TQ, TKV, 32>(a, stream);
    case 64: return launch_regime<TQ, TKV, 64>(a, stream);
    case 128: return launch_regime<TQ, TKV, 128>(a, stream);
    case 256: return launch_regime<TQ, TKV, 256>(a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename TQ>
int launch_kv(const Args& a, int D, int kv_bf16, cudaStream_t stream) {
  return kv_bf16 ? launch_dtype<TQ, __nv_bfloat16>(a, D, stream)
                 : launch_dtype<TQ, float>(a, D, stream);
}

bool aligned16(const void* p, long long s0, long long s1, long long s2,
               int elt) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && (s0 * elt) % 16 == 0 &&
         (s1 * elt) % 16 == 0 && (s2 * elt) % 16 == 0;
}

// ------------------------------------------------------------- backward
//
// The gradients of o = softmax(q k^T * scale, masked) v for an output
// gradient dO, with P the softmax:
//   dV = P^T dO,  dP = dO V^T,  Delta = rowsum(dO * o),
//   dS = P * (dP - Delta),  dQ = scale dS K,  dK = scale dS^T Q,
// dK and dV summed over the rep query heads of each key/value head.  The
// reference's Pallas kernel has no custom_vjp, so there is no TPU
// backward to replace: the reference trains through its jnp attention,
// and this backward lets the port train through K7.  Float32 operands,
// every product an fmaf (the file is built with -fmad=false), no atomics
// and a fixed order of every sum, so two calls give the same bits:
//   1. stats: a block per (b, hk, tile of 64 flattened rows) walks the
//      keys its rows see and writes each row's log2-sum-exp of the logits
//      scaled by scale * log2(e), and Delta (the forward writes no lse);
//   2. dk/dv: a block per (b, hk, tile of 64 keys, run of up to
//      ceil(rep * Lq / runs) flattened rows, `runs` as the caller plans
//      it) walks the rows of its run that see any
//      of its keys (all rep heads of the group) and keeps its keys' dK and
//      dV in registers.  Under a causal mask the first key tiles are seen
//      by every row and the last by few, so one block a key tile would
//      leave the card waiting on the first ones: the rows are cut into
//      runs of equal length instead.  With one run a block writes dK, dV;
//      with more, each run writes its partial sums to a scratch slot (zeros
//      for a run that sees none of the tile's keys) and
//   3. a reduction adds the runs' partials in run order;
//   4. dq: a block per (b, hk, tile of 64 flattened rows) walks the keys
//      its rows see, as the stats pass did, and writes dQ once.
// Rows are flattened position-major as in the forward (row f is position
// f / rep of head hk * rep + f % rep).  A block is 256 threads, 16 x 16;
// thread (ty, tx) computes the 4 x 4 logits of rows ty + 16 i and keys
// tx + 16 j of a 64 x 64 tile, reading float4s along D from row-major
// tiles of D + 4 words a row (conflict-free for a quarter warp's eight
// rows), and accumulates its 4 x D/16 outputs (rows or keys ty + 16 i,
// dims tx * D/16 ...).  Masks are evaluated only on tiles that cross the
// causal diagonal, a window edge or a ragged end.  Bound on this card:
// 10 * D flops an unmasked (query, key) pair against q, k, v, o, dO read
// and dq, dk, dv written once, so arithmetic: float32-accurate products
// run fastest as three TF32 MMAs each (495 T op/s, 165 effective), as the
// forward runs them; these passes run on the CUDA cores (67 T op/s) and
// do 16 * D (the logits three times, dO V^T twice).  Head widths 32, 64
// and 128.

constexpr int kBT = 64;             // backward: rows and keys a tile
constexpr int kThreadsBwd = 256;    // 16 x 16 threads

struct BwdArgs {
  const float* q;
  const float* k;
  const float* v;
  const float* o;
  const float* dO;
  float* dq;     // [B, H, Lq, D] contiguous
  float* dk;     // [B, Hkv, Lk, D] contiguous
  float* dv;
  float* lse;    // [B, H, Lq]: log2-sum-exp of the scaled logits
  float* delta;  // [B, H, Lq]: rowsum(dO * o)
  float* part;   // runs > 1: [2, runs, B, Hkv, Lk, D] partial dK, dV
  int B, H, Hkv, Lq, Lk;
  long long qsb, qsh, qsl, ksb, ksh, ksl, vsb, vsh, vsl, osb, osh, osl;
  long long dsb, dsh, dsl;
  int causal, window;  // window <= 0: none
  float scale;
  int runs;  // dk/dv: runs of ceil(rep * Lq / runs) flattened rows
};

template <int D>
__host__ __device__ constexpr int bwd_ld() { return D + 4; }

// Rows [f0, f0 + 64) of a group's flattened query rows of a [B, H, Lq, D]
// tensor at `src` (batch offset applied) into a row-major tile; zeros for
// rows at or past `rows`.
template <int D>
__device__ void bwd_load_rows(float* dst, const float* src, long long sh,
                              long long sl, int hk, int rep, int f0,
                              int rows) {
  for (int e = threadIdx.x; e < kBT * D; e += kThreadsBwd) {
    const int r = e / D, d = e % D, f = f0 + r;
    float x = 0.0f;
    if (f < rows)
      x = src[(hk * rep + f % rep) * sh + static_cast<long long>(f / rep) * sl +
              d];
    dst[r * bwd_ld<D>() + d] = x;
  }
}

// Keys [j0, j0 + 64) of one head of a [B, Hkv, Lk, D] tensor at `src`
// (batch and head offsets applied); zeros past Lk.
template <int D>
__device__ void bwd_load_keys(float* dst, const float* src, long long sl,
                              int j0, int Lk) {
  for (int e = threadIdx.x; e < kBT * D; e += kThreadsBwd) {
    const int r = e / D, d = e % D, j = j0 + r;
    dst[r * bwd_ld<D>() + d] =
        j < Lk ? src[static_cast<long long>(j) * sl + d] : 0.0f;
  }
}

// s[i][j] = A[ty + 16 i] . Bm[tx + 16 j] over D, fmaf in order of d.
template <int D>
__device__ __forceinline__ void bwd_dot(const float* A, const float* Bm,
                                        float (&s)[4][4], int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      x[i] = *reinterpret_cast<const float4*>(A + (ty + 16 * i) * bwd_ld<D>() +
                                              d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      y[j] = *reinterpret_cast<const float4*>(Bm + (tx + 16 * j) * bwd_ld<D>() +
                                              d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float acc = s[i][j];
        acc = fmaf(x[i].x, y[j].x, acc);
        acc = fmaf(x[i].y, y[j].y, acc);
        acc = fmaf(x[i].z, y[j].z, acc);
        acc = fmaf(x[i].w, y[j].w, acc);
        s[i][j] = acc;
      }
  }
}

// The absolute positions of a thread's four rows ty + 16 i of the tile of
// flattened rows from f0; a row at or past `rows` gets INT_MIN (it sees no
// key).
__device__ __forceinline__ void bwd_row_pos(const BwdArgs& a, int f0, int rep,
                                            int rows, int ty, int (&ap)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int f = f0 + ty + 16 * i;
    ap[i] = f < rows ? f / rep + (a.Lk - a.Lq) : -0x7fffffff - 1;
  }
}

// Whether the row at absolute position ap sees key j (ap = INT_MIN: none).
__device__ __forceinline__ bool bwd_sees(const BwdArgs& a, int ap, int j) {
  return ap >= 0 && j < a.Lk && (!a.causal || j <= ap) &&
         (a.window <= 0 || j > ap - a.window);
}

// Whether every (row, key) pair of rows [f0, f0 + 64) and keys [j0, j0 +
// 64) is visible, so that a tile needs no mask.
__device__ __forceinline__ bool bwd_tile_full(const BwdArgs& a, int rep,
                                              int rows, int f0, int j0) {
  const int off = a.Lk - a.Lq;
  const int ap_lo = f0 / rep + off, ap_hi = (f0 + kBT - 1) / rep + off;
  return f0 + kBT <= rows && j0 + kBT <= a.Lk &&
         (!a.causal || j0 + kBT - 1 <= ap_lo) &&
         (a.window <= 0 || j0 > ap_hi - a.window);
}

// The keys [lo, hi) that any of the flattened rows [f0, f_last] sees.
__device__ __forceinline__ void bwd_keys(const BwdArgs& a, int rep, int f0,
                                         int f_last, int& lo, int& hi) {
  const int off = a.Lk - a.Lq;
  lo = a.window > 0 ? max(0, f0 / rep + off - a.window + 1) : 0;
  hi = a.causal ? min(a.Lk, f_last / rep + off + 1) : a.Lk;
}

// The (b, hk) group and the row tile of a stats or dq block: groups
// fastest, the last row tiles (which see the most keys) first.
struct BwdRowTile {
  int b, hk, rep, rows, f0, f_last;
};
__device__ __forceinline__ BwdRowTile bwd_row_tile(const BwdArgs& a) {
  BwdRowTile t;
  const int groups = a.B * a.Hkv;
  t.rep = a.H / a.Hkv;
  t.rows = t.rep * a.Lq;
  const int ntiles = (t.rows + kBT - 1) / kBT;
  const int g = blockIdx.x % groups;
  t.b = g / a.Hkv;
  t.hk = g % a.Hkv;
  t.f0 = (ntiles - 1 - static_cast<int>(blockIdx.x) / groups) * kBT;
  t.f_last = min(t.f0 + kBT, t.rows) - 1;
  return t;
}

// Index into [B, H, Lq] of flattened row f of group (b, hk).
__device__ __forceinline__ long long bwd_row(const BwdArgs& a, int b, int hk,
                                             int rep, int f) {
  return (static_cast<long long>(b) * a.H + hk * rep + f % rep) * a.Lq +
         f / rep;
}

template <int D>
__global__ void __launch_bounds__(kThreadsBwd)
    attn_bwd_stats_kernel(const BwdArgs a) {
  extern __shared__ uint4 smem_u4[];
  float* Qs = reinterpret_cast<float*>(smem_u4);
  float* Ks = Qs + kBT * bwd_ld<D>();
  const BwdRowTile t = bwd_row_tile(a);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  bwd_load_rows<D>(Qs, a.q + t.b * a.qsb, a.qsh, a.qsl, t.hk, t.rep, t.f0,
                   t.rows);
  int ap[4];
  bwd_row_pos(a, t.f0, t.rep, t.rows, ty, ap);
  int lo, hi;
  bwd_keys(a, t.rep, t.f0, t.f_last, lo, hi);
  const float c = a.scale * kLog2e;
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.0f;
  }
  const float* kh = a.k + t.b * a.ksb + t.hk * a.ksh;
  for (int j0 = lo; j0 < hi; j0 += kBT) {
    __syncthreads();
    bwd_load_keys<D>(Ks, kh, a.ksl, j0, a.Lk);
    __syncthreads();
    float s[4][4];
    bwd_dot<D>(Qs, Ks, s, ty, tx);
    const bool full = bwd_tile_full(a, t.rep, t.rows, t.f0, j0);
    // Per row: the tile's largest scaled logit of this thread's keys,
    // then the running (m, l) rescaled once; a masked logit adds 0.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float x[4], mt = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = full || bwd_sees(a, ap[i], j0 + tx + 16 * j);
        x[j] = ok ? s[i][j] * c : kNeg;
        mt = fmaxf(mt, x[j]);
      }
      const float mn = fmaxf(m[i], mt);
      float add = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        add += x[j] > kNeg ? exp2f(x[j] - mn) : 0.0f;
      l[i] = fmaf(l[i], exp2f(m[i] - mn), add);
      m[i] = mn;
    }
  }
  // Merge the 16 lanes of a row (tx) pairwise; every lane ends with the
  // same (m, l).
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int o = 1; o < 16; o <<= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[i], o);
      const float lo_ = __shfl_xor_sync(0xffffffffu, l[i], o);
      const float mm = fmaxf(m[i], mo);
      l[i] = l[i] * exp2f(m[i] - mm) + lo_ * exp2f(mo - mm);
      m[i] = mm;
    }
  }
  // Delta of each row: its D products, tx-strided, then the same merge.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int f = t.f0 + ty + 16 * i;
    float dsum = 0.0f;
    if (f < t.rows) {
      const int h = t.hk * t.rep + f % t.rep, pos = f / t.rep;
      const float* orow = a.o + t.b * a.osb + h * a.osh + pos * a.osl;
      const float* drow = a.dO + t.b * a.dsb + h * a.dsh + pos * a.dsl;
      for (int d = tx; d < D; d += 16) dsum = fmaf(drow[d], orow[d], dsum);
    }
#pragma unroll
    for (int o = 1; o < 16; o <<= 1)
      dsum += __shfl_xor_sync(0xffffffffu, dsum, o);
    if (tx == 0 && f < t.rows) {
      const long long r = bwd_row(a, t.b, t.hk, t.rep, f);
      a.lse[r] = m[i] + log2f(l[i]);
      a.delta[r] = dsum;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreadsBwd, D <= 64 ? 2 : 1)
    attn_bwd_dq_kernel(const BwdArgs a) {
  constexpr int DV = D / 16;
  extern __shared__ uint4 smem_u4[];
  float* Qs = reinterpret_cast<float*>(smem_u4);
  float* Os = Qs + kBT * bwd_ld<D>();   // dO rows
  float* Ks = Os + kBT * bwd_ld<D>();
  float* Vs = Ks + kBT * bwd_ld<D>();
  float* Ss = Vs + kBT * bwd_ld<D>();   // dS [64][65]
  const BwdRowTile t = bwd_row_tile(a);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  bwd_load_rows<D>(Qs, a.q + t.b * a.qsb, a.qsh, a.qsl, t.hk, t.rep, t.f0,
                   t.rows);
  bwd_load_rows<D>(Os, a.dO + t.b * a.dsb, a.dsh, a.dsl, t.hk, t.rep, t.f0,
                   t.rows);
  int ap[4];
  bwd_row_pos(a, t.f0, t.rep, t.rows, ty, ap);
  float lse[4], del[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int f = t.f0 + ty + 16 * i;
    const long long r = f < t.rows ? bwd_row(a, t.b, t.hk, t.rep, f) : 0;
    lse[i] = f < t.rows ? a.lse[r] : 0.0f;
    del[i] = f < t.rows ? a.delta[r] : 0.0f;
  }
  int lo, hi;
  bwd_keys(a, t.rep, t.f0, t.f_last, lo, hi);
  const float c = a.scale * kLog2e;
  float acc[4][DV];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < DV; ++e) acc[i][e] = 0.0f;
  const float* kh = a.k + t.b * a.ksb + t.hk * a.ksh;
  const float* vh = a.v + t.b * a.vsb + t.hk * a.vsh;
  for (int j0 = lo; j0 < hi; j0 += kBT) {
    __syncthreads();
    bwd_load_keys<D>(Ks, kh, a.ksl, j0, a.Lk);
    bwd_load_keys<D>(Vs, vh, a.vsl, j0, a.Lk);
    __syncthreads();
    float s[4][4], dp[4][4];
    bwd_dot<D>(Qs, Ks, s, ty, tx);
    bwd_dot<D>(Os, Vs, dp, ty, tx);
    const bool full = bwd_tile_full(a, t.rep, t.rows, t.f0, j0);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kk = tx + 16 * j;
        float ds = 0.0f;
        if (full || bwd_sees(a, ap[i], j0 + kk))
          ds = exp2f(s[i][j] * c - lse[i]) * (dp[i][j] - del[i]);
        Ss[(ty + 16 * i) * (kBT + 1) + kk] = ds;
      }
    __syncthreads();
    for (int kk = 0; kk < kBT; ++kk) {
      float w[4], kv[DV];
#pragma unroll
      for (int i = 0; i < 4; ++i) w[i] = Ss[(ty + 16 * i) * (kBT + 1) + kk];
#pragma unroll
      for (int e = 0; e < DV; ++e) kv[e] = Ks[kk * bwd_ld<D>() + tx * DV + e];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < DV; ++e) acc[i][e] = fmaf(w[i], kv[e], acc[i][e]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int f = t.f0 + ty + 16 * i;
    if (f >= t.rows) continue;
    float* out = a.dq + bwd_row(a, t.b, t.hk, t.rep, f) * D + tx * DV;
#pragma unroll
    for (int e = 0; e < DV; ++e) out[e] = acc[i][e] * a.scale;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreadsBwd, D <= 64 ? 2 : 1)
    attn_bwd_dkdv_kernel(const BwdArgs a) {
  constexpr int DV = D / 16;
  extern __shared__ uint4 smem_u4[];
  float* Ks = reinterpret_cast<float*>(smem_u4);
  float* Vs = Ks + kBT * bwd_ld<D>();
  float* Qs = Vs + kBT * bwd_ld<D>();
  float* Os = Qs + kBT * bwd_ld<D>();   // dO rows
  float* Ps = Os + kBT * bwd_ld<D>();   // P [64][65]
  float* Ss = Ps + kBT * (kBT + 1);     // dS [64][65]
  float* lse_s = Ss + kBT * (kBT + 1);
  float* del_s = lse_s + kBT;
  const int groups = a.B * a.Hkv, rep = a.H / a.Hkv, rows = rep * a.Lq;
  const int g = blockIdx.x % groups, b = g / a.Hkv, hk = g % a.Hkv;
  // Groups fastest, then runs, then key tiles in order: under a causal
  // mask the first tiles are seen by the most rows, so the blocks with
  // full runs go first.
  const int run = (static_cast<int>(blockIdx.x) / groups) % a.runs;
  const int j0 = (static_cast<int>(blockIdx.x) / groups / a.runs) * kBT;
  const int j1 = min(j0 + kBT, a.Lk);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int off = a.Lk - a.Lq;
  // The flattened rows of this run that see a key of [j0, j1).
  const int p_lo = a.causal ? max(0, j0 - off) : 0;
  const int p_hi = a.window > 0 ? min(a.Lq, j1 - 1 + a.window - off) : a.Lq;
  const int run_rows = (rows + a.runs - 1) / a.runs;
  const int f_beg = p_lo * rep + run * run_rows;
  const int f_end = min(p_hi * rep, f_beg + run_rows);
  float dk[4][DV], dv[4][DV];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < DV; ++e) {
      dk[i][e] = 0.0f;
      dv[i][e] = 0.0f;
    }
  if (f_beg < f_end) {
    bwd_load_keys<D>(Ks, a.k + b * a.ksb + hk * a.ksh, a.ksl, j0, a.Lk);
    bwd_load_keys<D>(Vs, a.v + b * a.vsb + hk * a.vsh, a.vsl, j0, a.Lk);
  }
  const float c = a.scale * kLog2e;
  for (int f0 = f_beg; f0 < f_end; f0 += kBT) {
    __syncthreads();
    bwd_load_rows<D>(Qs, a.q + b * a.qsb, a.qsh, a.qsl, hk, rep, f0, rows);
    bwd_load_rows<D>(Os, a.dO + b * a.dsb, a.dsh, a.dsl, hk, rep, f0, rows);
    if (threadIdx.x < kBT) {
      const int f = f0 + threadIdx.x;
      const long long r = f < rows ? bwd_row(a, b, hk, rep, f) : 0;
      lse_s[threadIdx.x] = f < rows ? a.lse[r] : 0.0f;
      del_s[threadIdx.x] = f < rows ? a.delta[r] : 0.0f;
    }
    __syncthreads();
    float s[4][4], dp[4][4];
    bwd_dot<D>(Qs, Ks, s, ty, tx);
    bwd_dot<D>(Os, Vs, dp, ty, tx);
    int ap[4];
    bwd_row_pos(a, f0, rep, rows, ty, ap);
    const bool full = bwd_tile_full(a, rep, rows, f0, j0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kk = tx + 16 * j;
        float p = 0.0f, ds = 0.0f;
        if (full || bwd_sees(a, ap[i], j0 + kk)) {
          p = exp2f(s[i][j] * c - lse_s[r]);
          ds = p * (dp[i][j] - del_s[r]);
        }
        Ps[r * (kBT + 1) + kk] = p;
        Ss[r * (kBT + 1) + kk] = ds;
      }
    }
    __syncthreads();
    const int nr = min(kBT, f_end - f0);
    for (int r = 0; r < nr; ++r) {
      float pw[4], sw[4], ov[DV], qv[DV];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pw[i] = Ps[r * (kBT + 1) + ty + 16 * i];
        sw[i] = Ss[r * (kBT + 1) + ty + 16 * i];
      }
#pragma unroll
      for (int e = 0; e < DV; ++e) {
        ov[e] = Os[r * bwd_ld<D>() + tx * DV + e];
        qv[e] = Qs[r * bwd_ld<D>() + tx * DV + e];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < DV; ++e) {
          dv[i][e] = fmaf(pw[i], ov[e], dv[i][e]);
          dk[i][e] = fmaf(sw[i], qv[e], dk[i][e]);
        }
    }
  }
  // One run: the gradients.  Several: this run's partial sums (zeros if
  // it saw none of the tile's keys), which the reduction adds in order.
  const long long n = static_cast<long long>(a.B) * a.Hkv * a.Lk * D;
  float* out_k = a.runs == 1 ? a.dk : a.part + run * n;
  float* out_v = a.runs == 1 ? a.dv : a.part + (a.runs + run) * n;
  const float sk = a.runs == 1 ? a.scale : 1.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int j = j0 + ty + 16 * i;
    if (j >= a.Lk) continue;
    const long long base =
        ((static_cast<long long>(b) * a.Hkv + hk) * a.Lk + j) * D + tx * DV;
#pragma unroll
    for (int e = 0; e < DV; ++e) {
      out_k[base + e] = dk[i][e] * sk;
      out_v[base + e] = dv[i][e];
    }
  }
}

// dK = scale * (sum of the runs' partials), dV = the sum, each element's
// runs added in run order.
__global__ void __launch_bounds__(kThreadsBwd)
    attn_bwd_reduce_kernel(const BwdArgs a, long long n) {
  const long long e =
      static_cast<long long>(blockIdx.x) * kThreadsBwd + threadIdx.x;
  if (e >= n) return;
  float sk = 0.0f, sv = 0.0f;
  for (int r = 0; r < a.runs; ++r) {
    sk += a.part[r * n + e];
    sv += a.part[(a.runs + r) * n + e];
  }
  a.dk[e] = sk * a.scale;
  a.dv[e] = sv;
}

template <int D>
int launch_bwd(const BwdArgs& a, cudaStream_t stream) {
  constexpr size_t tile = sizeof(float) * kBT * bwd_ld<D>();
  constexpr size_t ptile = sizeof(float) * kBT * (kBT + 1);
  constexpr size_t sm_stats = 2 * tile;
  constexpr size_t sm_dq = 4 * tile + ptile;
  constexpr size_t sm_dkdv = 4 * tile + 2 * ptile + 2 * kBT * sizeof(float);
  const int groups = a.B * a.Hkv;
  const int rtiles = ((a.H / a.Hkv) * a.Lq + kBT - 1) / kBT;
  const int ktiles = (a.Lk + kBT - 1) / kBT;
  int err = opt_in(attn_bwd_stats_kernel<D>, sm_stats);
  if (err == 0) err = opt_in(attn_bwd_dq_kernel<D>, sm_dq);
  if (err == 0) err = opt_in(attn_bwd_dkdv_kernel<D>, sm_dkdv);
  if (err != 0) return err;
  attn_bwd_stats_kernel<D><<<rtiles * groups, kThreadsBwd, sm_stats,
                             stream>>>(a);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  attn_bwd_dkdv_kernel<D><<<ktiles * a.runs * groups, kThreadsBwd, sm_dkdv,
                            stream>>>(a);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  if (a.runs > 1) {
    const long long n = static_cast<long long>(a.B) * a.Hkv * a.Lk * D;
    const int blocks = static_cast<int>((n + kThreadsBwd - 1) / kThreadsBwd);
    attn_bwd_reduce_kernel<<<blocks, kThreadsBwd, 0, stream>>>(a, n);
    err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  attn_bwd_dq_kernel<D><<<rtiles * groups, kThreadsBwd, sm_dq, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [B, H, Lq, D], k/v [B, Hkv, Lk, D] with unit stride along D and the
// given element strides for batch, head and position (a slice of a
// preallocated cache is taken as it lies); o [B, H, Lq, D] contiguous, of
// q's type (float32, or bfloat16 when q_bf16 != 0).  k and v share a type
// (bfloat16 when kv_bf16 != 0) and are read in q's type.  kl, vl: nullptr,
// or rows [B, Hkv, D] of q's type, unit stride along D, that take the
// place of key and value Lk - 1.  D in {32, 64, 128, 256}; H a multiple of
// Hkv;
// window <= 0 for none.  A group of at most 16 rows (H / Hkv * Lq) takes
// regime B with `splits` runs of keys (ops.plan_k7); with splits > 1,
// `part` is float32 scratch of B * Hkv * splits * rows * (D + 2) values
// and a second kernel merges the runs into o.  Every other call takes
// regime A and needs splits = 1.  Launches on `stream` and returns
// cudaGetLastError() (0 on success), or the error of the shared-memory
// opt-in, or cudaErrorInvalidValue for arguments it does not take.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, const void* kl,
    const void* vl, int B, int H, int Hkv, int Lq, int Lk, int D,
    long long qsb, long long qsh, long long qsl, long long ksb,
    long long ksh, long long ksl, long long vsb, long long vsh,
    long long vsl, long long klsb, long long klsh, long long vlsb,
    long long vlsh, int causal, int window, float scale, int q_bf16,
    int kv_bf16, void* part, int splits, void* stream) {
  if (Hkv <= 0 || H % Hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  if ((kl == nullptr) != (vl == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool split_regime = (H / Hkv) * static_cast<long long>(Lq) <= kRowsB;
  if (splits < 1 || (!split_regime && splits != 1) ||
      (splits > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || Lq <= 0) return static_cast<int>(cudaGetLastError());
  const int elt = kv_bf16 ? 2 : 4;
  const int vec = aligned16(k, ksb, ksh, ksl, elt) &&
                  aligned16(v, vsb, vsh, vsl, elt);
  const Args a{q, k, v, o, kl, vl, static_cast<float*>(part), B, H, Hkv, Lq,
               Lk, qsb, qsh, qsl, ksb, ksh, ksl, vsb, vsh, vsl, klsb, klsh,
               vlsb, vlsh, causal, window, scale, splits, vec};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return q_bf16 ? launch_kv<__nv_bfloat16>(a, D, kv_bf16, s)
                : launch_kv<float>(a, D, kv_bf16, s);
}

// The backward of flash_attention_launch's function for float32 q [B, H,
// Lq, D], k, v [B, Hkv, Lk, D], the forward's output o [B, H, Lq, D] and
// its gradient dO [B, H, Lq, D], each with unit stride along D and the
// given element strides for batch, head and position: writes dq [B, H,
// Lq, D] and dk, dv [B, Hkv, Lk, D], contiguous float32, the same causal
// mask, window (<= 0 for none) and right-aligned queries (Lq <= Lk) as
// the forward.  `stats` is float32 scratch of 2 * B * H * Lq values;
// `runs` >= 1 the dk/dv pass's runs of rows, ceil(H / Hkv * Lq / runs)
// rows each (ops.plan_k7_bwd), and with runs > 1 `part` float32 scratch
// of 2 * runs * B * Hkv * Lk * D values.  D in {32, 64, 128}; H a
// multiple of Hkv.
// Three or four launches on `stream`; returns cudaGetLastError() (0 on
// success), the error of a shared-memory opt-in, or cudaErrorInvalidValue
// for arguments it does not take.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dO, void* dq, void* dk, void* dv, void* stats, void* part,
    int runs, int B, int H, int Hkv, int Lq, int Lk, int D, long long qsb,
    long long qsh, long long qsl, long long ksb, long long ksh,
    long long ksl, long long vsb, long long vsh, long long vsl,
    long long osb, long long osh, long long osl, long long dsb,
    long long dsh, long long dsl, int causal, int window, float scale,
    void* stream) {
  if (Hkv <= 0 || H % Hkv != 0 || Lq > Lk || stats == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (runs < 1 || (runs > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || Lq <= 0) return static_cast<int>(cudaGetLastError());
  float* st = static_cast<float*>(stats);
  const long long n = static_cast<long long>(B) * H * Lq;
  const BwdArgs a{static_cast<const float*>(q), static_cast<const float*>(k),
                  static_cast<const float*>(v), static_cast<const float*>(o),
                  static_cast<const float*>(dO), static_cast<float*>(dq),
                  static_cast<float*>(dk), static_cast<float*>(dv), st,
                  st + n, static_cast<float*>(part), B, H, Hkv, Lq, Lk, qsb,
                  qsh, qsl, ksb, ksh, ksl, vsb, vsh, vsl, osb, osh, osl, dsb,
                  dsh, dsl, causal, window, scale, runs};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch_bwd<32>(a, s);
    case 64: return launch_bwd<64>(a, s);
    case 128: return launch_bwd<128>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
