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
//    terms first.  The tensor cores' float32 accumulation truncates, so
//    P V sums each key tile into partials that start at zero, and each
//    lands in the output's accumulator as one fmaf, acc corr + partial,
//    rounded to nearest (a running accumulator over every key tile
//    biased o towards zero).  A bfloat16 value is exact in TF32: its lo
//    is 0, and the
//    MMAs that would carry it are not issued (a bf16 q drops lo_q hi_k;
//    k and v read as bf16, without a float32 last row, drop hi_q lo_k and
//    hi_p lo_v).  The bound of this route is 3 x the flops at 495 T op/s
//    (104 us at tinyllama's prefill).  A block is 4 warps and 64 rows;
//    each warp runs its 16 x 32 logits tile and its 16 x D accumulator as
//    MMA fragments.  Q's hi and lo fragments are made once a block
//    (hi in registers at D <= 64, the rest a lane-private copy in shared
//    memory, read back each key tile).  K and V come in tiles of 32 keys
//    (a 68.1 KB block at D = 64 and at most 168 registers a thread, so
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
// Under grad, regime A also writes each row's log2-sum-exp (`lse`, m +
// log2(l) of the online softmax) for the backward, at any group size, and
// for a bf16 q its output unrounded in float32 beside the bf16 one;
// without them a call runs exactly as above.  The backward
// (flash_attention_bwd_launch: float32 at every head width, bf16 at D <=
// 128) is three or four more kernels at the end of this file, with tiles
// of their own at D = 256; its note is there.
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
  float* lse;  // nullptr, or [B, H, Lq]: each row's log2-sum-exp (regime A)
  float* o32;  // nullptr, or [B, H, Lq, D]: o in float32 (regime A, lse)
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

// c = A B, TF32 in, float32 out: mma_tf32 into an accumulator of zeros,
// given as an input operand of its own, so that a partial needs no
// registers zeroed before its first product.
__device__ __forceinline__ void mma_tf32_z(float (&c)[4],
                                           const uint32_t (&a)[4],
                                           uint32_t b0, uint32_t b1) {
#ifdef __CUDA_ARCH__
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.0f), "f"(0.0f), "f"(0.0f), "f"(0.0f));
#else
  for (int i = 0; i < 4; ++i) c[i] = 0.0f;
  mma_tf32(c, a, b0, b1);
#endif
}

// 2^x as ex2.approx.ftz.f32 (a few ulp; a subnormal result is 0), which
// exp2f wraps in a range reduction P's arguments (<= 0) do not need: the
// prefill 2-4 % faster at D = 64 / 128 (tools/ablate_flash_attention.py,
// variant exp2f, on an H100 80GB HBM3 at 700 W).
__device__ __forceinline__ float ex2(float x) {
#ifdef __CUDA_ARCH__
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
#else
  return exp2f(x);
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

// Two consecutive float32 values stored as E (rounded once to bf16).
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
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

// Q's lane-private fragments: hi and lo at D > 64, lo alone at D <= 64
// (hi in registers there).
template <typename TKV, int D>
__host__ __device__ constexpr size_t smem_a() {
  return bka<D>() * (2 * D * sizeof(TKV) +
                     (ksp_stride<D>() + vsp_stride<D>()) * 4) +
         (D > 64 ? 2 : 1) * (D / 8) * kThreadsA * sizeof(uint4);
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

// kLse: also write each row's log2-sum-exp to a.lse (a grad call); the
// instantiation without it is the serving path's, untouched by the write.
template <typename TQ, typename TKV, int D, bool kLse>
__global__ void __launch_bounds__(kThreadsA, D <= 64 ? 3 : 1)
attn_tc_kernel(const Args a) {
  constexpr int BK = bka<D>();                         // keys a tile
  constexpr int NT = BK / 8;                           // key fragments
  constexpr bool kLoQ = sizeof(TQ) == 4;               // q has a lo part
  constexpr bool kQReg = D <= 64;                      // Q's hi in registers
  constexpr int NC = D > 128 ? 16 : 4;                 // o's tiles a chunk
  constexpr int KSP = ksp_stride<D>(), VSP = vsp_stride<D>();
  constexpr int NS = D / 8;                            // k-steps over d
  constexpr int NN = D / 8;                            // 8-column tiles of o
  extern __shared__ uint4 smem_u4[];
  uint32_t* Ksp = reinterpret_cast<uint32_t*>(smem_u4);  // [BK][KSP]
  uint32_t* Vsp = Ksp + BK * KSP;                        // [BK][VSP]
  TKV* Kr = reinterpret_cast<TKV*>(Vsp + BK * VSP);      // [BK][D]
  TKV* Vr = Kr + BK * D;                                 // [BK][D]
  uint4* Qf = reinterpret_cast<uint4*>(Vr + BK * D);     // Q's fragments

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
  // columns t) and 8s + 2t + 1 (columns t + 4) of rows g and g + 8.  At
  // D <= 64 hi stays in registers and lo goes to shared memory, which
  // leaves the registers for P V's partials (three blocks an SM).
  uint32_t qh[kQReg ? NS : 1][4];
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
      for (int i = 0; i < 4; ++i) qh[s][i] = h4[i];
      Qf[s * kThreadsA + tid] = make_uint4(l4[0], l4[1], l4[2], l4[3]);
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
        for (int i = 0; i < 4; ++i) ah[i] = qh[ks][i];
        if (kLoQ) {
          const uint4 lv = Qf[ks * kThreadsA + tid];
          al[0] = lv.x; al[1] = lv.y; al[2] = lv.z; al[3] = lv.w;
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
        s[n][c] = ok ? ex2(s[n][c] - m[c >> 1]) : 0.0f;   // p
        sum[c >> 1] += s[n][c];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
      l[i] = l[i] * corr[i] + sum[i];
    }

    // O = O corr + P V: k-step j takes keys 8j + 2t (A columns t) and 8j +
    // 2t + 1 (columns t + 4), which are the logits fragment's own columns.
    // The key tile's P V goes into partials that start at zero, NC
    // 8-column tiles of o at a time (a chunk), and each lands in acc by one
    // fmaf, acc corr + partial, rounded to nearest (the rescale's multiply
    // and the add in one instruction): the tensor cores' float32
    // accumulation drops low bits towards zero, and chained into acc
    // across every key tile it shrank o (F7: a mean signed error of -9.1e-6
    // of |o| at whisper-base's cross-attention, tools/k7_output_bias.py);
    // a partial of one tile's keys loses bits of its own size only.  The
    // k-steps stay outer, so consecutive MMAs go to different partials;
    // P is split again for each chunk.  A warp issues in order, so each
    // chunk's landing waits for its last products: chunks of 4 tiles cost
    // nothing measurable at D <= 128, and at D = 256 (one warp a
    // scheduler, 16-key tiles) chunks of 16 lost least, 15 % against the
    // running accumulator (chunks of 4, 8 and 16 and the running order
    // timed with tools/ablate_flash_attention.py on an H100 80GB HBM3 at
    // 700 W).
#pragma unroll
    for (int n0 = 0; n0 < NN; n0 += NC) {
      float c[NC][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t ph[4], pl[4];
        split(s[j][0], ph[0], pl[0]);
        split(s[j][2], ph[1], pl[1]);
        split(s[j][1], ph[2], pl[2]);
        split(s[j][3], ph[3], pl[3]);
        const uint32_t* v0 = Vsp + (8 * j + 2 * t) * VSP + 2 * g + 16 * n0;
#pragma unroll
        for (int n = 0; n < NC; ++n) {
          const uint2 b0 = *reinterpret_cast<const uint2*>(v0 + 16 * n);
          const uint2 b1 = *reinterpret_cast<const uint2*>(v0 + VSP + 16 * n);
          if (j == 0)
            mma_tf32_z(c[n], pl, b0.x, b1.x);
          else
            mma_tf32(c[n], pl, b0.x, b1.x);
          if (lo_kv) mma_tf32(c[n], ph, b0.y, b1.y);
          mma_tf32(c[n], ph, b0.x, b1.x);
        }
      }
#pragma unroll
      for (int n = 0; n < NC; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[n0 + n][e] = fmaf(acc[n0 + n][e], corr[e >> 1], c[n][e]);
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
  // Under grad with a bf16 q: o also unrounded in float32, for the
  // backward's Delta; the bf16 output above is it rounded once.
  if (kLse && a.o32 != nullptr) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (fr[i] >= rows) continue;
      const int h = hk * rep + fr[i] % rep, pos = fr[i] / rep;
      const float inv_l = 1.0f / fmaxf(l[i], 1e-30f);
      float* orow =
          a.o32 + ((static_cast<long long>(b) * a.H + h) * a.Lq + pos) * D;
#pragma unroll
      for (int n = 0; n < NN; ++n)
        store2(orow + 8 * n + 2 * t, acc[n][2 * i] * inv_l,
               acc[n][2 * i + 1] * inv_l);
    }
  }
  // Under grad: each row's log2-sum-exp of its scaled logits, m + log2(l)
  // (the quad's four lanes hold the same m and l), for the backward.
  if (kLse && t == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (fr[i] >= rows) continue;
      const int h = hk * rep + fr[i] % rep, pos = fr[i] / rep;
      a.lse[(static_cast<long long>(b) * a.H + h) * a.Lq + pos] =
          m[i] + log2f(l[i]);
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

template <typename TQ, typename TKV, int D, bool kLse>
int launch_tc(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = smem_a<TKV, D>();
  auto kern = attn_tc_kernel<TQ, TKV, D, kLse>;
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
  if (a.lse != nullptr) {
    // Built for what the backward takes only: q, k, v of one type,
    // float32 at every width, bf16 at D <= 128.
    if constexpr (sizeof(TQ) == sizeof(TKV) && (sizeof(TQ) == 4 || D <= 128))
      return launch_tc<TQ, TKV, D, true>(a, stream);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows <= 8) return launch_split<TQ, TKV, D, 8>(a, stream);
  if (rows <= kRowsB) return launch_split<TQ, TKV, D, 16>(a, stream);
  return launch_tc<TQ, TKV, D, false>(a, stream);
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
//   dV = P^T dO,  dP = dO V^T,  Delta = rowsum(P * dP) = rowsum(dO * o),
//   dS = P * (dP - Delta),  dQ = scale dS K,  dK = scale dS^T Q,
// dK and dV summed over the rep query heads of each key/value head.  The
// reference's Pallas kernel has no custom_vjp, so there is no TPU
// backward to replace: the reference trains through its jnp attention,
// and this backward lets the port train through K7.  Float32 operands, or
// bf16 ones (below), no atomics and a fixed order of every sum, so two
// calls give the same bits.  P is recomputed from the log2-sum-exp that the forward wrote
// under grad (regime A's `lse`): P = 2^(s * scale * log2(e) - lse).
//
// Bound on this card: 10 * D flops an unmasked (query, key) pair (q.k,
// dO.v, P^T dO, dS K, dS^T Q) against q, k, v, o, dO read and dq, dk, dv
// written once, so arithmetic.  A float32-accurate product runs fastest
// as three TF32 MMAs (lo.hi + hi.lo + hi.hi, small terms first, as the
// forward's `split` and `mma_tf32`; 495 T op/s, 165 effective): 260.6 us
// at tinyllama-1.1b's prefill, 1042.2 us at qwen3-moe's (D = 128).  These
// passes do 14 * D, every product so on the tensor cores: dQ is reduced
// over keys and dK, dV over rows, and without atomics each needs its own
// pass, so the dq pass forms the logits and dO V^T once more.
//   1. Delta: each row's lse and Delta = rowsum(dO * o), staged as
//      (lse, Delta) pairs in the group-major order of flattened rows that
//      the passes read (`stats`, each group's rows padded to a multiple
//      of 64 with zeros).  An error of Delta does not cancel in dQ =
//      scale sum_j dS_ij K_j (whose dS_ij sum to zero over j when Delta is
//      that of the same P and dP), so o must be unbiased: the forward adds
//      each key tile's tensor-core partial with a rounding add (regime A).
//      With o from a running tensor-core accumulator (a mean signed error
//      of -9.1e-6 of |o| at whisper-base's cross-attention,
//      tools/k7_output_bias.py on an H100 80GB HBM3 at 700 W), a
//      projection's gradient in chip_smoke.py phase 27's whisper-base
//      train-step copy was 1.4e-4 of its largest value off the CPU's (the
//      gate is 1e-4).
//   2. dk/dv: a block per (b, hk, tile of 64 keys, run of up to
//      ceil(rep * Lq / runs) flattened rows, `runs` as ops.plan_k7_bwd
//      plans them) walks the rows of its run that see any of its keys, BR
//      rows a tile.  A warp owns 16 keys, as the forward's warps own 16
//      rows: S^T = K_w Q^T and dP^T = V_w dO^T as MMA C fragments, P^T =
//      2^(S^T c - lse) and dS^T = P^T (dP^T - Delta) in place, then the
//      same values as A fragments of dV += P^T dO and dK += dS^T Q (the
//      forward's permuted reduction index: C fragment to A fragment with
//      no shuffle).  dK and dV stay in registers.  Under a causal mask
//      every row sees the first key tiles, so the rows are cut into runs
//      of equal length; with one run a block writes dK, dV, with more each
//      run writes its partial sums to a scratch slot (zeros for a run that
//      sees none of the tile's keys) and
//   3. a reduction adds the runs' partials in run order;
//   4. dq: a block per (b, hk, tile of 64 flattened rows), the last row
//      tiles first, walks the keys its rows see, 32 a tile: S = Q_w K^T,
//      dP = dO_w V^T, dS in place, dQ += dS K.
// Rows are flattened position-major as in the forward (row f is position
// f / rep of head hk * rep + f % rep).  Masks are evaluated only on tiles
// that cross the causal diagonal, a window edge or a ragged end; rows
// outside a block's run and keys past Lk are zeros in its tiles.
//
// Operand layout.  Q and dO are the B operand of a product reduced over D
// (S^T, dP^T: lane (g, t) reads elements 2t, 2t + 1 of row g) and of one
// reduced over rows (dK, dV: element g of rows 2t and 2t + 1); so is K in
// the dq pass.  One split tile serves both: row r of D values as D / 2
// chunks of 16 bytes, chunk c = {hi(2c), lo(2c), hi(2c + 1), lo(2c + 1)}
// at slot c ^ sw(r), sw(r) = 2 ((r >> 1) & 3) ^ 4 (r & 1), rows unpadded.
// A quarter warp's 16-byte reads of rows r, r + 1 then fill the two halves
// of the banks, and a half warp's 8-byte reads of rows 2t land on eight
// distinct slots: no bank conflict either way (with the rows in order, no
// padding serves both: the first wants 16 words mod 32, the second 4 mod
// 16, and a padding costs two blocks an SM at D = 64).  The A fragments
// (K_w, V_w; Q_w, dO_w) are read from the same tiles, two 16-byte loads a
// k-step; each lane's offsets into them are worked out once (StLane), so
// a load is a register plus a constant (the swizzle computed at every
// load cost 7 % at D = 128 on an H100: tools/ablate_flash_attention.py
// --backward).  Q and dO rows (dk/dv) or K and V rows (dq) land raw by
// 16-byte cp.async one tile ahead and are split once a block, as in the
// forward.  Shared memory and registers: at D <= 64 a block is 4 warps
// and two fit an SM (115 328 B at D = 64, the most two blocks may take).
// At D = 128 the tiles take 224 KB and a warp's dK, dV accumulators 128
// registers, so two warps share each 16-key (16-row) group, each taking
// half of the row (key) tile, and add their sums in a fixed order at the
// end: one block of 8 warps an SM, as many warps as two 4-warp blocks.
//
// D = 256 (recurrentgemma-2b) has passes of its own ("wide").  A 64-key
// K, V split tile alone would take 256 KB, a 64-row Q, dO one as much, and
// a warp's 16 x 256 dK and dV accumulators 256 registers.  So D is split:
// 8 warps, warp w takes the 16 keys (dk/dv) or 16 rows (dq) w / 4 of the
// block's 32 and the quarter w % 4 of D (64 columns).  A warp's products
// reduced over D (S^T and dP^T, or S and dP) cover its quarter only: the
// four quarters' partial C fragments go through shared memory and every
// warp adds them in quarter order, so the four hold the same sums; P and
// dS follow in place, and the products reduced over rows (keys) add into
// the warp's 16 x 64 accumulators of its quarter (64 registers for dK and
// dV, 32 for dQ).  The block's own operand (K, V for dk/dv; Q, dO for dq)
// is split once into the swizzled split tiles above.  The operand it
// walks (Q, dO rows; K, V keys) comes 16 rows (keys) a tile, by 16-byte
// cp.async into one of two raw float32 tiles while the other is computed
// on, and is split into hi and lo parts as each fragment is read: no
// split pass and one barrier less a tile (the raw tiles' own swizzle is
// at raw_pair).  A tile costs two block barriers (one for the copies,
// one for the quarters' sums).  Shared memory: 213 248 B (dk/dv) and 212
// 992 B (dq), one 8-warp block an SM; the dk/dv pass cuts the rows into
// runs of at most 4 096 (ops.plan_k7_bwd).  Tiles of 16 walked by a
// block of 16 (and a split pass) took 28.2 ms at recurrentgemma-2b's
// prefill, tiles of 32 walked by 16 without the split pass 19.9 ms, and
// this design 16.7-16.9 ms (tools/ablate_flash_attention.py --backward,
// paired, on an H100 80GB HBM3 at 700 W): a block of 32 halves the
// walked operand's traffic from L2.
// Head widths 32, 64, 128 and 256.
//
// bf16 operands (q, k, v and dO bf16) at D <= 128 have passes of their
// own, built for the bf16 tensor cores; their note follows the D = 256
// passes.

constexpr int kBwdKeys = 64;       // dk/dv: keys a block, 16 a warp group
constexpr int kBwdRows = 64;       // dq: rows a block, 16 a warp group
constexpr int kBwdBK = 32;         // dq: keys a tile
constexpr int kBwdAux = 256;       // threads of the Delta and sum kernels

// Warps sharing one 16-key (dk/dv) or 16-row (dq) group.
template <int D>
__host__ __device__ constexpr int bwd_pair() { return D > 64 ? 2 : 1; }
template <int D>
__host__ __device__ constexpr int bwd_threads() { return 128 * bwd_pair<D>(); }
// dk/dv: rows a tile.
template <int D>
__host__ __device__ constexpr int bwd_br() { return D > 32 ? 32 : 64; }

// K, V split (64 keys), Q, dO split and raw (BR rows), raw and current
// (lse, Delta) and the positions of the BR rows.
template <int D>
__host__ __device__ constexpr size_t smem_bwd_dkdv() {
  return 2 * kBwdKeys * D * 8 + 2 * bwd_br<D>() * D * 12 +
         bwd_br<D>() * (2 * sizeof(float2) + sizeof(int));
}
// Q, dO split (64 rows), K, V split and raw (32 keys).
template <int D>
__host__ __device__ constexpr size_t smem_bwd_dq() {
  return 2 * kBwdRows * D * 8 + 2 * kBwdBK * D * 12;
}

struct BwdArgs {
  const float* q;
  const float* k;
  const float* v;
  const float* dO;
  const float* o;    // [B, H, Lq, D]: the forward's output
  const float* lse;  // [B, H, Lq]: the forward's log2-sum-exp
  float* dq;         // [B, H, Lq, D] contiguous
  float* dk;         // [B, Hkv, Lk, D] contiguous
  float* dv;
  float2* stats;     // [B * Hkv][rows_pad]: (lse, Delta) of flattened rows
  float* part;       // runs > 1: [2, runs, B, Hkv, Lk, D] partial dK, dV
  int B, H, Hkv, Lq, Lk, rows_pad;
  long long qsb, qsh, qsl, ksb, ksh, ksl, vsb, vsh, vsl, dsb, dsh, dsl;
  long long osb, osh, osl;
  int causal, window;  // window <= 0: none
  float scale;
  int runs;  // dk/dv: runs of ceil(rep * Lq / runs) flattened rows
};

// Copies 8 bytes from global to shared memory (cp.async).
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
#ifdef __CUDA_ARCH__
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
               "l"(src)
               : "memory");
#else
  *static_cast<uint2*>(dst) = *static_cast<const uint2*>(src);
#endif
}

// The uint4 slot of chunk c (elements 2c, 2c + 1) of row r of a split tile.
template <int D>
__device__ __forceinline__ int st_slot(int r, int c) {
  return r * (D / 2) + (c ^ ((((r >> 1) & 3) << 1) ^ ((r & 1) << 2)));
}

// Lane (g, t)'s offsets into the split tiles, so that every fragment load
// is a base register plus a constant (no swizzle arithmetic in the loops).
// The lane reads (1) chunk 4s + t of row g of an 8-row group: with sw(g) =
// 4h + l, slot (4s + t) ^ sw(g) = 4s + (t ^ l) + 4h for even s and 8h
// less for odd s; and (2) element 8m + g of row 2t + e of a group: with H
// = (t >> 1) ^ e, its uint2 is 8m + (2t + e) D + (g & 3) + 4 ((g >> 2) ^
// (t & 1)) + 8H for even m and 16H less for odd m.
template <int D>
struct StLane {
  int p1e, p1o;              // (1), uint4 units: even and odd s
  int p20e, p20o, p21e, p21o;  // (2), uint2 units: e = 0, 1; even, odd m
  __device__ __forceinline__ StLane(int g, int t) {
    const int sw = (((g >> 1) & 3) << 1) ^ ((g & 1) << 2);
    const int h = sw >> 2, h0 = t >> 1, h1 = h0 ^ 1;
    const int col = (g & 3) + 4 * ((g >> 2) ^ (t & 1));
    p1e = g * (D / 2) + (t ^ (sw & 3)) + 4 * h;
    p1o = p1e - 8 * h;
    p20e = 2 * t * D + col + 8 * h0;
    p20o = p20e - 16 * h0;
    p21e = (2 * t + 1) * D + col + 8 * h1;
    p21o = p21e - 16 * h1;
  }
  // Elements (r0 + g, 8s + 2t) and (r0 + g, 8s + 2t + 1), r0 a multiple
  // of 8: {hi, lo, hi, lo}.
  __device__ __forceinline__ uint4 pair(const uint4* T, int r0,
                                        int s) const {
    return T[r0 * (D / 2) + ((s & 1) ? p1o : p1e) + 4 * s];
  }
  // Element (r0 + 2t + e, 8m + g), r0 a multiple of 8: {hi, lo}.
  __device__ __forceinline__ uint2 one(const uint4* T, int r0, int e,
                                       int m) const {
    const int b = e ? ((m & 1) ? p21o : p21e) : ((m & 1) ? p20o : p20e);
    return reinterpret_cast<const uint2*>(T)[r0 * D + b + 8 * m];
  }
};

// Values (r, d .. d + 3), d a multiple of 4, split into a tile.
template <int D>
__device__ __forceinline__ void st_put4(uint4* T, int r, int d, float4 x) {
  uint32_t h0, l0, h1, l1, h2, l2, h3, l3;
  split(x.x, h0, l0);
  split(x.y, h1, l1);
  split(x.z, h2, l2);
  split(x.w, h3, l3);
  T[st_slot<D>(r, d >> 1)] = make_uint4(h0, l0, h1, l1);
  T[st_slot<D>(r, (d >> 1) + 1)] = make_uint4(h2, l2, h3, l3);
}

// The A fragment of k-step s of rows r0 + g and r0 + g + 8: columns t and
// t + 4 hold d = 8s + 2t and 8s + 2t + 1 (the permuted reduction index).
template <int D>
__device__ __forceinline__ void st_afrag(const StLane<D>& L, const uint4* T,
                                         int r0, int s, uint32_t (&ah)[4],
                                         uint32_t (&al)[4]) {
  const uint4 x = L.pair(T, r0, s);
  const uint4 y = L.pair(T, r0 + 8, s);
  ah[0] = x.x; al[0] = x.y; ah[2] = x.z; al[2] = x.w;
  ah[1] = y.x; al[1] = y.y; ah[3] = y.z; al[3] = y.w;
}

// c += a b, float32-accurate: lo_a hi_b + hi_a lo_b + hi_a hi_b.
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t b0h,
                                     uint32_t b1h, uint32_t b0l,
                                     uint32_t b1l) {
  mma_tf32(c, al, b0h, b1h);
  mma_tf32(c, ah, b0l, b1l);
  mma_tf32(c, ah, b0h, b1h);
}

// c += a b as a partial that starts at zero and is added to c with a
// float32 add that rounds to nearest: the tensor cores' float32
// accumulation drops low bits towards zero, and chained into dQ (or, at
// D = 256, dK and dV) over every walked fragment it biased them towards
// zero (as it did o, F7); a partial of one fragment's 8 keys or rows
// loses bits of its own size only.
__device__ __forceinline__ void mma3_add(float (&c)[4],
                                         const uint32_t (&ah)[4],
                                         const uint32_t (&al)[4],
                                         uint32_t b0h, uint32_t b1h,
                                         uint32_t b0l, uint32_t b1l) {
  float p[4];
  mma_tf32_z(p, al, b0h, b1h);
  mma_tf32(p, ah, b0l, b1l);
  mma_tf32(p, ah, b0h, b1h);
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] += p[e];
}

// A C fragment split into the A fragment of a product reduced over its
// columns: A columns t and t + 4 are the C fragment's columns 2t, 2t + 1.
__device__ __forceinline__ void c_to_a(const float (&c)[4], uint32_t (&ah)[4],
                                       uint32_t (&al)[4]) {
  split(c[0], ah[0], al[0]);
  split(c[2], ah[1], al[1]);
  split(c[1], ah[2], al[2]);
  split(c[3], ah[3], al[3]);
}

// Rows [0, n) of a split tile from row(r), a row pointer or nullptr (a
// row of zeros), read directly.
template <int D, int NT, typename Row>
__device__ __forceinline__ void bwd_load_split(uint4* T, int n, Row row) {
  for (int idx = threadIdx.x; idx < n * (D / 4); idx += NT) {
    const int r = idx / (D / 4), d = (idx % (D / 4)) * 4;
    const float* p = row(r);
    const float4 x = p != nullptr ? *reinterpret_cast<const float4*>(p + d)
                                  : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    st_put4<D>(T, r, d, x);
  }
}

// Enqueues (cp.async) the rows r of [0, n) for which row(r) is not
// nullptr into the raw tile [n][D].
template <int D, int NT, typename Row>
__device__ __forceinline__ void bwd_issue(float* raw, int n, Row row) {
  for (int idx = threadIdx.x; idx < n * (D / 4); idx += NT) {
    const int r = idx / (D / 4), e = (idx % (D / 4)) * 4;
    const float* p = row(r);
    if (p != nullptr) cp_async16(raw + r * D + e, p + e);
  }
}

// The split pass: raw rows [0, n) into a split tile, zeros where !ok(r).
template <int D, int NT, typename Ok>
__device__ __forceinline__ void bwd_split(uint4* T, const float* raw, int n,
                                          Ok ok) {
  for (int idx = threadIdx.x; idx < n * (D / 4); idx += NT) {
    const int r = idx / (D / 4), d = (idx % (D / 4)) * 4;
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (ok(r)) x = *reinterpret_cast<const float4*>(raw + r * D + d);
    st_put4<D>(T, r, d, x);
  }
}

// Whether the row at absolute position ap sees key j.
__device__ __forceinline__ bool bwd_sees(const BwdArgs& a, int ap, int j) {
  return j < a.Lk && (!a.causal || j <= ap) &&
         (a.window <= 0 || j > ap - a.window);
}

// Whether rows at absolute positions [p0, p1] see every key of [j0, j0 +
// n): no mask needed.
__device__ __forceinline__ bool bwd_full(const BwdArgs& a, int p0, int p1,
                                         int j0, int n) {
  return j0 + n <= a.Lk && (!a.causal || j0 + n - 1 <= p0) &&
         (a.window <= 0 || j0 > p1 - a.window);
}

// Row f of a group (b, hk) of a [B, H, Lq, D] tensor at `base` (batch
// applied) with head and position strides sh, sl.
template <typename E>
__device__ __forceinline__ const E* bwd_qrow(const E* base, long long sh,
                                             long long sl, int hk, int rep,
                                             int f) {
  return base + (hk * rep + f % rep) * sh +
         static_cast<long long>(f / rep) * sl;
}

// The pair reduction at D = 128: the warp of half 1 leaves its sums in
// `red` (shared memory the tiles no longer need, 4 * 32 slots a value),
// the warp of half 0 adds them to its own, in that order.
template <int N>
__device__ __forceinline__ void bwd_pair_sum(float (&x)[N][4], float* red,
                                             int group, int half, int lane) {
  const int slot = group * 32 + lane;
  __syncthreads();   // every warp is done with the tiles
  if (half == 1) {
#pragma unroll
    for (int m = 0; m < N; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) red[(m * 4 + e) * 128 + slot] = x[m][e];
  }
  __syncthreads();
  if (half == 0) {
#pragma unroll
    for (int m = 0; m < N; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        x[m][e] = x[m][e] + red[(m * 4 + e) * 128 + slot];
  }
}

// Each flattened row's (lse, Delta) at stats[(b * Hkv + hk) * rows_pad +
// f], zeros for f >= rep * Lq: the forward's lse, and Delta = rowsum(dO *
// o) of the forward's float32 output o (unrounded also when the operands
// are bf16: a Delta from the bf16 output would carry its 2^-9 rounding
// into every dS) and dO of the operands' type TO, widened, summed in
// float32 in a fixed order: L = min(D / 4, 32) lanes a row, each adding
// the products of its D / (4 L) pieces of four in order, then a shuffle
// tree over the L lanes.  One read of o and dO.
template <typename TO, int D>
__global__ void __launch_bounds__(kBwdAux)
    attn_bwd_delta_kernel(const BwdArgs a) {
  constexpr int L = D / 4 < 32 ? D / 4 : 32;   // lanes a row
  constexpr int NV = D / (4 * L);              // pieces of four a lane
  const int rep = a.H / a.Hkv, rows = rep * a.Lq;
  const long long n = static_cast<long long>(a.B) * a.Hkv * a.rows_pad;
  const long long i = static_cast<long long>(blockIdx.x) * (kBwdAux / L) +
                      threadIdx.x / L;
  const int lane = threadIdx.x % L;
  const int grp = static_cast<int>(i / a.rows_pad);
  const int f = static_cast<int>(i % a.rows_pad);
  float sum = 0.0f, lse = 0.0f;
  if (i < n && f < rows) {
    const int b = grp / a.Hkv, hk = grp % a.Hkv;
    const float* orow = bwd_qrow(a.o + b * a.osb, a.osh, a.osl, hk, rep, f);
    const TO* drow = bwd_qrow(reinterpret_cast<const TO*>(a.dO) + b * a.dsb,
                              a.dsh, a.dsl, hk, rep, f);
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int d = 4 * (lane + L * j);
      const float4 x = *reinterpret_cast<const float4*>(orow + d);
      float y[4];
      load4(drow + d, y);
      sum = fmaf(x.x, y[0], sum);
      sum = fmaf(x.y, y[1], sum);
      sum = fmaf(x.z, y[2], sum);
      sum = fmaf(x.w, y[3], sum);
    }
    if (lane == 0) {
      const int h = hk * rep + f % rep, pos = f / rep;
      lse = a.lse[(static_cast<long long>(b) * a.H + h) * a.Lq + pos];
    }
  }
#pragma unroll
  for (int w = 1; w < L; w <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, w);
  if (i < n && lane == 0) a.stats[i] = make_float2(lse, sum);
}

template <int D>
__global__ void __launch_bounds__(bwd_threads<D>(), D <= 64 ? 2 : 1)
    attn_bwd_dkdv_kernel(const BwdArgs a) {
  constexpr int P = bwd_pair<D>(), NT = bwd_threads<D>(), BR = bwd_br<D>();
  constexpr int NS = D / 8;          // k-steps over d; 8-column tiles of dK
  constexpr int NTW = BR / 8 / P;    // 8-row tiles of a row tile a warp takes
  static_assert(P == 1 || 2 * NS * 4 * 128 * 4 <= 2 * BR * D * 8,
                "the pair sums fit the row tiles");
  extern __shared__ uint4 smem_u4[];
  uint4* Ks = smem_u4;                                   // [64][D] split
  uint4* Vs = Ks + kBwdKeys * D / 2;
  uint4* Qs = Vs + kBwdKeys * D / 2;                     // [BR][D] split
  uint4* Os = Qs + BR * D / 2;                           // dO
  float* Qr = reinterpret_cast<float*>(Os + BR * D / 2);  // [BR][D] raw
  float* Or = Qr + BR * D;
  float2* Sr = reinterpret_cast<float2*>(Or + BR * D);   // [BR] raw stats
  float2* Sc = Sr + BR;                                  // [BR] the tile's
  int* Pc = reinterpret_cast<int*>(Sc + BR);             // [BR] positions

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kw = warp / P, half = warp % P;
  const int groups = a.B * a.Hkv, rep = a.H / a.Hkv, rows = rep * a.Lq;
  const int grp = blockIdx.x % groups, b = grp / a.Hkv, hk = grp % a.Hkv;
  // Groups fastest, then runs, then key tiles in order: under a causal
  // mask the first tiles are seen by the most rows, so the blocks with
  // full runs go first.
  const int run = (static_cast<int>(blockIdx.x) / groups) % a.runs;
  const int j0 = (static_cast<int>(blockIdx.x) / groups / a.runs) * kBwdKeys;
  const int j1 = min(j0 + kBwdKeys, a.Lk);
  const int off = a.Lk - a.Lq;
  // The flattened rows of this run that see a key of [j0, j1).
  const int p_lo = a.causal ? max(0, j0 - off) : 0;
  const int p_hi = a.window > 0 ? min(a.Lq, j1 - 1 + a.window - off) : a.Lq;
  const int run_rows = (rows + a.runs - 1) / a.runs;
  const int f_beg = p_lo * rep + run * run_rows;
  const int f_end = min(p_hi * rep, f_beg + run_rows);
  const float* qb = a.q + b * a.qsb;
  const float* ob = a.dO + b * a.dsb;
  const float2* sb = a.stats + static_cast<long long>(grp) * a.rows_pad;

  // Rows [f0, f0 + BR) of the run: Q, dO and (lse, Delta) by cp.async.
  auto issue = [&](int f0) {
    bwd_issue<D, NT>(Qr, BR, [&](int r) -> const float* {
      return f0 + r < f_end ? bwd_qrow(qb, a.qsh, a.qsl, hk, rep, f0 + r)
                            : nullptr;
    });
    bwd_issue<D, NT>(Or, BR, [&](int r) -> const float* {
      return f0 + r < f_end ? bwd_qrow(ob, a.dsh, a.dsl, hk, rep, f0 + r)
                            : nullptr;
    });
    for (int r = tid; r < BR; r += NT)
      if (f0 + r < f_end) cp_async8(Sr + r, sb + f0 + r);
  };

  float dk[NS][4], dv[NS][4];
#pragma unroll
  for (int m = 0; m < NS; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dk[m][e] = 0.0f;
      dv[m][e] = 0.0f;
    }
  if (f_beg < f_end) {
    issue(f_beg);
    cp_async_commit();
    const float* kh = a.k + b * a.ksb + hk * a.ksh;
    const float* vh = a.v + b * a.vsb + hk * a.vsh;
    bwd_load_split<D, NT>(Ks, kBwdKeys, [&](int r) -> const float* {
      return j0 + r < a.Lk ? kh + static_cast<long long>(j0 + r) * a.ksl
                           : nullptr;
    });
    bwd_load_split<D, NT>(Vs, kBwdKeys, [&](int r) -> const float* {
      return j0 + r < a.Lk ? vh + static_cast<long long>(j0 + r) * a.vsl
                           : nullptr;
    });
  }
  const float c = a.scale * kLog2e;
  const int key0 = j0 + 16 * kw + g;   // this lane's keys: key0, key0 + 8
  const StLane<D> L(g, t);
  for (int f0 = f_beg; f0 < f_end; f0 += BR) {
    cp_async_wait0();
    __syncthreads();   // tile f0 landed; every warp is done with the last
    bwd_split<D, NT>(Qs, Qr, BR, [&](int r) { return f0 + r < f_end; });
    bwd_split<D, NT>(Os, Or, BR, [&](int r) { return f0 + r < f_end; });
    for (int r = tid; r < BR; r += NT) {
      Sc[r] = f0 + r < f_end ? Sr[r] : make_float2(0.0f, 0.0f);
      Pc[r] = (f0 + r) / rep + off;
    }
    __syncthreads();   // the split tiles are in place; the raw ones free
    if (f0 + BR < f_end) issue(f0 + BR);
    cp_async_commit();
    const bool full =
        bwd_full(a, f0 / rep + off, (f0 + BR - 1) / rep + off, j0, kBwdKeys);

    // S^T = K_w Q^T and dP^T = V_w dO^T: 8 rows a fragment.
    float st[NTW][4], dp[NTW][4];
#pragma unroll
    for (int n = 0; n < NTW; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        st[n][e] = 0.0f;
        dp[n][e] = 0.0f;
      }
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      uint32_t kh[4], kl[4], vh[4], vl[4];
      st_afrag<D>(L, Ks, 16 * kw, s, kh, kl);
      st_afrag<D>(L, Vs, 16 * kw, s, vh, vl);
#pragma unroll
      for (int n = 0; n < NTW; ++n) {
        const int r0 = 8 * (half * NTW + n);
        const uint4 xq = L.pair(Qs, r0, s);
        const uint4 xo = L.pair(Os, r0, s);
        mma3(st[n], kh, kl, xq.x, xq.z, xq.y, xq.w);
        mma3(dp[n], vh, vl, xo.x, xo.z, xo.y, xo.w);
      }
    }
    // P^T and dS^T in place: element e is key key0 + 8 (e >> 1), row r +
    // (e & 1) of the tile.
#pragma unroll
    for (int n = 0; n < NTW; ++n) {
      const int r = 8 * (half * NTW + n) + 2 * t;
      const float2 s0 = Sc[r], s1 = Sc[r + 1];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 sv = (e & 1) ? s1 : s0;
        float p = exp2f(st[n][e] * c - sv.x);
        if (!full && !bwd_sees(a, Pc[r + (e & 1)], key0 + 8 * (e >> 1)))
          p = 0.0f;
        st[n][e] = p;
        dp[n][e] = p * (dp[n][e] - sv.y);
      }
    }
    // dV += P^T dO and dK += dS^T Q: k-step n takes rows r (A columns t)
    // and r + 1 (columns t + 4), the fragments' own columns.  Each 8-column
    // tile m of dK and dV sums the row tile's fragments into partials that
    // start at zero and adds them with a rounding float32 add (as
    // mma3_add does a fragment: the tensor cores' truncating accumulation
    // chained over every row biased dK and dV towards zero).  A partial a
    // row tile rather than a fragment: at D = 128 the latter spilled at
    // 255 registers and took 11 % longer, this 6 % (against the chained
    // accumulators; tools/ablate_flash_attention.py --backward on an H100
    // 80GB HBM3 at 700 W).
    uint32_t ph[NTW][4], pl[NTW][4], sh[NTW][4], sl[NTW][4];
#pragma unroll
    for (int n = 0; n < NTW; ++n) {
      c_to_a(st[n], ph[n], pl[n]);
      c_to_a(dp[n], sh[n], sl[n]);
    }
#pragma unroll
    for (int m = 0; m < NS; ++m) {
      float pv[4], pk[4];
#pragma unroll
      for (int n = 0; n < NTW; ++n) {
        const int r0 = 8 * (half * NTW + n);
        const uint2 o0 = L.one(Os, r0, 0, m);
        const uint2 o1 = L.one(Os, r0, 1, m);
        const uint2 q0 = L.one(Qs, r0, 0, m);
        const uint2 q1 = L.one(Qs, r0, 1, m);
        if (n == 0) {
          mma_tf32_z(pv, pl[n], o0.x, o1.x);
          mma_tf32_z(pk, sl[n], q0.x, q1.x);
        } else {
          mma_tf32(pv, pl[n], o0.x, o1.x);
          mma_tf32(pk, sl[n], q0.x, q1.x);
        }
        mma_tf32(pv, ph[n], o0.y, o1.y);
        mma_tf32(pv, ph[n], o0.x, o1.x);
        mma_tf32(pk, sh[n], q0.y, q1.y);
        mma_tf32(pk, sh[n], q0.x, q1.x);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dv[m][e] += pv[e];
        dk[m][e] += pk[e];
      }
    }
  }
  if constexpr (P == 2) {
    bwd_pair_sum<NS>(dk, reinterpret_cast<float*>(Qs), kw, half, lane);
    bwd_pair_sum<NS>(dv, reinterpret_cast<float*>(Qs), kw, half, lane);
  }
  if (half != 0) return;
  // One run: the gradients.  Several: this run's partial sums (zeros if
  // it saw none of the tile's keys), which the reduction adds in order.
  const long long n = static_cast<long long>(a.B) * a.Hkv * a.Lk * D;
  float* out_k = a.runs == 1 ? a.dk : a.part + run * n;
  float* out_v = a.runs == 1 ? a.dv : a.part + (a.runs + run) * n;
  const float sk = a.runs == 1 ? a.scale : 1.0f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int j = key0 + 8 * i;
    if (j >= a.Lk) continue;
    const long long base =
        ((static_cast<long long>(b) * a.Hkv + hk) * a.Lk + j) * D + 2 * t;
#pragma unroll
    for (int m = 0; m < NS; ++m) {
      *reinterpret_cast<float2*>(out_k + base + 8 * m) =
          make_float2(dk[m][2 * i] * sk, dk[m][2 * i + 1] * sk);
      *reinterpret_cast<float2*>(out_v + base + 8 * m) =
          make_float2(dv[m][2 * i], dv[m][2 * i + 1]);
    }
  }
}

// dK = scale * (sum of the runs' partials), dV = the sum, each element's
// runs added in run order, each rounded once to the operands' type TO.
template <typename TO>
__global__ void __launch_bounds__(kBwdAux)
    attn_bwd_reduce_kernel(const BwdArgs a, long long n) {
  const long long e =
      static_cast<long long>(blockIdx.x) * kBwdAux + threadIdx.x;
  if (e >= n) return;
  float sk = 0.0f, sv = 0.0f;
  for (int r = 0; r < a.runs; ++r) {
    sk += a.part[r * n + e];
    sv += a.part[(a.runs + r) * n + e];
  }
  reinterpret_cast<TO*>(a.dk)[e] = from_f<TO>(sk * a.scale);
  reinterpret_cast<TO*>(a.dv)[e] = from_f<TO>(sv);
}

template <int D>
__global__ void __launch_bounds__(bwd_threads<D>(), D <= 64 ? 2 : 1)
    attn_bwd_dq_kernel(const BwdArgs a) {
  constexpr int P = bwd_pair<D>(), NT = bwd_threads<D>();
  constexpr int NS = D / 8;               // k-steps over d; tiles of dQ
  constexpr int NTW = kBwdBK / 8 / P;     // 8-key tiles a warp takes
  static_assert(P == 1 || NS * 4 * 128 * 4 <= 2 * kBwdBK * D * 8,
                "the pair sums fit the key tiles");
  extern __shared__ uint4 smem_u4[];
  uint4* Qs = smem_u4;                                    // [64][D] split
  uint4* Os = Qs + kBwdRows * D / 2;                      // dO
  uint4* Ks = Os + kBwdRows * D / 2;                      // [32][D] split
  uint4* Vs = Ks + kBwdBK * D / 2;
  float* Kr = reinterpret_cast<float*>(Vs + kBwdBK * D / 2);  // [32][D] raw
  float* Vr = Kr + kBwdBK * D;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rw = warp / P, half = warp % P;
  const int groups = a.B * a.Hkv, rep = a.H / a.Hkv, rows = rep * a.Lq;
  const int rtiles = (rows + kBwdRows - 1) / kBwdRows;
  const int grp = blockIdx.x % groups, b = grp / a.Hkv, hk = grp % a.Hkv;
  // Groups fastest, the last row tiles (which see the most keys) first.
  const int f0 =
      (rtiles - 1 - static_cast<int>(blockIdx.x) / groups) * kBwdRows;
  const int f_last = min(f0 + kBwdRows, rows) - 1;
  const int off = a.Lk - a.Lq;
  const int p0 = f0 / rep + off, p1 = f_last / rep + off;
  const int lo = a.window > 0 ? max(0, p0 - a.window + 1) : 0;
  const int hi = a.causal ? min(a.Lk, p1 + 1) : a.Lk;
  const int kt0 = (lo / kBwdBK) * kBwdBK;
  const int ntiles = hi > kt0 ? (hi - kt0 + kBwdBK - 1) / kBwdBK : 0;
  const float* kh = a.k + b * a.ksb + hk * a.ksh;
  const float* vh = a.v + b * a.vsb + hk * a.vsh;

  // Keys [kt, kt + 32) of K and V by cp.async (none past Lk).
  auto issue = [&](int kt) {
    bwd_issue<D, NT>(Kr, kBwdBK, [&](int r) -> const float* {
      return kt + r < a.Lk ? kh + static_cast<long long>(kt + r) * a.ksl
                           : nullptr;
    });
    bwd_issue<D, NT>(Vr, kBwdBK, [&](int r) -> const float* {
      return kt + r < a.Lk ? vh + static_cast<long long>(kt + r) * a.vsl
                           : nullptr;
    });
  };
  if (ntiles > 0) issue(kt0);
  cp_async_commit();
  const float* qb = a.q + b * a.qsb;
  const float* ob = a.dO + b * a.dsb;
  bwd_load_split<D, NT>(Qs, kBwdRows, [&](int r) -> const float* {
    return f0 + r < rows ? bwd_qrow(qb, a.qsh, a.qsl, hk, rep, f0 + r)
                         : nullptr;
  });
  bwd_load_split<D, NT>(Os, kBwdRows, [&](int r) -> const float* {
    return f0 + r < rows ? bwd_qrow(ob, a.dsh, a.dsl, hk, rep, f0 + r)
                         : nullptr;
  });
  // This lane's rows f0 + 16 rw + g and + 8: (lse, Delta) and positions
  // (the padding past `rows` holds zeros).
  const int fr = f0 + 16 * rw + g;
  const float2* sb = a.stats + static_cast<long long>(grp) * a.rows_pad;
  const float2 sv[2] = {sb[fr], sb[fr + 8]};
  const int ap[2] = {fr / rep + off, (fr + 8) / rep + off};
  const float c = a.scale * kLog2e;
  const StLane<D> L(g, t);

  float acc[NS][4];
#pragma unroll
  for (int m = 0; m < NS; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[m][e] = 0.0f;

  for (int it = 0; it < ntiles; ++it) {
    const int kt = kt0 + it * kBwdBK;
    cp_async_wait0();
    __syncthreads();   // tile it landed; every warp is done with tile it - 1
    bwd_split<D, NT>(Ks, Kr, kBwdBK, [&](int r) { return kt + r < a.Lk; });
    bwd_split<D, NT>(Vs, Vr, kBwdBK, [&](int r) { return kt + r < a.Lk; });
    __syncthreads();   // the split tiles are in place; the raw ones free
    if (it + 1 < ntiles) issue(kt + kBwdBK);
    cp_async_commit();
    const bool full = bwd_full(a, p0, p1, kt, kBwdBK);

    // S = Q_w K^T and dP = dO_w V^T: 8 keys a fragment.
    float s[NTW][4], dp[NTW][4];
#pragma unroll
    for (int n = 0; n < NTW; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = 0.0f;
        dp[n][e] = 0.0f;
      }
#pragma unroll
    for (int ks = 0; ks < NS; ++ks) {
      uint32_t qh[4], ql[4], oh[4], ol[4];
      st_afrag<D>(L, Qs, 16 * rw, ks, qh, ql);
      st_afrag<D>(L, Os, 16 * rw, ks, oh, ol);
#pragma unroll
      for (int n = 0; n < NTW; ++n) {
        const int r0 = 8 * (half * NTW + n);
        const uint4 xk = L.pair(Ks, r0, ks);
        const uint4 xv = L.pair(Vs, r0, ks);
        mma3(s[n], qh, ql, xk.x, xk.z, xk.y, xk.w);
        mma3(dp[n], oh, ol, xv.x, xv.z, xv.y, xv.w);
      }
    }
    // dS in place: element e is row g + 8 (e >> 1), key kj + (e & 1).
#pragma unroll
    for (int n = 0; n < NTW; ++n) {
      const int kj = kt + 8 * (half * NTW + n) + 2 * t;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 w = sv[e >> 1];
        float p = exp2f(s[n][e] * c - w.x);
        if (!full && !bwd_sees(a, ap[e >> 1], kj + (e & 1))) p = 0.0f;
        s[n][e] = p * (dp[n][e] - w.y);
      }
    }
    // dQ += dS K: k-step n takes keys kj (A columns t) and kj + 1.
#pragma unroll
    for (int n = 0; n < NTW; ++n) {
      uint32_t dh[4], dl[4];
      c_to_a(s[n], dh, dl);
      const int r0 = 8 * (half * NTW + n);
#pragma unroll
      for (int m = 0; m < NS; ++m) {
        const uint2 k0 = L.one(Ks, r0, 0, m);
        const uint2 k1 = L.one(Ks, r0, 1, m);
        mma3_add(acc[m], dh, dl, k0.x, k1.x, k0.y, k1.y);
      }
    }
  }
  if constexpr (P == 2)
    bwd_pair_sum<NS>(acc, reinterpret_cast<float*>(Ks), rw, half, lane);
  if (half != 0) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int f = fr + 8 * i;
    if (f >= rows) continue;
    float* out = a.dq + ((static_cast<long long>(b) * a.H + hk * rep +
                          f % rep) * a.Lq + f / rep) * D + 2 * t;
#pragma unroll
    for (int m = 0; m < NS; ++m)
      *reinterpret_cast<float2*>(out + 8 * m) =
          make_float2(acc[m][2 * i] * a.scale, acc[m][2 * i + 1] * a.scale);
  }
}

// ------------------------------------------------- backward at D = 256

constexpr int kWideKeys = 32;      // dk/dv: keys a block, 16 a warp group
constexpr int kWideBR = 16;        // dk/dv: rows a tile
constexpr int kWideRows = 32;      // dq: rows a block, 16 a warp group
constexpr int kWideBK = 16;        // dq: keys a tile
constexpr int kWideThreads = 256;  // 2 groups x 4 quarters of D

// K, V split (32 keys), two buffers of raw Q, dO (16 rows) and of their
// (lse, Delta), the quarters' partials [8 warps][2][2][32] float4.
template <int D>
__host__ __device__ constexpr size_t smem_bwd_dkdv_wide() {
  return 2 * kWideKeys * D * 8 + 2 * 2 * kWideBR * D * 4 +
         8 * 2 * 2 * 32 * sizeof(float4) + 2 * kWideBR * sizeof(float2);
}
// Q, dO split (32 rows), two buffers of raw K, V (16 keys), the partials.
template <int D>
__host__ __device__ constexpr size_t smem_bwd_dq_wide() {
  return 2 * kWideRows * D * 8 + 2 * 2 * kWideBK * D * 4 +
         8 * 2 * 2 * 32 * sizeof(float4);
}

// The raw tiles hold float32 rows as they are, each row's 8-byte chunks
// (elements 2c, 2c + 1) at slot c ^ rsw(r): a half warp's 8-byte reads
// of chunk 4s + t of rows r0 + g (g < 4 or g >= 4) and a warp's 4-byte
// reads of element 8m + g of rows r0 + 2t + e each fall on the 32 banks
// once (r0 a multiple of 8), and a 16-byte piece (chunks 2j, 2j + 1)
// stays whole.  The operands are split into TF32 hi and lo parts as they
// are read (raw_pair, raw_one), so no split pass runs.
__device__ __forceinline__ int rsw(int r) { return ((r ^ (r >> 1)) & 3) << 2; }

template <int D>
__device__ __forceinline__ void raw_pair(const float* T, int r, int c,
                                         uint32_t& h0, uint32_t& h1,
                                         uint32_t& l0, uint32_t& l1) {
  const float2 x = *reinterpret_cast<const float2*>(T + r * D +
                                                    2 * (c ^ rsw(r)));
  split(x.x, h0, l0);
  split(x.y, h1, l1);
}

template <int D>
__device__ __forceinline__ void raw_one(const float* T, int r, int d,
                                        uint32_t& h, uint32_t& l) {
  split(T[r * D + 2 * ((d >> 1) ^ rsw(r)) + (d & 1)], h, l);
}

// Enqueues rows [0, n) of a raw tile from row(r) by 16-byte cp.async, and
// writes zeros for the rows where row(r) is nullptr.
template <int D, int NT, typename Row>
__device__ __forceinline__ void wide_issue(float* T, int n, Row row) {
  for (int idx = threadIdx.x; idx < n * (D / 4); idx += NT) {
    const int r = idx / (D / 4), e = (idx % (D / 4)) * 4;
    float* dst = T + r * D + 2 * ((e >> 1) ^ rsw(r));
    const float* p = row(r);
    if (p != nullptr)
      cp_async16(dst, p + e);
    else
      *reinterpret_cast<float4*>(dst) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

// Warp (group, quarter)'s partial C fragments x[n] (product 0) and y[n]
// (1) for its two 8-row or 8-key fragments n into Ex, a block barrier,
// then the four quarters' of its group added in quarter order (the same
// sums on the four warps).
__device__ __forceinline__ void wide_exchange(float4* Ex, int group,
                                             int quarter, int lane,
                                             float (&x)[2][4],
                                             float (&y)[2][4]) {
  const auto at = [&](int q, int n, int p) {
    return ((((group * 4 + q) * 2 + n) * 2 + p) * 32) + lane;
  };
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    Ex[at(quarter, n, 0)] = make_float4(x[n][0], x[n][1], x[n][2], x[n][3]);
    Ex[at(quarter, n, 1)] = make_float4(y[n][0], y[n][1], y[n][2], y[n][3]);
  }
  __syncthreads();
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    float4 sx = Ex[at(0, n, 0)], sy = Ex[at(0, n, 1)];
#pragma unroll
    for (int q = 1; q < 4; ++q) {
      const float4 px = Ex[at(q, n, 0)], py = Ex[at(q, n, 1)];
      sx.x += px.x; sx.y += px.y; sx.z += px.z; sx.w += px.w;
      sy.x += py.x; sy.y += py.y; sy.z += py.z; sy.w += py.w;
    }
    x[n][0] = sx.x; x[n][1] = sx.y; x[n][2] = sx.z; x[n][3] = sx.w;
    y[n][0] = sy.x; y[n][1] = sy.y; y[n][2] = sy.z; y[n][3] = sy.w;
  }
}

template <int D>
__global__ void __launch_bounds__(kWideThreads, 1)
    attn_bwd_dkdv_wide_kernel(const BwdArgs a) {
  constexpr int NT = kWideThreads, BR = kWideBR, NK = kWideKeys;
  constexpr int NQ = D / 32;   // a quarter's k-steps, and 8-column tiles
  extern __shared__ uint4 smem_u4[];
  uint4* Ks = smem_u4;                                   // [32][D] split
  uint4* Vs = Ks + NK * D / 2;
  float* R = reinterpret_cast<float*>(Vs + NK * D / 2);  // [2][Q, dO][16][D]
  float4* Ex = reinterpret_cast<float4*>(R + 2 * 2 * BR * D);
  float2* St = reinterpret_cast<float2*>(Ex + 8 * 2 * 2 * 32);  // [2][16]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kg = warp >> 2, quarter = warp & 3;   // keys 16 kg .. 16 kg + 15
  const int groups = a.B * a.Hkv, rep = a.H / a.Hkv, rows = rep * a.Lq;
  const int grp = blockIdx.x % groups, b = grp / a.Hkv, hk = grp % a.Hkv;
  // Groups fastest, then runs, then key tiles in order (as the D <= 128
  // pass).
  const int run = (static_cast<int>(blockIdx.x) / groups) % a.runs;
  const int j0 = (static_cast<int>(blockIdx.x) / groups / a.runs) * NK;
  const int j1 = min(j0 + NK, a.Lk);
  const int off = a.Lk - a.Lq;
  const int p_lo = a.causal ? max(0, j0 - off) : 0;
  const int p_hi = a.window > 0 ? min(a.Lq, j1 - 1 + a.window - off) : a.Lq;
  const int run_rows = (rows + a.runs - 1) / a.runs;
  const int f_beg = p_lo * rep + run * run_rows;
  const int f_end = min(p_hi * rep, f_beg + run_rows);
  const float* qb = a.q + b * a.qsb;
  const float* ob = a.dO + b * a.dsb;
  const float2* sb = a.stats + static_cast<long long>(grp) * a.rows_pad;

  // Rows [f0, f0 + 16) of the run into buffer u: Q, dO and (lse, Delta)
  // by cp.async, zeros past f_end.
  auto issue = [&](int f0, int u) {
    float* Qr = R + u * 2 * BR * D;
    wide_issue<D, NT>(Qr, BR, [&](int r) -> const float* {
      return f0 + r < f_end ? bwd_qrow(qb, a.qsh, a.qsl, hk, rep, f0 + r)
                            : nullptr;
    });
    wide_issue<D, NT>(Qr + BR * D, BR, [&](int r) -> const float* {
      return f0 + r < f_end ? bwd_qrow(ob, a.dsh, a.dsl, hk, rep, f0 + r)
                            : nullptr;
    });
    for (int r = tid; r < BR; r += NT) {
      if (f0 + r < f_end)
        cp_async8(St + u * BR + r, sb + f0 + r);
      else
        St[u * BR + r] = make_float2(0.0f, 0.0f);
    }
  };

  float dk[NQ][4], dv[NQ][4];
#pragma unroll
  for (int m = 0; m < NQ; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dk[m][e] = 0.0f;
      dv[m][e] = 0.0f;
    }
  if (f_beg < f_end) {
    issue(f_beg, 0);
    cp_async_commit();
    const float* kh = a.k + b * a.ksb + hk * a.ksh;
    const float* vh = a.v + b * a.vsb + hk * a.vsh;
    bwd_load_split<D, NT>(Ks, NK, [&](int r) -> const float* {
      return j0 + r < a.Lk ? kh + static_cast<long long>(j0 + r) * a.ksl
                           : nullptr;
    });
    bwd_load_split<D, NT>(Vs, NK, [&](int r) -> const float* {
      return j0 + r < a.Lk ? vh + static_cast<long long>(j0 + r) * a.vsl
                           : nullptr;
    });
  }
  const float c = a.scale * kLog2e;
  const int key0 = j0 + 16 * kg + g;   // this lane's keys: key0, key0 + 8
  const int s0 = NQ * quarter;         // the quarter's first k-step, tile
  const StLane<D> L(g, t);
  int u = 0;                           // the buffer of this tile
  for (int f0 = f_beg; f0 < f_end; f0 += BR, u ^= 1) {
    cp_async_wait0();
    __syncthreads();   // tile f0 landed; every warp is done with the other
    if (f0 + BR < f_end) issue(f0 + BR, u ^ 1);
    cp_async_commit();
    const float* Qr = R + u * 2 * BR * D;
    const float* Or = Qr + BR * D;
    const float2* Sc = St + u * BR;
    const bool full =
        bwd_full(a, f0 / rep + off, (f0 + BR - 1) / rep + off, j0, NK);

    // The quarter's S^T = K Q^T and dP^T = V dO^T of the warp's 16 keys
    // over the tile's rows 8 n + (0..7).
    float st[2][4], dp[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        st[n][e] = 0.0f;
        dp[n][e] = 0.0f;
      }
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      const int s = s0 + i;
      uint32_t kh[4], kl[4], vh[4], vl[4];
      st_afrag<D>(L, Ks, 16 * kg, s, kh, kl);
      st_afrag<D>(L, Vs, 16 * kg, s, vh, vl);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int r = 8 * n + g;
        uint32_t h0, h1, l0, l1;
        raw_pair<D>(Qr, r, 4 * s + t, h0, h1, l0, l1);
        mma3(st[n], kh, kl, h0, h1, l0, l1);
        raw_pair<D>(Or, r, 4 * s + t, h0, h1, l0, l1);
        mma3(dp[n], vh, vl, h0, h1, l0, l1);
      }
    }
    wide_exchange(Ex, kg, quarter, lane, st, dp);
    // P^T and dS^T in place: element e of fragment n is key key0 + 8 (e
    // >> 1), row 8 n + 2t + (e & 1) of the tile.
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const int r = 8 * n + 2 * t;
      const float2 v0 = Sc[r], v1 = Sc[r + 1];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 sv = (e & 1) ? v1 : v0;
        float p = exp2f(st[n][e] * c - sv.x);
        if (!full && !bwd_sees(a, (f0 + r + (e & 1)) / rep + off,
                               key0 + 8 * (e >> 1)))
          p = 0.0f;
        st[n][e] = p;
        dp[n][e] = p * (dp[n][e] - sv.y);
      }
    }
    // dV += P^T dO and dK += dS^T Q: k-step n takes rows 8 n + 2t and +
    // 1 (the fragments' own columns); the quarter's columns.
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      uint32_t ph[4], pl[4], sh[4], sl[4];
      c_to_a(st[n], ph, pl);
      c_to_a(dp[n], sh, sl);
      const int r = 8 * n + 2 * t;
#pragma unroll
      for (int m = 0; m < NQ; ++m) {
        const int d = 8 * (s0 + m) + g;
        uint32_t o0h, o0l, o1h, o1l, q0h, q0l, q1h, q1l;
        raw_one<D>(Or, r, d, o0h, o0l);
        raw_one<D>(Or, r + 1, d, o1h, o1l);
        raw_one<D>(Qr, r, d, q0h, q0l);
        raw_one<D>(Qr, r + 1, d, q1h, q1l);
        mma3_add(dv[m], ph, pl, o0h, o1h, o0l, o1l);
        mma3_add(dk[m], sh, sl, q0h, q1h, q0l, q1l);
      }
    }
  }
  // One run: the gradients.  Several: this run's partial sums.
  const long long n = static_cast<long long>(a.B) * a.Hkv * a.Lk * D;
  float* out_k = a.runs == 1 ? a.dk : a.part + run * n;
  float* out_v = a.runs == 1 ? a.dv : a.part + (a.runs + run) * n;
  const float sk = a.runs == 1 ? a.scale : 1.0f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int j = key0 + 8 * i;
    if (j >= a.Lk) continue;
    const long long base =
        ((static_cast<long long>(b) * a.Hkv + hk) * a.Lk + j) * D + 2 * t;
#pragma unroll
    for (int m = 0; m < NQ; ++m) {
      const int col = 8 * (s0 + m);
      *reinterpret_cast<float2*>(out_k + base + col) =
          make_float2(dk[m][2 * i] * sk, dk[m][2 * i + 1] * sk);
      *reinterpret_cast<float2*>(out_v + base + col) =
          make_float2(dv[m][2 * i], dv[m][2 * i + 1]);
    }
  }
}

// The D = 256 dq pass.
template <int D>
__global__ void __launch_bounds__(kWideThreads, 1)
    attn_bwd_dq_wide_kernel(const BwdArgs a) {
  constexpr int NT = kWideThreads, BQ = kWideRows, BK = kWideBK;
  constexpr int NQ = D / 32;
  extern __shared__ uint4 smem_u4[];
  uint4* Qs = smem_u4;                                    // [32][D] split
  uint4* Os = Qs + BQ * D / 2;                            // dO
  float* R = reinterpret_cast<float*>(Os + BQ * D / 2);   // [2][K, V][16][D]
  float4* Ex = reinterpret_cast<float4*>(R + 2 * 2 * BK * D);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp >> 2, quarter = warp & 3;   // rows 16 rg .. 16 rg + 15
  const int groups = a.B * a.Hkv, rep = a.H / a.Hkv, rows = rep * a.Lq;
  const int rtiles = (rows + BQ - 1) / BQ;
  const int grp = blockIdx.x % groups, b = grp / a.Hkv, hk = grp % a.Hkv;
  // Groups fastest, the last row tiles (which see the most keys) first.
  const int f0 = (rtiles - 1 - static_cast<int>(blockIdx.x) / groups) * BQ;
  const int f_last = min(f0 + BQ, rows) - 1;
  const int off = a.Lk - a.Lq;
  const int p0 = f0 / rep + off, p1 = f_last / rep + off;
  const int lo = a.window > 0 ? max(0, p0 - a.window + 1) : 0;
  const int hi = a.causal ? min(a.Lk, p1 + 1) : a.Lk;
  const int kt0 = (lo / BK) * BK;
  const int ntiles = hi > kt0 ? (hi - kt0 + BK - 1) / BK : 0;
  const float* kh = a.k + b * a.ksb + hk * a.ksh;
  const float* vh = a.v + b * a.vsb + hk * a.vsh;

  // Keys [kt, kt + 16) of K and V into buffer u (zeros past Lk).
  auto issue = [&](int kt, int u) {
    float* Kr = R + u * 2 * BK * D;
    wide_issue<D, NT>(Kr, BK, [&](int r) -> const float* {
      return kt + r < a.Lk ? kh + static_cast<long long>(kt + r) * a.ksl
                           : nullptr;
    });
    wide_issue<D, NT>(Kr + BK * D, BK, [&](int r) -> const float* {
      return kt + r < a.Lk ? vh + static_cast<long long>(kt + r) * a.vsl
                           : nullptr;
    });
  };
  if (ntiles > 0) issue(kt0, 0);
  cp_async_commit();
  const float* qb = a.q + b * a.qsb;
  const float* ob = a.dO + b * a.dsb;
  bwd_load_split<D, NT>(Qs, BQ, [&](int r) -> const float* {
    return f0 + r < rows ? bwd_qrow(qb, a.qsh, a.qsl, hk, rep, f0 + r)
                         : nullptr;
  });
  bwd_load_split<D, NT>(Os, BQ, [&](int r) -> const float* {
    return f0 + r < rows ? bwd_qrow(ob, a.dsh, a.dsl, hk, rep, f0 + r)
                         : nullptr;
  });
  // This lane's rows f0 + 16 rg + g and + 8: (lse, Delta) and positions
  // (the padding past `rows` holds zeros).
  const int fr = f0 + 16 * rg + g;
  const float2* sb = a.stats + static_cast<long long>(grp) * a.rows_pad;
  const float2 sv[2] = {sb[fr], sb[fr + 8]};
  const int ap[2] = {fr / rep + off, (fr + 8) / rep + off};
  const float c = a.scale * kLog2e;
  const int s0 = NQ * quarter;
  const StLane<D> L(g, t);

  float acc[NQ][4];
#pragma unroll
  for (int m = 0; m < NQ; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[m][e] = 0.0f;

  for (int it = 0; it < ntiles; ++it) {
    const int kt = kt0 + it * BK, u = it & 1;
    cp_async_wait0();
    __syncthreads();   // tile it landed; every warp is done with the other
    if (it + 1 < ntiles) issue(kt + BK, u ^ 1);
    cp_async_commit();
    const float* Kr = R + u * 2 * BK * D;
    const float* Vr = Kr + BK * D;
    const bool full = bwd_full(a, p0, p1, kt, BK);

    // The quarter's S = Q K^T and dP = dO V^T of the warp's 16 rows over
    // the tile's keys 8 n + (0..7).
    float s[2][4], dp[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = 0.0f;
        dp[n][e] = 0.0f;
      }
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      const int ks = s0 + i;
      uint32_t qh[4], ql[4], oh[4], ol[4];
      st_afrag<D>(L, Qs, 16 * rg, ks, qh, ql);
      st_afrag<D>(L, Os, 16 * rg, ks, oh, ol);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int r = 8 * n + g;
        uint32_t h0, h1, l0, l1;
        raw_pair<D>(Kr, r, 4 * ks + t, h0, h1, l0, l1);
        mma3(s[n], qh, ql, h0, h1, l0, l1);
        raw_pair<D>(Vr, r, 4 * ks + t, h0, h1, l0, l1);
        mma3(dp[n], oh, ol, h0, h1, l0, l1);
      }
    }
    wide_exchange(Ex, rg, quarter, lane, s, dp);
    // dS in place: element e of fragment n is row fr + 8 (e >> 1), key kj
    // + (e & 1).
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const int kj = kt + 8 * n + 2 * t;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 w = sv[e >> 1];
        float p = exp2f(s[n][e] * c - w.x);
        if (!full && !bwd_sees(a, ap[e >> 1], kj + (e & 1))) p = 0.0f;
        s[n][e] = p * (dp[n][e] - w.y);
      }
    }
    // dQ += dS K: k-step n takes keys 8 n + 2t and + 1; the quarter's
    // columns.
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      uint32_t dh[4], dl[4];
      c_to_a(s[n], dh, dl);
      const int r = 8 * n + 2 * t;
#pragma unroll
      for (int m = 0; m < NQ; ++m) {
        const int d = 8 * (s0 + m) + g;
        uint32_t k0h, k0l, k1h, k1l;
        raw_one<D>(Kr, r, d, k0h, k0l);
        raw_one<D>(Kr, r + 1, d, k1h, k1l);
        mma3_add(acc[m], dh, dl, k0h, k1h, k0l, k1l);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int f = fr + 8 * i;
    if (f >= rows) continue;
    float* out = a.dq + ((static_cast<long long>(b) * a.H + hk * rep +
                          f % rep) * a.Lq + f / rep) * D + 2 * t;
#pragma unroll
    for (int m = 0; m < NQ; ++m)
      *reinterpret_cast<float2*>(out + 8 * (s0 + m)) =
          make_float2(acc[m][2 * i] * a.scale, acc[m][2 * i + 1] * a.scale);
  }
}

// ------------------------------------------ backward on bf16 operands
//
// bf16 operands (q, k, v and dO bf16; a train step under
// precision.options(dtype=bf16)), at D <= 128, have two passes of their
// own, built for the card's bf16 tensor cores.  The reference's jnp
// attention keeps P and dS in float32 (FlashAttention-2 rounds P to bf16
// for a bf16 MMA: another function), so the products stay
// float32-accurate.
//  * Q, dO, K and V stay bf16 in shared memory, 2 B an element, rows of D
//    values whose 16-byte chunks sit at chunk c ^ bf_sw(r) (r & 7 at D >=
//    64; (r >> 1) & 3 at D = 32, whose rows are four chunks), so the
//    eight rows one ldmatrix phase reads at one chunk fall on the 32
//    banks once, plain or .trans.  They land by 16-byte cp.async, the
//    walked operand one tile ahead into the other of two buffers: no
//    split pass, one block barrier a tile.
//  * Every product is mma.sync m16n8k16 bf16 with float32 accumulation,
//    its fragments loaded by ldmatrix.x4.  A product reduced over D (S^T
//    = K Q^T and dP^T = V dO^T; S and dP) is one MMA a tile: both
//    operands are bf16.  The B operand of a product reduced over rows or
//    keys (dO and Q of dV = P^T dO and dK = dS^T Q, K of dQ = dS K) comes
//    by ldmatrix.x4.trans from the same tiles, with no transposed copy.
//  * P and dS stay float32 in registers and enter their products as
//    three bf16 pieces (split3): hi = bf16_rn(x), mid = bf16_rn(x - hi),
//    lo = bf16_rn(x - hi - mid), 24 significant bits, so x = hi + mid +
//    lo exactly for |x| >= 2^-110 (below it the bits under bf16's least
//    subnormal, 2^-133, drop).  Two n8 C fragments make one k16 A
//    fragment (C columns 2t, 2t + 1 of tiles 2s and 2s + 1 are A columns
//    2t, 2t + 1 and 2t + 8, 2t + 9 of k-step s), so the pieces are packed
//    from the C fragments in place.  Three MMAs a product: lo, then mid,
//    then hi over the tile's k-steps, into a partial that starts at zero
//    and lands in the accumulator by a rounding add (F7).
//  * dk/dv: a block of 4 warps takes 64 keys, 16 a warp with its 16 x D
//    dK and dV in registers, and walks the rows of its run (runs and
//    their sum as in the float32 passes), bf_br rows a tile: 32 at D <=
//    64, 16 at D = 128, where dK and dV take 128 registers.  dq: a block
//    of 4 warps takes 64 rows, 16 a warp, and walks the keys they see,
//    bf_bk a tile: 64 at D <= 64, 32 at D = 128.
//  * P = 2^x by ex2.approx (as the forward; its 2^-22 is far below the
//    bf16 rounding of the gradients, and it was 2 % faster than exp2f).
//    Tiles that need no mask take a path without one (bf_p_ds_t, bf_ds),
//    and a walked row's head and position take one division for its Q
//    and dO pieces together: with a generic loop and a division a piece
//    the pass's integer work outweighed its MMAs.
//  * As in the float32 passes: Delta from the forward's float32 output
//    o32 (one from the bf16 o would carry its 2^-9 rounding into every
//    dS), a fixed order of every sum; dq, dk, dv rounded once to bf16.
// Bound: 22 * D bf16 flops an unmasked pair (S and dP at one MMA, dV, dK
// and dQ at three; the passes run 26 * D) at 989 T op/s, against bf16 q,
// k, v, dO and float32 o read and bf16 dq, dk, dv written once.  Shared
// memory: dk/dv 16 896 / 33 280 / 49 408 B and dq 24 576 / 49 152 /
// 65 536 B at D = 32 / 64 / 128 (ops.plan_k7_bwd_bf16), so at least two
// blocks an SM; registers set how many more fit
// (flash_attention_bwd_bf16_attrs reports them).  At tinyllama-1.1b's
// prefill 502.4-502.5 us, at qwen3-moe's 1 990.6-1 991.0 us, where the
// float32 passes templated on bf16 operands (split tiles with a zero lo
// half, TF32 MMAs) took 1 835.8-1 841.1 / 8 624.5-8 683.2 us and SDPA's
// bf16 backward 226.7-229.0 / 637.9-640.8 (tools/pair_flash_attention.py
// --backward --bf16, paired, on an H100 80GB HBM3 at 700 W).

constexpr int kBfKeys = 64;      // dk/dv: keys a block, 16 a warp
constexpr int kBfRows = 64;      // dq: rows a block, 16 a warp
constexpr int kBfThreads = 128;  // 4 warps

// dk/dv: rows a tile; dq: keys a tile.
template <int D>
__host__ __device__ constexpr int bf_br() { return D > 64 ? 16 : 32; }
template <int D>
__host__ __device__ constexpr int bf_bk() { return D > 64 ? 32 : 64; }

// K, V (64 keys), two buffers of Q, dO (BR rows) and of their (lse,
// Delta).
template <int D>
__host__ __device__ constexpr size_t smem_bwd_dkdv_bf16() {
  return 2 * kBfKeys * D * 2 + 2 * 2 * bf_br<D>() * D * 2 +
         2 * bf_br<D>() * sizeof(float2);
}
// Q, dO (64 rows), two buffers of K, V (BK keys).
template <int D>
__host__ __device__ constexpr size_t smem_bwd_dq_bf16() {
  return 2 * kBfRows * D * 2 + 2 * 2 * bf_bk<D>() * D * 2;
}

// A shared-memory address as ldmatrix takes it (32 bits on the card; the
// host form reads through a pointer).
#ifdef __CUDA_ARCH__
using saddr = uint32_t;
__device__ __forceinline__ saddr smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
#else
using saddr = unsigned long long;
__device__ __forceinline__ saddr smem_addr(const void* p) {
  return reinterpret_cast<unsigned long long>(p);
}
#endif

// The swizzle of the 16-byte chunks of row r of a [rows][D] bf16 tile.
template <int D>
__host__ __device__ constexpr int bf_sw(int r) {
  return D >= 64 ? (r & 7) : ((r >> 1) & 3);
}

// Byte offset of chunk c (values 8c .. 8c + 7) of row r.
template <int D>
__device__ __forceinline__ int bf_at(int r, int c) {
  return r * (2 * D) + ((c ^ bf_sw<D>(r)) << 4);
}

// Lane l's part of an ldmatrix.x4 address, so that each fragment's
// address is a base, a constant and one of four registers.  "a" reads
// rows r0 + (l & 15) at chunks c + (l >> 4): an A fragment (16 rows, a
// k16 step of two chunks) or, with .trans, the B fragments of two
// 8-column tiles over a k16 step of rows.  "b" reads rows r0 + (l & 7) +
// 8 (l >> 4) at chunks c + ((l >> 3) & 1): the B fragments of two 8-row
// tiles over a k16 step along D.  With r0 a multiple of 8 and c even, the
// row's swizzle is the lane's own, and its chunk (c + bit) ^ sw = (c &
// ~7) + ((c & 7) ^ x) with x = bit ^ sw < 8: pa, pb hold the lane's row
// offset plus ((c & 7) ^ x) << 4 for the four even values of c & 7 (a
// swizzle computed at every load made the compiler keep one register
// per chunk).
template <int D>
struct BfLane {
  int pa[4], pb[4];
  __device__ __forceinline__ explicit BfLane(int l) {
    const int ra = l & 15, rb = (l & 7) + 8 * (l >> 4);
    const int xa = (l >> 4) ^ bf_sw<D>(ra);
    const int xb = ((l >> 3) & 1) ^ bf_sw<D>(rb);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      pa[i] = ra * 2 * D + (((2 * i) ^ xa) << 4);
      pb[i] = rb * 2 * D + (((2 * i) ^ xb) << 4);
    }
  }
  __device__ __forceinline__ saddr a(saddr T, int r0, int c) const {
    return T + r0 * 2 * D + ((c & ~7) << 4) + pa[(c & 7) >> 1];
  }
  __device__ __forceinline__ saddr b(saddr T, int r0, int c) const {
    return T + r0 * 2 * D + ((c & ~7) << 4) + pb[(c & 7) >> 1];
  }
};

#ifndef __CUDA_ARCH__
// ldmatrix from the lanes' addresses, gathered by shuffles.
__device__ __forceinline__ void ldsm4_host(uint32_t (&r)[4], saddr u,
                                           bool trans) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const uint32_t lo = static_cast<uint32_t>(u);
  const uint32_t hi = static_cast<uint32_t>(u >> 32);
  const auto row = [&](int src) {
    const unsigned long long h = __shfl_sync(0xffffffffu, hi, src);
    return reinterpret_cast<const uint16_t*>(
        (h << 32) | __shfl_sync(0xffffffffu, lo, src));
  };
  for (int i = 0; i < 4; ++i) {
    if (trans) {
      const uint16_t* r0 = row(8 * i + 2 * t);
      const uint16_t* r1 = row(8 * i + 2 * t + 1);
      r[i] = static_cast<uint32_t>(r0[g]) | (static_cast<uint32_t>(r1[g]) << 16);
    } else {
      r[i] = reinterpret_cast<const uint32_t*>(row(8 * i + g))[t];
    }
  }
}
#endif

// ldmatrix.x4: lane (g, t) receives in r[i], of the 8 x 8 bf16 matrix i
// whose rows lanes 8i .. 8i + 7 address, row g's elements 2t and 2t + 1
// (the first in the low half); ldsm4_t (.trans) its elements (2t, g) and
// (2t + 1, g).
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], saddr s) {
#ifdef __CUDA_ARCH__
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
#else
  ldsm4_host(r, s, false);
#endif
}

__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], saddr s) {
#ifdef __CUDA_ARCH__
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
#else
  ldsm4_host(r, s, true);
#endif
}

// c += A (16 x 16, row) * B (16 x 8, col), bf16 in, float32 accumulate.
// Lane (g, t) holds a = {A[g][2t, 2t+1], A[g+8][2t, 2t+1], A[g][2t+8,
// 2t+9], A[g+8][2t+8, 2t+9]} and b = {B[2t, 2t+1][g], B[2t+8, 2t+9][g]},
// two bf16 a word (the lower index in the low half), and c as mma_tf32.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
#ifdef __CUDA_ARCH__
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
#else
  // The same product from the lanes' fragments, gathered by shuffles (a
  // product of two bf16 values is exact in float32).
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const auto dot = [](uint32_t x, uint32_t y) {
    return bf_lo(x) * bf_lo(y) + bf_hi(x) * bf_hi(y);
  };
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int s = 0; s < 4; ++s) {   // k = 2s, 2s + 1 and 2s + 8, 2s + 9
    const uint32_t a0 = __shfl_sync(0xffffffffu, a[0], 4 * g + s);
    const uint32_t a1 = __shfl_sync(0xffffffffu, a[1], 4 * g + s);
    const uint32_t a2 = __shfl_sync(0xffffffffu, a[2], 4 * g + s);
    const uint32_t a3 = __shfl_sync(0xffffffffu, a[3], 4 * g + s);
    const uint32_t c00 = __shfl_sync(0xffffffffu, b0, 8 * t + s);
    const uint32_t c01 = __shfl_sync(0xffffffffu, b1, 8 * t + s);
    const uint32_t c10 = __shfl_sync(0xffffffffu, b0, 8 * t + 4 + s);
    const uint32_t c11 = __shfl_sync(0xffffffffu, b1, 8 * t + 4 + s);
    acc[0] += dot(a0, c00) + dot(a2, c01);
    acc[1] += dot(a0, c10) + dot(a2, c11);
    acc[2] += dot(a1, c00) + dot(a3, c01);
    acc[3] += dot(a1, c10) + dot(a3, c11);
  }
  for (int i = 0; i < 4; ++i) c[i] += acc[i];
#endif
}

// c = A B, bf16 in, float32 out (an accumulator of zeros as an input
// operand, as mma_tf32_z).
__device__ __forceinline__ void mma_bf16_z(float (&c)[4],
                                           const uint32_t (&a)[4],
                                           uint32_t b0, uint32_t b1) {
#ifdef __CUDA_ARCH__
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.0f), "f"(0.0f), "f"(0.0f), "f"(0.0f));
#else
  for (int i = 0; i < 4; ++i) c[i] = 0.0f;
  mma_bf16(c, a, b0, b1);
#endif
}

// x and y rounded to bf16 (to nearest, ties to even) in one word, x in
// the low half.
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
#ifdef __CUDA_ARCH__
  uint32_t u;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(u) : "f"(y), "f"(x));
  return u;
#else
  const auto rn = [](float f) {
    const uint32_t u = __float_as_uint(f);
    return (u + 0x7fffu + ((u >> 16) & 1u)) >> 16;
  };
  return (rn(y) << 16) | rn(x);
#endif
}

// The three bf16 pieces of x and y (x in the low halves): x = hi + mid +
// lo (exact for |x| >= 2^-110; each difference is exact in float32).
__device__ __forceinline__ void split3(float x, float y, uint32_t& h,
                                       uint32_t& m, uint32_t& l) {
  h = pack_bf16(x, y);
  x -= bf_lo(h);
  y -= bf_hi(h);
  m = pack_bf16(x, y);
  x -= bf_lo(m);
  y -= bf_hi(m);
  l = pack_bf16(x, y);
}

// The pieces of k-step s of a product reduced over the columns of C
// fragments c0 = c[2s] and c1 = c[2s + 1], as A fragments: C columns 2t,
// 2t + 1 of c0 are A columns 2t, 2t + 1, those of c1 A columns 2t + 8, 2t
// + 9.
__device__ __forceinline__ void c_to_a3(const float (&c0)[4],
                                        const float (&c1)[4],
                                        uint32_t (&h)[4], uint32_t (&m)[4],
                                        uint32_t (&l)[4]) {
  split3(c0[0], c0[1], h[0], m[0], l[0]);
  split3(c0[2], c0[3], h[1], m[1], l[1]);
  split3(c1[0], c1[1], h[2], m[2], l[2]);
  split3(c1[2], c1[3], h[3], m[3], l[3]);
}

// acc[m] += (hi + mid + lo) B for the 8-column tiles m of a product
// reduced over NR k16 steps of the rows of tile T (B's rows, read by
// ldmatrix.x4.trans): a partial of the whole tile, lo, then mid, then hi
// over the k-steps, landing by a rounding add.
template <int D, int NR>
__device__ __forceinline__ void bf_rows_product(
    float (&acc)[D / 8][4], const uint32_t (&h)[NR][4],
    const uint32_t (&mid)[NR][4], const uint32_t (&l)[NR][4], saddr T,
    const BfLane<D>& L) {
#pragma unroll
  for (int m = 0; m < D / 8; m += 2) {
    uint32_t bt[NR][4];
#pragma unroll
    for (int s = 0; s < NR; ++s) ldsm4_t(bt[s], L.a(T, 16 * s, m));
    float p0[4], p1[4];
    mma_bf16_z(p0, l[0], bt[0][0], bt[0][1]);
    mma_bf16_z(p1, l[0], bt[0][2], bt[0][3]);
#pragma unroll
    for (int s = 1; s < NR; ++s) {
      mma_bf16(p0, l[s], bt[s][0], bt[s][1]);
      mma_bf16(p1, l[s], bt[s][2], bt[s][3]);
    }
#pragma unroll
    for (int s = 0; s < NR; ++s) {
      mma_bf16(p0, mid[s], bt[s][0], bt[s][1]);
      mma_bf16(p1, mid[s], bt[s][2], bt[s][3]);
    }
#pragma unroll
    for (int s = 0; s < NR; ++s) {
      mma_bf16(p0, h[s], bt[s][0], bt[s][1]);
      mma_bf16(p1, h[s], bt[s][2], bt[s][3]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[m][e] += p0[e];
      acc[m + 1][e] += p1[e];
    }
  }
}

// blockIdx.x read anew by a volatile read, which the compiler cannot
// carry over a loop: what is needed only after a pass's main loop is
// formed from it there instead of held in registers across the loop.
__device__ __forceinline__ int block_x() {
#ifdef __CUDA_ARCH__
  int r;
  asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(r));
  return r;
#else
  return static_cast<int>(blockIdx.x);
#endif
}

// Rows [0, n) of a swizzled bf16 tile from row(r) by 16-byte cp.async,
// zeros where row(r) is nullptr.
template <int D, int NT, typename Row>
__device__ __forceinline__ void bf_issue(char* T, int n, Row row) {
  for (int idx = threadIdx.x; idx < n * (D / 8); idx += NT) {
    const int r = idx / (D / 8), c = idx % (D / 8);
    char* dst = T + bf_at<D>(r, c);
    const __nv_bfloat16* p = row(r);
    if (p != nullptr)
      cp_async16(dst, p + 8 * c);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// dk/dv: P^T = 2^(S^T c - lse) and dS^T = P^T (dP^T - Delta) in place;
// element e of fragment j is key key0 + 8 (e >> 1), row 8j + 2t + (e &
// 1) of the tile at f0, whose (lse, Delta) are Sc.  With kMask the keys
// a row does not see get P = 0 (a tile that crosses the diagonal, a
// window's edge or the ragged end; the others take the straight path).
template <bool kMask, int NJ>
__device__ __forceinline__ void bf_p_ds_t(float (&st)[NJ][4],
                                          float (&dp)[NJ][4],
                                          const float2* Sc, const BwdArgs& a,
                                          float c, int t, int f0, int rep,
                                          int off, int key0) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int r = 8 * j + 2 * t;
    const float4 sv = *reinterpret_cast<const float4*>(Sc + r);
    int pos[2] = {0, 0};
    if (kMask) {
      pos[0] = (f0 + r) / rep + off;
      pos[1] = (f0 + r + 1) / rep + off;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float lse = (e & 1) ? sv.z : sv.x;
      const float del = (e & 1) ? sv.w : sv.y;
      float p = ex2(st[j][e] * c - lse);
      if (kMask && !bwd_sees(a, pos[e & 1], key0 + 8 * (e >> 1))) p = 0.0f;
      st[j][e] = p;
      dp[j][e] = p * (dp[j][e] - del);
    }
  }
}

// dq: dS = P (dP - Delta) in s, P = 2^(S c - lse); element e of fragment
// j is row 8 (e >> 1) of the lane's two (at positions ap, with (lse,
// Delta) sv), key kt + 8j + 2t + (e & 1).  kMask as bf_p_ds_t.
template <bool kMask, int NJ>
__device__ __forceinline__ void bf_ds(float (&s)[NJ][4],
                                      const float (&dp)[NJ][4],
                                      const float2 (&sv)[2],
                                      const int (&ap)[2], const BwdArgs& a,
                                      float c, int t, int kt) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int kj = kt + 8 * j + 2 * t;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 w = sv[e >> 1];
      float p = ex2(s[j][e] * c - w.x);
      if (kMask && !bwd_sees(a, ap[e >> 1], kj + (e & 1))) p = 0.0f;
      s[j][e] = p * (dp[j][e] - w.y);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kBfThreads, 2)
    attn_bwd_dkdv_bf16_kernel(const BwdArgs a) {
  using bf = __nv_bfloat16;
  constexpr int NT = kBfThreads, BR = bf_br<D>(), NK = kBfKeys;
  constexpr int NS = D / 16;       // k16 steps over D
  constexpr int NM = D / 8;        // 8-column tiles of dK, dV
  constexpr int NJ = BR / 8;       // 8-row tiles of a row tile
  constexpr int NR = BR / 16;      // k16 steps over a row tile
  constexpr int TB = BR * D * 2;   // bytes of a Q or dO tile
  extern __shared__ uint4 smem_u4[];
  char* Ks = reinterpret_cast<char*>(smem_u4);         // [64][D]
  char* Vs = Ks + NK * D * 2;
  char* R = Vs + NK * D * 2;                           // [2][Q, dO][BR][D]
  float2* St = reinterpret_cast<float2*>(R + 4 * TB);  // [2][BR]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int groups = a.B * a.Hkv, rep = a.H / a.Hkv, rows = rep * a.Lq;
  const int grp = blockIdx.x % groups, b = grp / a.Hkv, hk = grp % a.Hkv;
  // Groups fastest, then runs, then key tiles in order (as the float32
  // pass).
  const int run = (static_cast<int>(blockIdx.x) / groups) % a.runs;
  const int j0 = (static_cast<int>(blockIdx.x) / groups / a.runs) * NK;
  const int j1 = min(j0 + NK, a.Lk);
  const int off = a.Lk - a.Lq;
  const int p_lo = a.causal ? max(0, j0 - off) : 0;
  const int p_hi = a.window > 0 ? min(a.Lq, j1 - 1 + a.window - off) : a.Lq;
  const int run_rows = (rows + a.runs - 1) / a.runs;
  const int f_beg = p_lo * rep + run * run_rows;
  const int f_end = min(p_hi * rep, f_beg + run_rows);
  const float2* sb = a.stats + static_cast<long long>(grp) * a.rows_pad;
  // The thread's pieces of a walked tile: chunk ci of rows ri + k KS, k <
  // KP, one division a row for its Q and dO pieces together (a division
  // a piece, and a generic loop over the pieces, were most of the pass's
  // integer work).  The operands' base pointers are formed at each issue,
  // not held across the loop (with them held, and the rows' quotients,
  // the D = 128 pass spilled).
  constexpr int CPR = D / 8, KS = NT / CPR, KP = BR / KS;
  static_assert(KP >= 1 && BR % KS == 0, "a tile's pieces fill the block");
  const int ci = tid % CPR, ri = tid / CPR;

  // Rows [f0, f0 + BR) of the run into buffer u: Q, dO and (lse, Delta)
  // by cp.async, zeros past f_end.
  auto issue = [&](int f0, int u) {
    char* Qt = R + u * 2 * TB;
#pragma unroll
    for (int k = 0; k < KP; ++k) {
      const int r = ri + k * KS;
      char* dst = Qt + bf_at<D>(r, ci);
      const int fd = (f0 + r) / rep, fm = f0 + r - fd * rep;
      if (f0 + r < f_end) {
        const long long h = hk * rep + fm;
        cp_async16(dst, reinterpret_cast<const bf*>(a.q) + b * a.qsb +
                            h * a.qsh + fd * a.qsl + 8 * ci);
        cp_async16(dst + TB, reinterpret_cast<const bf*>(a.dO) + b * a.dsb +
                                 h * a.dsh + fd * a.dsl + 8 * ci);
      } else {
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
        *reinterpret_cast<uint4*>(dst + TB) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    if (tid < BR) {                    // BR <= NT: one row a thread
      if (f0 + tid < f_end)
        cp_async8(St + u * BR + tid, sb + f0 + tid);
      else
        St[u * BR + tid] = make_float2(0.0f, 0.0f);
    }
  };

  float dk[NM][4], dv[NM][4];
#pragma unroll
  for (int m = 0; m < NM; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dk[m][e] = 0.0f;
      dv[m][e] = 0.0f;
    }
  if (f_beg < f_end) {
    const bf* kh = reinterpret_cast<const bf*>(a.k) + b * a.ksb + hk * a.ksh;
    const bf* vh = reinterpret_cast<const bf*>(a.v) + b * a.vsb + hk * a.vsh;
    bf_issue<D, NT>(Ks, NK, [&](int r) -> const bf* {
      return j0 + r < a.Lk ? kh + static_cast<long long>(j0 + r) * a.ksl
                           : nullptr;
    });
    bf_issue<D, NT>(Vs, NK, [&](int r) -> const bf* {
      return j0 + r < a.Lk ? vh + static_cast<long long>(j0 + r) * a.vsl
                           : nullptr;
    });
    issue(f_beg, 0);
    cp_async_commit();
  }
  const float c = a.scale * kLog2e;
  const int key0 = j0 + 16 * warp + g;   // this lane's keys: key0, key0 + 8
  const BfLane<D> L(lane);
  const saddr Ka = smem_addr(Ks), Va = smem_addr(Vs), Ra = smem_addr(R);
  int u = 0;                             // the buffer of this tile
  for (int f0 = f_beg; f0 < f_end; f0 += BR, u ^= 1) {
    cp_async_wait0();
    __syncthreads();   // tile f0 landed; every warp is done with the other
    if (f0 + BR < f_end) issue(f0 + BR, u ^ 1);
    cp_async_commit();
    const saddr Qt = Ra + u * 2 * TB, Ot = Qt + TB;
    const float2* Sc = St + u * BR;
    const bool full =
        bwd_full(a, f0 / rep + off, (f0 + BR - 1) / rep + off, j0, NK);

    // S^T = K_w Q^T and dP^T = V_w dO^T: 8 rows a fragment.
    float st[NJ][4], dp[NJ][4];
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      uint32_t ka[4], va[4];
      ldsm4(ka, L.a(Ka, 16 * warp, 2 * s));
      ldsm4(va, L.a(Va, 16 * warp, 2 * s));
#pragma unroll
      for (int j = 0; j < NJ; j += 2) {
        uint32_t qf[4], of[4];
        ldsm4(qf, L.b(Qt, 8 * j, 2 * s));
        ldsm4(of, L.b(Ot, 8 * j, 2 * s));
        if (s == 0) {
          mma_bf16_z(st[j], ka, qf[0], qf[1]);
          mma_bf16_z(st[j + 1], ka, qf[2], qf[3]);
          mma_bf16_z(dp[j], va, of[0], of[1]);
          mma_bf16_z(dp[j + 1], va, of[2], of[3]);
        } else {
          mma_bf16(st[j], ka, qf[0], qf[1]);
          mma_bf16(st[j + 1], ka, qf[2], qf[3]);
          mma_bf16(dp[j], va, of[0], of[1]);
          mma_bf16(dp[j + 1], va, of[2], of[3]);
        }
      }
    }
    if (full)
      bf_p_ds_t<false>(st, dp, Sc, a, c, t, f0, rep, off, key0);
    else
      bf_p_ds_t<true>(st, dp, Sc, a, c, t, f0, rep, off, key0);
    // dV += P^T dO, then dK += dS^T Q: k-step s takes rows 16s .. 16s +
    // 15 of the tile, the fragments' own columns.
    {
      uint32_t h[NR][4], m[NR][4], l[NR][4];
#pragma unroll
      for (int s = 0; s < NR; ++s)
        c_to_a3(st[2 * s], st[2 * s + 1], h[s], m[s], l[s]);
      bf_rows_product<D, NR>(dv, h, m, l, Ot, L);
    }
    {
      uint32_t h[NR][4], m[NR][4], l[NR][4];
#pragma unroll
      for (int s = 0; s < NR; ++s)
        c_to_a3(dp[2 * s], dp[2 * s + 1], h[s], m[s], l[s]);
      bf_rows_product<D, NR>(dk, h, m, l, Qt, L);
    }
  }
  // One run: the gradients, rounded once to bf16.  Several: this run's
  // float32 partial sums (zeros if it saw none of the tile's keys), which
  // the reduction adds in order.  The group and the run are formed anew
  // (block_x): held across the loop, they spilled at D = 128.
  const long long n = static_cast<long long>(a.B) * a.Hkv * a.Lk * D;
  const int bx = block_x();
  const int grp_e = bx % groups, run_e = (bx / groups) % a.runs;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int j = key0 + 8 * i;
    if (j >= a.Lk) continue;
    const long long base =
        (static_cast<long long>(grp_e) * a.Lk + j) * D + 2 * t;
#pragma unroll
    for (int m = 0; m < NM; ++m) {
      if (a.runs == 1) {
        store2(reinterpret_cast<bf*>(a.dk) + base + 8 * m,
               dk[m][2 * i] * a.scale, dk[m][2 * i + 1] * a.scale);
        store2(reinterpret_cast<bf*>(a.dv) + base + 8 * m, dv[m][2 * i],
               dv[m][2 * i + 1]);
      } else {
        store2(a.part + run_e * n + base + 8 * m, dk[m][2 * i],
               dk[m][2 * i + 1]);
        store2(a.part + (a.runs + run_e) * n + base + 8 * m, dv[m][2 * i],
               dv[m][2 * i + 1]);
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kBfThreads, 2)
    attn_bwd_dq_bf16_kernel(const BwdArgs a) {
  using bf = __nv_bfloat16;
  constexpr int BK = bf_bk<D>(), BQ = kBfRows;
  constexpr int NS = D / 16;       // k16 steps over D
  constexpr int NM = D / 8;        // 8-column tiles of dQ
  constexpr int NJ = BK / 8;       // 8-key tiles of a key tile
  constexpr int NR = BK / 16;      // k16 steps over a key tile
  constexpr int TB = BK * D * 2;   // bytes of a K or V tile
  extern __shared__ uint4 smem_u4[];
  char* Qs = reinterpret_cast<char*>(smem_u4);   // [64][D]
  char* Os = Qs + BQ * D * 2;
  char* R = Os + BQ * D * 2;                     // [2][K, V][BK][D]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int groups = a.B * a.Hkv, rep = a.H / a.Hkv, rows = rep * a.Lq;
  const int rtiles = (rows + BQ - 1) / BQ;
  const int grp = blockIdx.x % groups, b = grp / a.Hkv, hk = grp % a.Hkv;
  // Groups fastest, the last row tiles (which see the most keys) first.
  const int f0 = (rtiles - 1 - static_cast<int>(blockIdx.x) / groups) * BQ;
  const int f_last = min(f0 + BQ, rows) - 1;
  const int off = a.Lk - a.Lq;
  const int p0 = f0 / rep + off, p1 = f_last / rep + off;
  const int lo = a.window > 0 ? max(0, p0 - a.window + 1) : 0;
  const int hi = a.causal ? min(a.Lk, p1 + 1) : a.Lk;
  const int kt0 = (lo / BK) * BK;
  const int ntiles = hi > kt0 ? (hi - kt0 + BK - 1) / BK : 0;
  const bf* kh = reinterpret_cast<const bf*>(a.k) + b * a.ksb + hk * a.ksh;
  const bf* vh = reinterpret_cast<const bf*>(a.v) + b * a.vsb + hk * a.vsh;

  // Keys [kt, kt + BK) of K and V into buffer u (zeros past Lk).
  auto issue = [&](int kt, int u) {
    char* Kt = R + u * 2 * TB;
    bf_issue<D, kBfThreads>(Kt, BK, [&](int r) -> const bf* {
      return kt + r < a.Lk ? kh + static_cast<long long>(kt + r) * a.ksl
                           : nullptr;
    });
    bf_issue<D, kBfThreads>(Kt + TB, BK, [&](int r) -> const bf* {
      return kt + r < a.Lk ? vh + static_cast<long long>(kt + r) * a.vsl
                           : nullptr;
    });
  };
  if (ntiles > 0) {
    const bf* qb = reinterpret_cast<const bf*>(a.q) + b * a.qsb;
    const bf* ob = reinterpret_cast<const bf*>(a.dO) + b * a.dsb;
    bf_issue<D, kBfThreads>(Qs, BQ, [&](int r) -> const bf* {
      return f0 + r < rows ? bwd_qrow(qb, a.qsh, a.qsl, hk, rep, f0 + r)
                           : nullptr;
    });
    bf_issue<D, kBfThreads>(Os, BQ, [&](int r) -> const bf* {
      return f0 + r < rows ? bwd_qrow(ob, a.dsh, a.dsl, hk, rep, f0 + r)
                           : nullptr;
    });
    issue(kt0, 0);
    cp_async_commit();
  }
  // This lane's rows f0 + 16 warp + g and + 8: (lse, Delta) and positions
  // (the padding past `rows` holds zeros).
  const int fr = f0 + 16 * warp + g;
  const float2* sb = a.stats + static_cast<long long>(grp) * a.rows_pad;
  const float2 sv[2] = {sb[fr], sb[fr + 8]};
  const int ap[2] = {fr / rep + off, (fr + 8) / rep + off};
  const float c = a.scale * kLog2e;
  const BfLane<D> L(lane);
  const saddr Qa = smem_addr(Qs), Oa = smem_addr(Os), Ra = smem_addr(R);

  float acc[NM][4];
#pragma unroll
  for (int m = 0; m < NM; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[m][e] = 0.0f;

  for (int it = 0; it < ntiles; ++it) {
    const int kt = kt0 + it * BK, u = it & 1;
    cp_async_wait0();
    __syncthreads();   // tile it landed; every warp is done with the other
    if (it + 1 < ntiles) issue(kt + BK, u ^ 1);
    cp_async_commit();
    const saddr Kt = Ra + u * 2 * TB, Vt = Kt + TB;
    const bool full = bwd_full(a, p0, p1, kt, BK);

    // S = Q_w K^T and dP = dO_w V^T: 8 keys a fragment.
    float s[NJ][4], dp[NJ][4];
#pragma unroll
    for (int ks = 0; ks < NS; ++ks) {
      uint32_t qa[4], oa[4];
      ldsm4(qa, L.a(Qa, 16 * warp, 2 * ks));
      ldsm4(oa, L.a(Oa, 16 * warp, 2 * ks));
#pragma unroll
      for (int j = 0; j < NJ; j += 2) {
        uint32_t kf[4], vf[4];
        ldsm4(kf, L.b(Kt, 8 * j, 2 * ks));
        ldsm4(vf, L.b(Vt, 8 * j, 2 * ks));
        if (ks == 0) {
          mma_bf16_z(s[j], qa, kf[0], kf[1]);
          mma_bf16_z(s[j + 1], qa, kf[2], kf[3]);
          mma_bf16_z(dp[j], oa, vf[0], vf[1]);
          mma_bf16_z(dp[j + 1], oa, vf[2], vf[3]);
        } else {
          mma_bf16(s[j], qa, kf[0], kf[1]);
          mma_bf16(s[j + 1], qa, kf[2], kf[3]);
          mma_bf16(dp[j], oa, vf[0], vf[1]);
          mma_bf16(dp[j + 1], oa, vf[2], vf[3]);
        }
      }
    }
    if (full)
      bf_ds<false>(s, dp, sv, ap, a, c, t, kt);
    else
      bf_ds<true>(s, dp, sv, ap, a, c, t, kt);
    // dQ += dS K: k-step s takes keys 16s .. 16s + 15 of the tile.
    uint32_t h[NR][4], m[NR][4], l[NR][4];
#pragma unroll
    for (int r = 0; r < NR; ++r)
      c_to_a3(s[2 * r], s[2 * r + 1], h[r], m[r], l[r]);
    bf_rows_product<D, NR>(acc, h, m, l, Kt, L);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int f = fr + 8 * i;
    if (f >= rows) continue;
    bf* out = reinterpret_cast<bf*>(a.dq) +
              ((static_cast<long long>(b) * a.H + hk * rep + f % rep) * a.Lq +
               f / rep) * D + 2 * t;
#pragma unroll
    for (int m = 0; m < NM; ++m)
      store2(out + 8 * m, acc[m][2 * i] * a.scale,
             acc[m][2 * i + 1] * a.scale);
  }
}

// The backward's launches for operands of type TO: float32 at every head
// width (the wide passes at 256), bf16 at D <= 128 (the passes above).
template <typename TO, int D>
int launch_bwd(const BwdArgs& a, cudaStream_t stream) {
  constexpr bool kBf = sizeof(TO) == 2, kWide = D > 128;
  static_assert(!kBf || !kWide, "the bf16 passes are built for D <= 128");
  constexpr int NT = kWide ? kWideThreads : bwd_threads<D>();
  constexpr int NT_dkdv = kBf ? kBfThreads : NT;
  constexpr int NT_dq = NT_dkdv;
  constexpr size_t sm_dkdv = kBf     ? smem_bwd_dkdv_bf16<D>()
                             : kWide ? smem_bwd_dkdv_wide<D>()
                                     : smem_bwd_dkdv<D>();
  constexpr size_t sm_dq = kBf     ? smem_bwd_dq_bf16<D>()
                           : kWide ? smem_bwd_dq_wide<D>()
                                   : smem_bwd_dq<D>();
  constexpr int kRowsBlk = kBf ? kBfRows : kWide ? kWideRows : kBwdRows;
  constexpr int kKeysBlk = kBf ? kBfKeys : kWide ? kWideKeys : kBwdKeys;
  constexpr int kRowsAux = kBwdAux / (D / 4 < 32 ? D / 4 : 32);
  void (*dkdv)(BwdArgs);   // the passes of the head width (one built each)
  void (*dq)(BwdArgs);
  if constexpr (kBf) {
    dkdv = attn_bwd_dkdv_bf16_kernel<D>;
    dq = attn_bwd_dq_bf16_kernel<D>;
  } else if constexpr (kWide) {
    dkdv = attn_bwd_dkdv_wide_kernel<D>;
    dq = attn_bwd_dq_wide_kernel<D>;
  } else {
    dkdv = attn_bwd_dkdv_kernel<D>;
    dq = attn_bwd_dq_kernel<D>;
  }
  const int groups = a.B * a.Hkv;
  const int rtiles = ((a.H / a.Hkv) * a.Lq + kRowsBlk - 1) / kRowsBlk;
  const int ktiles = (a.Lk + kKeysBlk - 1) / kKeysBlk;
  int err = opt_in(dkdv, sm_dkdv);
  if (err == 0) err = opt_in(dq, sm_dq);
  if (err != 0) return err;
  const long long nst = static_cast<long long>(groups) * a.rows_pad;
  attn_bwd_delta_kernel<TO, D>
      <<<static_cast<int>((nst + kRowsAux - 1) / kRowsAux), kBwdAux, 0,
         stream>>>(a);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  dkdv<<<ktiles * a.runs * groups, NT_dkdv, sm_dkdv, stream>>>(a);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  if (a.runs > 1) {
    const long long n = static_cast<long long>(a.B) * a.Hkv * a.Lk * D;
    const int blocks = static_cast<int>((n + kBwdAux - 1) / kBwdAux);
    attn_bwd_reduce_kernel<TO><<<blocks, kBwdAux, 0, stream>>>(a, n);
    err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  dq<<<rtiles * groups, NT_dq, sm_dq, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// What the bf16 passes of head width D take on this card: out = {dk/dv's
// registers, local (spilled) bytes, dynamic shared memory, blocks an SM;
// the same four of dq}.
template <int D>
int bwd_bf16_attrs(int* out) {
  void (*k[2])(BwdArgs) = {attn_bwd_dkdv_bf16_kernel<D>,
                           attn_bwd_dq_bf16_kernel<D>};
  const size_t sm[2] = {smem_bwd_dkdv_bf16<D>(), smem_bwd_dq_bf16<D>()};
  for (int i = 0; i < 2; ++i) {
    int err = opt_in(k[i], sm[i]);
    cudaFuncAttributes fa;
    if (err == 0) err = static_cast<int>(cudaFuncGetAttributes(&fa, k[i]));
    int blocks = 0;
    if (err == 0)
      err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, k[i], kBfThreads, sm[i]));
    if (err != 0) return err;
    out[4 * i] = fa.numRegs;
    out[4 * i + 1] = static_cast<int>(fa.localSizeBytes);
    out[4 * i + 2] = static_cast<int>(sm[i]);
    out[4 * i + 3] = blocks;
  }
  return 0;
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
// regime A and needs splits = 1.  `lse`: nullptr, or float32 [B, H, Lq],
// contiguous, which then receives each row's log2-sum-exp of its logits
// scaled by scale * log2(e) (what the backward reads); such a call takes
// regime A at any group size, and q, k, v of one type (the backward's:
// float32, or bf16 at D <= 128).  `o32`: nullptr, or float32 [B, H, Lq,
// D], contiguous, which a call with `lse` fills with o unrounded (for a
// bf16 q, whose o is it rounded once).  Launches on `stream` and returns
// cudaGetLastError() (0 on success), or the error of the shared-memory
// opt-in, or cudaErrorInvalidValue for arguments it does not take.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, const void* kl,
    const void* vl, int B, int H, int Hkv, int Lq, int Lk, int D,
    long long qsb, long long qsh, long long qsl, long long ksb,
    long long ksh, long long ksl, long long vsb, long long vsh,
    long long vsl, long long klsb, long long klsh, long long vlsb,
    long long vlsh, int causal, int window, float scale, int q_bf16,
    int kv_bf16, void* part, int splits, void* lse, void* o32,
    void* stream) {
  if (Hkv <= 0 || H % Hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  if ((kl == nullptr) != (vl == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool split_regime =
      lse == nullptr && (H / Hkv) * static_cast<long long>(Lq) <= kRowsB;
  if (splits < 1 || (!split_regime && splits != 1) ||
      (splits > 1 && part == nullptr) || (o32 != nullptr && lse == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || Lq <= 0) return static_cast<int>(cudaGetLastError());
  const int elt = kv_bf16 ? 2 : 4;
  const int vec = aligned16(k, ksb, ksh, ksl, elt) &&
                  aligned16(v, vsb, vsh, vsl, elt);
  const Args a{q, k, v, o, kl, vl, static_cast<float*>(part), B, H, Hkv, Lq,
               Lk, qsb, qsh, qsl, ksb, ksh, ksl, vsb, vsh, vsl, klsb, klsh,
               vlsb, vlsh, causal, window, scale, splits, vec,
               static_cast<float*>(lse), static_cast<float*>(o32)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return q_bf16 ? launch_kv<__nv_bfloat16>(a, D, kv_bf16, s)
                : launch_kv<float>(a, D, kv_bf16, s);
}

// The backward of flash_attention_launch's function for q [B, H, Lq, D],
// k, v [B, Hkv, Lk, D] and the gradient dO [B, H, Lq, D] of its output, all
// float32, or all bf16 when bf16 != 0 (then D <= 128); its float32 output
// o [B, H, Lq, D] (for bf16 operands the unrounded o32 of the forward)
// and its log2-sum-exp lse [B, H, Lq] (contiguous, as
// flash_attention_launch writes it): q, k, v, o and dO with unit stride
// along D, 16-byte aligned rows and the given element strides (multiples
// of 16 bytes) for batch, head and position.  Writes dq [B, H, Lq, D] and
// dk, dv [B, Hkv, Lk, D], contiguous, of the operands' type, for the same
// causal mask, window (<= 0 for none) and right-aligned queries (Lq <=
// Lk) as the forward.  `stats` is float32 scratch of 2 * B * Hkv *
// rows_pad values, rows_pad = H / Hkv * Lq rounded up to a multiple of 64;
// `runs` >= 1 the dk/dv pass's runs of rows, ceil(H / Hkv * Lq / runs)
// rows each (ops.plan_k7_bwd), and with runs > 1 `part` float32 scratch
// of 2 * runs * B * Hkv * Lk * D values.  D in {32, 64, 128, 256}; H a
// multiple of Hkv.  Three or four launches on `stream`; returns
// cudaGetLastError() (0 on success), the error of a shared-memory opt-in,
// or cudaErrorInvalidValue for arguments it does not take.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dO, const void* lse, void* dq, void* dk, void* dv,
    void* stats, void* part, int runs, int B, int H, int Hkv, int Lq,
    int Lk, int D, long long qsb, long long qsh, long long qsl,
    long long ksb, long long ksh, long long ksl, long long vsb,
    long long vsh, long long vsl, long long osb, long long osh,
    long long osl, long long dsb, long long dsh, long long dsl, int causal,
    int window, float scale, int bf16, void* stream) {
  if (Hkv <= 0 || H % Hkv != 0 || Lq > Lk || stats == nullptr ||
      lse == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (runs < 1 || (runs > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int elt = bf16 ? 2 : 4;
  if (!aligned16(q, qsb, qsh, qsl, elt) || !aligned16(k, ksb, ksh, ksl, elt) ||
      !aligned16(v, vsb, vsh, vsl, elt) || !aligned16(o, osb, osh, osl, 4) ||
      !aligned16(dO, dsb, dsh, dsl, elt))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || Lq <= 0) return static_cast<int>(cudaGetLastError());
  const int rows_pad = ((H / Hkv) * Lq + kBwdRows - 1) / kBwdRows * kBwdRows;
  const BwdArgs a{static_cast<const float*>(q), static_cast<const float*>(k),
                  static_cast<const float*>(v), static_cast<const float*>(dO),
                  static_cast<const float*>(o),
                  static_cast<const float*>(lse), static_cast<float*>(dq),
                  static_cast<float*>(dk), static_cast<float*>(dv),
                  static_cast<float2*>(stats), static_cast<float*>(part), B,
                  H, Hkv, Lq, Lk, rows_pad, qsb, qsh, qsl, ksb, ksh, ksl,
                  vsb, vsh, vsl, dsb, dsh, dsl, osb, osh, osl, causal, window,
                  scale, runs};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    switch (D) {
      case 32: return launch_bwd<__nv_bfloat16, 32>(a, s);
      case 64: return launch_bwd<__nv_bfloat16, 64>(a, s);
      case 128: return launch_bwd<__nv_bfloat16, 128>(a, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  switch (D) {
    case 32: return launch_bwd<float, 32>(a, s);
    case 64: return launch_bwd<float, 64>(a, s);
    case 128: return launch_bwd<float, 128>(a, s);
    case 256: return launch_bwd<float, 256>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The registers, local (spilled) bytes, dynamic shared memory and blocks
// an SM of the bf16 backward's dk/dv and dq passes at head width D (32,
// 64 or 128), into out[0..3] and out[4..7].  Returns a CUDA error, or
// cudaErrorInvalidValue for another D.
extern "C" int flash_attention_bwd_bf16_attrs(int D, int* out) {
  switch (D) {
    case 32: return bwd_bf16_attrs<32>(out);
    case 64: return bwd_bf16_attrs<64>(out);
    case 128: return bwd_bf16_attrs<128>(out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
