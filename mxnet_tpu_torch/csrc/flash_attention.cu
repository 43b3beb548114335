// Flash-attention forward (self-attention, optional causal mask, and ring
// attention's partial mode), for Hopper (sm_90a).
//
// Replaces: mxnet_tpu/rtc.py _flash_kernel, both modes, launched by
// _flash_call from flash_attention (partial=False: the normalized output)
// and from flash_attention_partial (partial=True: the local block of ring
// attention, mxnet_tpu/parallel/ring_attention.py _ring_attention_flash).
// For every (b, h) row and query t < Tq it computes the scores of q[t]
// against the keys k[key], key < Tk (and, causal, q_off + t >= k_off +
// key, i.e. key <= t + shift with shift = q_off - k_off), and the TPU
// kernel's online softmax in float32 over key tiles:
//   m_new = max(m, max_k s),  m_safe = m_new if finite else 0,
//   p = exp(s - m_safe) where s is finite else 0,
//   corr = exp(m - m_safe) where m is finite else 0,
//   l = l * corr + sum_k p,  acc = acc * corr + p . v
// The normalized mode writes out = acc / max(l, 1e-30) in the element
// type, rounded once (q, out (B*H, Tq, Dh), k, v (B*H, Tk, Dh); the causal
// mask bottom-right aligned as in the reference, tril(ones(Tq, Tk), Tk -
// Tq): the offsets q_off = Tk - Tq, k_off = 0, and a row that sees no key
// (Tq > Tk) is NaN, the reference's softmax over -inf alone).
// The partial mode writes the state as the key loop leaves it: acc (B*H,
// Tq, Dh), m and l (B*H, Tq), float32 whatever the element type; q (B*H,
// Tq, Dh) is one query shard and k, v (B*H, Tk, Dh) the K/V shard a ring
// position holds, at absolute offsets q_off and k_off. Key tiles wholly
// above the diagonal are not visited, so a query row that sees no key
// keeps the initial m = -inf, l = 0, acc = 0, as the TPU kernel's scratch
// does. Any Dh up to 128 runs on the smallest of the Dh 32, 64 and 128
// tiles that holds it (head_tile; the 16-bit instances take the Dh 64
// tiles for 8 to 64): the operands' columns past Dh reach the tiles as
// zeros, which leave the scores unchanged and give the accumulator zero
// columns that are not stored, and the scale is the caller's, 1/sqrt of
// the real Dh. The copies are 16 bytes: the float32 instance takes a Dh
// that is a multiple of 4, the 16-bit tensor-core instances a multiple of
// 8 (TMA's row pitch), each on 16-byte aligned operands, and the wrapper
// hands them any other Dh up to 128 as a zero-padded copy. Above 128 every element type takes the wide route
// (cc::flash_wide): column groups of 128 on the grid's x axis, the
// scores over Dh in 128-wide steps on the Dh 128 register tile. B*H is
// on the grid's x axis (2^31 - 1 blocks), the query tiles on y. Any T is
// taken; the query tiles with the most keys are scheduled first.
//
// Two designs, one per element type.
//
// float32 (namespace cc, on the CUDA cores). The reference multiplies at
// Precision.HIGHEST (mxnet_tpu/rtc.py:327-329, :345-346), which rules out
// TF32, so every product is a float32 FMA: q is scaled before the
// product, S and P . V are float32 sums. Bound: operations, 4 Tq Tk Dh
// flops per (b, h) row (half under the causal mask) at the float32
// CUDA-core rate, ~250 flops per byte at T = 1024, Dh = 64. What keeps a
// kernel from that rate is the shared-memory reads that feed the FMAs,
// the latency a block's warps cannot hide, the barriers that stall them
// and, under the causal mask, the unequal work of the query tiles. One
// block of 128 threads (two blocks an SM) per (b*h, query tile) LOOPS
// over key tiles (the TPU kernel's sequential grid axis): 64 queries and
// 64 keys at Dh = 64, 64 and 32 at Dh = 128, 128 and 64 at Dh = 32
// (Tile<DH>). The Q tile and tile
// 0's K and V are copied global -> shared with cp.async, all in flight at
// once, and Q is scaled in place; each later tile's copies go into the
// other of two stages as soon as every thread is done with it, so they
// fly while the current tile's products run. Each thread owns 4 query
// rows (the same rows in S and in the accumulator, so corr applies in
// place; rows rg + 16 j, strided so that a warp's 4 row groups read
// distinct banks), the keys cg + 8 i of S and the output columns 4 cg +
// 32 h: at Dh = 64 a 4 x 8 tile of S and of the accumulator, and each
// 16-byte shared read of K or V feeds 16 FMAs (a warp's 8 rows or column
// groups, padded rows, one wavefront); at Dh = 128 4 x 4 of S and 4 x 16
// of the accumulator; at Dh = 32 each thread owns 8 rows (rg + 16 j of a
// 128-query tile), 8 x 8 of S and 8 x 4 of the accumulator, so a 16-byte
// read of V feeds 32 FMAs where 4 rows would leave it 16 on a 4-column
// share. A row's max and sum reduce over the 8 lanes that
// share it. P goes through shared memory, key-major, each thread's rows
// side by side; a row group is 8 lanes of one warp, so P's rows are
// written and read inside a warp (__syncwarp): one block barrier a tile,
// where the next tile's copies start. The position mask is applied only
// on tiles that cross the diagonal or Tk; every tile keeps the isfinite
// guards (expf of a selected argument, no branch). Blocks start row by
// row with every row's heaviest query tile (the most keys under the
// causal mask) first, so the light tiles fill the end of the grid.
//
// bfloat16 and float16 (namespace tc, on the tensor cores). Bound:
// operations at the 16-bit tensor-core rate first (989 TFLOP/s dense;
// 4 Tq Tk Dh flops, 6 with the split below), bytes second (q, k, v read
// once: ~500 flops per byte at T = 1024, Dh = 64, above the card's ~295).
// The arithmetic keeps the reference's float32 products:
//  - S = Q . K^T is one wgmma (.f32.bf16.bf16 / .f32.f16.f16) per 16 of
//    Dh on q and k as they are stored: a product of two 16-bit values is
//    exact in float32 and wgmma sums in float32. The float32 S is then
//    multiplied by `scale`. At Dh = 16 and 64 the scale, 1/4 or 1/8, is
//    a power of two and this is the reference's (q * scale) . k apart
//    from the order of the sums; at any other Dh it differs by O(1)
//    float32 ulp.
//  - the mask and the online softmax above, in float32, as the float32
//    instance computes them; l sums the unsplit float32 p.
//  - P . V: each float32 p is split into p_hi = round16(p) and p_lo =
//    round16(p - p_hi) (the difference is exact in float32), and two
//    wgmmas accumulate p_hi . V + p_lo . V in float32, V exact in 16
//    bits. P is carried to ~2^-17 of itself in bfloat16 (~2^-22 in
//    float16, down to its 2^-25 subnormal step), far below the output's
//    own rounding (2^-9 in bfloat16). P alone is never rounded to 16 bits.
// Design: one block per (b*h, 128-query tile), 384 threads: two consumer
// warpgroups of 64 query rows each and a producer warpgroup that gives
// its registers to them (setmaxnreg: 40 / 232 a thread; its branch ends
// in `exit`, since a branch that rejoined theirs would hold ptxas to the
// launch's 168 and spill). One producer thread copies the Q tile once and
// the K and V tiles through a ring of kStages = 4 stages in shared memory
// with TMA (cp.async.bulk.tensor, 3-D maps over (Dh, T, b*h), so that rows
// past T, and past a head's end, arrive as zeros; the maps are encoded on
// the host through the runtime's driver entry point, no libcuda link),
// each stage guarded by a full and an empty mbarrier, so the copies run
// ahead of the products. Tiles are stored with the 128-byte swizzle that
// TMA writes and wgmma reads: one 128-byte atom spans 64 values of a row,
// so at Dh = 128 a tile is two panels of 64 columns. A consumer warpgroup
// runs S = Q . K^T from shared memory (m64 x Bk, both operands K-major),
// keeps S in registers and applies the mask and the softmax there (each
// thread holds two query rows, the same rows as its share of the
// accumulator, so corr applies in place; a row's max and sum reduce over
// the 4 lanes that share it, the two rows' chains interleaved). P is
// re-packed as the A fragment of P . V (the accumulator layout of S is
// the A-register layout), and p_hi . V and p_lo . V read V from shared
// memory (MN-major: the transpose bit). Tile j's S is issued together
// with tile j - 1's P . V, and tile j's softmax runs while that product
// finishes. Bk is 128 keys at Dh = 64 (S: 64 registers a thread) and 64
// at Dh = 128, where the accumulator doubles. A Dh below its tile's (16,
// 32 and 48 on the Dh = 64 tiles; 80, 96 and 112 on Dh = 128's) runs on
// TMA maps whose inner dimension is the real Dh: the box stays 64 columns
// (128 bytes, the swizzle's span) and its columns past Dh arrive as
// zeros, which leave S unchanged and give P . V zero columns that are not
// stored; the scale is the caller's (Dh^-1/2). It pays the tile's
// products for fewer bytes: the softmax's float32 work a score, which
// sets the pace, is the same. Keys past Tk get -inf
// scores, and queries past Tq are not written. What holds it at ~1.8x
// SDPA's time (PERF.md, PR 13): the softmax's float32 work a score (the
// accurate expf, the guards, the split) beside 1.5x the products of a
// plain 16-bit forward; a warpgroup ping-pong, 64-key tiles at Dh = 64,
// three consumer warpgroups, two blocks an SM and a second fragment
// buffer were each measured no faster.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "vec_io.cuh"

namespace {

// One launch's operands: q (bh, Tq, dh), k and v (bh, Tk, dh); out (bh,
// Tq, dh) in the element type for the normalized mode, acc (bh, Tq, dh),
// m and l (bh, Tq) float32 for the partial mode (the other outputs are
// null). dh is the operands' own head dim, at most the tile's DH.
struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* acc;
  float* m;
  float* l;
  int bh, Tq, Tk, dh, q_off, k_off, causal;
  float scale;
};

// The tile a head dim runs on: the smallest of 32, 64 and 128 that holds
// it (cuda_kernels.head_tile keeps the same rule)
int head_tile(int dh) { return dh <= 32 ? 32 : (dh <= 64 ? 64 : 128); }

// The query tiles go on the grid's y axis in chunks of its limit, one
// launch a chunk; a block's tile is y0 + blockIdx.y of the n_qt, counted
// from the heaviest
constexpr int kGridY = 65535;
inline unsigned grid_y(int n_qt, int y0) {
  return static_cast<unsigned>(n_qt - y0 < kGridY ? n_qt - y0 : kGridY);
}

// ==========================================================================
// float32: the CUDA cores
// ==========================================================================
namespace cc {

using mxio::Io;

// A block's shape by head dim: kBq query rows, kBk keys a tile, kG lanes a
// row group. Each thread owns kR query rows (rg + kRg j, strided so that
// the warp's row groups read distinct banks) in S and in the accumulator,
// the keys cg + kG i of S and the output columns 4 cg + 4 kG h.
template <int DH>
struct Tile;
template <>
struct Tile<32> {  // S 8 x 8, acc 8 x 4 a thread: 128-query blocks, so a
                   // 16-byte read of V still feeds 32 FMAs
  static constexpr int kBq = 128, kG = 8, kBk = 64, kR = 8;
};
template <>
struct Tile<64> {  // S 4 x 8, acc 4 x 8 a thread
  static constexpr int kBq = 64, kG = 8, kBk = 64, kR = 4;
};
template <>
struct Tile<128> {  // S 4 x 4, acc 4 x 16 a thread
  static constexpr int kBq = 64, kG = 8, kBk = 32, kR = 4;
};

template <int DH>
struct Cfg {
  static constexpr int kBq = Tile<DH>::kBq, kG = Tile<DH>::kG;
  static constexpr int kBk = Tile<DH>::kBk;  // keys per K / V tile
  static constexpr int kR = Tile<DH>::kR;    // query rows a thread
  static constexpr int kRg = kBq / kR;    // row groups
  static constexpr int kThreads = kRg * kG;
  static constexpr int kKs = kBk / kG;    // keys of S a thread
  static constexpr int kCs = DH / kG;     // output columns a thread
  static constexpr int kLd = DH + 4;      // padded row of the Q and K tiles
  static constexpr int kLdP = kBq + 4;    // a key's row of P
  static constexpr int kQ = kBq * kLd, kK = kBk * kLd, kV = kBk * DH;
  static constexpr int kFloats = kQ + 2 * kK + 2 * kV + kBk * kLdP;
  static_assert(kThreads == 128 && kCs % 4 == 0 && kR % 4 == 0 &&
                    32 % kG == 0,
                "shape");
};

// A row's max and sum over the kG lanes that share it (lanes of one row
// group are kG consecutive lanes); the butterfly leaves the same bits in
// every lane.
template <int G>
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <int G>
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 16 bytes global -> shared, asynchronously; zeros where `live` is false
// (src-size 0: nothing is read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool live) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(live ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's copy groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy the kBk K and V rows (dh floats each) of one (b, h) row from key k0
// on into a stage: K into a padded [kBk][kLd] tile, V into [kBk][DH]; rows
// past Tk and columns past dh zeros.
template <int DH>
__device__ __forceinline__ void copy_kv(const float* __restrict__ kb,
                                        const float* __restrict__ vb, int k0,
                                        int Tk, int dh, float* ks, float* vs) {
  using C = Cfg<DH>;
  constexpr int kBk = C::kBk, kUnits = DH / 4;
  for (int e = threadIdx.x; e < kBk * kUnits; e += C::kThreads) {
    const int r = e / kUnits, u = e % kUnits;
    const bool live = k0 + r < Tk && 4 * u < dh;
    const int64_t src = live ? static_cast<int64_t>(k0 + r) * dh + 4 * u : 0;
    cp_async16(ks + r * C::kLd + 4 * u, kb + src, live);
    cp_async16(vs + r * DH + 4 * u, vb + src, live);
  }
  cp_async_commit();
}

// S += (q * scale) . k for this thread's kR rows x kKs keys, over the DH
// columns of the Q tile qs and the K tile ks (both [.][kLd], q scaled)
template <int DH>
__device__ __forceinline__ void scores(
    const float* qs, const float* ks, int rg, int cg,
    float (&s)[Cfg<DH>::kR][Cfg<DH>::kKs]) {
  using C = Cfg<DH>;
  constexpr int kR = C::kR, kKs = C::kKs, kLd = C::kLd;
#pragma unroll
  for (int d = 0; d < DH; d += 4) {
    float4 a[kR];
#pragma unroll
    for (int j = 0; j < kR; ++j)
      a[j] = *reinterpret_cast<const float4*>(qs + (rg + C::kRg * j) * kLd +
                                              d);
#pragma unroll
    for (int i = 0; i < kKs; ++i) {
      const float4 b =
          *reinterpret_cast<const float4*>(ks + (cg + C::kG * i) * kLd + d);
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        s[j][i] = fmaf(a[j].x, b.x, s[j][i]);
        s[j][i] = fmaf(a[j].y, b.y, s[j][i]);
        s[j][i] = fmaf(a[j].z, b.z, s[j][i]);
        s[j][i] = fmaf(a[j].w, b.w, s[j][i]);
      }
    }
  }
}

// One key tile's mask, online-softmax update and acc += P . V from its
// scores s (this thread's kR rows x kKs keys) and the V tile vs
// ([kBk][DH], this thread's columns 4 cg + 4 kG h), P through ps
template <int DH>
__device__ __forceinline__ void softmax_pv(
    float (&s)[Cfg<DH>::kR][Cfg<DH>::kKs], const float* vs, float* ps,
    int k0, int q0, int Tk, int causal, int shift, int rg, int cg,
    float (&m)[Cfg<DH>::kR], float (&l)[Cfg<DH>::kR],
    float (&acc)[Cfg<DH>::kR][Cfg<DH>::kCs]) {
  using C = Cfg<DH>;
  constexpr int kBk = C::kBk, kG = C::kG, kRg = C::kRg;
  constexpr int kKs = C::kKs, kR = C::kR, kCs = C::kCs, kLdP = C::kLdP;
  // the position mask, only on a tile that crosses the diagonal or Tk
  if (k0 + kBk > Tk || (causal && k0 + kBk - 1 > q0 + shift)) {
#pragma unroll
    for (int j = 0; j < kR; ++j) {
      const int qp = q0 + rg + kRg * j;
#pragma unroll
      for (int i = 0; i < kKs; ++i) {
        const int kp = k0 + cg + kG * i;
        const bool live = kp < Tk && (!causal || kp <= qp + shift);
        s[j][i] = live ? s[j][i] : -INFINITY;
      }
    }
  }

  // the online-softmax update of each row; exp of a selected argument
  // (-inf where the guard fails), so expf runs without a branch
#pragma unroll
  for (int j = 0; j < kR; ++j) {
    float mb = -INFINITY;
#pragma unroll
    for (int i = 0; i < kKs; ++i) mb = fmaxf(mb, s[j][i]);
    const float m_new = fmaxf(m[j], row_max<kG>(mb));
    const float m_safe = isfinite(m_new) ? m_new : 0.0f;
    const float corr = expf(isfinite(m[j]) ? m[j] - m_safe : -INFINITY);
    float psum = 0.0f;
#pragma unroll
    for (int i = 0; i < kKs; ++i) {
      const float p = expf(isfinite(s[j][i]) ? s[j][i] - m_safe : -INFINITY);
      s[j][i] = p;
      psum += p;
    }
    l[j] = l[j] * corr + row_sum<kG>(psum);
    m[j] = m_new;
#pragma unroll
    for (int e = 0; e < kCs; ++e) acc[j][e] *= corr;
  }
#pragma unroll
  for (int i = 0; i < kKs; ++i) {
    float* prow = ps + (cg + kG * i) * kLdP + kR * rg;
#pragma unroll
    for (int j = 0; j < kR; j += 4)
      *reinterpret_cast<float4*>(prow + j) =
          make_float4(s[j][i], s[j + 1][i], s[j + 2][i], s[j + 3][i]);
  }
  __syncwarp();  // a row group's lanes are one warp's: so are P's rows

  // acc += P . V over the tile's keys (keys past Tk: p = 0, V rows 0)
#pragma unroll 8
  for (int c = 0; c < kBk; ++c) {
    float pr[kR];
#pragma unroll
    for (int j = 0; j < kR; j += 4) {
      const float4 p4 =
          *reinterpret_cast<const float4*>(ps + c * kLdP + kR * rg + j);
      pr[j] = p4.x;
      pr[j + 1] = p4.y;
      pr[j + 2] = p4.z;
      pr[j + 3] = p4.w;
    }
#pragma unroll
    for (int h = 0; h < kCs / 4; ++h) {
      const float4 w =
          *reinterpret_cast<const float4*>(vs + c * DH + 4 * cg + 4 * kG * h);
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        acc[j][4 * h + 0] = fmaf(pr[j], w.x, acc[j][4 * h + 0]);
        acc[j][4 * h + 1] = fmaf(pr[j], w.y, acc[j][4 * h + 1]);
        acc[j][4 * h + 2] = fmaf(pr[j], w.z, acc[j][4 * h + 2]);
        acc[j][4 * h + 3] = fmaf(pr[j], w.w, acc[j][4 * h + 3]);
      }
    }
  }
}

// emit: acc / l rounded once to E, or (partial) the registers as they
// stand, for this thread's rows and its columns 4 cg + 4 kG h .. + 3 of
// the block's column group starting at col0; 16-byte stores of float
// where dh is a multiple of 4 (each group of 4 lies wholly below dh or
// not), one value at a time otherwise. A normalized row that sees no key
// under the causal mask (Tq > Tk: q_off + qp < k_off) is NaN, the
// softmax of a row of -inf alone, as in the reference.
template <int DH, bool PARTIAL, typename E>
__device__ __forceinline__ void emit(
    const Args& op, int bh, int q0, int col0, int rg, int cg,
    const float (&m)[Cfg<DH>::kR], const float (&l)[Cfg<DH>::kR],
    const float (&acc)[Cfg<DH>::kR][Cfg<DH>::kCs]) {
  using C = Cfg<DH>;
  constexpr int kG = C::kG, kRg = C::kRg, kR = C::kR, kCs = C::kCs;
  const int Tq = op.Tq, dh = op.dh;
  const bool vec = std::is_same<E, float>::value && (dh & 3) == 0;
#pragma unroll
  for (int j = 0; j < kR; ++j) {
    const int qp = q0 + rg + kRg * j;
    if (qp >= Tq) continue;
    const int64_t row = static_cast<int64_t>(bh) * Tq + qp;
    float o[kCs];
    if (PARTIAL) {
#pragma unroll
      for (int e = 0; e < kCs; ++e) o[e] = acc[j][e];
      if (cg == 0 && col0 == 0) {  // the kG lanes of a row hold the same
        op.m[row] = m[j];          // m and l
        op.l[row] = l[j];
      }
    } else {
      const float lj = fmaxf(l[j], 1e-30f);
      const bool none = op.causal && qp + op.q_off - op.k_off < 0;
#pragma unroll
      for (int e = 0; e < kCs; ++e) o[e] = none ? NAN : acc[j][e] / lj;
    }
    float* frow = PARTIAL ? op.acc + row * dh + col0 : nullptr;
    E* erow = PARTIAL ? nullptr : static_cast<E*>(op.out) + row * dh + col0;
#pragma unroll
    for (int h = 0; h < kCs / 4; ++h) {
      const int c = 4 * cg + 4 * kG * h;
      if (col0 + c >= dh) continue;
      if (vec) {
        float* dst = PARTIAL ? frow + c : reinterpret_cast<float*>(erow) + c;
        *reinterpret_cast<float4*>(dst) =
            make_float4(o[4 * h], o[4 * h + 1], o[4 * h + 2], o[4 * h + 3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (col0 + c + e >= dh) break;
          if (PARTIAL)
            frow[c + e] = o[4 * h + e];
          else
            Io<E, 1>::store(erow, c + e, &o[4 * h + e]);
        }
      }
    }
  }
}

template <int DH, bool PARTIAL>
__global__ void __launch_bounds__(128, 1)
    flash_fwd(const Args op, int n_qt, int y0) {
  using C = Cfg<DH>;
  constexpr int kBq = C::kBq, kBk = C::kBk, kG = C::kG, kR = C::kR;
  constexpr int kKs = C::kKs, kCs = C::kCs, kLd = C::kLd;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [kBq][kLd], scaled
  float* kst = qs + C::kQ;                      // 2 x [kBk][kLd]
  float* vst = kst + 2 * C::kK;                 // 2 x [kBk][DH]
  float* ps = vst + 2 * C::kV;  // [kBk][kLdP]: key c, row rg + kRg j at
                                // column kR rg + j

  const int t = threadIdx.x;
  const int cg = t % kG, rg = t / kG;
  const int bh = blockIdx.x;
  const int Tq = op.Tq, Tk = op.Tk, causal = op.causal, dh = op.dh;
  // blocks start in order of x, then y: every row's heaviest query tile
  // (the most keys under the causal mask) first
  const int q0 = (n_qt - 1 - y0 - static_cast<int>(blockIdx.y)) * kBq;
  const int64_t k_base = static_cast<int64_t>(bh) * Tk * dh;
  const float* qb = static_cast<const float*>(op.q) +
                    static_cast<int64_t>(bh) * Tq * dh;
  const float* kb = static_cast<const float*>(op.k) + k_base;
  const float* vb = static_cast<const float*>(op.v) + k_base;
  // the causal test in shard-local positions: key kp is live for query qp
  // when k_off + kp <= q_off + qp, i.e. kp <= qp + shift
  const int shift = op.q_off - op.k_off;
  // key tiles wholly above the tile's last query row are not visited
  const int k_end = causal ? min(Tk, q0 + kBq + shift) : Tk;
  if (k_end > 0) {
    // the Q tile (zeros past Tq and past dh) and tile 0's K and V copies
    // all in flight; once Q has landed, each thread scales the units it
    // copied
    for (int e = t; e < kBq * DH / 4; e += C::kThreads) {
      const int r = e / (DH / 4), u = e % (DH / 4);
      const bool live = q0 + r < Tq && 4 * u < dh;
      cp_async16(qs + r * kLd + 4 * u,
                 qb + (live ? static_cast<int64_t>(q0 + r) * dh + 4 * u : 0),
                 live);
    }
    cp_async_commit();
    copy_kv<DH>(kb, vb, 0, Tk, dh, kst, vst);
    cp_async_wait<1>();  // Q's group
    for (int e = t; e < kBq * DH / 4; e += C::kThreads) {
      float4* p = reinterpret_cast<float4*>(qs + (e / (DH / 4)) * kLd +
                                            4 * (e % (DH / 4)));
      const float4 f = *p;
      *p = make_float4(f.x * op.scale, f.y * op.scale, f.z * op.scale,
                       f.w * op.scale);
    }
  }

  float m[kR], l[kR], acc[kR][kCs];
#pragma unroll
  for (int j = 0; j < kR; ++j) {
    m[j] = -INFINITY;
    l[j] = 0.0f;
#pragma unroll
    for (int e = 0; e < kCs; ++e) acc[j][e] = 0.0f;
  }

  int stage = 0;
  for (int k0 = 0; k0 < k_end; k0 += kBk, stage ^= 1) {
    // tile k0 has landed, and every thread is done with the previous
    // tile (its stage and P): the next tile's copies may start
    cp_async_wait<0>();
    __syncthreads();
    if (k0 + kBk < k_end)
      copy_kv<DH>(kb, vb, k0 + kBk, Tk, dh, kst + (stage ^ 1) * C::kK,
                  vst + (stage ^ 1) * C::kV);
    float s[kR][kKs];
#pragma unroll
    for (int j = 0; j < kR; ++j)
#pragma unroll
      for (int i = 0; i < kKs; ++i) s[j][i] = 0.0f;
    scores<DH>(qs, kst + stage * C::kK, rg, cg, s);
    softmax_pv<DH>(s, vst + stage * C::kV, ps, k0, q0, Tk, causal, shift, rg,
                   cg, m, l, acc);
  }
  emit<DH, PARTIAL, float>(op, bh, q0, 0, rg, cg, m, l, acc);
}

// Rows [r0, r0 + rows) of one (b, h) row's operand (dh values of E each),
// columns [c0, c0 + 128), widened to float32 and multiplied by `scale`
// (exact for 1) into a tile [rows][LD]: rows past T and columns past dh
// zeros. Plain loads, neighbouring threads on neighbouring columns.
template <typename E, int LD>
__device__ __forceinline__ void stage_cols(const E* __restrict__ src, int r0,
                                           int rows, int T, int c0, int dh,
                                           float scale, float* dst) {
  for (int e = threadIdx.x; e < rows * 128; e += 128) {
    const int r = e >> 7, d = e & 127;
    float f = 0.0f;
    if (r0 + r < T && c0 + d < dh)
      Io<E, 1>::load(src, static_cast<int64_t>(r0 + r) * dh + c0 + d, &f);
    dst[r * LD + d] = f * scale;
  }
}

// The wide route, Dh > 128, every element type (float32 and, for these
// head dims, bfloat16 and float16 too, on the CUDA cores): the Dh 128
// tile's block and register tile, one block per (b*h, column group, query
// tile) with the groups on the grid's x axis, each group 128 of the
// output's columns. For every key tile the scores take the keys' full Dh
// in 128-wide steps: the step's Q and K columns are staged, widened to
// float32 (q scaled), and added to S; the group's V columns come with the
// first step. One stage, the steps in order between two barriers each.
template <typename E, bool PARTIAL>
__global__ void __launch_bounds__(128, 1)
    flash_wide(const Args op, int n_qt, int groups, int y0) {
  constexpr int DH = 128;
  using C = Cfg<DH>;
  constexpr int kBq = C::kBq, kBk = C::kBk, kG = C::kG, kR = C::kR;
  constexpr int kKs = C::kKs, kCs = C::kCs, kLd = C::kLd;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [kBq][kLd], scaled
  float* ks = qs + C::kQ;                       // [kBk][kLd]
  float* vs = ks + C::kK;                       // [kBk][DH]
  float* ps = vs + C::kV;                       // [kBk][kLdP]

  const int t = threadIdx.x;
  const int cg = t % kG, rg = t / kG;
  const int bh = blockIdx.x / groups;
  const int col0 = (blockIdx.x % groups) * DH;
  const int Tq = op.Tq, Tk = op.Tk, causal = op.causal, dh = op.dh;
  const int q0 = (n_qt - 1 - y0 - static_cast<int>(blockIdx.y)) * kBq;
  const int64_t k_base = static_cast<int64_t>(bh) * Tk * dh;
  const E* qb = static_cast<const E*>(op.q) +
                static_cast<int64_t>(bh) * Tq * dh;
  const E* kb = static_cast<const E*>(op.k) + k_base;
  const E* vb = static_cast<const E*>(op.v) + k_base;
  const int shift = op.q_off - op.k_off;
  const int k_end = causal ? min(Tk, q0 + kBq + shift) : Tk;

  float m[kR], l[kR], acc[kR][kCs];
#pragma unroll
  for (int j = 0; j < kR; ++j) {
    m[j] = -INFINITY;
    l[j] = 0.0f;
#pragma unroll
    for (int e = 0; e < kCs; ++e) acc[j][e] = 0.0f;
  }
  for (int k0 = 0; k0 < k_end; k0 += kBk) {
    float s[kR][kKs];
#pragma unroll
    for (int j = 0; j < kR; ++j)
#pragma unroll
      for (int i = 0; i < kKs; ++i) s[j][i] = 0.0f;
    for (int c0 = 0; c0 < dh; c0 += DH) {
      __syncthreads();  // every thread is done with the tiles (and P)
      stage_cols<E, kLd>(qb, q0, kBq, Tq, c0, dh, op.scale, qs);
      stage_cols<E, kLd>(kb, k0, kBk, Tk, c0, dh, 1.0f, ks);
      if (c0 == 0) stage_cols<E, DH>(vb, k0, kBk, Tk, col0, dh, 1.0f, vs);
      __syncthreads();
      scores<DH>(qs, ks, rg, cg, s);
    }
    softmax_pv<DH>(s, vs, ps, k0, q0, Tk, causal, shift, rg, cg, m, l, acc);
  }
  emit<DH, PARTIAL, E>(op, bh, q0, col0, rg, cg, m, l, acc);
}

// The 16-byte copies take a dh that is a multiple of 4 floats on 16-byte
// aligned operands (the wrapper pads any other to such a copy)
inline bool aligned16(const Args& a) {
  const uintptr_t bits = static_cast<uintptr_t>(a.dh) * 4 |
                         reinterpret_cast<uintptr_t>(a.q) |
                         reinterpret_cast<uintptr_t>(a.k) |
                         reinterpret_cast<uintptr_t>(a.v);
  return (bits & 15) == 0;
}

template <int DH, bool PARTIAL>
int launch(const Args& a, cudaStream_t st) {
  constexpr int bytes = Cfg<DH>::kFloats * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<DH, PARTIAL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qt = (a.Tq + Cfg<DH>::kBq - 1) / Cfg<DH>::kBq;
  if (!aligned16(a)) return static_cast<int>(cudaErrorInvalidValue);
  for (int y0 = 0; y0 < n_qt; y0 += kGridY) {
    flash_fwd<DH, PARTIAL>
        <<<dim3(a.bh, grid_y(n_qt, y0)), Cfg<DH>::kThreads, bytes, st>>>(
            a, n_qt, y0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

template <typename E, bool PARTIAL>
int launch_wide(const Args& a, cudaStream_t st) {
  using C = Cfg<128>;
  constexpr int bytes =
      (C::kQ + C::kK + C::kV + C::kBk * C::kLdP) * static_cast<int>(
          sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_wide<E, PARTIAL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qt = (a.Tq + C::kBq - 1) / C::kBq;
  const int groups = (a.dh + 127) / 128;
  for (int y0 = 0; y0 < n_qt; y0 += kGridY) {
    flash_wide<E, PARTIAL>
        <<<dim3(static_cast<unsigned>(a.bh) * groups, grid_y(n_qt, y0)),
           C::kThreads, bytes, st>>>(a, n_qt, groups, y0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace cc

// ==========================================================================
// bfloat16 and float16: the tensor cores (wgmma), TMA copies
// ==========================================================================
namespace tc {

constexpr int kConsumers = 2;                    // warpgroups of 64 rows
constexpr int kBq = 64 * kConsumers;             // query rows per block
constexpr int kThreads = 128 * (kConsumers + 1);  // + the producer's
// registers a thread after setmaxnreg: 128 x (40 + 2 x 232) <= 65,536
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kStages = 4;  // K / V ring depth
constexpr int kRow = 128;   // bytes of a swizzle atom row

template <int DH>
struct Cfg {
  static constexpr int kBk = DH == 64 ? 128 : 64;  // keys per tile
  static constexpr int kPanels = DH / 64;          // 64-column panels
  static constexpr int kQBytes = kBq * DH * 2;
  static constexpr int kTileBytes = kBk * DH * 2;  // one K or V tile
  static constexpr int kStageBytes = 2 * kTileBytes;
  // + 1024: the tiles start on a 1024-byte boundary (the swizzle's period)
  static constexpr int kSmem = kQBytes + kStages * kStageBytes + 1024;
};

// ---- PTX: mbarriers, TMA, wgmma -------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Arrive once and expect `bytes` from the copies that complete on `bar`
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity `parity` has completed. A wait lasts a
// tile's copy or products; one that outlasts 2^26 polls is a fault, and
// traps (the launch fails) instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == (1u << 26)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One box of a 3-D map, at coordinates (c0, c1, c2), into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// A wgmma shared-memory descriptor of a 128-byte-swizzled operand at
// `addr`: 8-row groups 1024 bytes apart (SBO); `lbo` the byte stride
// between 64-column panels of an MN-major operand (unused, 16, when the
// operand is K-major).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// Wait until at most N of this warpgroup's committed groups are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of wgmma's registers
// across a fence or a wait: each value is taken as redefined here
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(a[i][r])::"memory");
}

#define MX_D32 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11," \
  " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23," \
  " %24, %25, %26, %27, %28, %29, %30, %31}"
#define MX_OUT32(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
  "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
  "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), \
  "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), \
  "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), \
  "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define MX_D64 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11," \
  " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23," \
  " %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35," \
  " %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47," \
  " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59," \
  " %60, %61, %62, %63}"
#define MX_OUT64(d) \
  MX_OUT32(d), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
  "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), \
  "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), \
  "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), \
  "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
  "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), \
  "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

// d (+)= A . B over 16 of the depth, A and B in shared memory, both
// K-major; d is m64 x N float32 (N / 2 registers a thread). scale_d = 0
// overwrites d.
#define MX_WGMMA_SS(NAME, N, TY, DSTR, OUTS, A, B, S)                        \
  __device__ __forceinline__ void NAME(float (&d)[N / 2], uint64_t a,       \
                                       uint64_t b, int scale_d) {           \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " S ", 0;\n"              \
                 "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "." TY \
                 " " DSTR ", " A ", " B ", p, 1, 1, 0, 0;\n}\n"              \
                 : OUTS(d)                                                  \
                 : "l"(a), "l"(b), "r"(scale_d));                           \
  }
// d += A . B over 16 of the depth, A in registers (4 x 2 values a
// thread), B in shared memory, MN-major (the transpose bit)
#define MX_WGMMA_RS(NAME, N, TY, DSTR, OUTS, A0, A1, A2, A3, B, S)          \
  __device__ __forceinline__ void NAME(float (&d)[N / 2],                   \
                                       const uint32_t (&a)[4], uint64_t b) { \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " S ", 0;\n"              \
                 "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "." TY \
                 " " DSTR ", {" A0 ", " A1 ", " A2 ", " A3 "}, " B          \
                 ", p, 1, 1, 1;\n}\n"                                        \
                 : OUTS(d)                                                  \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),      \
                   "r"(1));                                                 \
  }

MX_WGMMA_SS(ss64_bf16, 64, "bf16", MX_D32, MX_OUT32, "%32", "%33", "%34")
MX_WGMMA_SS(ss128_bf16, 128, "bf16", MX_D64, MX_OUT64, "%64", "%65", "%66")
MX_WGMMA_SS(ss64_f16, 64, "f16", MX_D32, MX_OUT32, "%32", "%33", "%34")
MX_WGMMA_SS(ss128_f16, 128, "f16", MX_D64, MX_OUT64, "%64", "%65", "%66")
MX_WGMMA_RS(rs64_bf16, 64, "bf16", MX_D32, MX_OUT32, "%32", "%33", "%34",
            "%35", "%36", "%37")
MX_WGMMA_RS(rs128_bf16, 128, "bf16", MX_D64, MX_OUT64, "%64", "%65", "%66",
            "%67", "%68", "%69")
MX_WGMMA_RS(rs64_f16, 64, "f16", MX_D32, MX_OUT32, "%32", "%33", "%34",
            "%35", "%36", "%37")
MX_WGMMA_RS(rs128_f16, 128, "f16", MX_D64, MX_OUT64, "%64", "%65", "%66",
            "%67", "%68", "%69")

// The element type's wgmmas, its pair split and its pair store
template <typename E>
struct Ty;

template <>
struct Ty<__nv_bfloat16> {
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  template <int N>
  static __device__ __forceinline__ void ss(float (&d)[N / 2], uint64_t a,
                                            uint64_t b, int scale_d) {
    if constexpr (N == 64) ss64_bf16(d, a, b, scale_d);
    else ss128_bf16(d, a, b, scale_d);
  }
  template <int N>
  static __device__ __forceinline__ void rs(float (&d)[N / 2],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    if constexpr (N == 64) rs64_bf16(d, a, b);
    else rs128_bf16(d, a, b);
  }
  // (x, y) -> hi = round(x, y), lo = round((x, y) - hi), packed low first
  // (cvt's second source lands in the low half); bfloat16 widens by a shift
  static __device__ __forceinline__ void split(float x, float y, uint32_t& hi,
                                               uint32_t& lo) {
    asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(hi) : "f"(y), "f"(x));
    const float hx = __uint_as_float(hi << 16);
    const float hy = __uint_as_float(hi & 0xffff0000u);
    asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(lo) : "f"(y - hy), "f"(x - hx));
  }
  static __device__ __forceinline__ void store2(void* p, float x, float y) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
  }
};

template <>
struct Ty<__half> {
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  template <int N>
  static __device__ __forceinline__ void ss(float (&d)[N / 2], uint64_t a,
                                            uint64_t b, int scale_d) {
    if constexpr (N == 64) ss64_f16(d, a, b, scale_d);
    else ss128_f16(d, a, b, scale_d);
  }
  template <int N>
  static __device__ __forceinline__ void rs(float (&d)[N / 2],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    if constexpr (N == 64) rs64_f16(d, a, b);
    else rs128_f16(d, a, b);
  }
  static __device__ __forceinline__ void split(float x, float y, uint32_t& hi,
                                               uint32_t& lo) {
    asm("cvt.rn.f16x2.f32 %0, %1, %2;" : "=r"(hi) : "f"(y), "f"(x));
    float hx, hy;
    asm("{\n.reg .f16 a, b;\nmov.b32 {a, b}, %2;\n"
        "cvt.f32.f16 %0, a;\ncvt.f32.f16 %1, b;\n}"
        : "=f"(hx), "=f"(hy)
        : "r"(hi));
    asm("cvt.rn.f16x2.f32 %0, %1, %2;" : "=r"(lo) : "f"(y - hy), "f"(x - hx));
  }
  static __device__ __forceinline__ void store2(void* p, float x, float y) {
    *reinterpret_cast<__half2*>(p) = __floats2half2_rn(x, y);
  }
};

// The scale, the mask and the online-softmax update of one key tile's S
// (rows r0 and r0 + 8 of this thread; S register 4 i + 2 h + e is row
// r0 + 8 h, key k0 + 8 i + cq + e): S becomes p in place, m and l are
// updated and corr[h] is the factor the accumulator's row h takes
template <int N>
__device__ __forceinline__ void online_softmax(
    float (&sc)[N], float (&m)[2], float (&l)[2], float (&corr)[2],
    float scale, int Tk, int causal, int shift, int k0, int r0, int cq,
    bool edge) {
  // both rows at once, two partial maxima and sums a row, so that the
  // shuffles and the dependent chains of the two rows overlap
  float mb[2][2] = {{-INFINITY, -INFINITY}, {-INFINITY, -INFINITY}};
#pragma unroll
  for (int i = 0; i < N / 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x = sc[4 * i + 2 * h + e] * scale;
        if (edge) {
          const int kp = k0 + 8 * i + cq + e;
          const bool live = kp < Tk && (!causal || kp <= r0 + 8 * h + shift);
          x = live ? x : -INFINITY;
        }
        sc[4 * i + 2 * h + e] = x;
        mb[h][e] = fmaxf(mb[h][e], x);
      }
  float m_safe[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float v = fmaxf(mb[h][0], mb[h][1]);
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
    const float m_new = fmaxf(m[h], v);
    m_safe[h] = isfinite(m_new) ? m_new : 0.0f;
    // exp(-inf) = 0: the guard selects the argument, so no branch is made
    corr[h] = expf(isfinite(m[h]) ? m[h] - m_safe[h] : -INFINITY);
    m[h] = m_new;
  }
  float ps[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
#pragma unroll
  for (int i = 0; i < N / 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float x = sc[4 * i + 2 * h + e];
        const float p = expf(isfinite(x) ? x - m_safe[h] : -INFINITY);
        sc[4 * i + 2 * h + e] = p;
        ps[h][e] += p;
      }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float v = ps[h][0] + ps[h][1];
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    l[h] = l[h] * corr[h] + v;
  }
}

// DH is the tile's head dim (64 or 128); op.dh <= DH the operands' own, the
// columns written (TMA fills the columns past it with zeros, which leave S
// unchanged and give P . V zero columns)
template <typename E, int DH, bool PARTIAL>
__global__ void __launch_bounds__(kThreads, 1)
    flash_tc(const __grid_constant__ CUtensorMap map_q,
             const __grid_constant__ CUtensorMap map_k,
             const __grid_constant__ CUtensorMap map_v, const Args op,
             int n_qt, int y0) {
  using C = Cfg<DH>;
  constexpr int kBk = C::kBk;
  constexpr int kS = kBk / 2;   // S registers a thread (m64 x kBk)
  constexpr int kO = DH / 2;    // accumulator registers a thread
  constexpr int kK = kBk / 16;  // 16-key steps of P . V
  __shared__ __align__(8) uint64_t bars[1 + 2 * kStages];
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_s = base;  // [panel][kBq][64], swizzled
  // stage s: the K tile [panel][kBk][64], then the V tile alike
  const uint32_t kv_s = base + C::kQBytes;
  const uint32_t bar_q = smem_u32(&bars[0]);
  const uint32_t bar_full = smem_u32(&bars[1]);              // + 8 s
  const uint32_t bar_empty = smem_u32(&bars[1 + kStages]);   // + 8 s

  const int bh = blockIdx.x;
  const int q0 = (n_qt - 1 - y0 - static_cast<int>(blockIdx.y)) * kBq;
  const int Tq = op.Tq, Tk = op.Tk, causal = op.causal;
  const float scale = op.scale;
  // key kp is live for query qp when kp <= qp + shift (causal); key
  // tiles wholly above the tile's last query row are not visited
  const int shift = op.q_off - op.k_off;
  const int k_end = causal ? min(Tk, q0 + kBq + shift) : Tk;
  const int n_kt = k_end > 0 ? (k_end + kBk - 1) / kBk : 0;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 4 * kConsumers);  // one per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= 4 * kConsumers) {
    // the producer warpgroup gives up registers; one thread copies Q once,
    // then K and V tile j into stage j % kStages once it is released
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (warp == 4 * kConsumers && lane == 0 && n_kt > 0) {
      mbar_expect(bar_q, C::kQBytes);
      for (int p = 0; p < C::kPanels; ++p)
        tma_load(q_s + p * kBq * kRow, &map_q, bar_q, 64 * p, q0, bh);
      for (int j = 0; j < n_kt; ++j) {
        const int s = j % kStages;
        const uint32_t ks = kv_s + s * C::kStageBytes;
        const uint32_t vs = ks + C::kTileBytes;
        mbar_wait(bar_empty + 8 * s, ((j / kStages) & 1) ^ 1);
        mbar_expect(bar_full + 8 * s, C::kStageBytes);
        for (int p = 0; p < C::kPanels; ++p) {
          tma_load(ks + p * kBk * kRow, &map_k, bar_full + 8 * s, 64 * p,
                   j * kBk, bh);
          tma_load(vs + p * kBk * kRow, &map_v, bar_full + 8 * s, 64 * p,
                   j * kBk, bh);
        }
      }
    }
    // leave here: a branch that rejoined the consumers' would hold ptxas
    // to the launch's 168 registers a thread in theirs too
    asm volatile("exit;");
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));

  // consumer warpgroup wg: query rows q0 + 64 wg .. + 63; this thread holds
  // rows r0 and r0 + 8 and, of each 8-column block, columns cq and cq + 1
  const int wg = warp / 4;
  const int r0 = q0 + 64 * wg + 16 * (warp % 4) + lane / 4;
  const int cq = 2 * (lane % 4);
  float o[kO];
#pragma unroll
  for (int i = 0; i < kO; ++i) o[i] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  const uint32_t qa = q_s + 64 * wg * kRow;  // this warpgroup's 64 rows

  // S = Q . K^T of stage s, issued: 16 of Dh a wgmma, a 32-byte step
  // inside a panel's 128-byte rows, then the next panel
  float sc[kS];
  auto issue_s = [&](int s) {
    const uint32_t ks = kv_s + s * C::kStageBytes;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;
      Ty<E>::template ss<kBk>(
          sc, desc(qa + (kk / 4) * kBq * kRow + off, 16),
          desc(ks + (kk / 4) * kBk * kRow + off, 16), kk > 0);
    }
    wgmma_commit();
  };
  // o += p_hi . V + p_lo . V of stage s, issued: the S registers of keys
  // 16 kk .. 16 kk + 15 are, in order, the A fragment of the kk-th step;
  // 16 keys are two 8-row groups, 2048 bytes down the V tile
  uint32_t hi[kK][4], lo[kK][4];
  auto issue_pv = [&](int s) {
    const uint32_t vs = kv_s + s * C::kStageBytes + C::kTileBytes;
#pragma unroll
    for (int kk = 0; kk < kK; ++kk) {
      const uint64_t bv = desc(vs + kk * 16 * kRow, kBk * kRow);
      Ty<E>::template rs<DH>(o, hi[kk], bv);
      Ty<E>::template rs<DH>(o, lo[kk], bv);
    }
    wgmma_commit();
  };
  // scale the accumulator's rows by corr, then split p into p_hi + p_lo
  auto rescale_split = [&](const float (&corr)[2]) {
#pragma unroll
    for (int i = 0; i < DH / 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        o[4 * i + 2 * h] *= corr[h];
        o[4 * i + 2 * h + 1] *= corr[h];
      }
#pragma unroll
    for (int kk = 0; kk < kK; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        Ty<E>::split(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1], hi[kk][r],
                     lo[kk][r]);
  };
  auto wait_full = [&](int j) {
    mbar_wait(bar_full + 8 * (j % kStages), (j / kStages) & 1);
    __syncwarp();
  };
  auto release = [&](int j) {  // stage j % kStages is read to its end
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * (j % kStages));
  };
  auto edge = [&](int k0) {  // a tile that needs the mask
    return k0 + kBk > Tk || (causal && k0 + kBk - 1 > q0 + 64 * wg + shift);
  };

  // Tile j's S is computed while tile j - 1's P . V runs, and its softmax
  // while that product finishes: S_j and PV_{j-1} are issued together,
  // S_j is waited for first, PV_{j-1} before the accumulator is rescaled
  float corr[2];
  if (n_kt > 0) {
    mbar_wait(bar_q, 0);
    wait_full(0);
    wgmma_fence();
    issue_s(0);
    wgmma_wait<0>();
    fence_regs(sc);
    online_softmax(sc, m, l, corr, scale, Tk, causal, shift, 0, r0, cq,
                   edge(0));
    rescale_split(corr);
  }
  for (int j = 1; j < n_kt; ++j) {
    wait_full(j);
    fence_regs(o);
    fence_regs(hi);
    fence_regs(lo);
    wgmma_fence();
    issue_s(j % kStages);
    issue_pv((j - 1) % kStages);
    wgmma_wait<1>();
    fence_regs(sc);
    online_softmax(sc, m, l, corr, scale, Tk, causal, shift, j * kBk, r0,
                   cq, edge(j * kBk));
    wgmma_wait<0>();
    fence_regs(o);
    release(j - 1);
    rescale_split(corr);
  }
  if (n_kt > 0) {
    fence_regs(o);
    fence_regs(hi);
    fence_regs(lo);
    wgmma_fence();
    issue_pv((n_kt - 1) % kStages);
    wgmma_wait<0>();
    fence_regs(o);
    release(n_kt - 1);
  }

  // emit: acc / l rounded once, or (partial) the registers as they stand;
  // accumulator register 4 i + 2 h + e is row r0 + 8 h, column 8 i + cq + e
  // (8-column block i lies wholly below dh, a multiple of 8, or not); a
  // normalized row that sees no key under the causal mask is NaN
  const int dh = op.dh;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qp = r0 + 8 * h;
    if (qp >= Tq) continue;
    const int64_t row = static_cast<int64_t>(bh) * Tq + qp;
    if (PARTIAL) {
      float* arow = op.acc + row * dh;
#pragma unroll
      for (int i = 0; i < DH / 8; ++i)
        if (8 * i < dh)
          *reinterpret_cast<float2*>(arow + 8 * i + cq) =
              make_float2(o[4 * i + 2 * h], o[4 * i + 2 * h + 1]);
      if (lane % 4 == 0) {  // the 4 lanes of a row hold the same m and l
        op.m[row] = m[h];
        op.l[row] = l[h];
      }
    } else {
      const float lh = causal && qp + shift < 0 ? NAN : fmaxf(l[h], 1e-30f);
      E* orow = static_cast<E*>(op.out) + row * dh;
#pragma unroll
      for (int i = 0; i < DH / 8; ++i)
        if (8 * i < dh)
          Ty<E>::store2(orow + 8 * i + cq, o[4 * i + 2 * h] / lh,
                        o[4 * i + 2 * h + 1] / lh);
    }
  }
}

// cuTensorMapEncodeTiled, reached through the runtime (no libcuda link)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult got;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &got);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &got);
#endif
    return err == cudaSuccess && got == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A (bh, T, dh) 16-bit operand as the 3-D map (dh, T, bh) with boxes of
// 64 columns x `rows` rows x 1, 128-byte swizzle, zeros outside (a box's
// columns past dh)
template <typename E>
bool tile_map(CUtensorMap* map, const void* ptr, int bh, int T, int dh,
              int rows) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(dh),
                              static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(dh) * 2,
                                 static_cast<cuuint64_t>(T) * dh * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return enc(map, Ty<E>::kMap, 3, const_cast<void*>(ptr), dims, strides, box,
             step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename E, int DH, bool PARTIAL>
int launch(const Args& a, cudaStream_t st) {
  using C = Cfg<DH>;
  constexpr int bytes = C::kSmem;
  const int n_qt = (a.Tq + kBq - 1) / kBq;
  cudaError_t err = cudaFuncSetAttribute(
      flash_tc<E, DH, PARTIAL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  // an empty K/V shard is never read: its maps are drawn over q
  const int tk = a.Tk > 0 ? a.Tk : a.Tq;
  const void* k = a.Tk > 0 ? a.k : a.q;
  const void* v = a.Tk > 0 ? a.v : a.q;
  CUtensorMap mq, mk, mv;
  if (!tile_map<E>(&mq, a.q, a.bh, a.Tq, a.dh, kBq) ||
      !tile_map<E>(&mk, k, a.bh, tk, a.dh, C::kBk) ||
      !tile_map<E>(&mv, v, a.bh, tk, a.dh, C::kBk))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int y0 = 0; y0 < n_qt; y0 += kGridY) {
    flash_tc<E, DH, PARTIAL>
        <<<dim3(a.bh, grid_y(n_qt, y0)), kThreads, bytes, st>>>(
            mq, mk, mv, a, n_qt, y0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace tc

template <typename E, bool PARTIAL>
int dispatch(const Args& a, void* stream) {
  if (a.dh < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (a.bh == 0 || a.Tq == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.dh > 128) return cc::launch_wide<E, PARTIAL>(a, st);
  const int tile = head_tile(a.dh);
  if constexpr (std::is_same<E, float>::value) {
    if (tile == 32) return cc::launch<32, PARTIAL>(a, st);
    if (tile == 64) return cc::launch<64, PARTIAL>(a, st);
    return cc::launch<128, PARTIAL>(a, st);
  } else {  // wgmma reads 128-byte rows: the Dh 64 tiles hold 8 to 64
    // TMA takes a row pitch and addresses that are multiples of 16 bytes
    const uintptr_t bits = static_cast<uintptr_t>(a.dh) * 2 |
                           reinterpret_cast<uintptr_t>(a.q) |
                           reinterpret_cast<uintptr_t>(a.k) |
                           reinterpret_cast<uintptr_t>(a.v);
    if (bits & 15) return static_cast<int>(cudaErrorInvalidValue);
    if (tile <= 64) return tc::launch<E, 64, PARTIAL>(a, st);
    return tc::launch<E, 128, PARTIAL>(a, st);
  }
}

// The normalized mode over q (bh, Tq, dh) and k, v (bh, Tk, dh): the
// causal mask bottom-right aligned, key kp live for query qp when kp <=
// qp + Tk - Tq (the reference's tril(ones(Tq, Tk), Tk - Tq)), i.e. the
// offsets q_off = Tk - Tq, k_off = 0
template <typename E>
int normalized(const void* q, const void* k, const void* v, void* out,
               int bh, int Tq, int Tk, int dh, int causal, float scale,
               void* stream) {
  const Args a{q, k, v, out, nullptr, nullptr, nullptr, bh, Tq, Tk, dh,
               Tk - Tq, 0, causal, scale};
  return dispatch<E, false>(a, stream);
}

template <typename E>
int partial(const void* q, const void* k, const void* v, void* acc, void* m,
            void* l, int bh, int Tq, int Tk, int dh, int q_off, int k_off,
            int causal, float scale, void* stream) {
  const Args a{q, k, v, nullptr, static_cast<float*>(acc),
               static_cast<float*>(m), static_cast<float*>(l), bh, Tq, Tk,
               dh, q_off, k_off, causal, scale};
  return dispatch<E, true>(a, stream);
}

}  // namespace

// q, out (bh, Tq, dh) and k, v (bh, Tk, dh) float32, contiguous, one
// device; any dh >= 1 (above 128 the wide route), any bh. Returns
// cudaGetLastError().
extern "C" int mx_flash_attention_f32(const void* q, const void* k,
                                      const void* v, void* out, int bh,
                                      int Tq, int Tk, int dh, int causal,
                                      float scale, void* stream) {
  return normalized<float>(q, k, v, out, bh, Tq, Tk, dh, causal, scale,
                           stream);
}

// The same over bfloat16 q, k, v and out, on the tensor cores for dh up to
// 128, a multiple of 8 on 16-byte aligned operands (cudaErrorInvalidValue
// for another such dh, and where a TMA map cannot be made); above 128 the
// wide route on the CUDA cores, any dh.
extern "C" int mx_flash_attention_bf16(const void* q, const void* k,
                                       const void* v, void* out, int bh,
                                       int Tq, int Tk, int dh, int causal,
                                       float scale, void* stream) {
  return normalized<__nv_bfloat16>(q, k, v, out, bh, Tq, Tk, dh, causal,
                                   scale, stream);
}

// The same over float16 q, k, v and out, on the tensor cores.
extern "C" int mx_flash_attention_f16(const void* q, const void* k,
                                      const void* v, void* out, int bh,
                                      int Tq, int Tk, int dh, int causal,
                                      float scale, void* stream) {
  return normalized<__half>(q, k, v, out, bh, Tq, Tk, dh, causal, scale,
                            stream);
}

// Partial mode: q (bh, Tq, dh), k and v (bh, Tk, dh) float32, contiguous,
// one device; acc (bh, Tq, dh), m and l (bh, Tq) float32 out. Any dh >= 1
// and bh, as the normalized mode. Returns cudaGetLastError().
extern "C" int mx_flash_attention_partial_f32(
    const void* q, const void* k, const void* v, void* acc, void* m, void* l,
    int bh, int Tq, int Tk, int dh, int q_off, int k_off, int causal,
    float scale, void* stream) {
  return partial<float>(q, k, v, acc, m, l, bh, Tq, Tk, dh, q_off, k_off,
                        causal, scale, stream);
}

// The same over bfloat16 q, k and v (acc, m and l float32), on the tensor
// cores.
extern "C" int mx_flash_attention_partial_bf16(
    const void* q, const void* k, const void* v, void* acc, void* m, void* l,
    int bh, int Tq, int Tk, int dh, int q_off, int k_off, int causal,
    float scale, void* stream) {
  return partial<__nv_bfloat16>(q, k, v, acc, m, l, bh, Tq, Tk, dh, q_off,
                                k_off, causal, scale, stream);
}

// The same over float16 q, k and v (acc, m and l float32), on the tensor
// cores.
extern "C" int mx_flash_attention_partial_f16(
    const void* q, const void* k, const void* v, void* acc, void* m, void* l,
    int bh, int Tq, int Tk, int dh, int q_off, int k_off, int causal,
    float scale, void* stream) {
  return partial<__half>(q, k, v, acc, m, l, bh, Tq, Tk, dh, q_off, k_off,
                         causal, scale, stream);
}
