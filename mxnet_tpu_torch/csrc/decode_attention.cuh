// Cursor-bounded flash-decode attention read, for Hopper (sm_90a): the
// kernel body and its launches, shared by four sources that nvcc builds in
// parallel: the Dh 32, 64 and 128 tiles over float32 caches
// (decode_attention.cu), fp8 caches (decode_attention_fp8.cu) and 16-bit
// ones (decode_attention_16.cu), and the general route, WIDE, over every
// cache type (decode_attention_any.cu). Each includes this header once,
// inside its own translation unit.
//
// Replaces: mxnet_tpu/ops/pallas_kernels.py _decode_attn_kernel, launched by
// decode_attention. For every (b, h) row and query s < S it computes
//   softmax_k( (q[s] * Dh^-1/2) . k[k_pos] )  over k_pos <= cursor_b + s
// and the weighted sum of v over the same keys, with an online softmax
// (running max m, normalizer l, accumulator acc) in float32, and writes
// the float32 output (B, H, S, Dh). Only the live prefix
// [0, min(C, cursor_b + S)) of the cache is ever read. The RoPE and the
// cache write happen before the call, outside this kernel (mxnet_tpu_torch/
// rtc.py), exactly as in the JAX package.
//
// The cache is float32 or fp8 storage (float8_e4m3fn, float8_e5m2) with a
// float32 query, or bfloat16 or float16 with a query of the same type (the
// mixed-precision paths), one template instance each. Cache values are
// widened to float32 as they are read from shared memory, as the TPU kernel
// widens its blocks on read (astype(float32)); fp8 goes through half, and
// every widening is exact, so the narrow instances compute exactly what the
// float32 instance computes on the same values. A 16-bit query is widened
// before it is scaled. The output is float32 in every instance (the op
// casts it to the query's type). A live score that is NaN or +inf (a NaN
// cell, e.g. a float8_e4m3fn overflow on write, or an e5m2 infinity) makes
// its row NaN, as it does in the plain softmax: its p is NaN, so the
// normalizer l and the accumulator carry the poison through every rescale
// (NaN * 0 is NaN) and every merge, while m ignores it (fmaxf drops NaN).
//
// Bound: bytes. Each row reads its live K and V prefix once, 2 * live * Dh
// * (4, 2 or 1) bytes, for 4 * S * live * Dh flops; at S=1 that is half a
// flop (one for bfloat16, two for fp8) per byte, far below the card's
// operations-per-byte line. At the served step (B*H = 64 rows of at most
// 256 keys) the bytes take about a microsecond, so what the design fights
// is latency:
//
// * The key range is split over blocks: the grid is (B*H, query tiles,
//   splits), the split size chosen on the host from B*H, S, C and the SM
//   count (cuda_kernels._decode_splits; it never reads the cursors), so
//   the served step runs 256 blocks of 64 keys instead of 64 blocks that
//   each walk a whole row, and a 4096-key cache 4 splits of 1024. A split
//   wholly past its row's live prefix reads nothing and leaves an empty
//   partial (m = -inf, l = 0, acc = 0).
// * Inside a block each warp is a flash-decode of its own: it takes the
//   split's 32-key chunks w, w + warps, ..., one key a lane for the
//   scores, and keeps (m, l, acc) in registers. A chunk's K and V rows are
//   copied into the warp's own shared-memory ring with cp.async, 16 bytes
//   a copy in every instance (the caches are 16-byte aligned, rows are 64
//   to 512 bytes), all of a chunk's copies in flight together and, where
//   a warp has more than one chunk, the next chunk's issued before this
//   one is consumed (two stages; one for a window over 256- or 512-byte
//   rows, to keep two blocks an SM). No block-wide barrier runs inside
//   the key loop: a warp waits for its own copies and syncs with
//   __syncwarp. The first chunks' copies are issued before the query rows
//   are staged, so the two loads overlap.
// * Head dims: a Dh up to 128 whose rows are a whole number of 16-byte
//   copies (and whose caches are 16-byte aligned) runs on the smallest of
//   the Dh 32, 64 and 128 tiles that holds it (head_tile); the copies
//   past Dh are zero-filled (nothing is read), the staged query is zero
//   past Dh, so the scores are Dh's own and the accumulator's columns
//   past Dh hold zeros, which are not stored. 1/sqrt(Dh) is the caller's,
//   from the real Dh.
// * Every other Dh takes the general route (WIDE): the Dh 128 tile, the
//   output's columns cut into groups of 128 on the grid's x axis (B*H *
//   groups blocks; one group up to 128), so a lane still holds 4 of V's
//   dims a row, whatever Dh. Each block takes the scores over the keys'
//   full Dh in 128-wide steps: for each step a warp copies the chunk's K
//   columns into its stage and its query rows' columns into its own slice
//   of shared memory, and adds the step's products to the scores; its
//   group's V columns come with the first step. One stage a warp, the
//   steps in order (the K rows are read once a group). Rows are copied in
//   the widest unit that divides their bytes and both caches' addresses
//   (`unit`, chosen by the wrapper: 16, 8 or 4 bytes through cp.async, 2
//   or 1 by plain loads, as an fp8 row of an odd Dh needs). Its S = 1
//   instance takes a thread's full 255 registers (decode_attn_any).
// * S = 1 has its own instance: one query row, one score a lane (four
//   interleaved partial sums), p handed to the accumulator by shuffles; a
//   lane accumulates Dh / 32 dims of the tile; two warps a block. A window
//   (S > 1, any S) takes tiles of 16 query rows on the grid's y axis, four
//   warps a block; a full tile runs every row's chains unguarded, so they
//   interleave, and the last tile's rows past S are skipped by
//   warp-uniform branches, never computed nor merged.
// * The block's warps are merged in warp order, in shared memory. With
//   more than one split each block writes its float32 (m, l, acc) to a
//   workspace and bumps its (row, tile) counter after a __threadfence;
//   the block that arrives last merges the splits in split order 0, 1, 2,
//   ... (so the bits do not depend on which block is last), writes the
//   output and resets the counter: one launch, no float atomics, the same
//   bits on every call. Every merge, warp or split, is the online rule:
//   m = max, m_safe = isfinite(m) ? m : 0, each side scaled by
//   exp(m_side - m_safe) (0 for a side whose m is not finite), added.
//
// Every product is a float32 FMA, no tensor cores and so no TF32, matching
// the reference's Precision.HIGHEST; exp is expf. The cursor is taken per
// (b, h) row, b-major: b = bh / H.
#pragma once

#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "vec_io.cuh"

namespace {

constexpr int kKeys = 32;               // keys a chunk: one a lane
constexpr int kWinRows = 16;            // query rows a window tile
constexpr int kPsStride = kWinRows + 4;  // floats a key's p row (padded)
constexpr int kMaxDevices = 16;
constexpr int kGridY = 65535;           // the grid's y limit
constexpr unsigned kAllLanes = 0xffffffffu;

// fp8 storage types: the interpretation __nv_cvt_fp8x2_to_halfraw2 takes
struct E4M3 {
  static constexpr __nv_fp8_interpretation_t kind = __NV_E4M3;
};
struct E5M2 {
  static constexpr __nv_fp8_interpretation_t kind = __NV_E5M2;
};

template <typename Cache>
constexpr bool kHalf16 = std::is_same<Cache, __nv_bfloat16>::value ||
                         std::is_same<Cache, __half>::value;

// bytes of one cache value
template <typename Cache>
constexpr int kElem = std::is_same<Cache, float>::value ? 4
                      : kHalf16<Cache>                   ? 2
                                                         : 1;

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kAllLanes, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kAllLanes, v, o);
  return v;
}

// a pair of fp8 codes -> two floats, through half (exact for both formats,
// NaN and infinities kept)
template <typename Fp8>
__device__ __forceinline__ float2 fp8x2_to_float2(uint32_t pair) {
  const __half2_raw hr = __nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(pair & 0xffffu), Fp8::kind);
  return __half22float2(__half2(hr));
}

__device__ __forceinline__ float widen1(float x) { return x; }
__device__ __forceinline__ float widen1(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float widen1(__half x) { return __half2float(x); }

// N consecutive cache values at p (N * kElem bytes, aligned to that) ->
// N floats, widened exactly. N is 1 (a lane's one V dim at Dh = 32), 2,
// 4, 8 or 16, one shared-memory access.
template <typename Cache, int N>
__device__ __forceinline__ void widen(const uint8_t* p, float* f) {
  if constexpr (N == 1 && !std::is_same<Cache, float>::value) {
    if constexpr (kHalf16<Cache>)
      f[0] = widen1(*reinterpret_cast<const Cache*>(p));
    else
      f[0] = fp8x2_to_float2<Cache>(*p).x;
    return;
  }
  constexpr int kBytes = N * kElem<Cache>;
  static_assert(N == 1 || kBytes == 2 || kBytes == 4 || kBytes == 8 ||
                    kBytes == 16,
                "one access of 2 to 16 bytes");
  uint32_t w[kBytes >= 4 ? kBytes / 4 : 1];
  if constexpr (kBytes == 16) {
    const uint4 r = *reinterpret_cast<const uint4*>(p);
    w[0] = r.x, w[1] = r.y, w[2] = r.z, w[3] = r.w;
  } else if constexpr (kBytes == 8) {
    const uint2 r = *reinterpret_cast<const uint2*>(p);
    w[0] = r.x, w[1] = r.y;
  } else if constexpr (kBytes == 4) {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  } else {
    w[0] = *reinterpret_cast<const uint16_t*>(p);
  }
  if constexpr (std::is_same<Cache, float>::value) {
#pragma unroll
    for (int i = 0; i < N; ++i) f[i] = __uint_as_float(w[i]);
  } else if constexpr (kHalf16<Cache>) {
    using Pair = typename mxio::Half<Cache>::Pair;
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const uint32_t bits = w[i];
      const float2 v =
          mxio::Half<Cache>::widen2(*reinterpret_cast<const Pair*>(&bits));
      f[2 * i] = v.x;
      f[2 * i + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float2 v = fp8x2_to_float2<Cache>(w[i / 2] >> (16 * (i % 2)));
      f[2 * i] = v.x;
      f[2 * i + 1] = v.y;
    }
  }
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

// 8 or 4 bytes global -> shared, asynchronously; zeros where `live` is
// false
template <int N>
__device__ __forceinline__ void cp_async_ca(void* dst, const void* src,
                                            bool live) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
               "l"(src), "n"(N), "r"(live ? N : 0)
               : "memory");
}

// one `unit`-byte copy (16, 8 or 4 through cp.async; 2 or 1 by a plain
// load and store), zeros where `live` is false
__device__ __forceinline__ void copy_unit(uint8_t* d, const uint8_t* s,
                                          bool live, int unit) {
  switch (unit) {
    case 16: cp_async16(d, s, live); break;
    case 8: cp_async_ca<8>(d, s, live); break;
    case 4: cp_async_ca<4>(d, s, live); break;
    case 2:
      *reinterpret_cast<uint16_t*>(d) =
          live ? *reinterpret_cast<const uint16_t*>(s) : uint16_t(0);
      break;
    default: *d = live ? *s : uint8_t(0);
  }
}

// Rows [0, nk) of a cache at src (row_bytes apart), the tile's bytes [c0,
// c0 + TILE) of each, into dst (PITCH apart) in `unit`-byte copies, the
// bytes past the row's own zero-filled; one warp, lane by lane
template <int TILE, int PITCH>
__device__ __forceinline__ void copy_rows(uint8_t* dst, const uint8_t* src,
                                          int nk, int row_bytes, int c0,
                                          int unit, int lane) {
  const int per = TILE / unit;
#pragma unroll 1
  for (int e = lane; e < nk * per; e += 32) {
    const int j = e / per, u = e % per;
    const int off = c0 + u * unit;
    const bool live = off < row_bytes;
    copy_unit(dst + j * PITCH + u * unit,
              src + static_cast<int64_t>(j) * row_bytes + (live ? off : 0),
              live, unit);
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}



// exp(x - m_safe) of a state whose max is x: 0 unless x is finite (the
// argument is selected, so expf runs unconditionally: no branch)
__device__ __forceinline__ float rescale(float x, float m_safe) {
  return expf(isfinite(x) ? x - m_safe : -INFINITY);
}

// Merge the state (mb, lb, ab) into (m, l, a): the online-softmax rule of
// the TPU kernel's m/l/corr update, for one accumulator entry
__device__ __forceinline__ void merge(float& m, float& l, float& a, float mb,
                                      float lb, float ab) {
  const float mn = fmaxf(m, mb);
  const float ms = isfinite(mn) ? mn : 0.0f;
  const float c0 = rescale(m, ms), c1 = rescale(mb, ms);
  l = fmaf(lb, c1, l * c0);
  a = fmaf(ab, c1, a * c0);
  m = mn;
}

// Shared-memory layout of one launch (bytes), for a block of ROWS query
// rows on the tile of head dim DH (32, 64 or 128; the cache's own Dh may be
// less, its columns past Dh zeros). A chunk stage holds 32 K rows then 32 V
// rows, each padded by 16 bytes so the lanes of a quarter warp, one K row
// each, hit distinct banks.
template <int DH, typename Cache, int ROWS, bool WIDE = false>
struct Smem {
  // warps a block: two at S = 1, four for a window tile (16 rows give a
  // chunk 16 times the work, so more warps share a split)
  static constexpr int kWarps = ROWS == 1 ? 2 : 4;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kRowBytes = DH * kElem<Cache>;
  static constexpr int kPitch = kRowBytes + 16;
  static constexpr int kStage = 2 * kKeys * kPitch;
  // ring stages a warp may take: two, but one for a window's four warps
  // over 256- or 512-byte rows, so that two blocks still fit an SM
  // (the wide route: one, its steps in order)
  static constexpr int kMaxStages =
      WIDE ? 1 : (ROWS == 1 || kRowBytes <= 128 ? 2 : 1);
  // the scaled query rows: the block's, or on the wide route each warp's
  // own, one 128-column step at a time
  static constexpr int kQ = (WIDE ? kWarps : 1) * ROWS * DH * 4;
  static constexpr int kPs = ROWS > 1 ? kWarps * kKeys * kPsStride * 4 : 0;
  // the warps' (m, l, acc) for the block merge, then each row's merge
  // coefficients and merged (m, l), over the ring
  static constexpr int kMerge =
      (kWarps * ROWS * (DH + 2) + ROWS * (2 * kWarps + 2)) * 4;
  static constexpr int bytes(int stages) {
    return kQ + kPs +
           (kWarps * stages * kStage > kMerge ? kWarps * stages * kStage
                                              : kMerge);
  }
};

// The scores of one chunk's keys (lane = key, its K row in the stage
// read 16 bytes at a time) against the tile's scaled query rows qs
// ([ROWS][DH]), added to sc: one row in four interleaved sums (the S = 1
// route), or one sum a row. FULL (a full tile: every window tile but the
// last, and S = 1) drops the row guards, so the rows' chains interleave.
template <bool FULL, int DH, typename Cache, int ROWS>
__device__ __forceinline__ void chunk_scores(
    const uint8_t* st, int nrows, const float* qs, int lane,
    float (&sc)[ROWS][ROWS == 1 ? 4 : 1]) {
  using L = Smem<DH, Cache, ROWS>;
  constexpr int kUnits = L::kRowBytes / 16;        // 16-byte units a row
  constexpr int kU = 16 / kElem<Cache>;            // values a unit
  constexpr int kParts = ROWS == 1 ? 4 : 1;
  const uint8_t* krow = st + lane * L::kPitch;
#pragma unroll
  for (int u = 0; u < kUnits; ++u) {
    float f[kU];
    widen<Cache, kU>(krow + 16 * u, f);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (FULL || r < nrows) {
        const float* qr = qs + r * DH + u * kU;
#pragma unroll
        for (int x = 0; x < kU; ++x)
          sc[r][u % kParts] = fmaf(qr[x], f[x], sc[r][u % kParts]);
      }
    }
  }
}

// One chunk's online-softmax update of every live row from its scores sc:
// the TPU kernel's m / l / corr rule, and acc = acc * corr + sum_j p_j v_j
// over the chunk's V rows in the stage. Inlined, so the state arrays stay
// in registers.
template <bool FULL, int DH, typename Cache, int ROWS>
__device__ __forceinline__ void chunk_apply(
    const uint8_t* st, int ks, int k_hi, int nrows, int64_t first_pos,
    float* ps, int lane, const float (&sc)[ROWS][ROWS == 1 ? 4 : 1],
    float (&m)[ROWS], float (&l)[ROWS], float (&acc)[ROWS][DH / 32]) {
  using L = Smem<DH, Cache, ROWS>;
  constexpr int kPitch = L::kPitch;
  constexpr int kVd = DH / 32;                     // dims a lane
  constexpr int kVBytes = kVd * kElem<Cache>;
  constexpr int kParts = ROWS == 1 ? 4 : 1;
  const int nk = min(kKeys, k_hi - ks);
  const int kp = ks + lane;
  // online-softmax update of each row (the TPU kernel's m/l/corr rule)
  float p[ROWS], corr[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    p[r] = 0.0f;
    corr[r] = 1.0f;
    if (FULL || r < nrows) {
      float dot = sc[r][0];
      if constexpr (kParts == 4)
        dot = (sc[r][0] + sc[r][1]) + (sc[r][2] + sc[r][3]);
      const bool valid = lane < nk && kp <= first_pos + r;
      const float s = valid ? dot : -INFINITY;
      const float m_new = fmaxf(m[r], warp_max(s));
      const float m_safe = isfinite(m_new) ? m_new : 0.0f;
      // p: exp(s - m_safe); 0 for a masked key; NaN for NaN or +inf
      p[r] = expf(isfinite(s) ? s - m_safe
                              : (s == -INFINITY ? -INFINITY : NAN));
      corr[r] = rescale(m[r], m_safe);
      l[r] = l[r] * corr[r] + warp_sum(p[r]);
      m[r] = m_new;
    }
  }
  // acc = acc * corr + sum_j p_j v_j, keys in order; a lane's dims
  // [lane * kVd, lane * kVd + kVd)
  const uint8_t* vrow = st + kKeys * kPitch + lane * kVBytes;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (FULL || r < nrows) {
#pragma unroll
      for (int d = 0; d < kVd; ++d) acc[r][d] *= corr[r];
    }
  }
  if constexpr (ROWS == 1) {
#pragma unroll 8
    for (int j = 0; j < nk; ++j) {
      const float pj = __shfl_sync(kAllLanes, p[0], j);
      float vv[kVd];
      widen<Cache, kVd>(vrow + j * kPitch, vv);
#pragma unroll
      for (int d = 0; d < kVd; ++d) acc[0][d] = fmaf(pj, vv[d], acc[0][d]);
    }
  } else {
#pragma unroll
    for (int r = 0; r < ROWS; r += 4)
      *reinterpret_cast<float4*>(ps + lane * kPsStride + r) =
          make_float4(p[r], p[r + 1], p[r + 2], p[r + 3]);
    __syncwarp();
#pragma unroll 2
    for (int j = 0; j < nk; ++j) {
      float vv[kVd];
      widen<Cache, kVd>(vrow + j * kPitch, vv);
      float pj[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; r += 4) {
        const float4 p4 =
            *reinterpret_cast<const float4*>(ps + j * kPsStride + r);
        pj[r] = p4.x, pj[r + 1] = p4.y, pj[r + 2] = p4.z, pj[r + 3] = p4.w;
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        if (FULL || r < nrows) {
#pragma unroll
          for (int d = 0; d < kVd; ++d)
            acc[r][d] = fmaf(pj[r], vv[d], acc[r][d]);
        }
      }
    }
  }
}

// One chunk's scores and update, its K and V rows staged together
template <bool FULL, int DH, typename Cache, int ROWS>
__device__ __forceinline__ void chunk_update(
    const uint8_t* st, int ks, int k_hi, int nrows, int64_t first_pos,
    const float* qs, float* ps, int lane, float (&m)[ROWS], float (&l)[ROWS],
    float (&acc)[ROWS][DH / 32]) {
  float sc[ROWS][ROWS == 1 ? 4 : 1];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int x = 0; x < (ROWS == 1 ? 4 : 1); ++x) sc[r][x] = 0.0f;
  chunk_scores<FULL, DH, Cache, ROWS>(st, nrows, qs, lane, sc);
  chunk_apply<FULL, DH, Cache, ROWS>(st, ks, k_hi, nrows, first_pos, ps,
                                     lane, sc, m, l, acc);
}

// The wide route's chunk (DH = 128 a step, dh > 128): for each 128-column
// step of the keys' Dh, the chunk's K columns into the warp's stage and
// its query rows' columns, scaled, into its own slice wq, the step's
// products added to the scores; the group's V columns come with step 0.
// The steps run in order on one stage (each waits for its copies).
template <bool FULL, int DH, typename Cache, typename Q, int ROWS>
__device__ __forceinline__ void wide_chunk(
    uint8_t* st, const uint8_t* kb, const uint8_t* vb, const Q* qb, int ks,
    int k_hi, int nrows, int64_t first_pos, int dh, int group, int unit,
    float scale, float* wq, float* ps, int lane, float (&m)[ROWS],
    float (&l)[ROWS], float (&acc)[ROWS][DH / 32]) {
  using L = Smem<DH, Cache, ROWS, true>;
  const int row_bytes = dh * kElem<Cache>;
  const int nk = min(kKeys, k_hi - ks);
  const int64_t off = static_cast<int64_t>(ks) * row_bytes;
  float sc[ROWS][ROWS == 1 ? 4 : 1];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int x = 0; x < (ROWS == 1 ? 4 : 1); ++x) sc[r][x] = 0.0f;
  for (int c0 = 0; c0 < dh; c0 += DH) {
    __syncwarp();  // the stage and wq are read to their end
    copy_rows<L::kRowBytes, L::kPitch>(st, kb + off, nk, row_bytes,
                                       c0 * kElem<Cache>, unit, lane);
    if (c0 == 0)
      copy_rows<L::kRowBytes, L::kPitch>(st + kKeys * L::kPitch, vb + off,
                                         nk, row_bytes,
                                         group * L::kRowBytes, unit, lane);
    cp_async_commit();
    for (int e = lane; e < nrows * DH; e += 32) {
      const int r = e / DH, d = c0 + e % DH;
      wq[e] = d < dh ? widen1(qb[r * dh + d]) * scale : 0.0f;
    }
    cp_async_wait<0>();
    __syncwarp();
    chunk_scores<FULL, DH, Cache, ROWS>(st, nrows, wq, lane, sc);
  }
  chunk_apply<FULL, DH, Cache, ROWS>(st, ks, k_hi, nrows, first_pos, ps, lane,
                                     sc, m, l, acc);
}

// DH is the tile's head dim, dh <= DH the operands' own (or, WIDE, any dh
// and `groups` = ceil(dh / DH) output-column groups on the grid's x axis,
// this block's the `blockIdx.x % groups`-th): the copies past dh are
// zero-filled, the query's columns past dh are zeros, so the scores are
// dh's and the accumulator's columns past dh are zeros, which are not
// stored. The tiles' rows are copied 16 bytes a copy; the general route
// (WIDE) copies `unit` bytes a copy, and also takes, as one column group
// of the Dh 128 tile, every Dh up to 128 whose rows or caches are not a
// multiple of 16 bytes. The scale is the caller's, dh^-1/2.
template <int DH, typename Cache, typename Q, int ROWS, bool WIDE>
__device__ __forceinline__ void decode_body(
    const Q* __restrict__ q, const uint8_t* __restrict__ k,
    const uint8_t* __restrict__ v, const int32_t* __restrict__ pos,
    float* __restrict__ out, float* __restrict__ ws,
    int* __restrict__ counters, int heads, int s_len, int cap, int dh,
    int split_keys, int stages, int unit, int groups, int tile0, int tiles,
    float scale) {
  using L = Smem<DH, Cache, ROWS, WIDE>;
  constexpr int kWarps = L::kWarps, kThreads = L::kThreads;
  constexpr int kPitch = L::kPitch;
  constexpr int kUnits = L::kRowBytes / 16;       // 16-byte units a tile row
  constexpr int kVd = DH / 32;                    // dims a lane
  const int row_bytes = dh * kElem<Cache>;        // a cache row's own bytes
  extern __shared__ __align__(16) uint8_t smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* ps_all = reinterpret_cast<float*>(smem + L::kQ);
  uint8_t* ring = smem + L::kQ + L::kPs;

  const int bh = WIDE ? blockIdx.x / groups : blockIdx.x;
  const int group = WIDE ? blockIdx.x % groups : 0;
  const int tile = tile0 + static_cast<int>(blockIdx.y);
  const int split = blockIdx.z;
  const int splits = gridDim.z;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int s0 = tile * ROWS;
  const int nrows = min(ROWS, s_len - s0);
  const int64_t cursor = pos[bh / heads];
  // keys this tile's rows see: [0, min(C, cursor + s0 + nrows))
  int64_t live = cursor + s0 + nrows;
  live = live < 0 ? 0 : (live > cap ? cap : live);
  const int n_keys = static_cast<int>(live);
  const int k_lo = split * split_keys;
  const int k_hi = min(k_lo + split_keys, n_keys);
  const int n_chunks = k_hi > k_lo ? (k_hi - k_lo + kKeys - 1) / kKeys : 0;

  const int64_t row_off = static_cast<int64_t>(bh) * cap * row_bytes;
  const uint8_t* kb = k + row_off;
  const uint8_t* vb = v + row_off;
  uint8_t* wring = ring + warp * stages * L::kStage;
  const int n_mine = n_chunks > warp ? (n_chunks - warp + kWarps - 1) / kWarps
                                     : 0;

  // the K and V rows of this warp's i-th chunk into its stage (keys past
  // k_hi are not copied: their scores are masked and their V rows unread;
  // the units past the row's own bytes are zero-filled)
  auto load = [&](int i) {
    const int ks = k_lo + (warp + i * kWarps) * kKeys;
    const int nk = min(kKeys, k_hi - ks);
    uint8_t* st = wring + (i % stages) * L::kStage;
#pragma unroll
    for (int c = 0; c < kUnits; ++c) {
      const int e = lane + 32 * c;
      const int j = e / kUnits, u = e % kUnits;
      if (j < nk) {
        const bool live = 16 * u < row_bytes;
        const int64_t src =
            static_cast<int64_t>(ks + j) * row_bytes + (live ? 16 * u : 0);
        cp_async16(st + j * kPitch + 16 * u, kb + src, live);
        cp_async16(st + (kKeys + j) * kPitch + 16 * u, vb + src, live);
      }
    }
    cp_async_commit();
  };

  float m[ROWS], l[ROWS], acc[ROWS][kVd];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.0f;
#pragma unroll
    for (int d = 0; d < kVd; ++d) acc[r][d] = 0.0f;
  }
  float* ps = ps_all + warp * kKeys * kPsStride;
  const Q* qb = q + (static_cast<int64_t>(bh) * s_len + s0) * dh;

  if constexpr (WIDE) {
    // each chunk's steps in order on one stage, the query staged by the
    // warp step by step; a window's rows keep their guards (one instance
    // of the chunk, which halves the route's build)
    float* wq = qs + warp * ROWS * DH;
    for (int i = 0; i < n_mine; ++i) {
      const int ks = k_lo + (warp + i * kWarps) * kKeys;
      wide_chunk<ROWS == 1, DH, Cache, Q, ROWS>(
          wring, kb, vb, qb, ks, k_hi, nrows, cursor + s0, dh, group, unit,
          scale, wq, ps, lane, m, l, acc);
      __syncwarp();  // ps is free for the next chunk
    }
  } else {
    // the ring: the first chunks are in flight while the query rows load,
    // and chunk i + 1 while chunk i is consumed (an empty group keeps the
    // count where no chunk is left)
    for (int i = 0; i < stages; ++i) {
      if (i < n_mine)
        load(i);
      else
        cp_async_commit();
    }
    // the scaled query rows of this tile, zeros past dh (rows past S are
    // never read)
    for (int e = t; e < nrows * DH; e += kThreads) {
      const int r = e / DH, d = e % DH;
      qs[e] = d < dh ? widen1(qb[r * dh + d]) * scale : 0.0f;
    }
    __syncthreads();
    for (int i = 0; i < n_mine; ++i) {
      if (stages > 1)  // chunk i has landed (chunk i + 1 may be pending)
        cp_async_wait<1>();
      else
        cp_async_wait<0>();
      __syncwarp();
      const uint8_t* st = wring + (i % stages) * L::kStage;
      const int ks = k_lo + (warp + i * kWarps) * kKeys;
      if (ROWS == 1 || nrows == ROWS)
        chunk_update<true, DH, Cache, ROWS>(st, ks, k_hi, nrows, cursor + s0,
                                            qs, ps, lane, m, l, acc);
      else
        chunk_update<false, DH, Cache, ROWS>(st, ks, k_hi, nrows,
                                             cursor + s0, qs, ps, lane, m, l,
                                             acc);
      __syncwarp();  // the stage and ps are free for the next chunk
      if (i + stages < n_mine)
        load(i + stages);
      else
        cp_async_commit();
    }
  }

  // merge the warps in warp order (the ring's memory holds their states)
  __syncthreads();
  float* mg = reinterpret_cast<float*>(ring);
  {
    float* wm = mg + warp * ROWS * (DH + 2);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (r < nrows) {
#pragma unroll
        for (int d = 0; d < kVd; ++d) wm[r * DH + lane * kVd + d] = acc[r][d];
        if (lane == 0) {
          wm[ROWS * DH + r] = m[r];
          wm[ROWS * DH + ROWS + r] = l[r];
        }
      }
    }
  }
  __syncthreads();
  // the rule's scales depend on the maxima alone, so a row's (c0, c1) for
  // each warp are worked out once, by one thread a row, and every entry of
  // the row takes them: the same arithmetic as merge() on each entry
  float* coef = mg + kWarps * ROWS * (DH + 2);      // [ROWS][kWarps][2]
  float* row_ml = coef + ROWS * kWarps * 2;         // m then l, a row
  if (t < nrows) {
    float mm = -INFINITY, ll = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* wm = mg + w * ROWS * (DH + 2);
      const float mb = wm[ROWS * DH + t], lb = wm[ROWS * DH + ROWS + t];
      const float mn = fmaxf(mm, mb);
      const float ms = isfinite(mn) ? mn : 0.0f;
      const float c0 = rescale(mm, ms), c1 = rescale(mb, ms);
      ll = fmaf(lb, c1, ll * c0);
      mm = mn;
      coef[(t * kWarps + w) * 2] = c0;
      coef[(t * kWarps + w) * 2 + 1] = c1;
    }
    row_ml[t] = mm;
    row_ml[ROWS + t] = ll;
  }
  __syncthreads();
  // the (row, column group, tile) this block's partials belong to
  const int64_t slot_of = static_cast<int64_t>(blockIdx.x) * tiles + tile;
  constexpr int kSlot = ROWS * (DH + 2);
  float* part = splits > 1 ? ws + (slot_of * splits + split) * kSlot : nullptr;
  // this block's output columns start at col0
  const int col0 = group * DH;
  float* ob = out + (static_cast<int64_t>(bh) * s_len + s0) * dh + col0;
  for (int e = t; e < nrows * DH; e += kThreads) {
    const int r = e / DH;
    float aa = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* c = coef + (r * kWarps + w) * 2;
      aa = fmaf(mg[w * ROWS * (DH + 2) + e], c[1], aa * c[0]);
    }
    if (splits == 1) {
      if (col0 + e % DH < dh)
        ob[r * dh + e % DH] = aa / fmaxf(row_ml[ROWS + r], 1e-30f);
    } else {
      part[e] = aa;
      if (e % DH == 0) {
        part[ROWS * DH + r] = row_ml[r];
        part[ROWS * DH + ROWS + r] = row_ml[ROWS + r];
      }
    }
  }
  if (splits == 1) return;

  // the last block of this (row, tile) to finish merges the splits, in
  // split order
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (t == 0) {
    int* counter = counters + slot_of;
    last = atomicAdd(counter, 1) == splits - 1;
    if (last) *counter = 0;  // every block of the group has counted
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // every thread's entries (rows past S skipped), the loads of a batch
  // of splits in flight together, merged in split order
  const float* first = ws + slot_of * splits * kSlot;
  // entries a thread (one at S = 1, Dh = 32, where the block's 64 threads
  // outnumber the row's 32 entries: the rest skip by the row guard)
  constexpr int kPer = (ROWS * DH + kThreads - 1) / kThreads;
  constexpr int kBatch = kPer >= 8 ? 1 : 8 / kPer;
  float mm[kPer], ll[kPer], aa[kPer];
#pragma unroll
  for (int x = 0; x < kPer; ++x) mm[x] = -INFINITY, ll[x] = aa[x] = 0.0f;
  for (int i0 = 0; i0 < splits; i0 += kBatch) {
    float mb[kBatch][kPer], lb[kBatch][kPer], ab[kBatch][kPer];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const float* pi = first + (i0 + j) * kSlot;
#pragma unroll
      for (int x = 0; x < kPer; ++x) {
        const int e = t + x * kThreads, r = e / DH;
        if (i0 + j < splits && r < nrows) {
          mb[j][x] = __ldcg(pi + ROWS * DH + r);
          lb[j][x] = __ldcg(pi + ROWS * DH + ROWS + r);
          ab[j][x] = __ldcg(pi + e);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
#pragma unroll
      for (int x = 0; x < kPer; ++x) {
        if (i0 + j < splits && (t + x * kThreads) / DH < nrows)
          merge(mm[x], ll[x], aa[x], mb[j][x], lb[j][x], ab[j][x]);
      }
    }
  }
#pragma unroll
  for (int x = 0; x < kPer; ++x) {
    const int e = t + x * kThreads;
    if (e / DH < nrows && col0 + e % DH < dh)
      ob[(e / DH) * dh + e % DH] = aa[x] / fmaxf(ll[x], 1e-30f);
  }
}

#define MX_DECODE_PARAMS                                                   \
  const Q *__restrict__ q, const uint8_t *__restrict__ k,                  \
      const uint8_t *__restrict__ v, const int32_t *__restrict__ pos,      \
      float *__restrict__ out, float *__restrict__ ws,                     \
      int *__restrict__ counters, int heads, int s_len, int cap, int dh,   \
      int split_keys, int stages, int unit, int groups, int tile0,         \
      int tiles, float scale
#define MX_DECODE_ARGS                                                     \
  q, k, v, pos, out, ws, counters, heads, s_len, cap, dh, split_keys,      \
      stages, unit, groups, tile0, tiles, scale

template <int DH, typename Cache, typename Q, int ROWS, bool WIDE>
__global__ void __launch_bounds__(Smem<DH, Cache, ROWS, WIDE>::kThreads)
    decode_attn(MX_DECODE_PARAMS) {
  decode_body<DH, Cache, Q, ROWS, WIDE>(MX_DECODE_ARGS);
}

// The general route at S = 1: held to ptxas' default register budget it
// spills (64 registers a thread), so it is allowed a thread's full 255
template <int DH, typename Cache, typename Q, int ROWS, bool WIDE>
__global__ void __launch_bounds__(Smem<DH, Cache, ROWS, WIDE>::kThreads, 1)
    decode_attn_any(MX_DECODE_PARAMS) {
  decode_body<DH, Cache, Q, ROWS, WIDE>(MX_DECODE_ARGS);
}

// one launch's arguments, as the entry points take them
struct Args {
  const void *q, *k, *v, *pos;
  void *out, *ws, *counters;
  int bh, heads, s_len, cap, dh, split_keys, splits, unit, groups;
  float scale;
  cudaStream_t st;
};

template <int DH, typename Cache, typename Q, int ROWS, bool WIDE>
int launch_rows(const Args& a) {
  using L = Smem<DH, Cache, ROWS, WIDE>;
  auto kern = [] {  // one kernel a route (each instance is compiled)
    if constexpr (WIDE && ROWS == 1)
      return decode_attn_any<DH, Cache, Q, ROWS, WIDE>;
    else
      return decode_attn<DH, Cache, Q, ROWS, WIDE>;
  }();
  static bool ready[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               L::bytes(L::kMaxStages));
    if (err != cudaSuccess) return static_cast<int>(err);
    ready[dev] = true;
  }
  // as many stages as a warp has chunks in its split, up to kMaxStages
  const int per_warp = (a.split_keys / kKeys + L::kWarps - 1) / L::kWarps;
  const int stages = per_warp < L::kMaxStages ? per_warp : L::kMaxStages;
  // the query tiles on the grid's y axis, in chunks of its limit: one
  // launch a chunk (decode_launches(S) of them), each tile its own
  // workspace slot whatever the chunk
  const int tiles = (a.s_len + ROWS - 1) / ROWS;
  for (int t0 = 0; t0 < tiles; t0 += kGridY) {
    const int n = tiles - t0 < kGridY ? tiles - t0 : kGridY;
    const dim3 grid(static_cast<unsigned>(a.bh) * a.groups, n, a.splits);
    kern<<<grid, L::kThreads, L::bytes(stages), a.st>>>(
        static_cast<const Q*>(a.q), static_cast<const uint8_t*>(a.k),
        static_cast<const uint8_t*>(a.v), static_cast<const int32_t*>(a.pos),
        static_cast<float*>(a.out), static_cast<float*>(a.ws),
        static_cast<int*>(a.counters), a.heads, a.s_len, a.cap, a.dh,
        a.split_keys, stages, a.unit, a.groups, t0, tiles, a.scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// The tile a head dim runs on: the smallest of 32, 64 and 128 that holds
// it, 128 above (cuda_kernels.head_tile keeps the same rule)
int head_tile(int dh) { return dh <= 32 ? 32 : (dh <= 64 ? 64 : 128); }

// The route's copy unit is the caller's: a power of two from 1 to 16 that
// divides a row's bytes and both caches' addresses
template <typename Cache>
bool unit_ok(const Args& a) {
  const uintptr_t bits = static_cast<uintptr_t>(a.dh) * kElem<Cache> |
                         reinterpret_cast<uintptr_t>(a.k) |
                         reinterpret_cast<uintptr_t>(a.v);
  return (a.unit == 1 || a.unit == 2 || a.unit == 4 || a.unit == 8 ||
          a.unit == 16) &&
         (bits & static_cast<uintptr_t>(a.unit - 1)) == 0;
}

// The arguments every route takes (cudaErrorInvalidValue otherwise):
// `groups` column groups of 128 above Dh 128 (1 up to it), a copy unit
// that fits the rows and caches, a split plan covering the cache.
template <typename Cache>
bool args_ok(const Args& a) {
  const int groups = a.dh > 128 ? (a.dh + 127) / 128 : 1;
  return a.dh >= 1 && a.groups == groups && unit_ok<Cache>(a) &&
         a.split_keys > 0 && a.split_keys % kKeys == 0 && a.splits >= 1 &&
         a.splits <= 65535 &&
         static_cast<int64_t>(a.split_keys) * a.splits >= a.cap &&
         (a.splits == 1 || (a.ws != nullptr && a.counters != nullptr));
}

// true where a launch takes the general route: above Dh 128, or rows
// copied in units below 16 bytes (cuda_kernels.decode_route)
inline bool general_route(const Args& a) {
  return a.groups > 1 || a.unit != 16;
}

}  // namespace

namespace {

// The tiles' launch: a Dh up to 128 whose rows are whole 16-byte copies
template <typename Cache, typename Q = float>
int launch_tiles(const Args& a) {
  if (a.bh == 0 || a.s_len == 0) return 0;
  if (!args_ok<Cache>(a) || general_route(a))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool one = a.s_len == 1;
  switch (head_tile(a.dh)) {
    case 32:
      return one ? launch_rows<32, Cache, Q, 1, false>(a)
                 : launch_rows<32, Cache, Q, kWinRows, false>(a);
    case 64:
      return one ? launch_rows<64, Cache, Q, 1, false>(a)
                 : launch_rows<64, Cache, Q, kWinRows, false>(a);
    default:
      return one ? launch_rows<128, Cache, Q, 1, false>(a)
                 : launch_rows<128, Cache, Q, kWinRows, false>(a);
  }
}

}  // namespace

// The entry points (MX_DECODE_ENTRY, one a cache type and route): q
// (b*h, s, dh) float32 (bfloat16 or float16 for those entry points), k/v
// cache (b*h, cap, dh) of the entry point's storage type, pos (b,) int32,
// out (b*h, s, dh) float32; contiguous, one device. Any dh >= 1 and any s
// (the query tiles in chunks of the grid's y limit, a launch each): dh up
// to 128 whose rows are whole 16-byte copies runs on the tile of
// head_tile(dh) (launch_tiles), any other dh on the general route
// (launch_any, decode_attention_any.cu) with `groups` = ceil(dh / 128)
// column groups (1 up to 128). `unit`: the copy's bytes, a power of two
// up to 16 that divides dh's row bytes and both caches' addresses. The
// key range is cut into `splits` splits of `split_keys` keys (a multiple
// of 32, split_keys * splits >= cap); with more than one split, ws holds
// the splits' float32 partials, laid out at the tile's head dim for every
// (row, column group, query tile) (cuda_kernels._decode_ws_sizes) and
// counters an int32 counter for each of those, kept at 0 between launches
// (zeroed once, reset by the kernel; never shared with the partials, whose
// layout changes with the shape). Returns cudaGetLastError()
// (cudaErrorInvalidValue for a split plan the kernel does not take, or a
// launch that belongs to the other route).
#define MX_DECODE_ENTRY(NAME, LAUNCH, ...)                                   \
  extern "C" int NAME(const void* q, const void* k, const void* v,          \
                      const void* pos, void* out, void* ws, void* counters, \
                      int batch, int heads, int s_len, int cap, int dh,     \
                      int split_keys, int splits, int unit, int groups,     \
                      float scale, void* stream) {                          \
    return LAUNCH<__VA_ARGS__>(                                              \
        Args{q, k, v, pos, out, ws, counters, batch * heads, heads, s_len,   \
             cap, dh, split_keys, splits, unit, groups, scale,               \
             static_cast<cudaStream_t>(stream)});                            \
  }
