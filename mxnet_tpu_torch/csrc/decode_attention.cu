// Cursor-bounded flash-decode attention read, for Hopper (sm_90a).
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
// mixed-precision paths), one template instance each. An fp8, bfloat16 or
// float16 tile is read 16 bytes a thread and widened to float32 while it is
// staged into shared memory, as the TPU kernel widens its query and cache
// blocks on read (astype(float32)); a 16-bit query is widened before it is
// scaled. Every widening is exact, so from the staged tile on the narrow
// instances compute exactly what the float32 instance computes, and the output
// is float32 in every instance (the op casts it to the query's type). A score
// that is NaN or +inf (a NaN cell, e.g. a float8_e4m3fn overflow on write, or
// an e5m2 infinity) makes its row NaN, as it does in the plain softmax.
//
// Bound: bytes. Each row reads its live K and V prefix once, 2 * live * Dh
// * (4, 2 or 1) bytes, for 4 * S * live * Dh flops; at S=1 that is half a
// flop (one for bfloat16, two for fp8) per byte, far below the card's
// operations-per-byte line. The TPU kernel runs the key blocks as a sequential grid axis with
// scratch carried between steps, and skips dead blocks by clamping its index
// map; here a block owns one (b, h) row and up to kSq query rows and LOOPS
// over the key tiles of the live prefix, so dead tiles are neither read nor
// computed. Tiles of kBk keys are staged in shared memory (K rows padded by
// one float so the 32 lanes of a warp, one key each, hit 32 different
// banks); every product is a float32 FMA, no tensor cores and so no TF32,
// matching the reference's Precision.HIGHEST. The cursor is taken per
// (b, h) row, b-major: b = bh / H.
//
// Known limit of this first version: the grid is one block per (b, h) row
// and query tile, so the decode path's B=8, H=8, S=1 launches 64 blocks on
// 132 SMs and the card is not filled; splitting the key range across
// blocks (split-K with a combine pass) is later work.
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "vec_io.cuh"

namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kSq = 16;        // query rows per block
constexpr int kBk = 32;        // keys per shared-memory tile (one per lane)

// fp8 storage types: the interpretation __nv_cvt_fp8x2_to_halfraw2 takes
struct E4M3 {
  static constexpr __nv_fp8_interpretation_t kind = __NV_E4M3;
};
struct E5M2 {
  static constexpr __nv_fp8_interpretation_t kind = __NV_E5M2;
};

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 16 fp8 codes (one aligned 16-byte load) -> 16 floats, converted in pairs
// through half (exact for both fp8 formats, NaN and infinities kept)
template <typename Fp8>
__device__ __forceinline__ void fp8x16_to_float(uint4 raw, float* dst) {
  const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int w = 0; w < 4; ++w) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const __nv_fp8x2_storage_t pair =
          static_cast<__nv_fp8x2_storage_t>(words[w] >> (16 * h));
      const __half2_raw hr = __nv_cvt_fp8x2_to_halfraw2(pair, Fp8::kind);
      const float2 f = __half22float2(__half2(hr));
      dst[4 * w + 2 * h] = f.x;
      dst[4 * w + 2 * h + 1] = f.y;
    }
  }
}

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float widen(__half x) { return __half2float(x); }

// the 16-bit cache types, read 8 values (16 bytes) a unit
template <typename Cache>
constexpr bool kHalf16 = std::is_same<Cache, __nv_bfloat16>::value ||
                         std::is_same<Cache, __half>::value;

// Stage keys [k_start, k_start + kBk) of one (b, h) row into ks/vs, zero
// past n_keys. float32 cache: one float a thread per step. bfloat16 or
// float16 cache: one 16-byte chunk (8 values of one row) a thread per
// step. fp8 cache: one 16-byte chunk (16 codes of one row) a thread per
// step.
template <int DH, typename Cache>
__device__ __forceinline__ void stage_tile(const void* kb, const void* vb,
                                           int k_start, int n_keys,
                                           float (*ks)[DH + 1],
                                           float (*vs)[DH]) {
  const int t = threadIdx.x;
  if constexpr (std::is_same<Cache, float>::value) {
    const float* kf = static_cast<const float*>(kb);
    const float* vf = static_cast<const float*>(vb);
    for (int e = t; e < kBk * DH; e += kThreads) {
      const int j = e / DH, d = e % DH;
      const int kp = k_start + j;
      const bool in = kp < n_keys;
      ks[j][d] = in ? kf[static_cast<int64_t>(kp) * DH + d] : 0.0f;
      vs[j][d] = in ? vf[static_cast<int64_t>(kp) * DH + d] : 0.0f;
    }
  } else if constexpr (kHalf16<Cache>) {
    using Unit = mxio::Io<Cache, 8>;
    constexpr int kChunks = DH / 8;  // 16-byte chunks per cache row
    const Cache* kh = static_cast<const Cache*>(kb);
    const Cache* vh = static_cast<const Cache*>(vb);
    for (int c = t; c < kBk * kChunks; c += kThreads) {
      const int j = c / kChunks, d0 = (c % kChunks) * 8;
      const int kp = k_start + j;
      float kv[8], vv[8];
      if (kp < n_keys) {
        const int64_t u = static_cast<int64_t>(kp) * kChunks + c % kChunks;
        Unit::load(kh, u, kv);
        Unit::load(vh, u, vv);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) kv[i] = vv[i] = 0.0f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        ks[j][d0 + i] = kv[i];
        vs[j][d0 + i] = vv[i];
      }
    }
  } else {
    constexpr int kChunks = DH / 16;  // 16-byte chunks per cache row
    const uint8_t* k8 = static_cast<const uint8_t*>(kb);
    const uint8_t* v8 = static_cast<const uint8_t*>(vb);
    for (int c = t; c < kBk * kChunks; c += kThreads) {
      const int j = c / kChunks, d0 = (c % kChunks) * 16;
      const int kp = k_start + j;
      float kv[16], vv[16];
      if (kp < n_keys) {
        const int64_t off = static_cast<int64_t>(kp) * DH + d0;
        fp8x16_to_float<Cache>(
            __ldg(reinterpret_cast<const uint4*>(k8 + off)), kv);
        fp8x16_to_float<Cache>(
            __ldg(reinterpret_cast<const uint4*>(v8 + off)), vv);
      } else {
#pragma unroll
        for (int i = 0; i < 16; ++i) kv[i] = vv[i] = 0.0f;
      }
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        ks[j][d0 + i] = kv[i];
        vs[j][d0 + i] = vv[i];
      }
    }
  }
}

template <int DH, typename Cache, typename Q>
__global__ void __launch_bounds__(kThreads)
decode_attn(const Q* __restrict__ q, const void* __restrict__ k,
            const void* __restrict__ v, const int32_t* __restrict__ pos,
            float* __restrict__ out, int heads, int s_len, int cap,
            float scale) {
  constexpr int kAcc = kSq * DH / kThreads;  // accumulator entries / thread
  constexpr int kElem = std::is_same<Cache, float>::value ? 4
                        : kHalf16<Cache>                    ? 2
                                                            : 1;
  __shared__ float qs[kSq][DH];
  __shared__ float ks[kBk][DH + 1];
  __shared__ float vs[kBk][DH];
  __shared__ float ps[kSq][kBk];
  __shared__ float m_s[kSq], l_s[kSq], corr_s[kSq];

  const int bh = blockIdx.x;
  const int s0 = blockIdx.y * kSq;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int64_t cursor = pos[bh / heads];
  const Q* qb = q + static_cast<int64_t>(bh) * s_len * DH;
  const int64_t row_bytes = static_cast<int64_t>(bh) * cap * DH * kElem;
  const void* kb = static_cast<const uint8_t*>(k) + row_bytes;
  const void* vb = static_cast<const uint8_t*>(v) + row_bytes;

  // the scaled query tile; rows past S are zero and never written out
  for (int e = t; e < kSq * DH; e += kThreads) {
    const int r = e / DH, d = e % DH;
    qs[r][d] = (s0 + r < s_len) ? widen(qb[(s0 + r) * DH + d]) * scale
                                : 0.0f;
  }
  if (t < kSq) {
    m_s[t] = -INFINITY;
    l_s[t] = 0.0f;
  }
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.0f;

  // keys this block's rows can see: [0, min(C, cursor + s_hi))
  const int s_hi = min(s_len, s0 + kSq);
  int64_t live = cursor + s_hi;
  if (live > cap) live = cap;
  const int n_keys = live > 0 ? static_cast<int>(live) : 0;

  for (int k_start = 0; k_start < n_keys; k_start += kBk) {
    __syncthreads();  // previous tile fully consumed (and qs/m/l ready)
    stage_tile<DH, Cache>(kb, vb, k_start, n_keys, ks, vs);
    __syncthreads();

    // scores: warp w takes rows w, w+4, ...; lane j takes key j
    for (int r = warp; r < kSq; r += kWarps) {
      const int s = s0 + r;
      const int kp = k_start + lane;
      float sc = 0.0f;
#pragma unroll 16
      for (int d = 0; d < DH; ++d) sc = fmaf(qs[r][d], ks[lane][d], sc);
      const bool valid = s < s_len && kp < cap &&
                         static_cast<int64_t>(kp) <= cursor + s;
      sc = valid ? sc : -INFINITY;
      // online-softmax update of row r (the TPU kernel's m/l/corr rule); a
      // live NaN or +inf score poisons the row as in the plain softmax
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, warp_max(sc));
      const float m_safe = isfinite(m_new) ? m_new : 0.0f;
      const float p = isfinite(sc) ? expf(sc - m_safe)
                      : (isnan(sc) || sc > 0.0f) ? NAN : 0.0f;
      const float corr = isfinite(m_old) ? expf(m_old - m_safe) : 0.0f;
      const float psum = warp_sum(p);
      ps[r][lane] = p;
      __syncwarp();
      if (lane == 0) {
        m_s[r] = m_new;
        l_s[r] = l_s[r] * corr + psum;
        corr_s[r] = corr;
      }
    }
    __syncthreads();

    // acc[r][d] = acc[r][d] * corr[r] + sum_j p[r][j] * v[j][d]
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int e = t + i * kThreads;
      const int r = e / DH, d = e % DH;
      float a = acc[i] * corr_s[r];
#pragma unroll 8
      for (int j = 0; j < kBk; ++j) a = fmaf(ps[r][j], vs[j][d], a);
      acc[i] = a;
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int e = t + i * kThreads;
    const int r = e / DH, d = e % DH;
    const int s = s0 + r;
    if (s < s_len) {
      const float l = fmaxf(l_s[r], 1e-30f);
      out[(static_cast<int64_t>(bh) * s_len + s) * DH + d] = acc[i] / l;
    }
  }
}

template <typename Cache, typename Q = float>
int launch(const void* q, const void* k, const void* v, const void* pos,
           void* out, int batch, int heads, int s_len, int cap, int dh,
           float scale, void* stream) {
  if (batch * heads == 0 || s_len == 0) return 0;
  const dim3 grid(batch * heads, (s_len + kSq - 1) / kSq);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Q* qt = static_cast<const Q*>(q);
  const int32_t* pf = static_cast<const int32_t*>(pos);
  float* of = static_cast<float*>(out);
  if (dh == 64) {
    decode_attn<64, Cache, Q><<<grid, kThreads, 0, st>>>(
        qt, k, v, pf, of, heads, s_len, cap, scale);
  } else if (dh == 128) {
    decode_attn<128, Cache, Q><<<grid, kThreads, 0, st>>>(
        qt, k, v, pf, of, heads, s_len, cap, scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (b*h, s, dh) float32 (bfloat16 or float16 for those entry points), k/v
// cache (b*h, cap, dh) of the entry point's storage type, pos (b,) int32,
// out (b*h, s, dh) float32; contiguous, one device; an fp8, bfloat16 or
// float16 cache 16-byte aligned. dh must be 64 or 128. Returns
// cudaGetLastError() (cudaErrorInvalidValue for another dh).
extern "C" int mx_decode_attention_f32(const void* q, const void* k,
                                       const void* v, const void* pos,
                                       void* out, int batch, int heads,
                                       int s_len, int cap, int dh,
                                       float scale, void* stream) {
  return launch<float>(q, k, v, pos, out, batch, heads, s_len, cap, dh, scale,
                       stream);
}

extern "C" int mx_decode_attention_e4m3(const void* q, const void* k,
                                        const void* v, const void* pos,
                                        void* out, int batch, int heads,
                                        int s_len, int cap, int dh,
                                        float scale, void* stream) {
  return launch<E4M3>(q, k, v, pos, out, batch, heads, s_len, cap, dh, scale,
                      stream);
}

extern "C" int mx_decode_attention_e5m2(const void* q, const void* k,
                                        const void* v, const void* pos,
                                        void* out, int batch, int heads,
                                        int s_len, int cap, int dh,
                                        float scale, void* stream) {
  return launch<E5M2>(q, k, v, pos, out, batch, heads, s_len, cap, dh, scale,
                      stream);
}

extern "C" int mx_decode_attention_bf16(const void* q, const void* k,
                                        const void* v, const void* pos,
                                        void* out, int batch, int heads,
                                        int s_len, int cap, int dh,
                                        float scale, void* stream) {
  return launch<__nv_bfloat16, __nv_bfloat16>(q, k, v, pos, out, batch,
                                              heads, s_len, cap, dh, scale,
                                              stream);
}

extern "C" int mx_decode_attention_f16(const void* q, const void* k,
                                       const void* v, const void* pos,
                                       void* out, int batch, int heads,
                                       int s_len, int cap, int dh,
                                       float scale, void* stream) {
  return launch<__half, __half>(q, k, v, pos, out, batch, heads, s_len, cap,
                                dh, scale, stream);
}
