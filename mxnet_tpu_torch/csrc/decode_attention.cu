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
// Bound: bytes. Each row reads its live K and V prefix once, 2 * live * Dh
// * 4 bytes, for 4 * S * live * Dh flops; at S=1 that is half a flop per
// byte, far below the card's operations-per-byte line. The TPU kernel runs
// the key blocks as a sequential grid axis with scratch carried between
// steps, and skips dead blocks by clamping its index map; here a block owns
// one (b, h) row and up to kSq query rows and LOOPS over the key tiles of
// the live prefix, so dead tiles are neither read nor computed. Tiles of
// kBk keys are staged in shared memory (K rows padded by one float so the
// 32 lanes of a warp, one key each, hit 32 different banks); every product
// is a float32 FMA, no tensor cores and so no TF32, matching the reference's
// Precision.HIGHEST. The cursor is taken per (b, h) row, b-major: b = bh / H.
//
// Known limit of this first version: the grid is one block per (b, h) row
// and query tile, so the decode path's B=8, H=8, S=1 launches 64 blocks on
// 132 SMs and the card is not filled; splitting the key range across
// blocks (split-K with a combine pass) is later work.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kSq = 16;        // query rows per block
constexpr int kBk = 32;        // keys per shared-memory tile (one per lane)

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
decode_attn_f32(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const int32_t* __restrict__ pos,
                float* __restrict__ out, int heads, int s_len, int cap,
                float scale) {
  constexpr int kAcc = kSq * DH / kThreads;  // accumulator entries / thread
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
  const float* qb = q + static_cast<int64_t>(bh) * s_len * DH;
  const float* kb = k + static_cast<int64_t>(bh) * cap * DH;
  const float* vb = v + static_cast<int64_t>(bh) * cap * DH;

  // the scaled query tile; rows past S are zero and never written out
  for (int e = t; e < kSq * DH; e += kThreads) {
    const int r = e / DH, d = e % DH;
    qs[r][d] = (s0 + r < s_len) ? qb[(s0 + r) * DH + d] * scale : 0.0f;
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
    for (int e = t; e < kBk * DH; e += kThreads) {
      const int j = e / DH, d = e % DH;
      const int kp = k_start + j;
      const bool in = kp < cap;
      ks[j][d] = in ? kb[static_cast<int64_t>(kp) * DH + d] : 0.0f;
      vs[j][d] = in ? vb[static_cast<int64_t>(kp) * DH + d] : 0.0f;
    }
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
      // online-softmax update of row r (the TPU kernel's m/l/corr rule)
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, warp_max(sc));
      const float m_safe = isfinite(m_new) ? m_new : 0.0f;
      const float p = isfinite(sc) ? expf(sc - m_safe) : 0.0f;
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

}  // namespace

// q (b*h, s, dh), k/v cache (b*h, cap, dh), pos (b,) int32, out
// (b*h, s, dh); float32, contiguous, one device. dh must be 64 or 128.
// Returns cudaGetLastError() (cudaErrorInvalidValue for another dh).
extern "C" int mx_decode_attention_f32(const void* q, const void* k,
                                       const void* v, const void* pos,
                                       void* out, int batch, int heads,
                                       int s_len, int cap, int dh,
                                       float scale, void* stream) {
  if (batch * heads == 0 || s_len == 0) return 0;
  const dim3 grid(batch * heads, (s_len + kSq - 1) / kSq);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const int32_t* pf = static_cast<const int32_t*>(pos);
  float* of = static_cast<float*>(out);
  if (dh == 64) {
    decode_attn_f32<64><<<grid, kThreads, 0, st>>>(qf, kf, vf, pf, of, heads,
                                                    s_len, cap, scale);
  } else if (dh == 128) {
    decode_attn_f32<128><<<grid, kThreads, 0, st>>>(qf, kf, vf, pf, of,
                                                     heads, s_len, cap,
                                                     scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
