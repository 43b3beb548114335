// Flash-attention forward (self-attention, optional causal mask), for
// Hopper (sm_90a).
//
// Replaces: mxnet_tpu/rtc.py _flash_kernel (partial=False), launched by
// _flash_call from flash_attention. For every (b, h) row and query t < T
// it computes
//   softmax_k( (q[t] * Dh^-1/2) . k[k] )  over k < T (and k <= t if causal)
// and the weighted sum of v over the same keys, with the TPU kernel's
// online softmax in float32: q is scaled before the product; per key tile
//   m_new = max(m, max_k s),  m_safe = m_new if finite else 0,
//   p = exp(s - m_safe) where s is finite else 0,
//   corr = exp(m - m_safe) where m is finite else 0,
//   l = l * corr + sum_k p,  acc = acc * corr + p . v
// and out = acc / max(l, 1e-30). q, k, v and out are (B*H, T, Dh) float32.
//
// Bound: operations. The two products take 4 * T * T * Dh flops per
// (b, h) row (half of that under the causal mask), against 4 * T * Dh * 4
// bytes moved; at T = 1024, Dh = 64 that is ~250 flops per byte, far above
// the float32 line of ~20. Every product is a float32 FMA on the CUDA
// cores: no tensor cores and so no TF32, which the reference's
// Precision.HIGHEST rules out. Design: one block of 256 threads per (b*h,
// 64-query tile); the block LOOPS over 64-key tiles (the TPU kernel's
// sequential grid axis), staging the scaled Q tile once and each K and V
// tile in shared memory, keeping m, l and the output accumulator in
// registers. Each thread owns 4 query rows (the same rows in S and in the
// accumulator, so corr applies in place) and 4 keys of S, taken 16 apart
// so the float4 reads of K rows (padded by 4 floats) hit distinct banks;
// a row's max and sum reduce over the 16 lanes that share it. P goes
// through shared memory, stored key-major, for the P.V product. Causal key
// tiles wholly above the diagonal are not visited, and the query tiles
// with the most keys are scheduled first. Any T is taken: the last query
// and key tiles are masked in the kernel (keys past T get -inf scores,
// queries past T are not written). Dh is a template parameter, 64 or 128.
// A later partial mode (ring attention's unnormalized acc, m, l) emits
// the registers this kernel holds at the end of its key loop instead of
// acc / l, with the shards' sequence offsets added to the causal test.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBq = 64;  // query rows per block
constexpr int kBk = 64;  // keys per shared-memory tile
constexpr int kPadP = kBq + 4;

template <int DH>
constexpr int smem_floats() {
  return kBq * (DH + 4) + kBk * (DH + 4) + kBk * DH + kBk * kPadP;
}

__device__ __forceinline__ float max16(float v) {
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float sum16(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ out, int T,
              int causal, float scale, int n_qt) {
  constexpr int kLd = DH + 4;    // padded row of the Q and K tiles
  constexpr int kNv = DH / 64;   // float4 groups of the accumulator
  constexpr int kVec = DH / 4;   // float4 per row
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [kBq][kLd], scaled
  float* ks = qs + kBq * kLd;                   // [kBk][kLd]
  float* vs = ks + kBk * kLd;                   // [kBk][DH]
  float* ps = vs + kBk * DH;                    // [kBk][kPadP], key-major

  const int t = threadIdx.x;
  const int tx = t & 15;   // keys tx + 16 i of S; columns of the output
  const int ty = t >> 4;   // query rows 4 ty .. 4 ty + 3
  const int bh = blockIdx.y;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x)) * kBq;
  const int64_t base = static_cast<int64_t>(bh) * T * DH;
  const float4* q4 = reinterpret_cast<const float4*>(q + base);
  const float4* k4 = reinterpret_cast<const float4*>(k + base);
  const float4* v4 = reinterpret_cast<const float4*>(v + base);

  for (int e = t; e < kBq * kVec; e += kThreads) {
    const int r = e / kVec, d = (e % kVec) * 4;
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (q0 + r < T) {
      x = q4[static_cast<int64_t>(q0 + r) * kVec + d / 4];
      x.x *= scale;
      x.y *= scale;
      x.z *= scale;
      x.w *= scale;
    }
    *reinterpret_cast<float4*>(qs + r * kLd + d) = x;
  }

  float m[4], l[4], acc[4][kNv * 4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    m[j] = -INFINITY;
    l[j] = 0.0f;
#pragma unroll
    for (int e = 0; e < kNv * 4; ++e) acc[j][e] = 0.0f;
  }

  const int k_end = causal ? min(T, q0 + kBq) : T;
  for (int k0 = 0; k0 < k_end; k0 += kBk) {
    __syncthreads();  // the previous tile is consumed (and qs is ready)
    for (int e = t; e < kBk * kVec; e += kThreads) {
      const int r = e / kVec, d = (e % kVec) * 4;
      float4 kv = make_float4(0.0f, 0.0f, 0.0f, 0.0f), vv = kv;
      if (k0 + r < T) {
        const int64_t i = static_cast<int64_t>(k0 + r) * kVec + d / 4;
        kv = k4[i];
        vv = v4[i];
      }
      *reinterpret_cast<float4*>(ks + r * kLd + d) = kv;
      *reinterpret_cast<float4*>(vs + r * DH + d) = vv;
    }
    __syncthreads();

    // S = (q * scale) . k for 4 rows x 4 keys
    float s[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
      float4 a[4], b[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        a[j] = *reinterpret_cast<const float4*>(qs + (ty * 4 + j) * kLd + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        b[i] = *reinterpret_cast<const float4*>(ks + (tx + 16 * i) * kLd + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[j][i] = fmaf(a[j].x, b[i].x, s[j][i]);
          s[j][i] = fmaf(a[j].y, b[i].y, s[j][i]);
          s[j][i] = fmaf(a[j].z, b[i].z, s[j][i]);
          s[j][i] = fmaf(a[j].w, b[i].w, s[j][i]);
        }
    }

    // mask, then the online-softmax update of each of the 4 rows
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int qp = q0 + ty * 4 + j;
      float mb = -INFINITY;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kp = k0 + tx + 16 * i;
        const bool live = kp < T && (!causal || kp <= qp);
        s[j][i] = live ? s[j][i] : -INFINITY;
        mb = fmaxf(mb, s[j][i]);
      }
      const float m_new = fmaxf(m[j], max16(mb));
      const float m_safe = isfinite(m_new) ? m_new : 0.0f;
      const float corr = isfinite(m[j]) ? expf(m[j] - m_safe) : 0.0f;
      float psum = 0.0f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = isfinite(s[j][i]) ? expf(s[j][i] - m_safe) : 0.0f;
        s[j][i] = p;
        psum += p;
      }
      l[j] = l[j] * corr + sum16(psum);
      m[j] = m_new;
#pragma unroll
      for (int e = 0; e < kNv * 4; ++e) acc[j][e] *= corr;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(ps + (tx + 16 * i) * kPadP + ty * 4) =
          make_float4(s[0][i], s[1][i], s[2][i], s[3][i]);
    __syncthreads();

    // acc += P . V over the tile's keys
    const int kn = min(kBk, T - k0);
#pragma unroll 4
    for (int c = 0; c < kn; ++c) {
      const float4 p =
          *reinterpret_cast<const float4*>(ps + c * kPadP + ty * 4);
      const float pr[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int g = 0; g < kNv; ++g) {
        const float4 w =
            *reinterpret_cast<const float4*>(vs + c * DH + g * 64 + tx * 4);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[j][g * 4 + 0] = fmaf(pr[j], w.x, acc[j][g * 4 + 0]);
          acc[j][g * 4 + 1] = fmaf(pr[j], w.y, acc[j][g * 4 + 1]);
          acc[j][g * 4 + 2] = fmaf(pr[j], w.z, acc[j][g * 4 + 2]);
          acc[j][g * 4 + 3] = fmaf(pr[j], w.w, acc[j][g * 4 + 3]);
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int qp = q0 + ty * 4 + j;
    if (qp >= T) continue;
    const float lj = fmaxf(l[j], 1e-30f);
    float* orow = out + base + static_cast<int64_t>(qp) * DH;
#pragma unroll
    for (int g = 0; g < kNv; ++g)
      *reinterpret_cast<float4*>(orow + g * 64 + tx * 4) =
          make_float4(acc[j][g * 4 + 0] / lj, acc[j][g * 4 + 1] / lj,
                      acc[j][g * 4 + 2] / lj, acc[j][g * 4 + 3] / lj);
  }
}

template <int DH>
int launch(const float* q, const float* k, const float* v, float* out,
           int bh, int T, int causal, float scale, cudaStream_t st) {
  constexpr int bytes = smem_floats<DH>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qt = (T + kBq - 1) / kBq;
  flash_fwd_f32<DH><<<dim3(n_qt, bh), kThreads, bytes, st>>>(
      q, k, v, out, T, causal, scale, n_qt);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, out (bh, T, dh) float32, contiguous, 16-byte aligned, one
// device; dh must be 64 or 128 and bh <= 65535. Returns
// cudaGetLastError() (cudaErrorInvalidValue for another dh).
extern "C" int mx_flash_attention_f32(const void* q, const void* k,
                                      const void* v, void* out, int bh,
                                      int T, int dh, int causal, float scale,
                                      void* stream) {
  if (bh == 0 || T == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(out);
  if (dh == 64) return launch<64>(qf, kf, vf, of, bh, T, causal, scale, st);
  if (dh == 128) return launch<128>(qf, kf, vf, of, bh, T, causal, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
