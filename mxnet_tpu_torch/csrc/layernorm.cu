// LayerNorm forward over the last axis, for Hopper (sm_90a).
//
// Replaces: mxnet_tpu/ops/pallas_kernels.py _ln_fwd_kernel, launched by
// _pl_layernorm_fwd. Computes, per row of x (N, C):
//   mean = sum(x) / C,  var = sum((x - mean)^2) / C   (two-pass, float32)
//   rstd = 1 / sqrt(var + eps),  y = (x - mean) * rstd * gamma + beta
// and writes y (N, C), mean (N,) and rstd (N,). The op's std output is
// 1 / rstd, taken by the wrapper.
//
// Bound: bytes. x is read and y written once (plus gamma/beta, shared by
// every row and cached); ~10 flops per element is far below the card's
// operations-per-byte line. Design: one warp per row. The row is walked
// three times (sum, squared deviations, write) straight from global
// memory; after the first pass it sits in L1 (2 KiB at C=512), so the
// second and third walks cost no device-memory traffic, and the kernel
// takes any C without a register-resident row. Accesses are 16-byte
// (float4) when C % 4 == 0 and the pointers are 16-byte aligned. The
// variance is the two-pass form of the TPU kernel, not E[x^2] - mean^2;
// 1 / sqrtf is IEEE-rounded, not the approximate rsqrtf.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps: 8 rows per block

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void ln_fwd_f32(const float* __restrict__ x,
                           const float* __restrict__ g,
                           const float* __restrict__ b,
                           float* __restrict__ y, float* __restrict__ mean_out,
                           float* __restrict__ rstd_out, int n, int c,
                           float eps) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= n) return;
  const float* xr = x + static_cast<int64_t>(row) * c;
  float* yr = y + static_cast<int64_t>(row) * c;
  const bool vec = (c & 3) == 0 &&
                   ((reinterpret_cast<uintptr_t>(xr) |
                     reinterpret_cast<uintptr_t>(yr) |
                     reinterpret_cast<uintptr_t>(g) |
                     reinterpret_cast<uintptr_t>(b)) & 15) == 0;
  const float inv_c = 1.0f / static_cast<float>(c);

  float s = 0.0f;
  if (vec) {
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    for (int i = lane; i < (c >> 2); i += 32) {
      const float4 v = x4[i];
      s += v.x;
      s += v.y;
      s += v.z;
      s += v.w;
    }
  } else {
    for (int i = lane; i < c; i += 32) s += xr[i];
  }
  const float mean = warp_sum(s) * inv_c;

  float q = 0.0f;
  if (vec) {
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    for (int i = lane; i < (c >> 2); i += 32) {
      const float4 v = x4[i];
      const float d0 = v.x - mean, d1 = v.y - mean;
      const float d2 = v.z - mean, d3 = v.w - mean;
      q = fmaf(d0, d0, q);
      q = fmaf(d1, d1, q);
      q = fmaf(d2, d2, q);
      q = fmaf(d3, d3, q);
    }
  } else {
    for (int i = lane; i < c; i += 32) {
      const float d0 = xr[i] - mean;
      q = fmaf(d0, d0, q);
    }
  }
  const float var = warp_sum(q) * inv_c;
  const float rstd = 1.0f / sqrtf(var + eps);

  if (vec) {
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    const float4* g4 = reinterpret_cast<const float4*>(g);
    const float4* b4 = reinterpret_cast<const float4*>(b);
    float4* y4 = reinterpret_cast<float4*>(yr);
    for (int i = lane; i < (c >> 2); i += 32) {
      const float4 v = x4[i], gg = g4[i], bb = b4[i];
      float4 o;
      o.x = (v.x - mean) * rstd * gg.x + bb.x;
      o.y = (v.y - mean) * rstd * gg.y + bb.y;
      o.z = (v.z - mean) * rstd * gg.z + bb.z;
      o.w = (v.w - mean) * rstd * gg.w + bb.w;
      y4[i] = o;
    }
  } else {
    for (int i = lane; i < c; i += 32)
      yr[i] = (xr[i] - mean) * rstd * g[i] + b[i];
  }
  if (lane == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

}  // namespace

// x (n, c), gamma (c,), beta (c,) -> y (n, c), mean (n,), rstd (n,); all
// float32, contiguous, on one device. Returns cudaGetLastError().
extern "C" int mx_layernorm_fwd_f32(const void* x, const void* gamma,
                                    const void* beta, void* y, void* mean,
                                    void* rstd, int n, int c, float eps,
                                    void* stream) {
  if (n > 0) {
    const int blocks = (n * 32 + kThreads - 1) / kThreads;
    ln_fwd_f32<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(gamma),
        static_cast<const float*>(beta), static_cast<float*>(y),
        static_cast<float*>(mean), static_cast<float*>(rstd), n, c, eps);
  }
  return static_cast<int>(cudaGetLastError());
}
