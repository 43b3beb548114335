// LayerNorm backward, the input gradient, for Hopper (sm_90a).
//
// Replaces: mxnet_tpu/ops/pallas_kernels.py _ln_bwd_dx_kernel, launched by
// _ln_pl_bwd_rule. Computes, per row of x (N, C), in float32, from the
// mean and rstd the forward saved:
//   xh = (x - mean) * rstd,  gy = ct * gamma
//   dx = rstd * (gy - mean(gy) - xh * mean(gy * xh))
//
// Bound: bytes. x and ct are read and dx written once (3 * N * C * 4
// bytes, plus gamma and the two statistics); about a dozen flops per
// element are far below the card's operations-per-byte line. Design: one
// warp per row, 8 rows per block, no shared memory. The row is walked
// twice: the first walk takes both row means in one pass (sum(gy) and
// sum(gy * xh) side by side), the second writes dx; after the first walk
// the row's x and ct sit in L1 (4 KiB at C = 512), so only the first walk
// and the write touch device memory. Accesses are 16-byte (float4) when
// C % 4 == 0 and every pointer is 16-byte aligned, scalar otherwise. Any
// C up to the JAX eligibility bound (65536) is taken by the same loop.
// gy and xh are rounded products (__fmul_rn), never fused into the
// subtraction that follows: at C = 1 gy - mean(gy) is then exactly 0, as
// in the plain version, where a fused residual would be scaled by
// rstd = eps^-1/2.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps: 8 rows per block

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void ln_bwd_dx_f32(const float* __restrict__ x,
                              const float* __restrict__ g,
                              const float* __restrict__ ct,
                              const float* __restrict__ mean,
                              const float* __restrict__ rstd,
                              float* __restrict__ dx, int n, int c) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= n) return;
  const int64_t off = static_cast<int64_t>(row) * c;
  const float* xr = x + off;
  const float* cr = ct + off;
  float* dr = dx + off;
  const float mu = mean[row];
  const float rs = rstd[row];
  const bool vec = (c & 3) == 0 &&
                   ((reinterpret_cast<uintptr_t>(xr) |
                     reinterpret_cast<uintptr_t>(cr) |
                     reinterpret_cast<uintptr_t>(dr) |
                     reinterpret_cast<uintptr_t>(g)) & 15) == 0;
  const float inv_c = 1.0f / static_cast<float>(c);

  float s1 = 0.0f, s2 = 0.0f;
  if (vec) {
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    const float4* c4 = reinterpret_cast<const float4*>(cr);
    const float4* g4 = reinterpret_cast<const float4*>(g);
    for (int i = lane; i < (c >> 2); i += 32) {
      const float4 xv = x4[i], cv = c4[i], gv = g4[i];
      const float y0 = __fmul_rn(cv.x, gv.x), y1 = __fmul_rn(cv.y, gv.y);
      const float y2 = __fmul_rn(cv.z, gv.z), y3 = __fmul_rn(cv.w, gv.w);
      s1 += y0;
      s1 += y1;
      s1 += y2;
      s1 += y3;
      s2 = fmaf(y0, __fmul_rn(xv.x - mu, rs), s2);
      s2 = fmaf(y1, __fmul_rn(xv.y - mu, rs), s2);
      s2 = fmaf(y2, __fmul_rn(xv.z - mu, rs), s2);
      s2 = fmaf(y3, __fmul_rn(xv.w - mu, rs), s2);
    }
  } else {
    for (int i = lane; i < c; i += 32) {
      const float y = __fmul_rn(cr[i], g[i]);
      s1 += y;
      s2 = fmaf(y, __fmul_rn(xr[i] - mu, rs), s2);
    }
  }
  const float m1 = warp_sum(s1) * inv_c;
  const float m2 = warp_sum(s2) * inv_c;

  if (vec) {
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    const float4* c4 = reinterpret_cast<const float4*>(cr);
    const float4* g4 = reinterpret_cast<const float4*>(g);
    float4* d4 = reinterpret_cast<float4*>(dr);
    for (int i = lane; i < (c >> 2); i += 32) {
      const float4 xv = x4[i], cv = c4[i], gv = g4[i];
      float4 o;
      o.x = rs * (__fmul_rn(cv.x, gv.x) - m1 -
                  __fmul_rn(__fmul_rn(xv.x - mu, rs), m2));
      o.y = rs * (__fmul_rn(cv.y, gv.y) - m1 -
                  __fmul_rn(__fmul_rn(xv.y - mu, rs), m2));
      o.z = rs * (__fmul_rn(cv.z, gv.z) - m1 -
                  __fmul_rn(__fmul_rn(xv.z - mu, rs), m2));
      o.w = rs * (__fmul_rn(cv.w, gv.w) - m1 -
                  __fmul_rn(__fmul_rn(xv.w - mu, rs), m2));
      d4[i] = o;
    }
  } else {
    for (int i = lane; i < c; i += 32)
      dr[i] = rs * (__fmul_rn(cr[i], g[i]) - m1 -
                    __fmul_rn(__fmul_rn(xr[i] - mu, rs), m2));
  }
}

}  // namespace

// x (n, c), gamma (c,), ct (n, c), mean (n,), rstd (n,) -> dx (n, c); all
// float32, contiguous, on one device. Returns cudaGetLastError().
extern "C" int mx_ln_bwd_dx_f32(const void* x, const void* gamma,
                                const void* ct, const void* mean,
                                const void* rstd, void* dx, int n, int c,
                                void* stream) {
  if (n > 0 && c > 0) {
    const int blocks = static_cast<int>(
        (static_cast<int64_t>(n) * 32 + kThreads - 1) / kThreads);
    ln_bwd_dx_f32<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(gamma),
        static_cast<const float*>(ct), static_cast<const float*>(mean),
        static_cast<const float*>(rstd), static_cast<float*>(dx), n, c);
  }
  return static_cast<int>(cudaGetLastError());
}
