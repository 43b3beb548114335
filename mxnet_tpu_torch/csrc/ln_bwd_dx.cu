// LayerNorm backward, the input gradient, for Hopper (sm_90a).
//
// Replaces: mxnet_tpu/ops/pallas_kernels.py _ln_bwd_dx_kernel, launched by
// _ln_pl_bwd_rule. Computes, per row of x (N, C), in float32, from the
// mean and rstd the forward saved:
//   xh = (x - mean) * rstd,  gy = ct * gamma
//   dx = rstd * (gy - mean(gy) - xh * mean(gy * xh))
// Three instances: float32, and bfloat16 or float16 (the mixed-precision path:
// x, gamma, ct and dx bfloat16, mean and rstd float32, as the forward saved
// them), which widens every value exactly, computes as the float32
// instance does and rounds dx to nearest even once, as the TPU kernel
// stores in x's dtype.
//
// Bound: bytes. x and ct are read and dx written once (3 * N * C * 4
// bytes in float32, half that in bfloat16, plus gamma and the two
// statistics); about a dozen flops per element are far below the card's
// operations-per-byte line. Design: one warp per row, 8 rows per block,
// no shared memory. The row is walked twice: the first walk takes both
// row means in one pass (sum(gy) and sum(gy * xh) side by side), the
// second writes dx; after the first walk the row's x and ct sit in L1 (4
// KiB at C = 512 in float32), so only the first walk and the write touch
// device memory. Accesses are 16-byte (4 floats or 8 16-bit values,
// vec_io.cuh) when C is a multiple of that unit and every pointer is
// 16-byte aligned, one value at a time otherwise. Any C up to the JAX
// eligibility bound (65536) is taken by the same loop. gy and xh are
// rounded products (__fmul_rn), never fused into the subtraction that
// follows: at C = 1 gy - mean(gy) is then exactly 0, as in the plain
// version, where a fused residual would be scaled by rstd = eps^-1/2.
#include <cuda_runtime.h>
#include <stdint.h>

#include "vec_io.cuh"

namespace {

using mxio::Io;

constexpr int kThreads = 256;  // 8 warps: 8 rows per block

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One warp per row; each lane walks units of W values (W divides c).
template <typename T, int W>
__global__ void ln_bwd_dx(const T* __restrict__ x, const T* __restrict__ g,
                          const T* __restrict__ ct,
                          const float* __restrict__ mean,
                          const float* __restrict__ rstd,
                          T* __restrict__ dx, int n, int c) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= n) return;
  const int64_t off = static_cast<int64_t>(row) * c;
  const T* xr = x + off;
  const T* cr = ct + off;
  T* dr = dx + off;
  const float mu = mean[row];
  const float rs = rstd[row];
  const int units = c / W;
  const float inv_c = 1.0f / static_cast<float>(c);
  float xf[W], cf[W], gf[W];

  float s1 = 0.0f, s2 = 0.0f;
  for (int i = lane; i < units; i += 32) {
    Io<T, W>::load(xr, i, xf);
    Io<T, W>::load(cr, i, cf);
    Io<T, W>::load(g, i, gf);
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const float y = __fmul_rn(cf[k], gf[k]);
      s1 += y;
      s2 = fmaf(y, __fmul_rn(xf[k] - mu, rs), s2);
    }
  }
  const float m1 = warp_sum(s1) * inv_c;
  const float m2 = warp_sum(s2) * inv_c;

  for (int i = lane; i < units; i += 32) {
    Io<T, W>::load(xr, i, xf);
    Io<T, W>::load(cr, i, cf);
    Io<T, W>::load(g, i, gf);
#pragma unroll
    for (int k = 0; k < W; ++k)
      xf[k] = rs * (__fmul_rn(cf[k], gf[k]) - m1 -
                    __fmul_rn(__fmul_rn(xf[k] - mu, rs), m2));
    Io<T, W>::store(dr, i, xf);
  }
}

template <typename T>
void launch(const void* x, const void* gamma, const void* ct,
            const void* mean, const void* rstd, void* dx, int n, int c,
            cudaStream_t st) {
  constexpr int kVec = 16 / sizeof(T);
  const int blocks = static_cast<int>(
      (static_cast<int64_t>(n) * 32 + kThreads - 1) / kThreads);
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(gamma);
  const T* ctt = static_cast<const T*>(ct);
  const float* mf = static_cast<const float*>(mean);
  const float* rf = static_cast<const float*>(rstd);
  T* dt = static_cast<T*>(dx);
  if (c % kVec == 0 && mxio::aligned(x, 16) && mxio::aligned(gamma, 16) &&
      mxio::aligned(ct, 16) && mxio::aligned(dx, 16))
    ln_bwd_dx<T, kVec><<<blocks, kThreads, 0, st>>>(xt, gt, ctt, mf, rf, dt,
                                                    n, c);
  else
    ln_bwd_dx<T, 1><<<blocks, kThreads, 0, st>>>(xt, gt, ctt, mf, rf, dt, n,
                                                 c);
}

}  // namespace

// x (n, c), gamma (c,), ct (n, c), mean (n,), rstd (n,) -> dx (n, c); all
// float32, contiguous, on one device. Returns cudaGetLastError().
extern "C" int mx_ln_bwd_dx_f32(const void* x, const void* gamma,
                                const void* ct, const void* mean,
                                const void* rstd, void* dx, int n, int c,
                                void* stream) {
  if (n > 0 && c > 0)
    launch<float>(x, gamma, ct, mean, rstd, dx, n, c,
                  static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// The same over bfloat16 x, gamma, ct and dx; mean and rstd float32.
extern "C" int mx_ln_bwd_dx_bf16(const void* x, const void* gamma,
                                 const void* ct, const void* mean,
                                 const void* rstd, void* dx, int n, int c,
                                 void* stream) {
  if (n > 0 && c > 0)
    launch<__nv_bfloat16>(x, gamma, ct, mean, rstd, dx, n, c,
                          static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// The same over float16 x, gamma, ct and dx; mean and rstd float32.
extern "C" int mx_ln_bwd_dx_f16(const void* x, const void* gamma,
                                const void* ct, const void* mean,
                                const void* rstd, void* dx, int n, int c,
                                void* stream) {
  if (n > 0 && c > 0)
    launch<__half>(x, gamma, ct, mean, rstd, dx, n, c,
                   static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
