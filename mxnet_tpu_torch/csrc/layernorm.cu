// LayerNorm forward over the last axis, for Hopper (sm_90a).
//
// Replaces: mxnet_tpu/ops/pallas_kernels.py _ln_fwd_kernel, launched by
// _pl_layernorm_fwd. Computes, per row of x (N, C):
//   mean = sum(x) / C,  var = sum((x - mean)^2) / C   (two-pass, float32)
//   rstd = 1 / sqrt(var + eps),  y = (x - mean) * rstd * gamma + beta
// and writes y (N, C), mean (N,) and rstd (N,). The op's std output is
// 1 / rstd, taken by the wrapper. Three instances: float32, and bfloat16 or
// float16 (the mixed-precision path: x, gamma and beta bfloat16, as the graph
// casts its parameters), which widens every value exactly, computes as the
// float32 instance does and rounds y to nearest even once; mean and rstd stay
// float32, as the TPU kernel's statistic outputs are.
//
// Bound: bytes. x is read and y written once (plus gamma/beta, shared by
// every row and cached); ~10 flops per element is far below the card's
// operations-per-byte line. Design: one warp per row. The row is walked
// three times (sum, squared deviations, write) straight from global
// memory; after the first pass it sits in L1 (2 KiB at C=512 in float32,
// 1 KiB in bfloat16), so the second and third walks cost no device-memory
// traffic, and the kernel takes any C without a register-resident row.
// Accesses are 16-byte (4 floats or 8 16-bit values, vec_io.cuh) when C
// is a multiple of that unit and the pointers are 16-byte aligned, one
// value at a time otherwise. The variance is the two-pass form of the TPU
// kernel, not E[x^2] - mean^2; 1 / sqrtf is IEEE-rounded, not the
// approximate rsqrtf.
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
__global__ void ln_fwd(const T* __restrict__ x, const T* __restrict__ g,
                       const T* __restrict__ b, T* __restrict__ y,
                       float* __restrict__ mean_out,
                       float* __restrict__ rstd_out, int n, int c,
                       float eps) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= n) return;
  const T* xr = x + static_cast<int64_t>(row) * c;
  T* yr = y + static_cast<int64_t>(row) * c;
  const int units = c / W;
  const float inv_c = 1.0f / static_cast<float>(c);
  float f[W];

  float s = 0.0f;
  for (int i = lane; i < units; i += 32) {
    Io<T, W>::load(xr, i, f);
#pragma unroll
    for (int k = 0; k < W; ++k) s += f[k];
  }
  const float mean = warp_sum(s) * inv_c;

  float q = 0.0f;
  for (int i = lane; i < units; i += 32) {
    Io<T, W>::load(xr, i, f);
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const float d0 = f[k] - mean;
      q = fmaf(d0, d0, q);
    }
  }
  const float var = warp_sum(q) * inv_c;
  const float rstd = 1.0f / sqrtf(var + eps);

  float gg[W], bb[W];
  for (int i = lane; i < units; i += 32) {
    Io<T, W>::load(xr, i, f);
    Io<T, W>::load(g, i, gg);
    Io<T, W>::load(b, i, bb);
#pragma unroll
    for (int k = 0; k < W; ++k) f[k] = (f[k] - mean) * rstd * gg[k] + bb[k];
    Io<T, W>::store(yr, i, f);
  }
  if (lane == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

template <typename T>
void launch(const void* x, const void* gamma, const void* beta, void* y,
            void* mean, void* rstd, int n, int c, float eps,
            cudaStream_t st) {
  constexpr int kVec = 16 / sizeof(T);
  const int blocks = (n * 32 + kThreads - 1) / kThreads;
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(gamma);
  const T* bt = static_cast<const T*>(beta);
  T* yt = static_cast<T*>(y);
  float* mf = static_cast<float*>(mean);
  float* rf = static_cast<float*>(rstd);
  if (c % kVec == 0 && mxio::aligned(x, 16) && mxio::aligned(y, 16) &&
      mxio::aligned(gamma, 16) && mxio::aligned(beta, 16))
    ln_fwd<T, kVec><<<blocks, kThreads, 0, st>>>(xt, gt, bt, yt, mf, rf, n,
                                                 c, eps);
  else
    ln_fwd<T, 1><<<blocks, kThreads, 0, st>>>(xt, gt, bt, yt, mf, rf, n, c,
                                              eps);
}

}  // namespace

// x (n, c), gamma (c,), beta (c,) -> y (n, c), mean (n,), rstd (n,); all
// float32, contiguous, on one device. Returns cudaGetLastError().
extern "C" int mx_layernorm_fwd_f32(const void* x, const void* gamma,
                                    const void* beta, void* y, void* mean,
                                    void* rstd, int n, int c, float eps,
                                    void* stream) {
  if (n > 0 && c > 0)
    launch<float>(x, gamma, beta, y, mean, rstd, n, c, eps,
                  static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// The same over bfloat16 x, gamma, beta and y; mean and rstd float32.
extern "C" int mx_layernorm_fwd_bf16(const void* x, const void* gamma,
                                     const void* beta, void* y, void* mean,
                                     void* rstd, int n, int c, float eps,
                                     void* stream) {
  if (n > 0 && c > 0)
    launch<__nv_bfloat16>(x, gamma, beta, y, mean, rstd, n, c, eps,
                          static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// The same over float16 x, gamma, beta and y; mean and rstd float32.
extern "C" int mx_layernorm_fwd_f16(const void* x, const void* gamma,
                                    const void* beta, void* y, void* mean,
                                    void* rstd, int n, int c, float eps,
                                    void* stream) {
  if (n > 0 && c > 0)
    launch<__half>(x, gamma, beta, y, mean, rstd, n, c, eps,
                   static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
