// Bias + exact (erf) GeLU backward, the input gradient, for Hopper
// (sm_90a).
//
// Replaces: mxnet_tpu/ops/pallas_kernels.py _bias_gelu_dx_kernel, launched
// by _bias_gelu_bwd_rule. Computes, in float32, for x (N, C), bias (C,)
// and the output cotangent ct (N, C):
//   z = x + bias,  phi = exp(-z^2 / 2) / sqrt(2 pi)
//   dx = ct * (0.5 * (1 + erf(z / sqrt(2))) + z * phi)
// with the TPU kernel's constants. Three instances: float32, and bfloat16 or
// float16 (the mixed-precision path: x, bias, ct and dx bfloat16), which
// widens every value exactly, computes in float32 as the float32 instance does
// and rounds dx to nearest even once. The bias gradient, the column sum
// of dx, stays a plain float32-accumulated reduction beside the kernel,
// as the JAX package leaves it to XLA.
//
// Bound: bytes. x and ct are read and dx written once (3 * N * C * 4
// bytes in float32, half that in bfloat16); erff and expf cost a few
// dozen instructions per element, still below the card's operations-per-
// byte line. Design: one elementwise pass, a grid-stride loop with 16-byte
// accesses (4 floats or 8 16-bit values, vec_io.cuh) when C is a
// multiple of that unit and every pointer is 16-byte aligned (a unit then
// never straddles two rows), one value at a time otherwise. erff and expf
// are the full-precision library functions, not the approximate
// intrinsics.
#include <cuda_runtime.h>
#include <stdint.h>

#include "vec_io.cuh"

namespace {

using mxio::Io;

constexpr int kThreads = 256;
constexpr float kInvSqrt2 = 0.7071067811865476f;
constexpr float kInvSqrt2Pi = 0.3989422804014327f;

__device__ __forceinline__ float dgelu(float z) {
  const float phi = expf(-0.5f * z * z) * kInvSqrt2Pi;
  return 0.5f * (1.0f + erff(z * kInvSqrt2)) + z * phi;
}

// Grid-stride over units of W values; `cu` units per row of bias.
template <typename T, int W>
__global__ void bias_gelu_dx(const T* __restrict__ x, const T* __restrict__ b,
                             const T* __restrict__ ct, T* __restrict__ dx,
                             int64_t units, int cu) {
  float f[W], bb[W], g[W];
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       i < units; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    Io<T, W>::load(x, i, f);
    Io<T, W>::load(b, i % cu, bb);
    Io<T, W>::load(ct, i, g);
#pragma unroll
    for (int k = 0; k < W; ++k) f[k] = g[k] * dgelu(f[k] + bb[k]);
    Io<T, W>::store(dx, i, f);
  }
}

template <typename T>
void launch(const void* x, const void* bias, const void* ct, void* dx,
            int n, int c, cudaStream_t st) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = c % kVec == 0 && mxio::aligned(x, 16) &&
                   mxio::aligned(bias, 16) && mxio::aligned(ct, 16) &&
                   mxio::aligned(dx, 16);
  const int w = vec ? kVec : 1;
  const int64_t units = static_cast<int64_t>(n) * c / w;
  int64_t blocks = (units + kThreads - 1) / kThreads;
  if (blocks > 65535) blocks = 65535;
  const T* xt = static_cast<const T*>(x);
  const T* bt = static_cast<const T*>(bias);
  const T* ctt = static_cast<const T*>(ct);
  T* dt = static_cast<T*>(dx);
  if (vec)
    bias_gelu_dx<T, kVec><<<static_cast<int>(blocks), kThreads, 0, st>>>(
        xt, bt, ctt, dt, units, c / kVec);
  else
    bias_gelu_dx<T, 1><<<static_cast<int>(blocks), kThreads, 0, st>>>(
        xt, bt, ctt, dt, units, c);
}

}  // namespace

// x (n, c), bias (c,), ct (n, c) -> dx (n, c); float32, contiguous, one
// device. Returns cudaGetLastError().
extern "C" int mx_bias_gelu_dx_f32(const void* x, const void* bias,
                                   const void* ct, void* dx, int n, int c,
                                   void* stream) {
  if (static_cast<int64_t>(n) * c > 0)
    launch<float>(x, bias, ct, dx, n, c, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// The same over bfloat16 x, bias, ct and dx.
extern "C" int mx_bias_gelu_dx_bf16(const void* x, const void* bias,
                                    const void* ct, void* dx, int n, int c,
                                    void* stream) {
  if (static_cast<int64_t>(n) * c > 0)
    launch<__nv_bfloat16>(x, bias, ct, dx, n, c,
                          static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// The same over float16 x, bias, ct and dx.
extern "C" int mx_bias_gelu_dx_f16(const void* x, const void* bias,
                                   const void* ct, void* dx, int n, int c,
                                   void* stream) {
  if (static_cast<int64_t>(n) * c > 0)
    launch<__half>(x, bias, ct, dx, n, c, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
