// Bias add + exact (erf) GeLU epilogue, for Hopper (sm_90a).
//
// Replaces: mxnet_tpu/ops/pallas_kernels.py _bias_gelu_kernel, launched by
// _pl_bias_gelu. Computes, in float32, for x (N, C) and bias (C,):
//   z = x + bias,  y = 0.5 * z * (1 + erf(z / sqrt(2)))
// Three instances: float32, and bfloat16 or float16 (the mixed-precision path:
// x, bias and y bfloat16), which widens x and bias exactly, computes in
// float32 as the TPU kernel does and rounds y to nearest even once.
//
// Bound: bytes. x is read and y written once; erff costs a few dozen
// instructions per element, still well below the card's operations-per-
// byte line. Design: one elementwise pass, a grid-stride loop with 16-byte
// accesses (4 floats or 8 16-bit values, vec_io.cuh) when C is a
// multiple of that unit and the pointers are 16-byte aligned (a unit then
// never straddles two rows), one value at a time otherwise. erff is the
// full-precision library erf, not an approximation.
#include <cuda_runtime.h>
#include <stdint.h>

#include "vec_io.cuh"

namespace {

using mxio::Io;

constexpr int kThreads = 256;
constexpr float kInvSqrt2 = 0.7071067811865476f;

__device__ __forceinline__ float gelu(float z) {
  return 0.5f * z * (1.0f + erff(z * kInvSqrt2));
}

// Grid-stride over units of W values; `cu` units per row of bias.
template <typename T, int W>
__global__ void bias_gelu(const T* __restrict__ x, const T* __restrict__ b,
                          T* __restrict__ y, int64_t units, int cu) {
  float f[W], bb[W];
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       i < units; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    Io<T, W>::load(x, i, f);
    Io<T, W>::load(b, i % cu, bb);
#pragma unroll
    for (int k = 0; k < W; ++k) f[k] = gelu(f[k] + bb[k]);
    Io<T, W>::store(y, i, f);
  }
}

template <typename T>
void launch(const void* x, const void* bias, void* y, int n, int c,
            cudaStream_t st) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = c % kVec == 0 && mxio::aligned(x, 16) &&
                   mxio::aligned(bias, 16) && mxio::aligned(y, 16);
  const int w = vec ? kVec : 1;
  const int64_t units = static_cast<int64_t>(n) * c / w;
  int64_t blocks = (units + kThreads - 1) / kThreads;
  if (blocks > 65535) blocks = 65535;
  const T* xt = static_cast<const T*>(x);
  const T* bt = static_cast<const T*>(bias);
  T* yt = static_cast<T*>(y);
  if (vec)
    bias_gelu<T, kVec><<<static_cast<int>(blocks), kThreads, 0, st>>>(
        xt, bt, yt, units, c / kVec);
  else
    bias_gelu<T, 1><<<static_cast<int>(blocks), kThreads, 0, st>>>(
        xt, bt, yt, units, c);
}

}  // namespace

// x (n, c), bias (c,) -> y (n, c); float32, contiguous, one device.
// Returns cudaGetLastError().
extern "C" int mx_bias_gelu_f32(const void* x, const void* bias, void* y,
                                int n, int c, void* stream) {
  if (static_cast<int64_t>(n) * c > 0)
    launch<float>(x, bias, y, n, c, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// The same over bfloat16 x, bias and y.
extern "C" int mx_bias_gelu_bf16(const void* x, const void* bias, void* y,
                                 int n, int c, void* stream) {
  if (static_cast<int64_t>(n) * c > 0)
    launch<__nv_bfloat16>(x, bias, y, n, c,
                          static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// The same over float16 x, bias and y.
extern "C" int mx_bias_gelu_f16(const void* x, const void* bias, void* y,
                                int n, int c, void* stream) {
  if (static_cast<int64_t>(n) * c > 0)
    launch<__half>(x, bias, y, n, c, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
