// Bias add + exact (erf) GeLU epilogue, for Hopper (sm_90a).
//
// Replaces: mxnet_tpu/ops/pallas_kernels.py _bias_gelu_kernel, launched by
// _pl_bias_gelu. Computes, in float32, for x (N, C) and bias (C,):
//   z = x + bias,  y = 0.5 * z * (1 + erf(z / sqrt(2)))
//
// Bound: bytes. x is read and y written once; erff costs a few dozen
// instructions per element, still well below the card's operations-per-
// byte line. Design: one elementwise pass, a grid-stride loop with 16-byte
// (float4) accesses when C % 4 == 0 and the pointers are 16-byte aligned
// (a float4 then never straddles two rows), scalar otherwise. erff is the
// full-precision library erf, not an approximation.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kInvSqrt2 = 0.7071067811865476f;

__device__ __forceinline__ float gelu(float z) {
  return 0.5f * z * (1.0f + erff(z * kInvSqrt2));
}

__global__ void bias_gelu_vec4(const float4* __restrict__ x,
                               const float4* __restrict__ b,
                               float4* __restrict__ y, int64_t n4, int c4) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       i < n4; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const float4 v = x[i], bb = b[i % c4];
    float4 o;
    o.x = gelu(v.x + bb.x);
    o.y = gelu(v.y + bb.y);
    o.z = gelu(v.z + bb.z);
    o.w = gelu(v.w + bb.w);
    y[i] = o;
  }
}

__global__ void bias_gelu_scalar(const float* __restrict__ x,
                                 const float* __restrict__ b,
                                 float* __restrict__ y, int64_t n, int c) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x)
    y[i] = gelu(x[i] + b[i % c]);
}

}  // namespace

// x (n, c), bias (c,) -> y (n, c); float32, contiguous, one device.
// Returns cudaGetLastError().
extern "C" int mx_bias_gelu_f32(const void* x, const void* bias, void* y,
                                int n, int c, void* stream) {
  const int64_t total = static_cast<int64_t>(n) * c;
  if (total > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool vec = (c & 3) == 0 &&
                     ((reinterpret_cast<uintptr_t>(x) |
                       reinterpret_cast<uintptr_t>(bias) |
                       reinterpret_cast<uintptr_t>(y)) & 15) == 0;
    const int64_t work = vec ? total / 4 : total;
    int64_t blocks = (work + kThreads - 1) / kThreads;
    if (blocks > 65535) blocks = 65535;
    if (vec) {
      bias_gelu_vec4<<<static_cast<int>(blocks), kThreads, 0, s>>>(
          static_cast<const float4*>(x), static_cast<const float4*>(bias),
          static_cast<float4*>(y), work, c / 4);
    } else {
      bias_gelu_scalar<<<static_cast<int>(blocks), kThreads, 0, s>>>(
          static_cast<const float*>(x), static_cast<const float*>(bias),
          static_cast<float*>(y), work, c);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
