// Bias + exact (erf) GeLU backward, the input gradient, for Hopper
// (sm_90a).
//
// Replaces: mxnet_tpu/ops/pallas_kernels.py _bias_gelu_dx_kernel, launched
// by _bias_gelu_bwd_rule. Computes, in float32, for x (N, C), bias (C,)
// and the output cotangent ct (N, C):
//   z = x + bias,  phi = exp(-z^2 / 2) / sqrt(2 pi)
//   dx = ct * (0.5 * (1 + erf(z / sqrt(2))) + z * phi)
// with the TPU kernel's constants. The bias gradient, the column sum of
// dx, stays a plain reduction beside the kernel, as the JAX package
// leaves it to XLA.
//
// Bound: bytes. x and ct are read and dx written once (3 * N * C * 4
// bytes); erff and expf cost a few dozen instructions per element, still
// below the card's operations-per-byte line. Design: one elementwise pass,
// a grid-stride loop with 16-byte (float4) accesses when C % 4 == 0 and
// every pointer is 16-byte aligned (a float4 then never straddles two
// rows), scalar otherwise. erff and expf are the full-precision library
// functions, not the approximate intrinsics.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kInvSqrt2 = 0.7071067811865476f;
constexpr float kInvSqrt2Pi = 0.3989422804014327f;

__device__ __forceinline__ float dgelu(float z) {
  const float phi = expf(-0.5f * z * z) * kInvSqrt2Pi;
  return 0.5f * (1.0f + erff(z * kInvSqrt2)) + z * phi;
}

__global__ void bias_gelu_dx_vec4(const float4* __restrict__ x,
                                  const float4* __restrict__ b,
                                  const float4* __restrict__ ct,
                                  float4* __restrict__ dx, int64_t n4,
                                  int c4) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       i < n4; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const float4 v = x[i], bb = b[i % c4], g = ct[i];
    float4 o;
    o.x = g.x * dgelu(v.x + bb.x);
    o.y = g.y * dgelu(v.y + bb.y);
    o.z = g.z * dgelu(v.z + bb.z);
    o.w = g.w * dgelu(v.w + bb.w);
    dx[i] = o;
  }
}

__global__ void bias_gelu_dx_scalar(const float* __restrict__ x,
                                    const float* __restrict__ b,
                                    const float* __restrict__ ct,
                                    float* __restrict__ dx, int64_t n,
                                    int c) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x)
    dx[i] = ct[i] * dgelu(x[i] + b[i % c]);
}

}  // namespace

// x (n, c), bias (c,), ct (n, c) -> dx (n, c); float32, contiguous, one
// device. Returns cudaGetLastError().
extern "C" int mx_bias_gelu_dx_f32(const void* x, const void* bias,
                                   const void* ct, void* dx, int n, int c,
                                   void* stream) {
  const int64_t total = static_cast<int64_t>(n) * c;
  if (total > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool vec = (c & 3) == 0 &&
                     ((reinterpret_cast<uintptr_t>(x) |
                       reinterpret_cast<uintptr_t>(bias) |
                       reinterpret_cast<uintptr_t>(ct) |
                       reinterpret_cast<uintptr_t>(dx)) & 15) == 0;
    const int64_t work = vec ? total / 4 : total;
    int64_t blocks = (work + kThreads - 1) / kThreads;
    if (blocks > 65535) blocks = 65535;
    if (vec) {
      bias_gelu_dx_vec4<<<static_cast<int>(blocks), kThreads, 0, s>>>(
          static_cast<const float4*>(x), static_cast<const float4*>(bias),
          static_cast<const float4*>(ct), static_cast<float4*>(dx), work,
          c / 4);
    } else {
      bias_gelu_dx_scalar<<<static_cast<int>(blocks), kThreads, 0, s>>>(
          static_cast<const float*>(x), static_cast<const float*>(bias),
          static_cast<const float*>(ct), static_cast<float*>(dx), work, c);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
