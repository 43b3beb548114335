// Loads and stores of W consecutive values as float32, for the kernels that
// have a float32 and a bfloat16 instance (embedding, layernorm, bias_gelu,
// decode_attention, softmax, softmax_ce_bwd, bn_stats, bn_apply_relu).
//
// Io<T, W>::load(p, u, f) reads unit u (the W values p[u*W .. u*W+W-1]) into
// f[0..W-1] as float32; Io<T, W>::store(p, u, f) writes f back in T. A unit is
// one aligned access: W = 4 floats or 8 bfloat16 values are 16 bytes, W = 4
// bfloat16 values 8 bytes, W = 2 bfloat16 values 4 bytes; the caller checks
// the alignment. bfloat16 is widened exactly and rounded to nearest even
// (__bfloat162float, __float2bfloat16_rn), as XLA converts.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mxio {

template <typename T, int W>
struct Io;

template <>
struct Io<float, 1> {
  static __device__ __forceinline__ void load(const float* p, int64_t u,
                                              float* f) {
    f[0] = p[u];
  }
  static __device__ __forceinline__ void store(float* p, int64_t u,
                                               const float* f) {
    p[u] = f[0];
  }
};

template <>
struct Io<float, 4> {
  static __device__ __forceinline__ void load(const float* p, int64_t u,
                                              float* f) {
    const float4 v = reinterpret_cast<const float4*>(p)[u];
    f[0] = v.x;
    f[1] = v.y;
    f[2] = v.z;
    f[3] = v.w;
  }
  static __device__ __forceinline__ void store(float* p, int64_t u,
                                               const float* f) {
    reinterpret_cast<float4*>(p)[u] = make_float4(f[0], f[1], f[2], f[3]);
  }
};

template <>
struct Io<__nv_bfloat16, 1> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              int64_t u, float* f) {
    f[0] = __bfloat162float(p[u]);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, int64_t u,
                                               const float* f) {
    p[u] = __float2bfloat16_rn(f[0]);
  }
};

// W bfloat16 values as W / 2 pairs inside one access of 2 * W bytes
template <int W, typename Raw>
struct IoPairs {
  static_assert(sizeof(Raw) == 2 * W, "one access holds W bfloat16 values");
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              int64_t u, float* f) {
    const Raw raw = reinterpret_cast<const Raw*>(p)[u];
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int k = 0; k < W / 2; ++k) {
      const float2 v = __bfloat1622float2(h[k]);
      f[2 * k] = v.x;
      f[2 * k + 1] = v.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, int64_t u,
                                               const float* f) {
    Raw raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int k = 0; k < W / 2; ++k)
      h[k] = __floats2bfloat162_rn(f[2 * k], f[2 * k + 1]);
    reinterpret_cast<Raw*>(p)[u] = raw;
  }
};

template <>
struct Io<__nv_bfloat16, 2> : IoPairs<2, unsigned int> {};
template <>
struct Io<__nv_bfloat16, 4> : IoPairs<4, uint2> {};
template <>
struct Io<__nv_bfloat16, 8> : IoPairs<8, uint4> {};

// True when p is aligned to `bytes` (a power of two)
inline bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

}  // namespace mxio
