// Loads and stores of W consecutive values as float32, for the kernels that
// have a float32, a bfloat16 and a float16 instance (embedding, layernorm,
// bias_gelu, decode_attention, softmax, softmax_ce_bwd, bn_stats,
// bn_apply_relu, ln_bwd, bias_gelu_dx, flash_attention, qfc_matmul).
//
// Io<T, W>::load(p, u, f) reads unit u (the W values p[u*W .. u*W+W-1]) into
// f[0..W-1] as float32; Io<T, W>::store(p, u, f) writes f back in T. The
// same load in two steps, for a kernel that fetches a unit ahead of its use:
// Io<T, W>::raw(p, u) returns the unit as stored (Io<T, W>::Raw, registers
// that hold the bytes) and Io<T, W>::widen(r, f) widens it. A unit is
// one aligned access: W = 4 floats or 8 16-bit values are 16 bytes, W = 4
// 16-bit values 8 bytes, W = 2 16-bit values 4 bytes; the caller checks the
// alignment. bfloat16 and float16 are widened exactly (__bfloat162float,
// __half2float and their pair forms) and rounded to nearest even
// (__float2bfloat16_rn, __float2half_rn), as XLA converts; float16
// subnormals are kept both ways.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mxio {

template <typename T, int W>
struct Io;

template <>
struct Io<float, 1> {
  using Raw = float;
  static __device__ __forceinline__ Raw raw(const float* p, int64_t u) {
    return p[u];
  }
  static __device__ __forceinline__ void widen(Raw r, float* f) { f[0] = r; }
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
  using Raw = float4;
  static __device__ __forceinline__ Raw raw(const float* p, int64_t u) {
    return reinterpret_cast<const float4*>(p)[u];
  }
  static __device__ __forceinline__ void widen(Raw v, float* f) {
    f[0] = v.x;
    f[1] = v.y;
    f[2] = v.z;
    f[3] = v.w;
  }
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

// The two 16-bit types: their pair type and exact widening, and stores
// rounded to nearest even (subnormals kept, as XLA converts)
template <typename H>
struct Half;

template <>
struct Half<__nv_bfloat16> {
  using Pair = __nv_bfloat162;
  static __device__ __forceinline__ float widen(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  static __device__ __forceinline__ float2 widen2(Pair x) {
    return __bfloat1622float2(x);
  }
  static __device__ __forceinline__ __nv_bfloat16 round(float f) {
    return __float2bfloat16_rn(f);
  }
  static __device__ __forceinline__ Pair round2(float a, float b) {
    return __floats2bfloat162_rn(a, b);
  }
};

template <>
struct Half<__half> {
  using Pair = __half2;
  static __device__ __forceinline__ float widen(__half x) {
    return __half2float(x);
  }
  static __device__ __forceinline__ float2 widen2(Pair x) {
    return __half22float2(x);
  }
  static __device__ __forceinline__ __half round(float f) {
    return __float2half_rn(f);
  }
  static __device__ __forceinline__ Pair round2(float a, float b) {
    return __floats2half2_rn(a, b);
  }
};

template <typename H>
struct IoOne {
  using Raw = H;
  static __device__ __forceinline__ Raw raw(const H* p, int64_t u) {
    return p[u];
  }
  static __device__ __forceinline__ void widen(Raw r, float* f) {
    f[0] = Half<H>::widen(r);
  }
  static __device__ __forceinline__ void load(const H* p, int64_t u,
                                              float* f) {
    f[0] = Half<H>::widen(p[u]);
  }
  static __device__ __forceinline__ void store(H* p, int64_t u,
                                               const float* f) {
    p[u] = Half<H>::round(f[0]);
  }
};

// W 16-bit values as W / 2 pairs inside one access of 2 * W bytes
template <typename H, int W, typename R>
struct IoPairs {
  static_assert(sizeof(R) == 2 * W, "one access holds W 16-bit values");
  using Raw = R;
  using Pair = typename Half<H>::Pair;
  static __device__ __forceinline__ Raw raw(const H* p, int64_t u) {
    return reinterpret_cast<const Raw*>(p)[u];
  }
  static __device__ __forceinline__ void widen(const Raw& r, float* f) {
    const Pair* h = reinterpret_cast<const Pair*>(&r);
#pragma unroll
    for (int k = 0; k < W / 2; ++k) {
      const float2 v = Half<H>::widen2(h[k]);
      f[2 * k] = v.x;
      f[2 * k + 1] = v.y;
    }
  }
  static __device__ __forceinline__ void load(const H* p, int64_t u,
                                              float* f) {
    widen(raw(p, u), f);
  }
  static __device__ __forceinline__ void store(H* p, int64_t u,
                                               const float* f) {
    Raw raw;
    Pair* h = reinterpret_cast<Pair*>(&raw);
#pragma unroll
    for (int k = 0; k < W / 2; ++k)
      h[k] = Half<H>::round2(f[2 * k], f[2 * k + 1]);
    reinterpret_cast<Raw*>(p)[u] = raw;
  }
};

template <>
struct Io<__nv_bfloat16, 1> : IoOne<__nv_bfloat16> {};
template <>
struct Io<__nv_bfloat16, 2> : IoPairs<__nv_bfloat16, 2, unsigned int> {};
template <>
struct Io<__nv_bfloat16, 4> : IoPairs<__nv_bfloat16, 4, uint2> {};
template <>
struct Io<__nv_bfloat16, 8> : IoPairs<__nv_bfloat16, 8, uint4> {};
template <>
struct Io<__half, 1> : IoOne<__half> {};
template <>
struct Io<__half, 2> : IoPairs<__half, 2, unsigned int> {};
template <>
struct Io<__half, 4> : IoPairs<__half, 4, uint2> {};
template <>
struct Io<__half, 8> : IoPairs<__half, 8, uint4> {};

// True when p is aligned to `bytes` (a power of two)
inline bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

}  // namespace mxio
