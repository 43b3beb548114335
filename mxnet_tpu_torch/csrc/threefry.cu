// Threefry2x32 random bits for Dropout and the uniform draws, for Hopper
// (sm_90a).
//
// Replaces: no Pallas kernel. The JAX package draws Dropout's mask
// (mxnet_tpu/ops/nn.py _dropout_fwd, jax.random.bernoulli) and the samplers'
// and initializers' uniform draws (mxnet_tpu/ops/tensor.py _reg_sampler,
// mxnet_tpu/initializer.py, jax.random.uniform / normal / exponential)
// through XLA's threefry2x32. This source computes the same bits: element n
// of a draw (row-major, a 64-bit index) hashes the counter (n >> 32,
// n & 0xffffffff) under the two key words with threefry2x32's 20 rounds
// (adds, rotates as __funnelshift_l and xors on 32-bit words), and its bits
// are the xor of the two output words. The float in [0, 1) is
// (bits >> 9 | 0x3f800000) read as float32, minus 1, as jax.random.uniform
// makes it.
//
// Two entry points, one launch each:
// - dropout (float32, bfloat16, float16): keep = u < keep_prob (float32),
//   mask = keep ? m : 0 with m = 1 / keep_prob as the JAX package rounds it
//   (the caller passes it, exact in the data's type), y = x * mask in the
//   data's type (x widened exactly; x * m is exact in float32 for 16-bit
//   data, so y is rounded once). y and mask are written in one pass.
// - uniform (float32): max(lo, fma(u, hi - lo, lo)) as XLA fuses it, then
//   optionally sqrt(2) * erfinvf(.) (the normal sampler, lo = nextafter(-1,
//   0), hi = 1) or -log1pf(-u) (the exponential sampler).
// - uniform (bfloat16, float16): the draws of mx.random.draw in the type,
//   bit for bit for uniform: the low 8 (bfloat16) or 16 (float16) random
//   bits, their top 7 or 10 under the exponent of 1.0, minus 1 (exact);
//   then u * span + lo with span = hi - lo rounded to the type by the
//   caller: float16 takes the float32 product (exact: 11 by 11 bits) and
//   the float32 sum, rounded once to float16, as XLA keeps float32 through
//   it on the CPU; bfloat16 rounds the product and the sum each to the
//   type, as XLA does; max(lo, .) in the type. normal is sqrt(2) (1.4140625
//   in either type) times erfinv, and exponential -log1p(-u), each function
//   rounded to the type and the product rounded again, as PyTorch computes
//   them on 16-bit tensors.
//
// Bound: operations. threefry2x32 is ~73 integer operations on 32-bit
// words for each 32 random bits, and an element of float32 Dropout moves
// 12 bytes (x read, y and mask written): at the card's integer rate (64
// INT32 operations a clock an SM, half its float32 lanes) the hash takes
// longer than the bytes at 3.35 TB/s. Design: one thread hashes the W
// elements of one 16-byte unit of x (4 floats or 8 16-bit values, when
// the three pointers are 16-byte aligned; else W = 1), so loads and stores
// are 16 bytes wide and the W hashes are
// independent chains the scheduler interleaves; the rotations are single
// funnel shifts; a grid-stride loop over the units, 64-bit indices
// throughout, and the values past the last whole unit (a size that is not
// a multiple of W) by the first threads of the same launch, one each.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "vec_io.cuh"

namespace {

using mxio::Io;

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 1 << 20;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// threefry2x32 of the counter (n >> 32, n & 0xffffffff) under (k0, k1);
// returns the xor of the two output words.
__device__ __forceinline__ uint32_t threefry_bits(uint32_t k0, uint32_t k1,
                                                  uint64_t n) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  uint32_t x0 = static_cast<uint32_t>(n >> 32) + k0;
  uint32_t x1 = static_cast<uint32_t>(n) + k1;
#define MX_ROUND(r) \
  x0 += x1;         \
  x1 = rotl(x1, r) ^ x0;
  MX_ROUND(13) MX_ROUND(15) MX_ROUND(26) MX_ROUND(6)
  x0 += k1; x1 += k2 + 1u;
  MX_ROUND(17) MX_ROUND(29) MX_ROUND(16) MX_ROUND(24)
  x0 += k2; x1 += k0 + 2u;
  MX_ROUND(13) MX_ROUND(15) MX_ROUND(26) MX_ROUND(6)
  x0 += k0; x1 += k1 + 3u;
  MX_ROUND(17) MX_ROUND(29) MX_ROUND(16) MX_ROUND(24)
  x0 += k1; x1 += k2 + 4u;
  MX_ROUND(13) MX_ROUND(15) MX_ROUND(26) MX_ROUND(6)
  x0 += k2; x1 += k0 + 5u;
#undef MX_ROUND
  return x0 ^ x1;
}

// The float32 in [0, 1) of 32 random bits.
__device__ __forceinline__ float unit_f32(uint32_t b) {
  return __uint_as_float((b >> 9) | 0x3F800000u) - 1.0f;
}

// One launch: units [0, units) of W values each through the grid-stride
// loop, then the n - units * W values past them (fewer than W) by the
// first threads of the grid, one value each.
template <typename T, int W>
__global__ void dropout(const T* __restrict__ x, T* __restrict__ y,
                        T* __restrict__ mask, int64_t units, int64_t n,
                        uint32_t k0, uint32_t k1, float keep, float m) {
  const int64_t tid = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                      threadIdx.x;
  float f[W], g[W];
  for (int64_t u = tid; u < units;
       u += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    Io<T, W>::load(x, u, f);
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const uint64_t i = static_cast<uint64_t>(u) * W + k;
      g[k] = unit_f32(threefry_bits(k0, k1, i)) < keep ? m : 0.0f;
      f[k] = __fmul_rn(f[k], g[k]);
    }
    Io<T, W>::store(y, u, f);
    Io<T, W>::store(mask, u, g);
  }
  const int64_t i = units * W + tid;
  if (W > 1 && i < n) {
    Io<T, 1>::load(x, i, f);
    g[0] = unit_f32(threefry_bits(k0, k1, static_cast<uint64_t>(i))) < keep
               ? m : 0.0f;
    f[0] = __fmul_rn(f[0], g[0]);
    Io<T, 1>::store(y, i, f);
    Io<T, 1>::store(mask, i, g);
  }
}

int blocks_for(int64_t units) {
  int64_t b = (units + kThreads - 1) / kThreads;
  return static_cast<int>(b < kMaxBlocks ? (b > 0 ? b : 1) : kMaxBlocks);
}

template <typename T>
int launch_dropout(const void* x, void* y, void* mask, int64_t n,
                   uint32_t k0, uint32_t k1, float keep, float m,
                   cudaStream_t st) {
  constexpr int kVec = 16 / sizeof(T);
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  T* mt = static_cast<T*>(mask);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (mxio::aligned(x, 16) && mxio::aligned(y, 16) &&
      mxio::aligned(mask, 16)) {
    const int64_t units = n / kVec;
    dropout<T, kVec><<<blocks_for(units > 0 ? units : 1), kThreads, 0, st>>>(
        xt, yt, mt, units, n, k0, k1, keep, m);
  } else {
    dropout<T, 1><<<blocks_for(n), kThreads, 0, st>>>(xt, yt, mt, n, n, k0,
                                                      k1, keep, m);
  }
  return static_cast<int>(cudaGetLastError());
}

// transform: 0 uniform in [lo, lo + span), 1 normal, 2 exponential
__global__ void uniform_f32(float* __restrict__ out, int64_t n, uint32_t k0,
                            uint32_t k1, float lo, float span,
                            int transform) {
  constexpr float kSqrt2 = 1.4142135623730951f;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const float f = unit_f32(threefry_bits(k0, k1, static_cast<uint64_t>(i)));
    float v = fmaxf(lo, __fmaf_rn(f, span, lo));
    if (transform == 1)
      v = __fmul_rn(kSqrt2, erfinvf(v));
    else if (transform == 2)
      v = -log1pf(-v);
    out[i] = v;
  }
}

// The 16-bit types' draws: the random bits used (kMask), the shift that
// leaves the mantissa's, 1.0's bits, and whether u * span + lo rounds each
// op to the type (bfloat16) or once, from float32 (float16).
template <typename T>
struct Bits16;
template <>
struct Bits16<__half> {
  static constexpr uint32_t kMask = 0xFFFFu, kShift = 6, kOne = 0x3C00u;
  static constexpr bool kRoundEach = false;
  static __device__ __forceinline__ float unit(uint32_t b) {
    return __half2float(__ushort_as_half(static_cast<unsigned short>(
               ((b & kMask) >> kShift) | kOne))) - 1.0f;
  }
};
template <>
struct Bits16<__nv_bfloat16> {
  static constexpr uint32_t kMask = 0xFFu, kShift = 1, kOne = 0x3F80u;
  static constexpr bool kRoundEach = true;
  static __device__ __forceinline__ float unit(uint32_t b) {
    return __bfloat162float(__ushort_as_bfloat16(static_cast<unsigned short>(
               ((b & kMask) >> kShift) | kOne))) - 1.0f;
  }
};

template <typename T>
__device__ __forceinline__ float round16(float x) {
  return mxio::Half<T>::widen(mxio::Half<T>::round(x));
}

// transform as uniform_f32's; lo and span are values of the type T.
template <typename T>
__global__ void uniform_16(T* __restrict__ out, int64_t n, uint32_t k0,
                           uint32_t k1, float lo, float span,
                           int transform) {
  constexpr float kSqrt2 = 1.4140625f;   // sqrt(2) rounded to T (both)
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const float f = Bits16<T>::unit(
        threefry_bits(k0, k1, static_cast<uint64_t>(i)));
    float p = __fmul_rn(f, span);
    if (Bits16<T>::kRoundEach) p = round16<T>(p);
    float v = fmaxf(lo, round16<T>(__fadd_rn(p, lo)));
    if (transform == 1)
      v = round16<T>(__fmul_rn(kSqrt2, round16<T>(erfinvf(v))));
    else if (transform == 2)
      v = -round16<T>(log1pf(-v));
    out[i] = mxio::Half<T>::round(v);
  }
}

template <typename T>
int launch_uniform_16(void* out, long long n, unsigned k0, unsigned k1,
                      float lo, float span, int transform, void* stream) {
  if (n > 0)
    uniform_16<T><<<blocks_for(n), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<T*>(out), n, k0, k1, lo, span, transform);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, y, mask (n,) in one dtype, contiguous, one device; keep the keep
// probability (float32), m the kept value of the mask. Returns
// cudaGetLastError().
extern "C" int mx_dropout_f32(const void* x, void* y, void* mask,
                              long long n, unsigned k0, unsigned k1,
                              float keep, float m, void* stream) {
  return launch_dropout<float>(x, y, mask, n, k0, k1, keep, m,
                               static_cast<cudaStream_t>(stream));
}

extern "C" int mx_dropout_bf16(const void* x, void* y, void* mask,
                               long long n, unsigned k0, unsigned k1,
                               float keep, float m, void* stream) {
  return launch_dropout<__nv_bfloat16>(x, y, mask, n, k0, k1, keep, m,
                                       static_cast<cudaStream_t>(stream));
}

extern "C" int mx_dropout_f16(const void* x, void* y, void* mask,
                              long long n, unsigned k0, unsigned k1,
                              float keep, float m, void* stream) {
  return launch_dropout<__half>(x, y, mask, n, k0, k1, keep, m,
                                static_cast<cudaStream_t>(stream));
}

// out (n,) float32: the draws of key (k0, k1), see uniform_f32.
extern "C" int mx_uniform_f32(void* out, long long n, unsigned k0,
                              unsigned k1, float lo, float span,
                              int transform, void* stream) {
  if (n > 0)
    uniform_f32<<<blocks_for(n), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
        static_cast<float*>(out), n, k0, k1, lo, span, transform);
  return static_cast<int>(cudaGetLastError());
}

// out (n,) bfloat16 / float16: the draws of key (k0, k1), see uniform_16;
// lo and span are values of the type.
extern "C" int mx_uniform_bf16(void* out, long long n, unsigned k0,
                               unsigned k1, float lo, float span,
                               int transform, void* stream) {
  return launch_uniform_16<__nv_bfloat16>(out, n, k0, k1, lo, span,
                                          transform, stream);
}

extern "C" int mx_uniform_f16(void* out, long long n, unsigned k0,
                              unsigned k1, float lo, float span,
                              int transform, void* stream) {
  return launch_uniform_16<__half>(out, n, k0, k1, lo, span, transform,
                                   stream);
}
