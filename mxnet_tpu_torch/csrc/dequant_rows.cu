// Per-row weight dequant, for Hopper (sm_90a): QuantizedConvolution's
// weight, rebuilt in float32 ahead of the convolution.
//
// Replaces: mxnet_tpu/ops/quant.py _dequant_rows_kernel, launched by
// _qconv_pallas_variant. Computes, for w (O, cols) int8 or float8_e4m3fn
// (a conv weight (O, C, kh, kw) seen as rows) and s (O,) float32:
//   out[o, c] = float(w[o, c]) * s[o]
// The product is rounded once (__fmul_rn), so the kernel is bit-identical
// to its plain version and to the JAX composition.
//
// Bound: bytes. Each weight is read once (1 byte) and written once as
// float32 (4 bytes); one multiply per element. Design: one elementwise
// grid-stride pass. When cols % 4 == 0 and the pointers allow it, a thread
// takes 4 weights as one 32-bit load and writes them as one float4 (the 4
// never straddle two rows); otherwise one weight at a time (ResNet's stem,
// cols = 147). Most conv weights are small, so most launches are
// launch-bound; the largest on ResNet-50's path, (512, 4608), moves 11.8 MB.
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct I8 {};
struct E4M3 {};

__device__ __forceinline__ float decode(uint32_t b, I8) {
  return static_cast<float>(static_cast<int8_t>(static_cast<uint8_t>(b)));
}

__device__ __forceinline__ float decode(uint32_t b, E4M3) {
  __nv_fp8_e4m3 v;
  v.__x = static_cast<__nv_fp8_storage_t>(b & 0xffu);
  return static_cast<float>(v);
}

template <typename W>
__global__ void dequant_rows_vec4(const uint32_t* __restrict__ w,
                                  const float* __restrict__ s,
                                  float4* __restrict__ out, int64_t n4,
                                  int64_t cols4) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       i < n4; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const uint32_t v = w[i];
    const float sc = s[i / cols4];
    float4 o;
    o.x = __fmul_rn(decode(v, W()), sc);
    o.y = __fmul_rn(decode(v >> 8, W()), sc);
    o.z = __fmul_rn(decode(v >> 16, W()), sc);
    o.w = __fmul_rn(decode(v >> 24, W()), sc);
    out[i] = o;
  }
}

template <typename W>
__global__ void dequant_rows_scalar(const uint8_t* __restrict__ w,
                                    const float* __restrict__ s,
                                    float* __restrict__ out, int64_t n,
                                    int64_t cols) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x)
    out[i] = __fmul_rn(decode(w[i], W()), s[i / cols]);
}

template <typename W>
int launch(const void* w, const void* s, void* out, int rows, int cols,
           void* stream) {
  const int64_t total = static_cast<int64_t>(rows) * cols;
  if (total > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const bool vec = (cols & 3) == 0 &&
                     (reinterpret_cast<uintptr_t>(w) & 3) == 0 &&
                     (reinterpret_cast<uintptr_t>(out) & 15) == 0;
    const int64_t work = vec ? total / 4 : total;
    int64_t blocks = (work + kThreads - 1) / kThreads;
    if (blocks > 65535) blocks = 65535;
    if (vec) {
      dequant_rows_vec4<W><<<static_cast<int>(blocks), kThreads, 0, st>>>(
          static_cast<const uint32_t*>(w), static_cast<const float*>(s),
          static_cast<float4*>(out), work, cols / 4);
    } else {
      dequant_rows_scalar<W><<<static_cast<int>(blocks), kThreads, 0, st>>>(
          static_cast<const uint8_t*>(w), static_cast<const float*>(s),
          static_cast<float*>(out), work, cols);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// w (rows, cols) one byte per weight, s (rows,) float32 -> out (rows, cols)
// float32; contiguous, one device. Returns cudaGetLastError().
extern "C" int mx_dequant_rows_i8_f32(const void* w, const void* s, void* out,
                                      int rows, int cols, void* stream) {
  return launch<I8>(w, s, out, rows, cols, stream);
}

extern "C" int mx_dequant_rows_e4m3_f32(const void* w, const void* s,
                                        void* out, int rows, int cols,
                                        void* stream) {
  return launch<E4M3>(w, s, out, rows, cols, stream);
}
