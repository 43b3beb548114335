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
// float32 (4 bytes); one multiply per element.
//
// Two entry points:
// - mx_dequant_rows_*: one weight, one elementwise grid-stride pass. When
//   cols % 4 == 0 and the pointers allow it, a thread takes 4 weights as
//   one 32-bit load and writes them as one float4 (the 4 never straddle
//   two rows); otherwise one weight at a time. The executor calls it for a
//   conv whose weight the graph computes.
// - mx_dequant_rows_multi_*: every conv weight of a forward in one launch
//   (the executor's prologue over the weights that come straight from
//   variables: ResNet-50's 53, 23.5 M values, where one launch each left
//   most of them at the per-call floor, their bytes far below a
//   microsecond each). The host (ops/cuda_kernels.py,
//   _dequant_tables) passes, per weight, the three pointers, the length,
//   the columns, the cumulative count of kChunk-value chunks and whether
//   the 16-byte route applies; the table travels by value as the kernel's
//   parameter (as multi_update.cuh's), a block a chunk, found by binary
//   search. On the 16-byte route (cols % 16 == 0, weight and output
//   16-byte aligned) a thread reads 16 weights with one 16-byte load, its
//   kUnroll loads issued before any is used; the 16 lie in one row (cols %
//   16 == 0), so a unit reads its row's scale once. A warp's 32 units are
//   2 KB of output, written as four float4s a thread in store order: in
//   store k lane l writes float4 32 k + l, whose 4 codes and scale it takes
//   from the unit's lane (8 k + l / 4) by shuffles, so each store
//   instruction writes 512 contiguous bytes. (Each lane writing its own
//   unit's 64 bytes, the first design, left every 32-byte sector written
//   in two halves at a 64-byte stride: 1.65x the device time.) Any other
//   weight (the stem's 147 columns, an offset view) takes one value at a
//   time in the same launch, kScalarUnroll loads in flight a thread.
#include <cuda_fp16.h>
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

// ---- the multi-weight launch ----------------------------------------------
constexpr int kCap = 512;      // weights a launch's table holds
constexpr int kChunk = 16384;  // values a block dequantizes
constexpr int kUnroll = kChunk / 16 / kThreads;  // 16-byte loads a thread
constexpr int kScalarUnroll = 8;

// The launch table; the host fills this layout as a numpy structured type
// (cuda_kernels.py _DEQUANT_TABLE): keep the two in step.
struct Table {
  const uint8_t* w[kCap];
  const float* s[kCap];
  float* out[kCap];
  long long n[kCap];      // values of weight a
  int cols[kCap];
  int chunk_end[kCap];    // chunks of weights 0..a together
  int vec[kCap];          // 1: the 16-byte route
  int count;              // weights in this launch
  int pad;
};

__device__ __forceinline__ int find_weight(const Table& t, int chunk) {
  int lo = 0, hi = t.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (t.chunk_end[mid] > chunk) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  return lo;
}

// 4 codes (one 32-bit word) -> 4 floats, each times `sc` rounded once
__device__ __forceinline__ float4 decode4(uint32_t w, float sc, I8) {
  return make_float4(__fmul_rn(decode(w, I8()), sc),
                     __fmul_rn(decode(w >> 8, I8()), sc),
                     __fmul_rn(decode(w >> 16, I8()), sc),
                     __fmul_rn(decode(w >> 24, I8()), sc));
}

__device__ __forceinline__ float4 decode4(uint32_t w, float sc, E4M3) {
  // pairs through half: exact
  const __half2_raw h0 = __nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(w & 0xffffu), __NV_E4M3);
  const __half2_raw h1 = __nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(w >> 16), __NV_E4M3);
  const float2 a = __half22float2(__half2(h0));
  const float2 b = __half22float2(__half2(h1));
  return make_float4(__fmul_rn(a.x, sc), __fmul_rn(a.y, sc),
                     __fmul_rn(b.x, sc), __fmul_rn(b.y, sc));
}

template <typename W>
__global__ void __launch_bounds__(kThreads)
    dequant_rows_multi(const __grid_constant__ Table t) {
  const int chunk = blockIdx.x;
  const int a = find_weight(t, chunk);
  const long long start =
      static_cast<long long>(chunk - (a ? t.chunk_end[a - 1] : 0)) * kChunk;
  const long long rest = t.n[a] - start;
  const int len = rest < kChunk ? static_cast<int>(rest) : kChunk;
  const uint8_t* w = t.w[a] + start;
  float* out = t.out[a] + start;
  const float* s = t.s[a];
  const long long cols = t.cols[a];
  if (t.vec[a]) {
    // len is a multiple of 16: so are cols, the weight's length and kChunk
    const int nu = len >> 4;
    const int lane = threadIdx.x & 31;
    uint4 r[kUnroll];
    float sc[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = u * kThreads + threadIdx.x;
      r[u] = i < nu ? __ldg(reinterpret_cast<const uint4*>(w) + i)
                    : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = u * kThreads + threadIdx.x;
      sc[u] = i < nu ? __ldg(s + (start + 16 * i) / cols) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i0 = u * kThreads + (threadIdx.x & ~31);  // the warp's first
      if (i0 >= nu) continue;                             // (warp-uniform)
      float4* o = reinterpret_cast<float4*>(out) + 4 * i0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int src = 8 * k + (lane >> 2), q = lane & 3;
        const uint32_t w0 = __shfl_sync(0xffffffffu, r[u].x, src);
        const uint32_t w1 = __shfl_sync(0xffffffffu, r[u].y, src);
        const uint32_t w2 = __shfl_sync(0xffffffffu, r[u].z, src);
        const uint32_t w3 = __shfl_sync(0xffffffffu, r[u].w, src);
        const float s_src = __shfl_sync(0xffffffffu, sc[u], src);
        const uint32_t word =
            q == 0 ? w0 : (q == 1 ? w1 : (q == 2 ? w2 : w3));
        if (i0 + src < nu) o[32 * k + lane] = decode4(word, s_src, W());
      }
    }
    return;
  }
  for (int base = 0; base < len; base += kThreads * kScalarUnroll) {
    uint32_t b[kScalarUnroll];
#pragma unroll
    for (int u = 0; u < kScalarUnroll; ++u) {
      const int i = base + u * kThreads + threadIdx.x;
      if (i < len) b[u] = __ldg(w + i);
    }
#pragma unroll
    for (int u = 0; u < kScalarUnroll; ++u) {
      const int i = base + u * kThreads + threadIdx.x;
      if (i < len)
        out[i] = __fmul_rn(decode(b[u], W()), __ldg(s + (start + i) / cols));
    }
  }
}

template <typename W>
int launch_multi(const void* table, long long bytes, int blocks,
                 void* stream) {
  if (bytes != static_cast<long long>(sizeof(Table)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (blocks > 0) {
    dequant_rows_multi<W>
        <<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            *static_cast<const Table*>(table));
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

// The multi-weight launch over the table at host address `table` (`bytes`
// long, checked against this build's layout) with `blocks` chunks; every
// weight of the entry point's storage type. Returns cudaGetLastError(),
// or cudaErrorInvalidValue for a table of another size.
extern "C" int mx_dequant_rows_multi_i8_f32(const void* table,
                                            long long bytes, int blocks,
                                            void* stream) {
  return launch_multi<I8>(table, bytes, blocks, stream);
}

extern "C" int mx_dequant_rows_multi_e4m3_f32(const void* table,
                                              long long bytes, int blocks,
                                              void* stream) {
  return launch_multi<E4M3>(table, bytes, blocks, stream);
}
