// Row softmax, for Hopper (sm_90a): the SoftmaxOutput forward.
//
// Replaces: mxnet_tpu/ops/pallas_kernels.py _softmax_fwd_kernel, launched
// by _pl_softmax. Computes, per row of x (N, C), in float32:
//   m = max(x),  e = exp(x - m),  y = e / sum(e)
// and stores y in x's type. Three instances: float32, and bfloat16 or float16
// (the mixed-precision path), which reads bfloat16, computes in float32 as the
// TPU kernel does (its .astype(jnp.float32)), and rounds y to nearest even.
//
// Bound: bytes. x is read and y written once (2 * N * C * sizeof(T)
// bytes); a few flops per element are far below the card's
// operations-per-byte line. Design: a row is walked three times (max,
// exp-sum, write) straight from global memory; after the first walk it
// sits in L1/L2 (4 KB at C = 1000 in float32, 256 KB at the C = 65536
// bound), so only the first walk and the write touch device memory. Rows
// of C <= 1024 take one warp each (8 rows per block, no shared memory);
// longer rows take a block of 512 threads and reduce through shared
// memory. A 16-bit row of even C on 4-byte aligned pointers is walked in
// __nv_bfloat162 or __half2 pairs (one 4-byte access per lane), else one value
// at a time. The exponential is expf (not the approximate __expf) and the
// normalisation a true division, as in the TPU kernel.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "vec_io.cuh"

namespace {

using mxio::Io;

constexpr int kWarpThreads = 256;   // warp-per-row: 8 rows per block
constexpr int kBlockThreads = 512;  // block-per-row
constexpr int kWarpRowMax = 1024;   // longest row a single warp takes

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One warp per row; each lane walks units of W values (W divides C).
template <typename T, int W>
__global__ void softmax_rows_warp(const T* __restrict__ x,
                                  T* __restrict__ y, int n, int c) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= n) return;
  const int units = c / W;
  const T* xr = x + static_cast<int64_t>(row) * c;
  T* yr = y + static_cast<int64_t>(row) * c;
  float f[W];
  float m = -INFINITY;
  for (int i = lane; i < units; i += 32) {
    Io<T, W>::load(xr, i, f);
#pragma unroll
    for (int k = 0; k < W; ++k) m = fmaxf(m, f[k]);
  }
  m = warp_max(m);
  float s = 0.0f;
  for (int i = lane; i < units; i += 32) {
    Io<T, W>::load(xr, i, f);
#pragma unroll
    for (int k = 0; k < W; ++k) s += expf(f[k] - m);
  }
  s = warp_sum(s);
  for (int i = lane; i < units; i += 32) {
    Io<T, W>::load(xr, i, f);
#pragma unroll
    for (int k = 0; k < W; ++k) f[k] = expf(f[k] - m) / s;
    Io<T, W>::store(yr, i, f);
  }
}

// Reduce v over the block (max when is_max, else sum); every thread
// gets the result. `red` holds one slot per warp.
__device__ __forceinline__ float block_reduce(float v, bool is_max,
                                              float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarp = blockDim.x >> 5;
  v = is_max ? warp_max(v) : warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = lane < nwarp ? red[lane] : (is_max ? -INFINITY : 0.0f);
  r = is_max ? warp_max(r) : warp_sum(r);
  __syncthreads();  // red is reused by the next reduction
  return r;
}

template <typename T>
__global__ void softmax_rows_block(const T* __restrict__ x,
                                   T* __restrict__ y, int c) {
  __shared__ float red[32];
  const T* xr = x + static_cast<int64_t>(blockIdx.x) * c;
  T* yr = y + static_cast<int64_t>(blockIdx.x) * c;
  float f;
  float m = -INFINITY;
  for (int i = threadIdx.x; i < c; i += blockDim.x) {
    Io<T, 1>::load(xr, i, &f);
    m = fmaxf(m, f);
  }
  m = block_reduce(m, true, red);
  float s = 0.0f;
  for (int i = threadIdx.x; i < c; i += blockDim.x) {
    Io<T, 1>::load(xr, i, &f);
    s += expf(f - m);
  }
  s = block_reduce(s, false, red);
  for (int i = threadIdx.x; i < c; i += blockDim.x) {
    Io<T, 1>::load(xr, i, &f);
    f = expf(f - m) / s;
    Io<T, 1>::store(yr, i, &f);
  }
}

template <typename T, int W>
void launch(const void* x, void* y, int n, int c, cudaStream_t st) {
  if (c <= kWarpRowMax) {
    const int blocks = (n * 32 + kWarpThreads - 1) / kWarpThreads;
    softmax_rows_warp<T, W><<<blocks, kWarpThreads, 0, st>>>(
        static_cast<const T*>(x), static_cast<T*>(y), n, c);
  } else {
    softmax_rows_block<T><<<n, kBlockThreads, 0, st>>>(
        static_cast<const T*>(x), static_cast<T*>(y), c);
  }
}

}  // namespace

// x (n, c) -> y (n, c), float32, contiguous, on one device.
// Returns cudaGetLastError().
extern "C" int mx_softmax_f32(const void* x, void* y, int n, int c,
                              void* stream) {
  if (n > 0 && c > 0)
    launch<float, 1>(x, y, n, c, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// The same over 16-bit x and y (H = __nv_bfloat16 or __half): pairs in one
// 4-byte access a lane for even C and 4-byte aligned rows, else one value
template <typename H>
int half_rows(const void* x, void* y, int n, int c, void* stream) {
  if (n > 0 && c > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if ((c & 1) == 0 && mxio::aligned(x, 4) && mxio::aligned(y, 4))
      launch<H, 2>(x, y, n, c, st);
    else
      launch<H, 1>(x, y, n, c, st);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mx_softmax_bf16(const void* x, void* y, int n, int c,
                               void* stream) {
  return half_rows<__nv_bfloat16>(x, y, n, c, stream);
}

extern "C" int mx_softmax_f16(const void* x, void* y, int n, int c,
                              void* stream) {
  return half_rows<__half>(x, y, n, c, stream);
}
