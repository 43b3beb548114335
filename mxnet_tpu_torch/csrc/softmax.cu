// Row softmax, for Hopper (sm_90a): the SoftmaxOutput forward.
//
// Replaces: mxnet_tpu/ops/pallas_kernels.py _softmax_fwd_kernel, launched
// by _pl_softmax. Computes, per row of x (N, C), in float32:
//   m = max(x),  e = exp(x - m),  y = e / sum(e)
//
// Bound: bytes. x is read and y written once (2 * N * C * 4 bytes); a few
// flops per element are far below the card's operations-per-byte line.
// Design: a row is walked three times (max, exp-sum, write) straight from
// global memory; after the first walk it sits in L1/L2 (4 KB at C = 1000,
// 256 KB at the C = 65536 bound), so only the first walk and the write
// touch device memory. Rows of C <= 1024 take one warp each (8 rows per
// block, no shared memory); longer rows take a block of 512 threads and
// reduce through shared memory. The exponential is expf (not the
// approximate __expf) and the normalisation a true division, as in the
// TPU kernel.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

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

__global__ void softmax_warp_f32(const float* __restrict__ x,
                                 float* __restrict__ y, int n, int c) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= n) return;
  const float* xr = x + static_cast<int64_t>(row) * c;
  float* yr = y + static_cast<int64_t>(row) * c;
  float m = -INFINITY;
  for (int i = lane; i < c; i += 32) m = fmaxf(m, xr[i]);
  m = warp_max(m);
  float s = 0.0f;
  for (int i = lane; i < c; i += 32) s += expf(xr[i] - m);
  s = warp_sum(s);
  for (int i = lane; i < c; i += 32) yr[i] = expf(xr[i] - m) / s;
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

__global__ void softmax_block_f32(const float* __restrict__ x,
                                  float* __restrict__ y, int c) {
  __shared__ float red[32];
  const float* xr = x + static_cast<int64_t>(blockIdx.x) * c;
  float* yr = y + static_cast<int64_t>(blockIdx.x) * c;
  float m = -INFINITY;
  for (int i = threadIdx.x; i < c; i += blockDim.x) m = fmaxf(m, xr[i]);
  m = block_reduce(m, true, red);
  float s = 0.0f;
  for (int i = threadIdx.x; i < c; i += blockDim.x) s += expf(xr[i] - m);
  s = block_reduce(s, false, red);
  for (int i = threadIdx.x; i < c; i += blockDim.x)
    yr[i] = expf(xr[i] - m) / s;
}

}  // namespace

// x (n, c) -> y (n, c), float32, contiguous, on one device.
// Returns cudaGetLastError().
extern "C" int mx_softmax_f32(const void* x, void* y, int n, int c,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n > 0 && c > 0) {
    if (c <= kWarpRowMax) {
      const int blocks = (n * 32 + kWarpThreads - 1) / kWarpThreads;
      softmax_warp_f32<<<blocks, kWarpThreads, 0, st>>>(
          static_cast<const float*>(x), static_cast<float*>(y), n, c);
    } else {
      softmax_block_f32<<<n, kBlockThreads, 0, st>>>(
          static_cast<const float*>(x), static_cast<float*>(y), c);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
