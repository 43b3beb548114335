// Row softmax, for Hopper (sm_90a): the SoftmaxOutput forward.
//
// Replaces: mxnet_tpu/ops/pallas_kernels.py _softmax_fwd_kernel, launched
// by _pl_softmax. Computes, per row of x (N, C), in float32:
//   m = max(x),  e = exp(x - m),  y = e / sum(e)
// and stores y in x's type. Three instances: float32, and bfloat16 or float16
// (the mixed-precision path), which reads its type, computes in float32 as the
// TPU kernel does (its .astype(jnp.float32)), and rounds y to nearest even.
//
// Bound: bytes. x is read and y written once (2 * N * C * sizeof(T)
// bytes); a few flops per element are far below the card's
// operations-per-byte line. At the LM head (8192, 32000) a float32 row is
// 128 KB: 132 SMs holding a few rows each are more than the 50 MB L2, so a
// design that walks a row twice reads it twice from device memory.
//
// Design: each row is read from device memory once and written once, as
// the TPU kernel keeps whole rows in VMEM. The row lives in registers as
// float32: a thread loads its share of it (units of W values, vec_io.cuh,
// all issued before the first is used), takes its max, turns each value
// into exp(x - m) in place (the exponential once per element), sums them,
// and writes e / s from the same registers. Four routes, chosen from C:
//   - C <= 1024 (the ResNet-50 head's 1000): one warp per row, up to 32
//     values a lane; warp shuffles reduce, and the warp waits on device
//     memory once. A block holds one warp below 1024 rows (a small batch
//     spreads over as many SMs as it has rows) and four above.
//   - C <= 32768 with 16-byte units (16384 with narrower ones): one block
//     of 1024 threads per row, up to 32 values a thread (the LM head's
//     32000: 31.25; 64 registers a thread, so one block an SM). The grid
//     is persistent, one block an SM walking rows row0, row0 + SMs, ...,
//     and with 16-byte units the next row streams into shared memory
//     (cp.async, each thread its own slots, 128 KB a block in float32) while
//     this row is reduced, exponentiated and written, so device memory is
//     read ahead of the arithmetic and the block never waits on a load.
//   - Rows up to 65536 (the JAX package's eligibility bound): a cluster of
//     R = ceil(C / 16384) blocks on neighbouring SMs holds the row (R = 4 at
//     65536), each block a contiguous slice at 16 values a thread; the
//     blocks exchange their partial max and sum through distributed shared
//     memory (cluster barriers, mapa). Two blocks holding half a row each
//     were measured slower at C = 32000 (each cluster barrier waited ~1 us
//     for the other SM), so a cluster is kept for rows one block cannot
//     hold.
//   - Longer rows, any C (the streaming route: an LM head over a vocabulary
//     past 64 K): a row no longer fits a cluster's registers, so one block
//     of 512 threads a row (persistent, four blocks an SM) reads it twice.
//     Pass one keeps a running max and sum a thread, unit by unit (a unit
//     whose max exceeds the running max rescales the sum by exp(m_old -
//     m_new) first), merged over the block in a fixed order (an xor
//     butterfly over each warp, the warps' partials in warp order through
//     the same butterfly); pass two writes exp(x - m) / s. Bytes: the row
//     read twice and written once, where the register routes read it
//     once; the second read is served from L2 where the rows in flight fit.
// A row takes 16-byte units where C is a multiple of the unit and the
// pointers are 16-byte aligned, 16-bit pairs where C is even and they are
// 4-byte aligned, else one value at a time. Reduction order (the CPU tests
// emulate it): a thread takes its values unit by unit, then an xor
// butterfly over the warp's 32 lanes; a block's 32 warp partials go through
// the same butterfly; a cluster adds its blocks' partials in rank order.
// The exponential is expf (not the approximate __expf) and the
// normalisation a true division, as in the TPU kernel.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <math.h>
#include <stdint.h>

#include "vec_io.cuh"

namespace cg = cooperative_groups;

namespace {

using mxio::Io;

constexpr int kWarpRowMax = 1024;    // longest row one warp holds
constexpr int kBlockThreads = 1024;  // a block (or a cluster's block)
constexpr int kValsMax = 32;         // float32 values a thread holds

// The values a thread of the block route holds at most: 32 with 16-byte
// units, 16 with narrower ones, whose addressing takes more registers (a
// block of 1024 threads has 64 a thread)
template <typename T, int W>
constexpr int block_vals() {
  return W * sizeof(T) == 16 ? kValsMax : 16;
}
// A cluster's blocks hold 16 values a thread (the cluster exchange takes
// registers too): a row of C values takes ceil(C / 16384) blocks
constexpr int kClusterRowMax = kBlockThreads * 16;

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// This thread's share of a row: units u = first + k * stride (k < K) below
// end, each W values, loaded into v (all loads issued first). Returns the
// share's max.
template <typename T, int W, int K>
__device__ __forceinline__ float load_max(const T* __restrict__ xr,
                                          int first, int stride, int end,
                                          float (&v)[K][W]) {
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (first + k * stride < end) Io<T, W>::load(xr, first + k * stride, v[k]);
  float m = -INFINITY;
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (first + k * stride < end) {
#pragma unroll
      for (int w = 0; w < W; ++w) m = fmaxf(m, v[k][w]);
    }
  return m;
}

// v = exp(v - m) in place; returns the share's sum, unit by unit
template <int W, int K>
__device__ __forceinline__ float exp_sum(int first, int stride, int end,
                                         float m, float (&v)[K][W]) {
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (first + k * stride < end) {
#pragma unroll
      for (int w = 0; w < W; ++w) {
        v[k][w] = expf(v[k][w] - m);
        s += v[k][w];
      }
    }
  return s;
}

// y = v / s for the share
template <typename T, int W, int K>
__device__ __forceinline__ void store_div(T* __restrict__ yr, int first,
                                          int stride, int end, float s,
                                          const float (&v)[K][W]) {
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (first + k * stride < end) {
      float f[W];
#pragma unroll
      for (int w = 0; w < W; ++w) f[w] = v[k][w] / s;
      Io<T, W>::store(yr, first + k * stride, f);
    }
}

// One warp per row (C <= 1024): K units of W values a lane
template <typename T, int W, int K>
__global__ void __launch_bounds__(128)
    softmax_warp(const T* __restrict__ x, T* __restrict__ y, int n, int c) {
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n) return;
  const int units = c / W;
  const T* xr = x + static_cast<int64_t>(row) * c;
  T* yr = y + static_cast<int64_t>(row) * c;
  float v[K][W];
  const float m = warp_max(load_max<T, W, K>(xr, lane, 32, units, v));
  const float s = warp_sum(exp_sum<W, K>(lane, 32, units, m, v));
  store_div<T, W, K>(yr, lane, 32, units, s, v);
}

// Reduce v over the block (max when is_max, else sum); every thread gets
// the result. `red` holds one slot per warp.
__device__ __forceinline__ float block_reduce(float v, bool is_max,
                                              float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = is_max ? warp_max(v) : warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[lane];  // 32 warps: one partial a lane
  r = is_max ? warp_max(r) : warp_sum(r);
  __syncthreads();  // red is reused by the next reduction
  return r;
}

// Combine the cluster's block partials (each block's `slot`) in rank
// order; every block gets the same value
__device__ __forceinline__ float cluster_reduce(float v, bool is_max,
                                                float* slot,
                                                const cg::cluster_group& cl) {
  if (threadIdx.x == 0) *slot = v;
  cl.sync();
  const int nb = static_cast<int>(cl.num_blocks());
  float r = *cl.map_shared_rank(slot, 0);
  for (int b = 1; b < nb; ++b) {
    const float p = *cl.map_shared_rank(slot, b);
    r = is_max ? fmaxf(r, p) : r + p;
  }
  return r;
}

// 16-byte copy into shared memory without registers (cp.async), and the
// wait for this thread's copies
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Start copying this thread's 16-byte units of a row (first + k * threads,
// k < K, below end) into its slots of `stage` ([K][kBlockThreads])
template <int K>
__device__ __forceinline__ void prefetch(const void* xr, int first, int end,
                                         uint4* stage) {
  const uint4* src = static_cast<const uint4*>(xr);
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (first + k * kBlockThreads < end)
      cp_async16(&stage[k * kBlockThreads + threadIdx.x],
                 src + first + k * kBlockThreads);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Rows longer than a warp's: one block of 1024 threads per row, K units of
// W values a thread; with kCluster a cluster of R blocks per row, block
// rank r holding units [r * per_block, (r + 1) * per_block). Persistent:
// one block an SM, each cluster (or block) walking rows row0, row0 +
// clusters, ... With 16-byte units the next row's units stream into shared
// memory (cp.async, each thread its own slots) while this row is reduced,
// exponentiated and written; narrower units are loaded when their row
// comes.
template <typename T, int W, int K, bool kCluster>
__global__ void __launch_bounds__(kBlockThreads, 1)
    softmax_block(const T* __restrict__ x, T* __restrict__ y, int n, int c,
                  int per_block) {
  constexpr bool kStage = W * sizeof(T) == 16;
  extern __shared__ uint4 stage[];  // [K][kBlockThreads], when kStage
  __shared__ float red[kBlockThreads / 32];
  __shared__ float part[2];  // this block's max and sum, for the cluster
  const cg::cluster_group cl = cg::this_cluster();
  const int nb = kCluster ? static_cast<int>(cl.num_blocks()) : 1;
  const int rank = kCluster ? static_cast<int>(cl.block_rank()) : 0;
  const int clusters = gridDim.x / nb;
  const int units = c / W;
  const int first = rank * per_block + threadIdx.x;
  const int end = min(units, (rank + 1) * per_block);
  int row = blockIdx.x / nb;
  if (kStage && row < n) prefetch<K>(x + static_cast<int64_t>(row) * c,
                                     first, end, stage);
  for (; row < n; row += clusters) {
    float v[K][W];
    float m;
    if (kStage) {
      cp_async_wait_all();
      m = load_max<T, W, K>(reinterpret_cast<const T*>(stage), threadIdx.x,
                            kBlockThreads, end - rank * per_block, v);
    } else {
      m = load_max<T, W, K>(x + static_cast<int64_t>(row) * c, first,
                            kBlockThreads, end, v);
    }
    m = block_reduce(m, true, red);
    // every thread's slots are read (the reduction needed their values):
    // refill them with the next row
    if (kStage && row + clusters < n)
      prefetch<K>(x + static_cast<int64_t>(row + clusters) * c, first, end,
                  stage);
    if (kCluster) m = cluster_reduce(m, true, &part[0], cl);
    float s = block_reduce(exp_sum<W, K>(first, kBlockThreads, end, m, v),
                           false, red);
    if (kCluster) s = cluster_reduce(s, false, &part[1], cl);
    store_div<T, W, K>(y + static_cast<int64_t>(row) * c, first,
                       kBlockThreads, end, s, v);
  }
  // the peers may still read part[1]: leave only after they all have
  if (kCluster) cl.sync();
}

constexpr int kStreamThreads = 512;               // the streaming route
constexpr int kStreamRowMin = 4 * kClusterRowMax;  // its rows: C > 65536

// Merge a running (max, sum) pair (mo, so) into (m, s): each side's sum
// scaled by exp(its max - the new max), a side whose max is -inf (no value
// yet, or only -inf) adding nothing
__device__ __forceinline__ void merge_ms(float& m, float& s, float mo,
                                         float so) {
  const float mn = fmaxf(m, mo);
  const float a = m == -INFINITY ? 0.0f : expf(m - mn);
  const float b = mo == -INFINITY ? 0.0f : expf(mo - mn);
  s = s * a + so * b;
  m = mn;
}

// (max, sum) over the block: the xor butterfly over a warp's lanes, then
// the warps' pairs in warp order through the same butterfly; every thread
// gets the result
__device__ __forceinline__ void block_merge_ms(float& m, float& s,
                                               float* red_m, float* red_s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1)
    merge_ms(m, s, __shfl_xor_sync(0xffffffffu, m, o),
             __shfl_xor_sync(0xffffffffu, s, o));
  if (lane == 0) red_m[warp] = m, red_s[warp] = s;
  __syncthreads();
  constexpr int kWarps = kStreamThreads / 32;
  m = lane < kWarps ? red_m[lane] : -INFINITY;
  s = lane < kWarps ? red_s[lane] : 0.0f;
  for (int o = 16; o > 0; o >>= 1)
    merge_ms(m, s, __shfl_xor_sync(0xffffffffu, m, o),
             __shfl_xor_sync(0xffffffffu, s, o));
  __syncthreads();  // red_* are reused by the next row
}

// The streaming route (C > 65536, no upper bound): one block a row,
// persistent over rows row0, row0 + gridDim.x, ...; a thread takes units
// u = t, t + 512, ... of W values. Pass one: the running max and sum; pass
// two: y = exp(x - m) / s. A NaN or +inf makes the row NaN and a row of
// -inf alone is NaN, as in the plain version (exp(-inf) is 0 otherwise).
template <typename T, int W>
__global__ void __launch_bounds__(kStreamThreads)
    softmax_stream(const T* __restrict__ x, T* __restrict__ y, int n, int c) {
  __shared__ float red_m[kStreamThreads / 32], red_s[kStreamThreads / 32];
  const int units = c / W;
  for (int row = blockIdx.x; row < n; row += gridDim.x) {
    const T* xr = x + static_cast<int64_t>(row) * c;
    float m = -INFINITY, s = 0.0f;
    for (int u = threadIdx.x; u < units; u += kStreamThreads) {
      float f[W];
      Io<T, W>::load(xr, u, f);
      float um = f[0];
#pragma unroll
      for (int w = 1; w < W; ++w) um = fmaxf(um, f[w]);
      if (um > m) {  // (a NaN sum stays NaN: 0 * NaN)
        s *= m == -INFINITY ? 0.0f : expf(m - um);
        m = um;
      }
#pragma unroll
      for (int w = 0; w < W; ++w)
        s += f[w] == -INFINITY ? 0.0f : expf(f[w] - m);
    }
    block_merge_ms(m, s, red_m, red_s);
    T* yr = y + static_cast<int64_t>(row) * c;
    for (int u = threadIdx.x; u < units; u += kStreamThreads) {
      float f[W];
      Io<T, W>::load(xr, u, f);
#pragma unroll
      for (int w = 0; w < W; ++w)
        f[w] = (f[w] == -INFINITY ? 0.0f : expf(f[w] - m)) / s;
      Io<T, W>::store(yr, u, f);
    }
  }
}

template <typename T, int W>
cudaError_t launch_stream(const T* x, T* y, int n, int c, cudaStream_t st) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int blocks = std::min(n, 4 * std::max(1, sms));
  softmax_stream<T, W><<<blocks, kStreamThreads, 0, st>>>(x, y, n, c);
  return cudaSuccess;
}

// The values a thread holds, 8, 16 or 32, the fewest that cover `units`
// units of W values over `threads`
template <int W>
int vals_for(int units, int threads) {
  const int per = (units + threads - 1) / threads;
  return per * W <= 8 ? 8 : (per * W <= 16 ? 16 : kValsMax);
}

template <typename T, int W, int K, bool kCluster>
cudaError_t launch_block(const T* x, T* y, int n, int c, int r,
                         int per_block, cudaStream_t st) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int clusters = std::min(n, std::max(1, sms / r));
  const int smem = W * sizeof(T) == 16 ? K * kBlockThreads * 16 : 0;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        softmax_block<T, W, K, kCluster>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(clusters) * r);
  cfg.blockDim = dim3(kBlockThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = r;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, softmax_block<T, W, K, kCluster>, x, y, n, c,
                            per_block);
}

template <typename T, int W>
cudaError_t launch(const void* xv, void* yv, int n, int c,
                   cudaStream_t st) {
  const T* x = static_cast<const T*>(xv);
  T* y = static_cast<T*>(yv);
  const int units = c / W;
  if (c <= kWarpRowMax) {
    const int warps = n >= 1024 ? 4 : 1;
    const dim3 grid((n + warps - 1) / warps), block(32 * warps);
    switch (vals_for<W>(units, 32)) {
      case 8: softmax_warp<T, W, (8 + W - 1) / W><<<grid, block, 0, st>>>(
          x, y, n, c); break;
      case 16: softmax_warp<T, W, 16 / W><<<grid, block, 0, st>>>(
          x, y, n, c); break;
      default: softmax_warp<T, W, kValsMax / W><<<grid, block, 0, st>>>(
          x, y, n, c);
    }
    return cudaSuccess;
  }
  if (c > kStreamRowMin) return launch_stream<T, W>(x, y, n, c, st);
  if (c > kBlockThreads * block_vals<T, W>()) {
    const int r = (c + kClusterRowMax - 1) / kClusterRowMax;
    return launch_block<T, W, 16 / W, true>(x, y, n, c, r,
                                            (units + r - 1) / r, st);
  }
  switch (vals_for<W>(units, kBlockThreads)) {
    case 8: return launch_block<T, W, (8 + W - 1) / W, false>(
        x, y, n, c, 1, units, st);
    case 16: return launch_block<T, W, 16 / W, false>(x, y, n, c, 1, units,
                                                      st);
    default: return launch_block<T, W, block_vals<T, W>() / W, false>(
        x, y, n, c, 1, units, st);
  }
}

int finish(cudaError_t launched) {
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(launched != cudaSuccess ? launched : last);
}

}  // namespace

// x (n, c) -> y (n, c), float32, contiguous, on one device; any c.
// Returns the launch's error, else cudaGetLastError().
extern "C" int mx_softmax_f32(const void* x, void* y, int n, int c,
                              void* stream) {
  cudaError_t e = cudaSuccess;
  if (n > 0 && c > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    e = (c % 4 == 0 && mxio::aligned(x, 16) && mxio::aligned(y, 16))
            ? launch<float, 4>(x, y, n, c, st)
            : launch<float, 1>(x, y, n, c, st);
  }
  return finish(e);
}

// The same over 16-bit x and y (H = __nv_bfloat16 or __half): 16-byte units
// of 8, pairs in one 4-byte access, or one value at a time, as C and the
// pointers' alignment allow
template <typename H>
int half_rows(const void* x, void* y, int n, int c, void* stream) {
  cudaError_t e = cudaSuccess;
  if (n > 0 && c > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (c % 8 == 0 && mxio::aligned(x, 16) && mxio::aligned(y, 16))
      e = launch<H, 8>(x, y, n, c, st);
    else if (c % 2 == 0 && mxio::aligned(x, 4) && mxio::aligned(y, 4))
      e = launch<H, 2>(x, y, n, c, st);
    else
      e = launch<H, 1>(x, y, n, c, st);
  }
  return finish(e);
}

extern "C" int mx_softmax_bf16(const void* x, void* y, int n, int c,
                               void* stream) {
  return half_rows<__nv_bfloat16>(x, y, n, c, stream);
}

extern "C" int mx_softmax_f16(const void* x, void* y, int n, int c,
                              void* stream) {
  return half_rows<__half>(x, y, n, c, stream);
}
