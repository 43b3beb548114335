// The multi-tensor optimizer update: one launch updates every parameter
// array of a step in place (sgd_mom.cu and adam.cu, rows 9 and 10).
//
// Replaces, with the per-array kernels' arithmetic: the JAX package's
// fused step, whose one program applies SGD.fused_plan / Adam.fused_plan
// (mxnet_tpu/optimizer.py) to every array with per-array lr and wd
// (mxnet_tpu/module/executor_group.py setup_fused_step), and the per-array
// Pallas kernels _sgd_mom_kernel / _adam_kernel
// (mxnet_tpu/ops/pallas_kernels.py, launched by _tiled_elementwise).
//
// Bound: bytes, 20 (SGD-momentum) or 28 (Adam) bytes an element: 0.153 /
// 0.214 ms for ResNet-50's 25.5 M parameters at 3.35 TB/s. What held the
// per-array kernels back was the launch count (157 a ResNet-50 step, 104
// of them 4096 elements or fewer, each leaving most SMs idle) and few
// bytes in flight (one 4-byte access a thread a pass). Design:
// - The table. The host (ops/cuda_kernels.py, _multi_plan and
//   _multi_tables) cuts every array into chunks of kChunk elements, a
//   chunk never crossing two arrays, and passes, per array, the operands'
//   pointers, the length, lr, wd, the cumulative chunk count and whether
//   every operand is 16-byte aligned. The table travels by value as the
//   kernel's parameter (CUDA 12.1 and later take up to 32,764 bytes of
//   parameters on sm_70 and later), so nothing is staged in device memory
//   that a later step could overwrite before the copy has run. A list
//   longer than kCap arrays takes several launches, in index order.
// - One block a chunk. A block finds its array by binary search over the
//   cumulative chunk counts (uniform across the block: constant-cache
//   broadcasts). The small arrays (BatchNorm gamma / beta, biases) are
//   one short chunk each in the same grid: no launch of their own.
// - Loads. An aligned array moves in 16-byte float4 accesses; each thread
//   issues the loads of every operand for kUnroll vectors before any
//   arithmetic (192 / 256 bytes a thread in flight), then computes and
//   stores them. The last chunk's tail (under 4 elements) and every chunk
//   of a misaligned array take 4-byte accesses in the same kernel, loads
//   again issued kUnroll at a time.
// - Rounding. Op applies the per-array kernel's own element function, so
//   each element comes out bit for bit as the per-array kernel writes it.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace mxmulti {

constexpr int kCap = 512;       // arrays a launch's table holds
constexpr int kChunk = 8192;    // elements a block updates
constexpr int kThreads = 256;
constexpr int kUnroll = 4;      // vectors (or scalars) loaded before use

// P operands an array: 0 the weight, 1 the gradient (read only), 2.. the
// states. The host fills this layout as a numpy structured type
// (cuda_kernels.py _MULTI_TABLE): keep the two in step.
template <int P>
struct Table {
  float* ptr[P][kCap];
  long long n[kCap];
  float lr[kCap];
  float wd[kCap];
  int chunk_end[kCap];    // chunks of arrays 0..a together
  int vec[kCap];          // 1: every operand of array a 16-byte aligned
  int count;              // arrays in this launch
  int pad;
};

template <int P>
__device__ __forceinline__ int find_array(const Table<P>& t, int chunk) {
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

__device__ __forceinline__ float& lane(float4& v, int k) {
  return k == 0 ? v.x : (k == 1 ? v.y : (k == 2 ? v.z : v.w));
}

// Op: __device__ void operator()(float* v, float lr, float wd) const,
// which updates v[0] and v[2..P-1] from v[0..P-1] as the per-array kernel
// updates one element.
template <int P, class Op>
__global__ void __launch_bounds__(kThreads)
    multi_update(const __grid_constant__ Table<P> t, const Op op) {
  const int chunk = blockIdx.x;
  const int a = find_array(t, chunk);
  const long long start =
      static_cast<long long>(chunk - (a ? t.chunk_end[a - 1] : 0)) * kChunk;
  const long long rest = t.n[a] - start;
  const int len = rest < kChunk ? static_cast<int>(rest) : kChunk;
  float* p[P];
#pragma unroll
  for (int j = 0; j < P; ++j) p[j] = t.ptr[j][a] + start;
  const float lr = t.lr[a];
  const float wd = t.wd[a];
  int done = 0;
  if (t.vec[a]) {
    const int nv = len >> 2;
    for (int base = 0; base < nv; base += kThreads * kUnroll) {
      float4 r[kUnroll][P];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = base + u * kThreads + threadIdx.x;
        if (i < nv) {
#pragma unroll
          for (int j = 0; j < P; ++j) {
            r[u][j] = reinterpret_cast<const float4*>(p[j])[i];
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = base + u * kThreads + threadIdx.x;
        if (i < nv) {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            float v[P];
#pragma unroll
            for (int j = 0; j < P; ++j) v[j] = lane(r[u][j], k);
            op(v, lr, wd);
#pragma unroll
            for (int j = 0; j < P; ++j) lane(r[u][j], k) = v[j];
          }
#pragma unroll
          for (int j = 0; j < P; ++j) {
            if (j != 1) reinterpret_cast<float4*>(p[j])[i] = r[u][j];
          }
        }
      }
    }
    done = nv << 2;
  }
  for (int base = done; base < len; base += kThreads * kUnroll) {
    float r[kUnroll][P];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = base + u * kThreads + threadIdx.x;
      if (i < len) {
#pragma unroll
        for (int j = 0; j < P; ++j) r[u][j] = p[j][i];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = base + u * kThreads + threadIdx.x;
      if (i < len) {
        op(r[u], lr, wd);
#pragma unroll
        for (int j = 0; j < P; ++j) {
          if (j != 1) p[j][i] = r[u][j];
        }
      }
    }
  }
}

// Launch over the table at host address `table` (`bytes` long, checked
// against this build's layout) with `blocks` chunks. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a table of another
// size.
template <int P, class Op>
int launch(const void* table, long long bytes, int blocks, const Op& op,
           void* stream) {
  if (bytes != static_cast<long long>(sizeof(Table<P>))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (blocks > 0) {
    multi_update<P, Op>
        <<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            *static_cast<const Table<P>*>(table), op);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mxmulti
