// BatchNorm channel statistics, for Hopper (sm_90a): the first half of
// FusedConvBNReLU's epilogue in training.
//
// Replaces: mxnet_tpu/ops/pallas_kernels.py _bn_stats_kernel, launched by
// _pl_channel_stats. Computes, for x (N, C, H, W), contiguous, in float32:
//   sum[c] = sum_{n, hw} x[n, c, hw]      sq[c] = sum_{n, hw} x[n, c, hw]^2
// Three instances: float32 x, and bfloat16 or float16 x (the mixed-precision
// path: each value widened exactly, as the TPU kernel's .astype(jnp.float32));
// x * x is a float32 product rounded before it is added (never an FMA), as
// the TPU kernel's sum(x * x). The statistics are float32, written to one
// (2, C) buffer: sums, then sums of squares.
//
// Bound: bytes. x is read once (N * C * HW * sizeof(T) bytes); the outputs
// are 2C floats. The TPU kernel walks batch and spatial blocks as a
// sequential grid axis and accumulates into its resident (1, C) output
// tile. Here blocks run in parallel and in no order, so the sum over N * HW
// is a deterministic reduction in one launch, with no float atomics (whose
// order, and so whose rounding, would change from run to run):
//
// * The grid is (channel groups, splits of N), sized on the host from the
//   shape and the SM count (cuda_kernels._bn_stats_plan): about four
//   blocks of 256 threads an SM, each thread keeping up to four 16-byte
//   loads in flight. Block (group, split) sums its channels over the rows
//   n of its split.
// * Planes (HW a multiple of the 16-byte unit, x aligned: every shape of
//   ResNet-50 but HW 49, and HW 196 in 16 bits): a group is one channel c,
//   whose (n, c) planes are contiguous runs of HW values. The block walks
//   its planes' units as one flat range, thread t taking units t, t + 256,
//   ..., four of them loaded before any is added; the (row, unit) of a
//   thread's next unit is an incremented pair, with no division a unit. A
//   unit's values are summed as a balanced tree, then added to the
//   thread's running sums. (Unaligned x, or a shape where no slab fits:
//   the same walk one value a unit.)
// * Slabs (small HW that is no multiple of the unit: 49 in every type, 196
//   in 16 bits): a group is G channels, so that for each n the slab x[n,
//   c0 : c0 + G, :] is one contiguous, 16-byte aligned run (G HW a multiple
//   of the unit; the host picks G). The block copies a stage of up to four
//   units a thread (whole slabs of a few rows) into shared memory with
//   16-byte loads, all in flight together, and then thread g P + j (P = 256
//   / G lanes a channel) sums channel g's values j, j + P, ... of each
//   staged row: each value is attributed to its channel by where it lies in
//   the slab, not by a division a unit.
// * A channel's lanes are combined in a fixed tree: a butterfly of warp
//   shuffles over min(P, 32) lanes, then the channel's warps in order.
// * The splits of a group (at most eight) are one thread-block cluster:
//   each block leaves its channels' (sum, sq) in its shared memory, and
//   after the cluster's barrier the cluster's first block reads them
//   through distributed shared memory and adds them in split order, then
//   writes the output. No workspace, no counter, no atomics and no
//   __threadfence on the call's critical path: one launch, the same bits
//   on every call for a shape and an alignment of x.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "vec_io.cuh"

namespace {

namespace cg = cooperative_groups;
using mxio::Io;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLoads = 4;  // units a thread keeps in flight; a stage's units
constexpr int kMaxSplits = 8;  // a cluster's blocks (the portable most)
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ float widen1(float v) { return v; }
__device__ __forceinline__ float widen1(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float widen1(__half v) { return __half2float(v); }

// x * x rounded to float32 (__fmul_rn is never contracted into an FMA)
__device__ __forceinline__ float square(float v) { return __fmul_rn(v, v); }

// The sum and the sum of squares of f[0..V-1], as a balanced tree
template <int V>
struct Tree {
  static __device__ __forceinline__ float sum(const float* f) {
    return Tree<V / 2>::sum(f) + Tree<V / 2>::sum(f + V / 2);
  }
  static __device__ __forceinline__ float sq(const float* f) {
    return Tree<V / 2>::sq(f) + Tree<V / 2>::sq(f + V / 2);
  }
};

template <>
struct Tree<1> {
  static __device__ __forceinline__ float sum(const float* f) { return f[0]; }
  static __device__ __forceinline__ float sq(const float* f) {
    return square(f[0]);
  }
};

// Combine (s, q) over the P lanes of each channel (threads g P + j, P a
// power of two): a butterfly over min(P, 32) lanes, then, for P > 32, the
// channel's warps in order. Lane j = 0 holds the result. Every thread of
// the block calls it (P > 32 takes block barriers).
__device__ __forceinline__ void lanes_reduce(float& s, float& q, int P,
                                             float2* red) {
  const int w = P < 32 ? P : 32;
  for (int o = w >> 1; o > 0; o >>= 1) {
    s += __shfl_xor_sync(kAll, s, o);
    q += __shfl_xor_sync(kAll, q, o);
  }
  if (P > 32) {
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) red[warp] = make_float2(s, q);
    __syncthreads();
    if ((threadIdx.x & (P - 1)) == 0) {
      for (int k = 1; k < P / 32; ++k) {
        s += red[warp + k].x;
        q += red[warp + k].y;
      }
    }
    __syncthreads();
  }
}

// Lane j = 0 of channel g (g < gc) holds the block's (s, q) of channel
// c0 + g. The group's splits are one cluster, split = rank: each block
// leaves its (s, q) in `part`, and rank 0 adds the ranks' in rank order and
// writes the output. The second barrier keeps every rank's shared memory
// alive until rank 0 has read it.
__device__ __forceinline__ void finish(float s, float q, int c0, int gc,
                                       int g, int j, int c,
                                       float* __restrict__ out,
                                       float2* part) {
  cg::cluster_group cluster = cg::this_cluster();
  const bool head = j == 0 && g < gc;
  if (head) part[g] = make_float2(s, q);
  cluster.sync();
  if (head && cluster.block_rank() == 0) {
    const int splits = static_cast<int>(cluster.num_blocks());
    float2 v[kMaxSplits];
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r)
      if (r < splits) v[r] = *cluster.map_shared_rank(part + g, r);
    float a = v[0].x, b = v[0].y;
#pragma unroll
    for (int r = 1; r < kMaxSplits; ++r) {
      if (r < splits) {
        a += v[r].x;
        b += v[r].y;
      }
    }
    out[c0 + g] = a;
    out[c + c0 + g] = b;
  }
  cluster.sync();
}

// Planes: block (c, split) sums channel c over rows [split * rows, + rows)
// of HW = units * V values each, V values a unit (HW % V == 0, x aligned
// to a unit). Offsets and the walk over a split's units are 64-bit: a
// split may hold more than 2^31 values of its channel.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    bn_stats_planes(const T* __restrict__ x, float* __restrict__ out,
                    int n, int c, int64_t hw, int rows) {
  __shared__ float2 red[kWarps], part[1];
  using Raw = typename Io<T, V>::Raw;
  const int ch = blockIdx.x, t = threadIdx.x;
  const int n0 = blockIdx.y * rows;
  const int nr = min(rows, n - n0);
  const int64_t units = hw / V;  // units a plane
  float s = 0.0f, q = 0.0f;
  if (nr > 0 && units > 0) {
    const T* base = x + (static_cast<int64_t>(n0) * c + ch) * hw;
    const int64_t pitch = static_cast<int64_t>(c) * units;  // units a row
    const int64_t total = nr * units;
    // unit f = r * units + u: (r, u) of this thread's next unit, moved
    // kThreads units on by (dr, du) with a carry
    const int64_t dr = kThreads / units, du = kThreads % units;
    int64_t r = t / units, u = t % units;
    for (int64_t f0 = t; f0 < total; f0 += kLoads * kThreads) {
      Raw raw[kLoads];
#pragma unroll
      for (int k = 0; k < kLoads; ++k) {
        if (f0 + k * kThreads < total)
          raw[k] = Io<T, V>::raw(base, r * pitch + u);
        u += du;
        r += dr;
        if (u >= units) {
          u -= units;
          ++r;
        }
      }
#pragma unroll
      for (int k = 0; k < kLoads; ++k) {
        if (f0 + k * kThreads < total) {
          float f[V];
          Io<T, V>::widen(raw[k], f);
          s += Tree<V>::sum(f);
          q += Tree<V>::sq(f);
        }
      }
    }
  }
  lanes_reduce(s, q, kThreads, red);
  finish(s, q, ch, 1, 0, t, c, out, part);
}

// Slabs: block (group, split) sums channels [group * G, + G) over rows
// [split * rows, + rows); a row's slab x[n, c0 : c0 + G, :] is one run of
// G HW values, V values a unit (G HW % V == 0 and C HW % V == 0, x aligned
// to a unit), staged stage_rows rows at a time (stage_rows G HW / V <=
// kLoads * kThreads units)
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    bn_stats_slabs(const T* __restrict__ x, float* __restrict__ out,
                   int n, int c, int hw, int G, int stage_rows, int rows) {
  // the host takes this route only where G HW fits a stage (< 2^14)
  extern __shared__ __align__(16) uint8_t stage_raw[];
  __shared__ float2 red[kWarps], part[kThreads];
  using Raw = typename Io<T, V>::Raw;
  T* st = reinterpret_cast<T*>(stage_raw);
  const int t = threadIdx.x;
  const int P = kThreads / G;         // lanes a channel
  const int g = t / P, j = t % P;
  const int c0 = blockIdx.x * G;
  const int gc = min(G, c - c0);      // channels of this group
  const int len = gc * hw;            // values of a slab
  const int units = len / V;
  const int n0 = blockIdx.y * rows;
  const int nr = min(rows, n - n0);
  const int64_t pitch = static_cast<int64_t>(c) * hw / V;  // units a row
  const T* base = x + (static_cast<int64_t>(n0) * c + c0) * hw;
  // the (row, unit) of this thread's units of a stage: the same in every
  // stage, worked out once
  int ur[kLoads], uu[kLoads];
#pragma unroll
  for (int k = 0; k < kLoads; ++k) {
    const int f = t + k * kThreads;
    ur[k] = f / units;
    uu[k] = f % units;
  }
  float s = 0.0f, q = 0.0f;
  for (int r0 = 0; r0 < nr; r0 += stage_rows) {
    const int sr = min(stage_rows, nr - r0);
    Raw raw[kLoads];
#pragma unroll
    for (int k = 0; k < kLoads; ++k)
      if (ur[k] < sr)
        raw[k] = Io<T, V>::raw(base, (r0 + ur[k]) * pitch + uu[k]);
#pragma unroll
    for (int k = 0; k < kLoads; ++k)
      if (ur[k] < sr)
        reinterpret_cast<Raw*>(st)[ur[k] * units + uu[k]] = raw[k];
    __syncthreads();
    if (g < gc) {
      for (int r = 0; r < sr; ++r) {
        const T* row = st + r * len + g * hw;
        for (int h = j; h < hw; h += P) {
          const float v = widen1(row[h]);
          s += v;
          q += square(v);
        }
      }
    }
    __syncthreads();  // the stage is free for the next rows
  }
  lanes_reduce(s, q, P, red);
  finish(s, q, c0, gc, g, j, c, out, part);
}

// one launch's arguments, as the entry points take them
struct Args {
  const void* x;
  void* out;
  int n, c;
  int64_t hw;
  int route, vec, group, stage_rows, rows, splits;
  cudaStream_t st;
};

// kern over a grid of (channel groups, splits), the splits of a group one
// cluster; one split takes a plain launch (each block its own cluster of
// one), which the card starts ~1.4 us sooner than a cluster launch
// (tools/bn_stats_probe.py)
template <typename Kernel, typename... Rest>
int launch(const Args& a, Kernel kern, int bytes, Rest... rest) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.c + a.group - 1) / a.group, a.splits, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = a.st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = a.splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = a.splits > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kern, rest...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int V>
int planes(const Args& a) {
  return launch(a, bn_stats_planes<T, V>, 0, static_cast<const T*>(a.x),
                static_cast<float*>(a.out), a.n, a.c, a.hw, a.rows);
}

template <typename T, int V>
int slabs(const Args& a) {
  const int hw = static_cast<int>(a.hw);   // G HW fits a stage
  const int bytes = a.stage_rows * a.group * hw * static_cast<int>(sizeof(T));
  return launch(a, bn_stats_slabs<T, V>, bytes, static_cast<const T*>(a.x),
                static_cast<float*>(a.out), a.n, a.c, hw, a.group,
                a.stage_rows, a.rows);
}

template <typename T>
int run(const Args& a) {
  constexpr int kV = 16 / static_cast<int>(sizeof(T));
  if (a.c <= 0) return 0;
  const int64_t covered = static_cast<int64_t>(a.rows) * a.splits;
  const bool bad_plan =
      a.n < 0 || a.hw < 0 || a.splits < 1 || a.splits > kMaxSplits ||
      a.rows < 0 || covered < a.n ||
      (a.vec != 1 && a.vec != kV) ||
      (a.vec > 1 && !mxio::aligned(a.x, 16));
  if (bad_plan) return static_cast<int>(cudaErrorInvalidValue);
  if (a.route == 0) {
    if (a.group != 1 || a.hw % a.vec != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    return a.vec == 1 ? planes<T, 1>(a) : planes<T, kV>(a);
  }
  const int64_t slab = static_cast<int64_t>(a.group) * a.hw;
  if (a.route != 1 || a.vec != kV || a.hw < 1 || a.group < 1 ||
      a.group > kThreads || (a.group & (a.group - 1)) != 0 ||
      slab % kV != 0 || (static_cast<int64_t>(a.c) * a.hw) % kV != 0 ||
      a.stage_rows < 1 || a.stage_rows * slab > kLoads * kThreads * kV)
    return static_cast<int>(cudaErrorInvalidValue);
  return slabs<T, kV>(a);
}

}  // namespace

// x (n, c, hw) contiguous, of the entry point's type -> out (2, c) float32:
// the sums, then the sums of squares. The plan is the host's
// (cuda_kernels._bn_stats_plan): route 0 (planes) or 1 (slabs), vec values
// a load (1, or 16 bytes' worth: x then 16-byte aligned), group channels a
// block (1 for planes; a power of two <= 256 for slabs), stage_rows rows a
// stage (slabs), rows of n a split, splits (<= 8, a cluster; rows * splits
// >= n). Both on one device. Returns cudaGetLastError()
// (cudaErrorInvalidValue for a plan the kernel does not take).
#define MX_BN_STATS_ENTRY(NAME, T)                                           \
  extern "C" int NAME(const void* x, void* out, int n, int c, long long hw, \
                      int route, int vec, int group, int stage_rows,        \
                      int rows, int splits, void* stream) {                 \
    return run<T>(Args{x, out, n, c, hw, route, vec, group, stage_rows,     \
                       rows, splits, static_cast<cudaStream_t>(stream)});   \
  }

MX_BN_STATS_ENTRY(mx_bn_stats_f32, float)
MX_BN_STATS_ENTRY(mx_bn_stats_bf16, __nv_bfloat16)
MX_BN_STATS_ENTRY(mx_bn_stats_f16, __half)
