// BatchNorm channel statistics, for Hopper (sm_90a): the first half of
// FusedConvBNReLU's epilogue in training.
//
// Replaces: mxnet_tpu/ops/pallas_kernels.py _bn_stats_kernel, launched by
// _pl_channel_stats. Computes, for x (N, C, H, W) float32, contiguous, in
// float32:
//   sum[c] = sum_{n, hw} x[n, c, hw]      sq[c] = sum_{n, hw} x[n, c, hw]^2
//
// Bound: bytes. x is read once (N * C * HW * 4 bytes); the outputs are two
// (C,) vectors. The TPU kernel walks batch and spatial blocks as a
// sequential grid axis and accumulates into its resident (1, C) output
// tile. Here blocks run in parallel and in no order, so the sum over N * HW
// is a deterministic two-stage reduction, with no float atomics (whose
// order, and so whose rounding, would change from run to run):
//   stage 1: block (c, s) sums channel c over the rows n of slice s (R
//            rows of HW contiguous floats each; R depends only on the
//            shape, so a slice holds about 8K floats). Each thread walks
//            the slice with a fixed stride, 16-byte loads when HW % 4 == 0
//            and x is 16-byte aligned (a float4 then never straddles two
//            rows), one float at a time otherwise (stage 4 of ResNet-50 has
//            HW = 49); the block then sums its threads in a fixed tree
//            (warp shuffles, then the warps' partials in order) and writes
//            one partial per output into a (S, C) buffer;
//   stage 2: one thread per channel sums the S partials in order.
// Both stages are launched by one call.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kThreads2 = 256;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// units are float4 (VEC) or float; hwu = HW in units, and a slice's
// rows * hwu units fit 32 bits (the wrapper checks)
template <bool VEC>
__global__ void bn_stats_partial_f32(const float* __restrict__ x,
                                     float* __restrict__ part_sum,
                                     float* __restrict__ part_sq, int n,
                                     int c, unsigned hwu, int rows) {
  const int ch = blockIdx.x;
  const int slice = blockIdx.y;
  const int n0 = slice * rows;
  const int n1 = min(n, n0 + rows);
  const unsigned units = static_cast<unsigned>(n1 - n0) * hwu;
  float s = 0.0f, q = 0.0f;
  for (unsigned t = threadIdx.x; t < units; t += kThreads) {
    const unsigned r = t / hwu;
    const int64_t row = static_cast<int64_t>(n0 + r) * c + ch;
    const int64_t i = row * hwu + (t - r * hwu);
    if (VEC) {
      const float4 v = reinterpret_cast<const float4*>(x)[i];
      s += (v.x + v.y) + (v.z + v.w);
      q += (v.x * v.x + v.y * v.y) + (v.z * v.z + v.w * v.w);
    } else {
      const float v = x[i];
      s += v;
      q = fmaf(v, v, q);
    }
  }
  __shared__ float ws[kWarps], wq[kWarps];
  s = warp_sum(s);
  q = warp_sum(q);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    ws[warp] = s;
    wq[warp] = q;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float a = ws[0], b = wq[0];
#pragma unroll
    for (int k = 1; k < kWarps; ++k) {
      a += ws[k];
      b += wq[k];
    }
    part_sum[static_cast<int64_t>(slice) * c + ch] = a;
    part_sq[static_cast<int64_t>(slice) * c + ch] = b;
  }
}

__global__ void bn_stats_final_f32(const float* __restrict__ part_sum,
                                   const float* __restrict__ part_sq,
                                   float* __restrict__ sum,
                                   float* __restrict__ sq, int c,
                                   int slices) {
  const int ch = blockIdx.x * blockDim.x + threadIdx.x;
  if (ch >= c) return;
  float a = 0.0f, b = 0.0f;
  for (int k = 0; k < slices; ++k) {
    a += part_sum[static_cast<int64_t>(k) * c + ch];
    b += part_sq[static_cast<int64_t>(k) * c + ch];
  }
  sum[ch] = a;
  sq[ch] = b;
}

}  // namespace

// x (n, c, hw) float32 -> sum (c,), sq (c,); part_sum and part_sq are
// (slices, c) scratch buffers, slices = ceil(n / rows) <= 65535, and
// rows * hw + kThreads < 2^31. All contiguous, on one device. Returns
// cudaGetLastError().
extern "C" int mx_bn_stats_f32(const void* x, void* part_sum, void* part_sq,
                               void* sum, void* sq, int n, int c, int hw,
                               int rows, int slices, void* stream) {
  if (c <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool empty = n <= 0 || hw <= 0;
  if (!empty) {
    const dim3 grid(c, slices);
    const bool vec = (hw & 3) == 0 &&
                     (reinterpret_cast<uintptr_t>(x) & 15) == 0;
    if (vec) {
      bn_stats_partial_f32<true><<<grid, kThreads, 0, st>>>(
          static_cast<const float*>(x), static_cast<float*>(part_sum),
          static_cast<float*>(part_sq), n, c,
          static_cast<unsigned>(hw / 4), rows);
    } else {
      bn_stats_partial_f32<false><<<grid, kThreads, 0, st>>>(
          static_cast<const float*>(x), static_cast<float*>(part_sum),
          static_cast<float*>(part_sq), n, c, static_cast<unsigned>(hw),
          rows);
    }
    const int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  bn_stats_final_f32<<<(c + kThreads2 - 1) / kThreads2, kThreads2, 0, st>>>(
      static_cast<const float*>(part_sum), static_cast<const float*>(part_sq),
      static_cast<float*>(sum), static_cast<float*>(sq), c,
      empty ? 0 : slices);
  return static_cast<int>(cudaGetLastError());
}
