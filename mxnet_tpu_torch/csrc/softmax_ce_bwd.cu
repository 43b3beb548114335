// Softmax cross-entropy gradient, for Hopper (sm_90a): the SoftmaxOutput
// backward, which ignores the incoming head gradient.
//
// Replaces: mxnet_tpu/ops/pallas_kernels.py _softmax_ce_bwd_kernel,
// launched by _softmax_ce_bwd. Computes, for p (N, C) and label (N,) held
// as float32:
//   g[i, j] = (p[i, j] - (j == int(label[i]))) * keep[i] * scale
// with keep[i] = (label[i] != ignore_label) under use_ignore, else 1. A
// label outside [0, C) matches no column, so its row is p * keep * scale,
// as the TPU kernel's iota compare gives. The "valid" normalisation
// divides afterwards, in the wrapper, as the TPU path does.
//
// Bound: bytes. p is read and g written once (the labels are N floats);
// two flops per element. Design: one thread per element over a grid-
// stride loop of 64-bit indices, neighbouring threads on neighbouring
// columns; the row's label is a broadcast read that stays in L1. Each
// step rounds as the plain version does (no fused multiply-add).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

__global__ void softmax_ce_bwd_f32(const float* __restrict__ p,
                                   const float* __restrict__ label,
                                   float* __restrict__ g, int64_t total,
                                   int c, float scale, int use_ignore,
                                   float ignore_label) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       i < total; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t row = i / c;
    const int col = static_cast<int>(i - row * c);
    const float lf = label[row];
    const float onehot = (col == __float2int_rz(lf)) ? 1.0f : 0.0f;
    float v = __fsub_rn(p[i], onehot);
    if (use_ignore) v = __fmul_rn(v, lf != ignore_label ? 1.0f : 0.0f);
    g[i] = __fmul_rn(v, scale);
  }
}

}  // namespace

// p (n, c), label (n,) -> g (n, c); float32, contiguous, on one device.
// Returns cudaGetLastError().
extern "C" int mx_softmax_ce_bwd_f32(const void* p, const void* label,
                                     void* g, int n, int c, float scale,
                                     int use_ignore, float ignore_label,
                                     void* stream) {
  const int64_t total = static_cast<int64_t>(n) * c;
  if (total > 0) {
    const int64_t want = (total + kThreads - 1) / kThreads;
    const int blocks = static_cast<int>(want < kMaxBlocks ? want
                                                          : kMaxBlocks);
    softmax_ce_bwd_f32<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(p), static_cast<const float*>(label),
        static_cast<float*>(g), total, c, scale, use_ignore, ignore_label);
  }
  return static_cast<int>(cudaGetLastError());
}
