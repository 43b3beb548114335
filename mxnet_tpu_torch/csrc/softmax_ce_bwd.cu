// Softmax cross-entropy gradient, for Hopper (sm_90a): the SoftmaxOutput
// backward, which ignores the incoming head gradient.
//
// Replaces: mxnet_tpu/ops/pallas_kernels.py _softmax_ce_bwd_kernel,
// launched by _softmax_ce_bwd. Computes, for p (N, C) and label (N,) held
// as float32, in float32:
//   g[i, j] = (p[i, j] - (j == int(label[i]))) * keep[i] * scale
// with keep[i] = (label[i] != ignore_label) under use_ignore, else 1, and
// stores g in p's type. A label outside [0, C) matches no column, so its
// row is p * keep * scale, as the TPU kernel's iota compare gives. The
// "valid" normalisation divides afterwards, in the wrapper, as the TPU
// path does. Three instances: float32, and bfloat16 or float16 p and g (the
// mixed-precision path: p widened exactly, g rounded to nearest even; the
// label stays float32, as the TPU path casts it).
//
// Bound: bytes. p is read and g written once (the labels are N floats);
// two flops per element. Design: one thread per unit of W neighbouring
// elements of one row (W = 2, one __nv_bfloat162 or __half2, for 16-bit p of
// even C on 4-byte aligned pointers; else W = 1) over a grid-stride loop of
// 64-bit indices, neighbouring threads on neighbouring columns; the row's
// label is a broadcast read that stays in L1. Each step rounds as the
// plain version does (no fused multiply-add).
#include <cuda_runtime.h>
#include <stdint.h>

#include "vec_io.cuh"

namespace {

using mxio::Io;

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

// units: N * C / W; W divides C, so a unit never straddles two rows
template <typename T, int W>
__global__ void softmax_ce_bwd_kernel(const T* __restrict__ p,
                                      const float* __restrict__ label,
                                      T* __restrict__ g, int64_t units,
                                      int c, float scale, int use_ignore,
                                      float ignore_label) {
  for (int64_t u = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       u < units; u += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t i = u * W;
    const int64_t row = i / c;
    const int col = static_cast<int>(i - row * c);
    const float lf = label[row];
    const int lab = __float2int_rz(lf);
    const float keep = lf != ignore_label ? 1.0f : 0.0f;
    float f[W];
    Io<T, W>::load(p, u, f);
#pragma unroll
    for (int k = 0; k < W; ++k) {
      float v = __fsub_rn(f[k], (col + k == lab) ? 1.0f : 0.0f);
      if (use_ignore) v = __fmul_rn(v, keep);
      f[k] = __fmul_rn(v, scale);
    }
    Io<T, W>::store(g, u, f);
  }
}

template <typename T, int W>
void launch(const void* p, const void* label, void* g, int n, int c,
            float scale, int use_ignore, float ignore_label,
            cudaStream_t st) {
  const int64_t units = static_cast<int64_t>(n) * c / W;
  if (units <= 0) return;
  const int64_t want = (units + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < kMaxBlocks ? want : kMaxBlocks);
  softmax_ce_bwd_kernel<T, W><<<blocks, kThreads, 0, st>>>(
      static_cast<const T*>(p), static_cast<const float*>(label),
      static_cast<T*>(g), units, c, scale, use_ignore, ignore_label);
}

}  // namespace

// p (n, c), label (n,) -> g (n, c); float32, contiguous, on one device.
// Returns cudaGetLastError().
extern "C" int mx_softmax_ce_bwd_f32(const void* p, const void* label,
                                     void* g, int n, int c, float scale,
                                     int use_ignore, float ignore_label,
                                     void* stream) {
  launch<float, 1>(p, label, g, n, c, scale, use_ignore, ignore_label,
                   static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// The same over 16-bit p and g (H = __nv_bfloat16 or __half); the label
// stays float32
template <typename H>
int half_grad(const void* p, const void* label, void* g, int n, int c,
              float scale, int use_ignore, float ignore_label,
              void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((c & 1) == 0 && mxio::aligned(p, 4) && mxio::aligned(g, 4))
    launch<H, 2>(p, label, g, n, c, scale, use_ignore, ignore_label, st);
  else
    launch<H, 1>(p, label, g, n, c, scale, use_ignore, ignore_label, st);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mx_softmax_ce_bwd_bf16(const void* p, const void* label,
                                      void* g, int n, int c, float scale,
                                      int use_ignore, float ignore_label,
                                      void* stream) {
  return half_grad<__nv_bfloat16>(p, label, g, n, c, scale, use_ignore,
                                  ignore_label, stream);
}

extern "C" int mx_softmax_ce_bwd_f16(const void* p, const void* label,
                                     void* g, int n, int c, float scale,
                                     int use_ignore, float ignore_label,
                                     void* stream) {
  return half_grad<__half>(p, label, g, n, c, scale, use_ignore,
                           ignore_label, stream);
}
