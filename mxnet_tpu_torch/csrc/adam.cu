// Adam, in place, for Hopper (sm_90a).
//
// Replaces: mxnet_tpu/ops/pallas_kernels.py _adam_kernel, run over
// (16k, 128) tiles by _tiled_elementwise. Computes, elementwise over w,
// g, mean, var of any length, in float32:
//   g' = g * rescale;  g' = clip(g', -clip, clip) when clip > 0;
//   g' = g' + wd * w;
//   mean = b1 * mean + (1 - b1) * g';  var = b2 * var + (1 - b2) * g' * g'
//   w = w - lr * mean / (sqrt(var) + eps)
// (epsilon outside the square root, as the TPU kernel places it; the
// optimizer folds the bias correction into lr) and writes w, mean and var
// back in place. 1 - b1 and 1 - b2 arrive from the host, rounded from
// double as the JAX package's Python scalars are.
//
// Two entry points, as in sgd_mom.cu: mx_adam_f32 for one array,
// mx_adam_multi_f32 for a whole step's arrays in one launch (design in
// multi_update.cuh); both apply adam_elem, so an element comes out bit
// for bit the same through either.
//
// Bound: bytes. Four arrays are read and three written, 28 bytes per
// element; about a dozen flops and one square root per element. The
// one-array design: the grid-stride elementwise loop of sgd_mom.cu, with
// each step rounded as the plain version rounds it (_rn intrinsics, IEEE
// sqrtf and division; no fused multiply-adds).
#include <cuda_runtime.h>
#include <stdint.h>

#include "multi_update.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

struct AdamHyper {
  float b1, one_m_b1, b2, one_m_b2, eps, rescale, clip;
};

__device__ __forceinline__ void adam_elem(float& w, float g, float& mean,
                                          float& var, float lr, float wd,
                                          const AdamHyper& h) {
  float gi = __fmul_rn(g, h.rescale);
  if (h.clip > 0.0f) {
    gi = gi < -h.clip ? -h.clip : (gi > h.clip ? h.clip : gi);
  }
  gi = __fadd_rn(gi, __fmul_rn(wd, w));
  mean = __fadd_rn(__fmul_rn(h.b1, mean), __fmul_rn(h.one_m_b1, gi));
  var = __fadd_rn(__fmul_rn(h.b2, var),
                  __fmul_rn(__fmul_rn(h.one_m_b2, gi), gi));
  const float step = __fdiv_rn(__fmul_rn(lr, mean),
                               __fadd_rn(__fsqrt_rn(var), h.eps));
  w = __fsub_rn(w, step);
}

__global__ void adam_f32(float* __restrict__ w, const float* __restrict__ g,
                         float* __restrict__ mean, float* __restrict__ var,
                         int64_t n, float lr, float wd, AdamHyper h) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    float wi = w[i];
    float mi = mean[i];
    float vi = var[i];
    adam_elem(wi, g[i], mi, vi, lr, wd, h);
    mean[i] = mi;
    var[i] = vi;
    w[i] = wi;
  }
}

// v: weight, gradient, mean, var
struct Adam {
  AdamHyper h;
  __device__ __forceinline__ void operator()(float* v, float lr,
                                             float wd) const {
    adam_elem(v[0], v[1], v[2], v[3], lr, wd, h);
  }
};

}  // namespace

// w, g, mean, var (n,) float32, contiguous, on one device; w, mean and var
// updated in place. clip <= 0 means no clip. Returns cudaGetLastError().
extern "C" int mx_adam_f32(void* w, const void* g, void* mean, void* var,
                           long long n, float lr, float b1, float one_m_b1,
                           float b2, float one_m_b2, float eps, float wd,
                           float rescale, float clip, void* stream) {
  if (n > 0) {
    const long long want = (n + kThreads - 1) / kThreads;
    const int blocks = static_cast<int>(want < kMaxBlocks ? want
                                                          : kMaxBlocks);
    adam_f32<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<float*>(w), static_cast<const float*>(g),
        static_cast<float*>(mean), static_cast<float*>(var), n, lr, wd,
        AdamHyper{b1, one_m_b1, b2, one_m_b2, eps, rescale, clip});
  }
  return static_cast<int>(cudaGetLastError());
}

// Every array of `table` (host memory, `bytes` long: mxmulti::Table<4>,
// operands weight, gradient, mean, var) in one launch of `blocks` chunks;
// weights, means and vars updated in place. Returns cudaGetLastError(),
// or cudaErrorInvalidValue for a table of another layout.
extern "C" int mx_adam_multi_f32(const void* table, long long bytes,
                                 int blocks, float b1, float one_m_b1,
                                 float b2, float one_m_b2, float eps,
                                 float rescale, float clip, void* stream) {
  return mxmulti::launch<4>(
      table, bytes, blocks,
      Adam{AdamHyper{b1, one_m_b1, b2, one_m_b2, eps, rescale, clip}},
      stream);
}
