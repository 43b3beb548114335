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
// Bound: bytes. Four arrays are read and three written, 28 bytes per
// element; about a dozen flops and one square root per element. Design:
// the grid-stride elementwise loop of sgd_mom.cu, with each step rounded
// as the plain version rounds it (_rn intrinsics, IEEE sqrtf and
// division; no fused multiply-adds).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

__global__ void adam_f32(float* __restrict__ w, const float* __restrict__ g,
                         float* __restrict__ mean, float* __restrict__ var,
                         int64_t n, float lr, float b1, float one_m_b1,
                         float b2, float one_m_b2, float eps, float wd,
                         float rescale, float clip) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const float wi = w[i];
    float gi = __fmul_rn(g[i], rescale);
    if (clip > 0.0f) gi = gi < -clip ? -clip : (gi > clip ? clip : gi);
    gi = __fadd_rn(gi, __fmul_rn(wd, wi));
    const float mi = __fadd_rn(__fmul_rn(b1, mean[i]), __fmul_rn(one_m_b1, gi));
    const float vi = __fadd_rn(__fmul_rn(b2, var[i]),
                               __fmul_rn(__fmul_rn(one_m_b2, gi), gi));
    mean[i] = mi;
    var[i] = vi;
    const float step = __fdiv_rn(__fmul_rn(lr, mi),
                                 __fadd_rn(__fsqrt_rn(vi), eps));
    w[i] = __fsub_rn(wi, step);
  }
}

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
        static_cast<float*>(mean), static_cast<float*>(var), n, lr, b1,
        one_m_b1, b2, one_m_b2, eps, wd, rescale, clip);
  }
  return static_cast<int>(cudaGetLastError());
}
