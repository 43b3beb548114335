// SGD with momentum, in place, for Hopper (sm_90a).
//
// Replaces: mxnet_tpu/ops/pallas_kernels.py _sgd_mom_kernel, run over
// (16k, 128) tiles by _tiled_elementwise (and reached by rtc.py's
// pallas_sgd_mom_update). Computes, elementwise over w, g, m of any
// length, in float32:
//   g' = g * rescale;  g' = clip(g', -clip, clip) when clip > 0;
//   g' = g' + wd * w;  m = momentum * m - lr * g';  w = w + m
// and writes m and w back in place (the TPU kernel writes new buffers;
// here the weight and momentum cells own their storage).
//
// Bound: bytes. Three arrays are read and two written, 20 bytes per
// element (511 MB per ResNet-50 step over its 25.5 M parameters); a
// handful of flops per element. Design: one thread per element over a
// grid-stride loop of 64-bit indices, so any length works, not only
// multiples of the block; enough blocks to fill the 132 SMs several
// times. Each step rounds as the plain version does: the multiplies and
// adds are the _rn intrinsics, which the compiler does not fuse into
// fused multiply-adds. The clip is a compare, so a NaN gradient stays
// NaN as under jnp.clip.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

__global__ void sgd_mom_f32(float* __restrict__ w, const float* __restrict__ g,
                            float* __restrict__ m, int64_t n, float lr,
                            float momentum, float wd, float rescale,
                            float clip) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const float wi = w[i];
    float gi = __fmul_rn(g[i], rescale);
    if (clip > 0.0f) gi = gi < -clip ? -clip : (gi > clip ? clip : gi);
    gi = __fadd_rn(gi, __fmul_rn(wd, wi));
    const float mi = __fsub_rn(__fmul_rn(momentum, m[i]), __fmul_rn(lr, gi));
    m[i] = mi;
    w[i] = __fadd_rn(wi, mi);
  }
}

}  // namespace

// w, g, m (n,) float32, contiguous, on one device; w and m updated in
// place. clip <= 0 means no clip. Returns cudaGetLastError().
extern "C" int mx_sgd_mom_f32(void* w, const void* g, void* m, long long n,
                              float lr, float momentum, float wd,
                              float rescale, float clip, void* stream) {
  if (n > 0) {
    const long long want = (n + kThreads - 1) / kThreads;
    const int blocks = static_cast<int>(want < kMaxBlocks ? want
                                                          : kMaxBlocks);
    sgd_mom_f32<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<float*>(w), static_cast<const float*>(g),
        static_cast<float*>(m), n, lr, momentum, wd, rescale, clip);
  }
  return static_cast<int>(cudaGetLastError());
}
