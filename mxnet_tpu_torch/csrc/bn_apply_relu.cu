// BatchNorm apply + ReLU, for Hopper (sm_90a): the second half of
// FusedConvBNReLU's epilogue, in training and in inference.
//
// Replaces: mxnet_tpu/ops/pallas_kernels.py _bn_apply_relu_kernel,
// launched by _pl_apply_bn_relu. Computes, for x (N, C, H, W) float32 and
// the per-channel scale (C,) and shift (C,) the op derives from the
// statistics:
//   y[n, c, hw] = max(x[n, c, hw] * scale[c] + shift[c], 0)
// The product and the sum are rounded separately (__fmul_rn, __fadd_rn:
// no fused multiply-add), so the kernel is bit-identical to its plain
// version; a NaN passes through, as torch.maximum passes it.
//
// Bound: bytes. x is read once and y written once (2 * N * C * HW * 4
// bytes); two flops and a compare per element. Design: one elementwise
// grid-stride pass. When HW % 4 == 0 and x, y are 16-byte aligned, a thread
// takes 4 floats of one (n, c) row as one float4 (they never straddle two
// rows, so they share one channel); otherwise one float at a time (stage 4
// of ResNet-50 has HW = 49). The channel of an index is (index / HW) % C:
// two 32-bit integer divisions per unit where the indices fit, inside the
// instruction budget of a pass that moves 32 bytes per float4.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float apply(float x, float s, float b) {
  const float v = __fadd_rn(__fmul_rn(x, s), b);
  return (v > 0.0f || v != v) ? v : 0.0f;
}

// I: the index type, 32-bit unsigned when every index fits (integer
// division is then several times cheaper), else 64-bit
template <typename I>
__global__ void bn_apply_relu_vec4(const float4* __restrict__ x,
                                   const float* __restrict__ scale,
                                   const float* __restrict__ shift,
                                   float4* __restrict__ y, I n4, I hw4,
                                   I c) {
  for (I i = blockIdx.x * static_cast<I>(blockDim.x) + threadIdx.x; i < n4;
       i += static_cast<I>(gridDim.x) * blockDim.x) {
    const I ch = (i / hw4) % c;
    const float s = scale[ch], b = shift[ch];
    const float4 v = x[i];
    float4 o;
    o.x = apply(v.x, s, b);
    o.y = apply(v.y, s, b);
    o.z = apply(v.z, s, b);
    o.w = apply(v.w, s, b);
    y[i] = o;
  }
}

template <typename I>
__global__ void bn_apply_relu_scalar(const float* __restrict__ x,
                                     const float* __restrict__ scale,
                                     const float* __restrict__ shift,
                                     float* __restrict__ y, I n, I hw, I c) {
  for (I i = blockIdx.x * static_cast<I>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<I>(gridDim.x) * blockDim.x) {
    const I ch = (i / hw) % c;
    y[i] = apply(x[i], scale[ch], shift[ch]);
  }
}

template <typename I>
void launch(const void* x, const void* scale, const void* shift, void* y,
            int64_t work, int64_t hw, int c, bool vec, int blocks,
            cudaStream_t st) {
  if (vec) {
    bn_apply_relu_vec4<I><<<blocks, kThreads, 0, st>>>(
        static_cast<const float4*>(x), static_cast<const float*>(scale),
        static_cast<const float*>(shift), static_cast<float4*>(y),
        static_cast<I>(work), static_cast<I>(hw / 4), static_cast<I>(c));
  } else {
    bn_apply_relu_scalar<I><<<blocks, kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(scale),
        static_cast<const float*>(shift), static_cast<float*>(y),
        static_cast<I>(work), static_cast<I>(hw), static_cast<I>(c));
  }
}

}  // namespace

// x (n, c, hw) float32, scale (c,), shift (c,) -> y (n, c, hw); all
// contiguous, on one device. Returns cudaGetLastError().
extern "C" int mx_bn_apply_relu_f32(const void* x, const void* scale,
                                    const void* shift, void* y, int n, int c,
                                    int hw, void* stream) {
  const int64_t total = static_cast<int64_t>(n) * c * hw;
  if (total > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const bool vec = (hw & 3) == 0 &&
                     (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
                     (reinterpret_cast<uintptr_t>(y) & 15) == 0;
    const int64_t work = vec ? total / 4 : total;
    int64_t blocks = (work + kThreads - 1) / kThreads;
    if (blocks > 132 * 16) blocks = 132 * 16;   // 16 blocks per SM, then stride
    // the stride loop's last step must not wrap a 32-bit index
    if (work + blocks * kThreads < (int64_t{1} << 32)) {
      launch<uint32_t>(x, scale, shift, y, work, hw, c, vec,
                       static_cast<int>(blocks), st);
    } else {
      launch<int64_t>(x, scale, shift, y, work, hw, c, vec,
                      static_cast<int>(blocks), st);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
