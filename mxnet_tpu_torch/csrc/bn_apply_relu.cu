// BatchNorm apply + ReLU, for Hopper (sm_90a): the second half of
// FusedConvBNReLU's epilogue, in training and in inference.
//
// Replaces: mxnet_tpu/ops/pallas_kernels.py _bn_apply_relu_kernel,
// launched by _pl_apply_bn_relu. Computes, for x (N, C, H, W) and the
// per-channel float32 scale (C,) and shift (C,) the op derives from the
// statistics, in float32:
//   y[n, c, hw] = max(x[n, c, hw] * scale[c] + shift[c], 0)
// and stores y in x's type. Three instances: float32 x and y, and bfloat16 or
// float16 x and y (the mixed-precision path: x widened exactly, y rounded once
// to nearest even, as the TPU kernel's .astype(o_ref.dtype)). The product and
// the sum are rounded separately (__fmul_rn, __fadd_rn: no fused
// multiply-add), so the kernel is bit-identical to its plain version; a
// NaN passes through, as torch.maximum passes it.
//
// Bound: bytes. x is read once and y written once (2 * N * C * HW *
// sizeof(T) bytes); two flops and a compare per element. Design: one
// elementwise grid-stride pass over units of V values of one (n, c) row
// (they never straddle two rows, so they share one channel): 16-byte
// units (V = 4 floats, or V = 8 16-bit values) when HW % V == 0 and x, y
// are 16-byte aligned, for bfloat16 8-byte units of 4 when HW % 4 == 0 and
// both are 8-byte aligned (stage 3 of ResNet-50 has HW = 196), one value
// at a time otherwise (stage 4 has HW = 49). The channel of a unit is
// (unit / HW_units) % C: two 32-bit integer divisions per unit where the
// indices fit, inside the instruction budget of a pass that moves 16 to 32
// bytes per unit.
#include <cuda_runtime.h>
#include <stdint.h>

#include "vec_io.cuh"

namespace {

using mxio::Io;

constexpr int kThreads = 256;

__device__ __forceinline__ float apply(float x, float s, float b) {
  const float v = __fadd_rn(__fmul_rn(x, s), b);
  return (v > 0.0f || v != v) ? v : 0.0f;
}

// T: the storage type; V: values per unit; I: the index type, 32-bit
// unsigned when every index fits (integer division is then several times
// cheaper), else 64-bit
template <typename T, int V, typename I>
__global__ void bn_apply_relu_kernel(const T* __restrict__ x,
                                     const float* __restrict__ scale,
                                     const float* __restrict__ shift,
                                     T* __restrict__ y, I units, I hwu,
                                     I c) {
  for (I i = blockIdx.x * static_cast<I>(blockDim.x) + threadIdx.x;
       i < units; i += static_cast<I>(gridDim.x) * blockDim.x) {
    const I ch = (i / hwu) % c;
    const float s = scale[ch], b = shift[ch];
    float f[V];
    Io<T, V>::load(x, i, f);
#pragma unroll
    for (int k = 0; k < V; ++k) f[k] = apply(f[k], s, b);
    Io<T, V>::store(y, i, f);
  }
}

template <typename T, int V>
void launch(const void* x, const void* scale, const void* shift, void* y,
            int64_t total, int64_t hw, int c, cudaStream_t st) {
  const int64_t units = total / V;
  int64_t blocks = (units + kThreads - 1) / kThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;   // 16 blocks per SM, then stride
  const T* xs = static_cast<const T*>(x);
  const float* sc = static_cast<const float*>(scale);
  const float* sh = static_cast<const float*>(shift);
  T* ys = static_cast<T*>(y);
  // the stride loop's last step must not wrap a 32-bit index
  if (units + blocks * kThreads < (int64_t{1} << 32)) {
    bn_apply_relu_kernel<T, V, uint32_t>
        <<<static_cast<int>(blocks), kThreads, 0, st>>>(
            xs, sc, sh, ys, static_cast<uint32_t>(units),
            static_cast<uint32_t>(hw / V), static_cast<uint32_t>(c));
  } else {
    bn_apply_relu_kernel<T, V, int64_t>
        <<<static_cast<int>(blocks), kThreads, 0, st>>>(
            xs, sc, sh, ys, units, hw / V, static_cast<int64_t>(c));
  }
}

bool both_aligned(const void* x, const void* y, uintptr_t bytes) {
  return mxio::aligned(x, bytes) && mxio::aligned(y, bytes);
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
    if ((hw & 3) == 0 && both_aligned(x, y, 16))
      launch<float, 4>(x, scale, shift, y, total, hw, c, st);
    else
      launch<float, 1>(x, scale, shift, y, total, hw, c, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// The same over 16-bit x and y (H = __nv_bfloat16 or __half); scale and
// shift stay float32
template <typename H>
int half_apply(const void* x, const void* scale, const void* shift, void* y,
               int n, int c, int hw, void* stream) {
  const int64_t total = static_cast<int64_t>(n) * c * hw;
  if (total > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if ((hw & 7) == 0 && both_aligned(x, y, 16))
      launch<H, 8>(x, scale, shift, y, total, hw, c, st);
    else if ((hw & 3) == 0 && both_aligned(x, y, 8))
      launch<H, 4>(x, scale, shift, y, total, hw, c, st);
    else
      launch<H, 1>(x, scale, shift, y, total, hw, c, st);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mx_bn_apply_relu_bf16(const void* x, const void* scale,
                                     const void* shift, void* y, int n,
                                     int c, int hw, void* stream) {
  return half_apply<__nv_bfloat16>(x, scale, shift, y, n, c, hw, stream);
}

extern "C" int mx_bn_apply_relu_f16(const void* x, const void* scale,
                                    const void* shift, void* y, int n, int c,
                                    int hw, void* stream) {
  return half_apply<__half>(x, scale, shift, y, n, c, hw, stream);
}
