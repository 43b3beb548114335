// Dequant-fused dense matmul, for Hopper (sm_90a): QuantizedFullyConnected.
//
// Replaces: mxnet_tpu/ops/quant.py _qfc_kernel, launched by _pl_qfc_matmul.
// Computes, for x (M, K) float32, bfloat16 or float16, w (N, K) int8 or
// float8_e4m3fn and the per-output-channel scales s (N,) float32, in
// float32:
//   out[m, n] = sum_k x[m, k] * (float(w[n, k]) * s[n])
// Each weight is decoded and multiplied by its row's scale (one rounding,
// __fmul_rn) before the dot, as the TPU kernel scales its weight tile in
// VMEM ahead of the MXU product; the float32-wide weight never exists in
// device memory. A bfloat16 or float16 x (a quantized graph under
// compute_dtype) is widened exactly as it is staged, and the output stays
// float32, as the TPU kernel's out_shape is float32 whatever x's type: the
// op adds the bias in float32 and rounds to x's type once, as the JAX
// package's Pallas variant does.
//
// Bound: at the serving path's shapes (M <= 8, K = 2048, N = 1000) bytes:
// the weight is read once (N * K bytes) and a few flops per byte sit far
// below the card's operations-per-byte line. From M in the hundreds up,
// operations (2 M N K float32 flops on the CUDA cores).
// Design: a plain tiled float32 matmul. One 256-thread block per 64 x 64
// output tile loops over K in chunks of 16; each chunk of x rows and of
// decoded, scaled weight rows is staged in shared memory, transposed, so
// that the inner loop reads both without bank conflicts, and each thread
// keeps a 4 x 4 register tile of float32 FMAs (no TF32 or tensor-core MMA:
// the TPU kernel's Precision.HIGHEST product is float32). Every load is one
// element under a mask, so any M, N and K (K = 13 included) is taken and
// no row is read as wider words than it holds. At M <= 8 most of a 64-row
// tile is masked and N = 1000 gives 16 blocks for 132 SMs: the kernel is
// latency-bound there; a GEMV-shaped or split-K design is its next step.
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "vec_io.cuh"

namespace {

constexpr int kBM = 64, kBN = 64, kBK = 16, kThreads = 256, kPad = 4;

struct I8 {};
struct E4M3 {};

__device__ __forceinline__ float decode(uint8_t b, I8) {
  return static_cast<float>(static_cast<int8_t>(b));
}

__device__ __forceinline__ float decode(uint8_t b, E4M3) {
  __nv_fp8_e4m3 v;
  v.__x = b;
  return static_cast<float>(v);
}

__device__ __forceinline__ float widen(float v) { return v; }
template <typename H>
__device__ __forceinline__ float widen(H v) {
  return mxio::Half<H>::widen(v);
}

template <typename W, typename X>
__global__ void __launch_bounds__(kThreads)
    qfc_matmul_f32(const X* __restrict__ x, const uint8_t* __restrict__ w,
                   const float* __restrict__ s, float* __restrict__ out,
                   int m, int n, int k) {
  __shared__ float xs[kBK][kBM + kPad];
  __shared__ float ws[kBK][kBN + kPad];
  __shared__ float ss[kBN];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  if (tid < kBN) ss[tid] = n0 + tid < n ? s[n0 + tid] : 0.0f;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < k; k0 += kBK) {
    __syncthreads();  // ss is written, and the previous chunk is consumed
    for (int e = tid; e < kBM * kBK; e += kThreads) {
      const int r = e / kBK, kk = e % kBK, gm = m0 + r, gk = k0 + kk;
      xs[kk][r] = (gm < m && gk < k)
                      ? widen(x[static_cast<int64_t>(gm) * k + gk]) : 0.0f;
    }
    for (int e = tid; e < kBN * kBK; e += kThreads) {
      const int r = e / kBK, kk = e % kBK, gn = n0 + r, gk = k0 + kk;
      ws[kk][r] = (gn < n && gk < k)
                      ? __fmul_rn(decode(w[static_cast<int64_t>(gn) * k + gk],
                                         W()), ss[r])
                      : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn < n) out[static_cast<int64_t>(gm) * n + gn] = acc[i][j];
    }
  }
}

template <typename W, typename X = float>
int launch(const void* x, const void* w, const void* s, void* out, int m,
           int n, int k, void* stream) {
  if (m > 0 && n > 0 && k > 0) {
    const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
    qfc_matmul_f32<W, X>
        <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const X*>(x), static_cast<const uint8_t*>(w),
            static_cast<const float*>(s), static_cast<float*>(out), m, n, k);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (m, k) float32, w (n, k) one byte per weight, s (n,) float32 ->
// out (m, n) float32; contiguous, one device. Returns cudaGetLastError().
extern "C" int mx_qfc_matmul_i8_f32(const void* x, const void* w,
                                    const void* s, void* out, int m, int n,
                                    int k, void* stream) {
  return launch<I8>(x, w, s, out, m, n, k, stream);
}

extern "C" int mx_qfc_matmul_e4m3_f32(const void* x, const void* w,
                                      const void* s, void* out, int m, int n,
                                      int k, void* stream) {
  return launch<E4M3>(x, w, s, out, m, n, k, stream);
}

// The same over bfloat16 or float16 x; s and out stay float32.
extern "C" int mx_qfc_matmul_i8_bf16(const void* x, const void* w,
                                     const void* s, void* out, int m, int n,
                                     int k, void* stream) {
  return launch<I8, __nv_bfloat16>(x, w, s, out, m, n, k, stream);
}

extern "C" int mx_qfc_matmul_e4m3_bf16(const void* x, const void* w,
                                       const void* s, void* out, int m,
                                       int n, int k, void* stream) {
  return launch<E4M3, __nv_bfloat16>(x, w, s, out, m, n, k, stream);
}

extern "C" int mx_qfc_matmul_i8_f16(const void* x, const void* w,
                                    const void* s, void* out, int m, int n,
                                    int k, void* stream) {
  return launch<I8, __half>(x, w, s, out, m, n, k, stream);
}

extern "C" int mx_qfc_matmul_e4m3_f16(const void* x, const void* w,
                                      const void* s, void* out, int m, int n,
                                      int k, void* stream) {
  return launch<E4M3, __half>(x, w, s, out, m, n, k, stream);
}
