// LayerNorm forward over the last axis, for Hopper (sm_90a).
//
// Replaces: mxnet_tpu/ops/pallas_kernels.py _ln_fwd_kernel, launched by
// _pl_layernorm_fwd. Computes, per row of x (N, C):
//   mean = sum(x) / C,  var = sum((x - mean)^2) / C   (two-pass, float32)
//   rstd = 1 / sqrt(var + eps),  y = (x - mean) * rstd * gamma + beta
// and writes y (N, C), mean (N,), rstd (N,) and the op's std output
// 1 / rstd (N,) (an IEEE division, as PyTorch's 1.0 / rstd rounds it, so
// the op launches nothing after the kernel). Three instances: float32, and
// bfloat16 or float16 (the mixed-precision path: x, gamma and beta 16-bit,
// as the graph casts its parameters), which widens every value exactly,
// computes as the float32 instance does and rounds y to nearest even once;
// mean, rstd and std stay float32, as the TPU kernel's statistic outputs
// are.
//
// Bound: bytes. x is read and y written once (plus gamma/beta, shared by
// every row and cached); ~10 flops per element is far below the card's
// operations-per-byte line. At the decode shape (8, 512) the call is
// latency: each dependent round trip to device memory costs about a
// microsecond. Design: one warp per row. For C <= 1024 (the LM's 512) the
// row is resident in the warp's registers (16 float32 values a lane at
// C = 512, four 16-byte loads issued together): one read of x, the sum,
// the squared deviations and the write all from registers, so the kernel
// waits on device memory once. Longer rows take the walk design: the row
// is walked three times (sum, squared deviations, write), the second and
// third walks served from L1 (the first brought the row in). A block holds
// one warp below 1024 rows, so a decode batch spreads over as many SMs as
// it has rows, and four above. Accesses are 16-byte (4 floats or 8 16-bit
// values, vec_io.cuh) when C is a multiple of that unit and the pointers
// are 16-byte aligned, one value at a time otherwise. The variance is the
// two-pass form of the TPU kernel, not E[x^2] - mean^2; 1 / sqrtf is
// IEEE-rounded, not the approximate rsqrtf. Reduction order (the CPU tests
// emulate it): a lane sums its values unit by unit, then an xor butterfly
// over the warp's 32 lanes.
#include <cuda_runtime.h>
#include <stdint.h>

#include "vec_io.cuh"

namespace {

using mxio::Io;

constexpr int kRegRowMax = 1024;  // longest row held in a warp's registers

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void write_stats(int row, float mean, float rstd,
                                            float* __restrict__ mean_out,
                                            float* __restrict__ rstd_out,
                                            float* __restrict__ std_out) {
  mean_out[row] = mean;
  rstd_out[row] = rstd;
  std_out[row] = 1.0f / rstd;
}

// One warp per row held in registers: K units of W values a lane
template <typename T, int W, int K>
__global__ void __launch_bounds__(128)
    ln_fwd_regs(const T* __restrict__ x, const T* __restrict__ g,
                const T* __restrict__ b, T* __restrict__ y,
                float* __restrict__ mean_out, float* __restrict__ rstd_out,
                float* __restrict__ std_out, int n, int c, float eps) {
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n) return;
  const T* xr = x + static_cast<int64_t>(row) * c;
  T* yr = y + static_cast<int64_t>(row) * c;
  const int units = c / W;
  const float inv_c = 1.0f / static_cast<float>(c);
  float v[K][W];
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (lane + 32 * k < units) Io<T, W>::load(xr, lane + 32 * k, v[k]);

  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (lane + 32 * k < units) {
#pragma unroll
      for (int w = 0; w < W; ++w) s += v[k][w];
    }
  const float mean = warp_sum(s) * inv_c;

  float q = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (lane + 32 * k < units) {
#pragma unroll
      for (int w = 0; w < W; ++w) {
        const float d0 = v[k][w] - mean;
        q = fmaf(d0, d0, q);
      }
    }
  const float var = warp_sum(q) * inv_c;
  const float rstd = 1.0f / sqrtf(var + eps);

#pragma unroll
  for (int k = 0; k < K; ++k)
    if (lane + 32 * k < units) {
      float gg[W], bb[W];
      Io<T, W>::load(g, lane + 32 * k, gg);
      Io<T, W>::load(b, lane + 32 * k, bb);
#pragma unroll
      for (int w = 0; w < W; ++w)
        v[k][w] = (v[k][w] - mean) * rstd * gg[w] + bb[w];
      Io<T, W>::store(yr, lane + 32 * k, v[k]);
    }
  if (lane == 0) write_stats(row, mean, rstd, mean_out, rstd_out, std_out);
}

// One warp per row walked three times (C > 1024); each lane walks units of
// W values (W divides c)
template <typename T, int W>
__global__ void __launch_bounds__(128)
    ln_fwd_walk(const T* __restrict__ x, const T* __restrict__ g,
                const T* __restrict__ b, T* __restrict__ y,
                float* __restrict__ mean_out, float* __restrict__ rstd_out,
                float* __restrict__ std_out, int n, int c, float eps) {
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n) return;
  const T* xr = x + static_cast<int64_t>(row) * c;
  T* yr = y + static_cast<int64_t>(row) * c;
  const int units = c / W;
  const float inv_c = 1.0f / static_cast<float>(c);
  float f[W];

  float s = 0.0f;
  for (int i = lane; i < units; i += 32) {
    Io<T, W>::load(xr, i, f);
#pragma unroll
    for (int k = 0; k < W; ++k) s += f[k];
  }
  const float mean = warp_sum(s) * inv_c;

  float q = 0.0f;
  for (int i = lane; i < units; i += 32) {
    Io<T, W>::load(xr, i, f);
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const float d0 = f[k] - mean;
      q = fmaf(d0, d0, q);
    }
  }
  const float var = warp_sum(q) * inv_c;
  const float rstd = 1.0f / sqrtf(var + eps);

  float gg[W], bb[W];
  for (int i = lane; i < units; i += 32) {
    Io<T, W>::load(xr, i, f);
    Io<T, W>::load(g, i, gg);
    Io<T, W>::load(b, i, bb);
#pragma unroll
    for (int k = 0; k < W; ++k) f[k] = (f[k] - mean) * rstd * gg[k] + bb[k];
    Io<T, W>::store(yr, i, f);
  }
  if (lane == 0) write_stats(row, mean, rstd, mean_out, rstd_out, std_out);
}

template <typename T, int W>
void launch_w(const T* x, const T* g, const T* b, T* y, float* mean,
              float* rstd, float* std, int n, int c, float eps,
              cudaStream_t st) {
  const int warps = n >= 1024 ? 4 : 1;
  const dim3 grid((n + warps - 1) / warps), block(32 * warps);
  if (c > kRegRowMax) {
    ln_fwd_walk<T, W><<<grid, block, 0, st>>>(x, g, b, y, mean, rstd, std,
                                              n, c, eps);
    return;
  }
  // a lane's values: 8, 16 or 32, the fewest that hold the row
  const int vals = ((c / W + 31) / 32) * W;
  if (vals <= 8)
    ln_fwd_regs<T, W, (8 + W - 1) / W><<<grid, block, 0, st>>>(
        x, g, b, y, mean, rstd, std, n, c, eps);
  else if (vals <= 16)
    ln_fwd_regs<T, W, 16 / W><<<grid, block, 0, st>>>(
        x, g, b, y, mean, rstd, std, n, c, eps);
  else
    ln_fwd_regs<T, W, 32 / W><<<grid, block, 0, st>>>(
        x, g, b, y, mean, rstd, std, n, c, eps);
}

template <typename T>
int launch(const void* x, const void* gamma, const void* beta, void* y,
           void* mean, void* rstd, void* std, int n, int c, float eps,
           void* stream) {
  if (n > 0 && c > 0) {
    constexpr int kVec = 16 / sizeof(T);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const T* xt = static_cast<const T*>(x);
    const T* gt = static_cast<const T*>(gamma);
    const T* bt = static_cast<const T*>(beta);
    T* yt = static_cast<T*>(y);
    float* mf = static_cast<float*>(mean);
    float* rf = static_cast<float*>(rstd);
    float* sf = static_cast<float*>(std);
    if (c % kVec == 0 && mxio::aligned(x, 16) && mxio::aligned(y, 16) &&
        mxio::aligned(gamma, 16) && mxio::aligned(beta, 16))
      launch_w<T, kVec>(xt, gt, bt, yt, mf, rf, sf, n, c, eps, st);
    else
      launch_w<T, 1>(xt, gt, bt, yt, mf, rf, sf, n, c, eps, st);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (n, c), gamma (c,), beta (c,) -> y (n, c), mean (n,), rstd (n,),
// std = 1 / rstd (n,); all float32, contiguous, on one device. Returns
// cudaGetLastError().
extern "C" int mx_layernorm_fwd_f32(const void* x, const void* gamma,
                                    const void* beta, void* y, void* mean,
                                    void* rstd, void* std, int n, int c,
                                    float eps, void* stream) {
  return launch<float>(x, gamma, beta, y, mean, rstd, std, n, c, eps,
                       stream);
}

// The same over bfloat16 x, gamma, beta and y; the statistics float32.
extern "C" int mx_layernorm_fwd_bf16(const void* x, const void* gamma,
                                     const void* beta, void* y, void* mean,
                                     void* rstd, void* std, int n, int c,
                                     float eps, void* stream) {
  return launch<__nv_bfloat16>(x, gamma, beta, y, mean, rstd, std, n, c,
                               eps, stream);
}

// The same over float16 x, gamma, beta and y; the statistics float32.
extern "C" int mx_layernorm_fwd_f16(const void* x, const void* gamma,
                                    const void* beta, void* y, void* mean,
                                    void* rstd, void* std, int n, int c,
                                    float eps, void* stream) {
  return launch<__half>(x, gamma, beta, y, mean, rstd, std, n, c, eps,
                        stream);
}
