// LayerNorm backward, the parameter gradients, for Hopper (sm_90a).
//
// Replaces: mxnet_tpu/ops/pallas_kernels.py _ln_bwd_dparams_kernel,
// launched by _ln_pl_bwd_rule. Computes, over every row of x (N, C), in
// float32, from the mean and rstd the forward saved:
//   dgamma[c] = sum_r ct[r, c] * (x[r, c] - mean[r]) * rstd[r]
//   dbeta[c]  = sum_r ct[r, c]
//
// Bound: bytes. x and ct are read once (2 * N * C * 4 bytes); the outputs
// are two (C,) vectors. The TPU kernel walks the row blocks as a
// sequential grid axis and accumulates into its resident output block.
// Here blocks run in parallel and in no order, so the sum over rows is a
// deterministic two-stage reduction, with no float atomics (whose order,
// and so whose rounding, would change from run to run):
//   stage 1: a block of 32 columns x 8 row lanes walks one chunk of
//            `rows` rows (each lane every 8th row, coalesced 128-byte row
//            segments per warp), then sums its 8 lanes in a fixed order
//            through shared memory and writes one partial per column into
//            a (chunks, C) buffer for each output;
//   stage 2: one thread per column sums the `chunks` partials in order.
// The chunking depends only on N, so repeated calls give identical bits.
// Both stages are launched by one call.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 32;   // columns per stage-1 block (one per lane)
constexpr int kLanes = 8;   // row lanes per stage-1 block
constexpr int kThreads2 = 256;

__global__ void ln_dparams_partial_f32(const float* __restrict__ x,
                                       const float* __restrict__ ct,
                                       const float* __restrict__ mean,
                                       const float* __restrict__ rstd,
                                       float* __restrict__ part_g,
                                       float* __restrict__ part_b, int n,
                                       int c, int rows) {
  __shared__ float sg[kLanes][kCols + 1];
  __shared__ float sb[kLanes][kCols + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int col = blockIdx.x * kCols + tx;
  const int chunk = blockIdx.y;
  const int r0 = chunk * rows;
  const int r1 = min(n, r0 + rows);
  float dg = 0.0f, db = 0.0f;
  if (col < c) {
    for (int r = r0 + ty; r < r1; r += kLanes) {
      const int64_t i = static_cast<int64_t>(r) * c + col;
      const float cv = ct[i];
      db += cv;
      dg = fmaf(cv, (x[i] - mean[r]) * rstd[r], dg);
    }
  }
  sg[ty][tx] = dg;
  sb[ty][tx] = db;
  __syncthreads();
  if (ty == 0 && col < c) {
    float a = sg[0][tx], b = sb[0][tx];
#pragma unroll
    for (int k = 1; k < kLanes; ++k) {
      a += sg[k][tx];
      b += sb[k][tx];
    }
    part_g[static_cast<int64_t>(chunk) * c + col] = a;
    part_b[static_cast<int64_t>(chunk) * c + col] = b;
  }
}

__global__ void ln_dparams_final_f32(const float* __restrict__ part_g,
                                     const float* __restrict__ part_b,
                                     float* __restrict__ dgamma,
                                     float* __restrict__ dbeta, int c,
                                     int chunks) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= c) return;
  float a = 0.0f, b = 0.0f;
  for (int k = 0; k < chunks; ++k) {
    a += part_g[static_cast<int64_t>(k) * c + col];
    b += part_b[static_cast<int64_t>(k) * c + col];
  }
  dgamma[col] = a;
  dbeta[col] = b;
}

}  // namespace

// x (n, c), ct (n, c), mean (n,), rstd (n,) -> dgamma (c,), dbeta (c,);
// part_g and part_b are (chunks, c) scratch buffers with chunks =
// ceil(n / rows) <= 65535 and rows a multiple of 8. All float32,
// contiguous, on one device. Returns cudaGetLastError().
extern "C" int mx_ln_bwd_dparams_f32(const void* x, const void* ct,
                                     const void* mean, const void* rstd,
                                     void* part_g, void* part_b,
                                     void* dgamma, void* dbeta, int n, int c,
                                     int rows, int chunks, void* stream) {
  if (c <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    const dim3 grid((c + kCols - 1) / kCols, chunks);
    ln_dparams_partial_f32<<<grid, dim3(kCols, kLanes), 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(ct),
        static_cast<const float*>(mean), static_cast<const float*>(rstd),
        static_cast<float*>(part_g), static_cast<float*>(part_b), n, c, rows);
    const int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  ln_dparams_final_f32<<<(c + kThreads2 - 1) / kThreads2, kThreads2, 0, s>>>(
      static_cast<const float*>(part_g), static_cast<const float*>(part_b),
      static_cast<float*>(dgamma), static_cast<float*>(dbeta), c,
      n > 0 ? chunks : 0);
  return static_cast<int>(cudaGetLastError());
}
