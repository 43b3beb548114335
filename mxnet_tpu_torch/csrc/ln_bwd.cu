// LayerNorm backward for Hopper (sm_90a): dx, dgamma and dbeta in one pass
// over x and ct.
//
// Replaces: mxnet_tpu/ops/pallas_kernels.py _ln_bwd_dx_kernel (the input
// gradient) and _ln_bwd_dparams_kernel (the parameter gradients), the two
// kernels _ln_pl_bwd_rule launches. Computes, over x (N, C), in float32,
// from the mean and rstd the forward saved:
//   xh = (x - mean) * rstd,  gy = ct * gamma
//   dx = rstd * (gy - mean(gy) - xh * mean(gy * xh))   per row
//   dgamma = sum_r ct * xh,  dbeta = sum_r ct           per column
// Three instances: float32, and bfloat16 or float16 (the mixed-precision
// path: x, gamma, ct, dx, dgamma and dbeta 16-bit; mean, rstd and every
// partial sum float32), which widens every value exactly, computes as the
// float32 instance does and rounds dx, dgamma and dbeta to nearest even
// once each, as the TPU path stores dx in x's dtype and casts the float32
// sums to gamma's dtype. Either half can be off: a null dx skips the input
// gradient (gamma is then not read), a null dgdb the parameter gradients.
// gy and xh are rounded products (__fmul_rn), never fused into the
// subtraction that follows: at C = 1, gy - mean(gy) is then exactly 0, as
// in the plain version, where a fused residual would be scaled by
// rstd = eps^-1/2.
//
// Bound: bytes. x and ct are read and dx written once: 3 N C values, plus
// gamma, the two statistics and the 2 C parameter gradients. About 15
// flops an element are far below the card's operations-per-byte line. The
// two TPU kernels read x and ct once each (5 N C values between them).
//
// The register route, C <= 1024 (the LM's C = 512). One warp per row: the
// row's x and ct are loaded once into the warp's registers (16-byte units,
// vec_io.cuh), both row means come from one xor butterfly each, and dx is
// written from registers. The grid is persistent, sized from the card's SM
// count: as many blocks of 16 warps (8 above C = 512, where a lane holds 32
// values) as the SMs hold at once, and warp w of the grid walks rows w,
// w + G * warps, ... (a rule of N and the grid size alone). Each warp
// fetches its next row's units, as stored, while it works on this one, so
// it always has a row in flight. gamma is widened once a block into shared
// memory. Each lane keeps the running dgamma and dbeta of the columns it
// owns in registers across every row its warp walks. Then, in a fixed
// order and with no float atomics, so repeated calls give the same bits:
//   block: the warps' column sums added in warp order through shared
//          memory, one partial row per block (float32 scratch (G, 2C));
//   grid:  one grid-wide barrier (a cooperative launch, every block
//          resident), then each column by one warp: lane l adds the
//          blocks' partials l, l + 32, l + 64, ... in order (its loads
//          issued together), an xor butterfly adds the 32 lanes, and the
//          sum is rounded once.
// One launch a call; without the parameter gradients an ordinary launch.
//
// The walked route, C > 1024, any length (past the JAX package's
// eligibility bound of 65536 too: an LM head's LayerNorm over a vocabulary
// past 64 K): the row does not fit a warp's registers. Nothing in it
// holds a row: its indices are 64-bit where they scale with N * C, its
// grid's x axis takes ceil(C / 32) blocks (2^31 - 1 at most), and the
// parameter sums stay in the same fixed order at any C. dx: one warp per
// row walks it twice
// (both row means in one pass, then the write, the second walk served
// from L1). dgamma / dbeta: a block of 32 columns x 8 row lanes walks a
// chunk of `rows` rows (lane ty every 8th row) and adds its lanes in order
// into (chunks, 2C) partials; a second kernel adds each column's chunks in
// order and rounds once. Up to three launches a call, x and ct read twice.
//
// Accesses are 16-byte (4 floats or 8 16-bit values) when C is a multiple
// of that unit and every pointer read or written in units is 16-byte
// aligned, one value at a time otherwise.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "vec_io.cuh"

namespace {

namespace cg = cooperative_groups;
using mxio::Io;

constexpr int kRegRowMax = 1024;  // longest row held in a warp's registers
constexpr int kMaxDevices = 64;
// the register route's shared memory: gamma as float32 (kRegRowMax) and the
// warps' column sums (16 warps x 2 x 512, or 8 x 2 x 1024, floats)
constexpr int kRegSmem = (kRegRowMax + 16 * 2 * 512) * 4;
constexpr int kBatch = 8;          // a lane's partial loads in flight
constexpr int kWalkThreads = 256;  // walked dx: 8 rows per block
constexpr int kCols = 32;          // walked dparams: columns per block
constexpr int kLanes = 8;          // walked dparams: row lanes per block
constexpr int kFinalThreads = 256;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// unit u (W values) of a float32 row in shared memory: read, write
template <int W>
__device__ __forceinline__ void smem_load(const float* s, int u, float* f) {
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int i = 0; i < W / 4; ++i) {
      const float4 v = reinterpret_cast<const float4*>(s)[u * (W / 4) + i];
      f[4 * i] = v.x;
      f[4 * i + 1] = v.y;
      f[4 * i + 2] = v.z;
      f[4 * i + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i) f[i] = s[u * W + i];
  }
}

template <int W>
__device__ __forceinline__ void smem_store(float* s, int u, const float* f) {
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int i = 0; i < W / 4; ++i)
      reinterpret_cast<float4*>(s)[u * (W / 4) + i] =
          make_float4(f[4 * i], f[4 * i + 1], f[4 * i + 2], f[4 * i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i) s[u * W + i] = f[i];
  }
}

// the units of row r a lane holds (units lane + 32 k below `units`), as
// stored, and the row's statistics
template <typename T, int W, int K>
__device__ __forceinline__ void fetch_row(
    const T* __restrict__ x, const T* __restrict__ ct,
    const float* __restrict__ mean, const float* __restrict__ rstd, int r,
    int c, int units, int lane, typename Io<T, W>::Raw (&rx)[K],
    typename Io<T, W>::Raw (&rc)[K], float& mu, float& rs) {
  const int64_t off = static_cast<int64_t>(r) * c;
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (lane + 32 * k < units) {
      rx[k] = Io<T, W>::raw(x + off, lane + 32 * k);
      rc[k] = Io<T, W>::raw(ct + off, lane + 32 * k);
    }
  mu = mean[r];
  rs = rstd[r];
}

// The register route: a lane holds K units of W values of a row
template <typename T, int W, int K, int WARPS>
__global__ void __launch_bounds__(WARPS * 32, 1)
    ln_bwd_regs(const T* __restrict__ x, const T* __restrict__ g,
                const T* __restrict__ ct, const float* __restrict__ mean,
                const float* __restrict__ rstd, T* __restrict__ dx,
                T* __restrict__ dgdb, float* __restrict__ part, int n,
                int c) {
  extern __shared__ float4 smem4[];
  float* gs = reinterpret_cast<float*>(smem4);  // gamma, float32
  float* red = gs + kRegRowMax;                 // WARPS x 2c column sums
  using Raw = typename Io<T, W>::Raw;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int units = c / W;
  const int stride = gridDim.x * WARPS;
  const bool want_dx = dx != nullptr, want_dp = dgdb != nullptr;
  const float inv_c = 1.0f / static_cast<float>(c);

  // the first row in flight before gamma is staged
  int row = blockIdx.x * WARPS + warp;
  Raw rx[K], rc[K];
  float next_mu = 0.0f, next_rs = 0.0f;
  if (row < n)
    fetch_row<T, W, K>(x, ct, mean, rstd, row, c, units, lane, rx, rc,
                       next_mu, next_rs);
  if (want_dx) {
    for (int u = threadIdx.x; u < units; u += WARPS * 32) {
      float f[W];
      Io<T, W>::load(g, u, f);
#pragma unroll
      for (int w = 0; w < W; ++w) gs[u * W + w] = f[w];
    }
    __syncthreads();
  }

  float dg[K][W], db[K][W];
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int w = 0; w < W; ++w) dg[k][w] = db[k][w] = 0.0f;
  for (; row < n; row += stride) {
    float xv[K][W], cv[K][W];
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (lane + 32 * k < units) {
        Io<T, W>::widen(rx[k], xv[k]);
        Io<T, W>::widen(rc[k], cv[k]);
      }
    const float mu = next_mu, rs = next_rs;
    if (row + stride < n)
      fetch_row<T, W, K>(x, ct, mean, rstd, row + stride, c, units, lane,
                         rx, rc, next_mu, next_rs);

    float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (lane + 32 * k < units) {
        float gf[W];
        if (want_dx) smem_load<W>(gs, lane + 32 * k, gf);
#pragma unroll
        for (int w = 0; w < W; ++w) {
          const float xh = __fmul_rn(xv[k][w] - mu, rs);
          if (want_dp) {
            dg[k][w] = fmaf(cv[k][w], xh, dg[k][w]);
            db[k][w] += cv[k][w];
          }
          if (want_dx) {
            const float gy = __fmul_rn(cv[k][w], gf[w]);
            s1 += gy;
            s2 = fmaf(gy, xh, s2);
            cv[k][w] = gy;
          }
          xv[k][w] = xh;
        }
      }
    if (want_dx) {
      const float m1 = warp_sum(s1) * inv_c;
      const float m2 = warp_sum(s2) * inv_c;
      T* dr = dx + static_cast<int64_t>(row) * c;
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (lane + 32 * k < units) {
#pragma unroll
          for (int w = 0; w < W; ++w)
            xv[k][w] = rs * (cv[k][w] - m1 - __fmul_rn(xv[k][w], m2));
          Io<T, W>::store(dr, lane + 32 * k, xv[k]);
        }
    }
  }
  if (!want_dp) return;

  // block: the warps' column sums, in warp order
  float* mine = red + warp * 2 * c;
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (lane + 32 * k < units) {
      smem_store<W>(mine, lane + 32 * k, dg[k]);
      smem_store<W>(mine + c, lane + 32 * k, db[k]);
    }
  __syncthreads();
  for (int col = threadIdx.x; col < 2 * c; col += WARPS * 32) {
    float v[WARPS];
#pragma unroll
    for (int w = 0; w < WARPS; ++w) v[w] = red[w * 2 * c + col];
    float s = v[0];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) s += v[w];
    part[static_cast<int64_t>(blockIdx.x) * 2 * c + col] = s;
  }

  // grid: every block's partial row written, then each column by a warp
  // (consecutive columns on consecutive blocks); a lane's loads are issued
  // kBatch at a time, then added in block order
  cg::this_grid().sync();
  const int blocks = gridDim.x;
  for (int col = warp * blocks + blockIdx.x; col < 2 * c; col += stride) {
    float s = 0.0f;
    for (int b0 = lane; b0 < blocks; b0 += 32 * kBatch) {
      float v[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int b = b0 + 32 * i;
        v[i] = b < blocks
                   ? __ldcg(part + static_cast<int64_t>(b) * 2 * c + col)
                   : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < kBatch; ++i) s += v[i];
    }
    s = warp_sum(s);
    if (lane == 0) Io<T, 1>::store(dgdb, col, &s);
  }
}

// The walked route's dx: one warp per row, each lane walking units of W
// values (W divides c)
template <typename T, int W>
__global__ void __launch_bounds__(kWalkThreads)
    ln_bwd_dx_walk(const T* __restrict__ x, const T* __restrict__ g,
                   const T* __restrict__ ct, const float* __restrict__ mean,
                   const float* __restrict__ rstd, T* __restrict__ dx,
                   int n, int c) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= n) return;
  const int64_t off = static_cast<int64_t>(row) * c;
  const T* xr = x + off;
  const T* cr = ct + off;
  T* dr = dx + off;
  const float mu = mean[row];
  const float rs = rstd[row];
  const int units = c / W;
  const float inv_c = 1.0f / static_cast<float>(c);
  float xf[W], cf[W], gf[W];

  float s1 = 0.0f, s2 = 0.0f;
  for (int i = lane; i < units; i += 32) {
    Io<T, W>::load(xr, i, xf);
    Io<T, W>::load(cr, i, cf);
    Io<T, W>::load(g, i, gf);
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const float y = __fmul_rn(cf[k], gf[k]);
      s1 += y;
      s2 = fmaf(y, __fmul_rn(xf[k] - mu, rs), s2);
    }
  }
  const float m1 = warp_sum(s1) * inv_c;
  const float m2 = warp_sum(s2) * inv_c;

  for (int i = lane; i < units; i += 32) {
    Io<T, W>::load(xr, i, xf);
    Io<T, W>::load(cr, i, cf);
    Io<T, W>::load(g, i, gf);
#pragma unroll
    for (int k = 0; k < W; ++k)
      xf[k] = rs * (__fmul_rn(cf[k], gf[k]) - m1 -
                    __fmul_rn(__fmul_rn(xf[k] - mu, rs), m2));
    Io<T, W>::store(dr, i, xf);
  }
}

// The walked route's parameter gradients, stage 1: one chunk of `rows`
// rows for 32 columns, 8 row lanes, into part (chunks, 2c): dgamma's
// partials in columns [0, c), dbeta's in [c, 2c)
template <typename T>
__global__ void ln_dparams_walk(const T* __restrict__ x,
                                const T* __restrict__ ct,
                                const float* __restrict__ mean,
                                const float* __restrict__ rstd,
                                float* __restrict__ part, int n, int c,
                                int rows) {
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
      float cv, xv;
      Io<T, 1>::load(ct, i, &cv);
      Io<T, 1>::load(x, i, &xv);
      db += cv;
      dg = fmaf(cv, __fmul_rn(xv - mean[r], rstd[r]), dg);
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
    float* p = part + static_cast<int64_t>(chunk) * 2 * c;
    p[col] = a;
    p[c + col] = b;
  }
}

// stage 2: each of the 2c columns adds its `chunks` partials in order
template <typename T>
__global__ void ln_dparams_walk_final(const float* __restrict__ part,
                                      T* __restrict__ dgdb, int c,
                                      int chunks) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= 2 * c) return;
  float a = 0.0f;
  for (int k = 0; k < chunks; ++k)
    a += part[static_cast<int64_t>(k) * 2 * c + col];
  Io<T, 1>::store(dgdb, col, &a);
}

template <typename T>
struct Args {
  const T* x;
  const T* g;
  const T* ct;
  const float* mean;
  const float* rstd;
  T* dx;
  T* dgdb;
  float* part;
  int n, c, part_rows;
};

// One register-route instance: the grid (blocks resident on every SM,
// read once per device and kept), then an ordinary launch (dx alone) or a
// cooperative one (the grid-wide barrier of the parameter gradients)
template <typename T, int W, int K, int WARPS>
cudaError_t launch_regs(Args<T> a, cudaStream_t st) {
  static int per_sm[kMaxDevices], sms[kMaxDevices];
  auto kern = ln_bwd_regs<T, W, K, WARPS>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (per_sm[dev] == 0) {
    int blocks = 0;
    if ((err = cudaFuncSetAttribute(
             kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
             kRegSmem)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &blocks, kern, WARPS * 32, kRegSmem)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(
             &sms[dev], cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return err;
    if (blocks < 1) return cudaErrorLaunchOutOfResources;
    per_sm[dev] = blocks;
  }
  const bool dp = a.dgdb != nullptr;
  int grid = std::min((a.n + WARPS - 1) / WARPS, per_sm[dev] * sms[dev]);
  if (dp) grid = std::min(grid, a.part_rows);
  grid = std::max(grid, 1);
  const size_t smem = (kRegRowMax + (dp ? WARPS * 2 * a.c : 0)) *
                      sizeof(float);
  if (!dp) {
    kern<<<grid, WARPS * 32, smem, st>>>(a.x, a.g, a.ct, a.mean, a.rstd,
                                         a.dx, a.dgdb, a.part, a.n, a.c);
    return cudaGetLastError();
  }
  void* params[] = {&a.x, &a.g, &a.ct, &a.mean, &a.rstd,
                    &a.dx, &a.dgdb, &a.part, &a.n, &a.c};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kern),
                                    dim3(grid), dim3(WARPS * 32), params,
                                    smem, st);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the caller raises with this code
    return err;
  }
  return cudaGetLastError();
}

// a lane's values: 8, 16 or 32, the fewest that hold the row
template <typename T, int W>
cudaError_t launch_w(const Args<T>& a, cudaStream_t st) {
  const int vals = ((a.c / W + 31) / 32) * W;
  if (vals <= 8) return launch_regs<T, W, (8 + W - 1) / W, 16>(a, st);
  if (vals <= 16) return launch_regs<T, W, 16 / W, 16>(a, st);
  return launch_regs<T, W, 32 / W, 8>(a, st);
}

template <typename T, int W>
cudaError_t launch_walk_dx(const Args<T>& a, cudaStream_t st) {
  const int blocks = static_cast<int>(
      (static_cast<int64_t>(a.n) * 32 + kWalkThreads - 1) / kWalkThreads);
  ln_bwd_dx_walk<T, W><<<blocks, kWalkThreads, 0, st>>>(
      a.x, a.g, a.ct, a.mean, a.rstd, a.dx, a.n, a.c);
  return cudaGetLastError();
}

// The walked route's chunking: 64-row chunks, larger (a multiple of 8)
// when N needs more than 65535 (the grid's y limit); at least one chunk
void walk_chunks(int n, int* rows, int* chunks) {
  int r = std::max(64, (n + 65534) / 65535);
  r = (r + 7) / 8 * 8;
  *rows = r;
  *chunks = std::max(1, (n + r - 1) / r);
}

template <typename T>
int launch(const void* x, const void* gamma, const void* ct,
           const void* mean, const void* rstd, void* dx, void* dgdb,
           void* part, int n, int c, int part_rows, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Args<T> a{static_cast<const T*>(x), static_cast<const T*>(gamma),
                  static_cast<const T*>(ct), static_cast<const float*>(mean),
                  static_cast<const float*>(rstd), static_cast<T*>(dx),
                  static_cast<T*>(dgdb), static_cast<float*>(part), n, c,
                  part_rows};
  const bool want_dx = dx != nullptr && n > 0, want_dp = dgdb != nullptr;
  if (c <= 0 || !(want_dx || want_dp))
    return static_cast<int>(cudaGetLastError());
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = c % kVec == 0 && mxio::aligned(x, 16) &&
                   mxio::aligned(ct, 16) &&
                   (!want_dx || (mxio::aligned(gamma, 16) &&
                                 mxio::aligned(dx, 16)));
  cudaError_t err = cudaSuccess;
  if (c <= kRegRowMax) {
    err = vec ? launch_w<T, kVec>(a, st) : launch_w<T, 1>(a, st);
    return static_cast<int>(err);
  }
  if (want_dx) {
    err = vec ? launch_walk_dx<T, kVec>(a, st) : launch_walk_dx<T, 1>(a, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (want_dp) {
    int rows, chunks;
    walk_chunks(n, &rows, &chunks);
    if (part_rows < chunks) return static_cast<int>(cudaErrorInvalidValue);
    if (n > 0) {
      const dim3 grid((c + kCols - 1) / kCols, chunks);
      ln_dparams_walk<T><<<grid, dim3(kCols, kLanes), 0, st>>>(
          a.x, a.ct, a.mean, a.rstd, a.part, n, c, rows);
      if ((err = cudaGetLastError()) != cudaSuccess)
        return static_cast<int>(err);
    }
    ln_dparams_walk_final<T>
        <<<(2 * c + kFinalThreads - 1) / kFinalThreads, kFinalThreads, 0,
           st>>>(a.part, a.dgdb, c, n > 0 ? chunks : 0);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

}  // namespace

// x, ct (n, c), gamma (c,), mean, rstd (n,) -> dx (n, c) and dgdb (2, c):
// dgamma in dgdb[0 .. c), dbeta in dgdb[c .. 2c). A null dx skips the
// input gradient (gamma may then be null), a null dgdb the parameter
// gradients (part may then be null). part: float32 scratch of part_rows
// rows of 2c values, part_rows >= 1 for c <= 1024 (the register route
// uses at most that many blocks) and >= the walked route's chunks,
// ceil(n / rows) with rows = max(64, ceil(n / 65535)) rounded up to a
// multiple of 8, above. All float32, contiguous, on one device. Returns
// the launch's CUDA error code (0 on success).
extern "C" int mx_ln_bwd_f32(const void* x, const void* gamma,
                             const void* ct, const void* mean,
                             const void* rstd, void* dx, void* dgdb,
                             void* part, int n, int c, int part_rows,
                             void* stream) {
  return launch<float>(x, gamma, ct, mean, rstd, dx, dgdb, part, n, c,
                       part_rows, stream);
}

// The same over bfloat16 x, gamma, ct, dx and dgdb; mean, rstd and part
// float32.
extern "C" int mx_ln_bwd_bf16(const void* x, const void* gamma,
                              const void* ct, const void* mean,
                              const void* rstd, void* dx, void* dgdb,
                              void* part, int n, int c, int part_rows,
                              void* stream) {
  return launch<__nv_bfloat16>(x, gamma, ct, mean, rstd, dx, dgdb, part, n,
                               c, part_rows, stream);
}

// The same over float16 x, gamma, ct, dx and dgdb; mean, rstd and part
// float32.
extern "C" int mx_ln_bwd_f16(const void* x, const void* gamma,
                             const void* ct, const void* mean,
                             const void* rstd, void* dx, void* dgdb,
                             void* part, int n, int c, int part_rows,
                             void* stream) {
  return launch<__half>(x, gamma, ct, mean, rstd, dx, dgdb, part, n, c,
                        part_rows, stream);
}
