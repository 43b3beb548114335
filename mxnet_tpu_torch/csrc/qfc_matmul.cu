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
// package's Pallas variant does. Every product is a float32 FMA (no TF32
// or tensor-core MMA: the TPU kernel's product is Precision.HIGHEST).
//
// Bound. At the serving rungs (M <= 8; ResNet-50's head K = 2048, N = 1000)
// bytes: the weight is 2.05 MB of the 2.15 MB a call moves and each weight
// byte feeds 2 M flops, far below the card's operations-per-byte line; the
// 0.6 us the bytes take at 3.35 TB/s is below a launch's own latency, so
// what is left is one chain of dependent loads (weights, x, the sums) with
// as many loads in flight as the card takes. From M in the hundreds up,
// operations (2 M N K float32 flops on the CUDA cores).
//
// Two routes, one launch each; the wrapper picks one from the shapes
// (cuda_kernels._qfc_route: mt > 0 is the GEMV route with mt rows of x a
// block, mt = 0 the tiled route).
//
// GEMV route, small M. A block of 8 warps stages mt <= 4 rows of x once in
// shared memory as float32 (16-value units padded to 20 floats, so that a
// warp's 16-byte reads of 32 consecutive units take the minimum of
// wavefronts), zeros past K and past M. Each warp owns 4 output channels
// and one of ks splits of K (the units [split * per, split * per + per),
// per = ceil(ceil(K / 16) / ks)); lane l takes the split's units l, l + 32,
// ... Before it touches x a lane issues the 16-byte loads of 2 units of
// each of its 4 weight rows (the first ones before x is staged, so that
// they fly under the staging), then decodes each 4-byte word (int8 through
// __byte_perm into a float's mantissa, exact; e4m3 through half with the
// hardware conversion, exact: every e4m3 value is a float16), scales it
// and applies the 4 scaled weights of each channel to all mt rows while
// they are in registers: every x read feeds 16 FMAs. A lane sums its units
// in order; a warp's lanes are summed by a shuffle butterfly (xor 16, 8,
// 4, 2, 1: every lane holds the same bits); the ks warps of a channel group
// add their sums in split order through shared memory. No float atomics:
// two calls on the same inputs give the same bits. ks splits K where N
// gives few warps (ks is the least power of two, at most 8 and at most
// K / 512, that fills the card's SMs with blocks). A weight row is read as
// 16-byte units where K is a multiple of 16 and the weight is 16-byte
// aligned, else one byte at a time (zeros past K); x is staged 4 values at
// a time, 8 such loads a thread in flight before any is widened and
// stored, where its pointer and K allow, else one value at a time.
//
// Tiled route, large M. One 256-thread block per 64 x 64 output tile loops
// over K in chunks of 16; each chunk of x rows and of decoded, scaled
// weight rows is staged in shared memory, transposed, so that the inner
// loop reads both without bank conflicts, and each thread keeps a 4 x 4
// register tile of float32 FMAs. Every load is one element under a mask,
// so any M, N and K (K = 13 included) is taken. At small M most of a tile
// is masked and N = 1000 gives 16 blocks for 132 SMs. Until its tiles fill
// the card a call takes one tile's time, then grows with the tiles; the
// GEMV route's time grows with M N. The wrapper takes the GEMV route while
// M N is below both (cuda_kernels._qfc_gemv_wins, fit to the route-break
// table in PERF.md at N = 1000, 4096 and 32000): at ResNet-50's head up to
// M = 976, at N = 32000 up to M ~ 50.
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "vec_io.cuh"

namespace {

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

// The 4 weights of a little-endian 32-bit word, byte 0 first, as float32.
// int8: 0x4B0000bb is 2^23 + bb as a float; with bb = b ^ 0x80 the
// difference 2^23 + bb - (2^23 + 128) is b, exactly.
__device__ __forceinline__ void decode4(uint32_t word, float* f, I8) {
  const uint32_t v = word ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __int_as_float(static_cast<int>(
               __byte_perm(v, 0x4B000000u, 0x7440u + i))) -
           8388736.0f;
}

__device__ __forceinline__ void decode4(uint32_t word, float* f, E4M3) {
  const __half2 lo(__nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(word & 0xffffu), __NV_E4M3));
  const __half2 hi(__nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(word >> 16), __NV_E4M3));
  const float2 a = __half22float2(lo), b = __half22float2(hi);
  f[0] = a.x;
  f[1] = a.y;
  f[2] = b.x;
  f[3] = b.y;
}

__device__ __forceinline__ float widen(float v) { return v; }
template <typename H>
__device__ __forceinline__ float widen(H v) {
  return mxio::Half<H>::widen(v);
}

// ==========================================================================
// GEMV route
// ==========================================================================
constexpr int kGvWarps = 8;                 // warps a block
constexpr int kGvThreads = 32 * kGvWarps;
constexpr int kNr = 4;                      // output channels a warp
constexpr int kChunk = 2;                   // units a lane loads at once
constexpr int kPitch = 20;                  // floats a staged 16-value unit
constexpr int kStage = 8;                   // x loads a thread in flight

// One 16-byte unit (16 weights) of row `row`: one load where `vec`, else
// 16 byte loads with zeros past K
__device__ __forceinline__ uint4 load_unit(const uint8_t* __restrict__ w,
                                           int64_t row, int u, int k,
                                           bool vec) {
  if (vec) return __ldg(reinterpret_cast<const uint4*>(w + row * k) + u);
  uint32_t word[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    const int kk = 16 * u + e;
    if (kk < k)
      word[e / 4] |= static_cast<uint32_t>(__ldg(w + row * k + kk))
                     << (8 * (e % 4));
  }
  return make_uint4(word[0], word[1], word[2], word[3]);
}

template <typename W, typename X, int MT>
__global__ void __launch_bounds__(kGvThreads, 2)
    qfc_gemv(const X* __restrict__ x, const uint8_t* __restrict__ w,
             const float* __restrict__ s, float* __restrict__ out, int m,
             int n, int k, int ks, int vec_w) {
  extern __shared__ float4 smem4[];
  const int units = (k + 15) / 16;
  float* xs = reinterpret_cast<float*>(smem4);  // [MT][units][kPitch]
  float* red = xs + MT * units * kPitch;        // [kGvWarps][kNr * MT]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int groups = kGvWarps / ks;
  const int g = warp / ks, split = warp % ks;
  // blocks walk the channel chunks of one band of mt rows, then the next
  const int chunks = (n + groups * kNr - 1) / (groups * kNr);
  const int chunk = blockIdx.x % chunks;
  const int n0 = (chunk * groups + g) * kNr;        // the warp's channels
  const int m0 = (blockIdx.x / chunks) * MT;
  const int per = (units + ks - 1) / ks;
  const int u_lo = split * per, u_hi = min(units, u_lo + per);
  const bool vec = vec_w != 0;

  float sc[kNr];
#pragma unroll
  for (int r = 0; r < kNr; ++r) sc[r] = n0 + r < n ? __ldg(s + n0 + r) : 0.0f;
  uint4 raw[kChunk][kNr];
  auto load = [&](int base) {
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      const int u = base + 32 * c;
#pragma unroll
      for (int r = 0; r < kNr; ++r)
        raw[c][r] = (u < u_hi && n0 + r < n)
                        ? load_unit(w, n0 + r, u, k, vec)
                        : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  load(u_lo + lane);  // in flight while x is staged

  // x rows m0 .. m0 + MT - 1 as float32 units, zeros past K and past M:
  // kStage aligned 4-value loads a thread in flight before any is widened
  // and stored, where x's pointer and K allow; else one value at a time
  const int slots = MT * units * 4;  // unit e / 4 of the rows, quarter e % 4
  if (k % 4 == 0 &&
      reinterpret_cast<uintptr_t>(x) % (4 * sizeof(X)) == 0) {
    using Io4 = mxio::Io<X, 4>;
    for (int e0 = tid; e0 < slots; e0 += kGvThreads * kStage) {
      typename Io4::Raw raw_x[kStage];
      bool live[kStage];
#pragma unroll
      for (int b = 0; b < kStage; ++b) {
        const int e = e0 + b * kGvThreads, r = e / (units * 4);
        const int kk = 4 * (e % (units * 4));  // 16 u + 4 q
        live[b] = e < slots && m0 + r < m && kk < k;
        if (live[b])
          raw_x[b] = Io4::raw(x + static_cast<int64_t>(m0 + r) * k + kk, 0);
      }
#pragma unroll
      for (int b = 0; b < kStage; ++b) {
        const int e = e0 + b * kGvThreads;
        float f[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if (live[b]) Io4::widen(raw_x[b], f);
        if (e < slots)
          *reinterpret_cast<float4*>(xs + (e / 4) * kPitch + 4 * (e % 4)) =
              make_float4(f[0], f[1], f[2], f[3]);
      }
    }
  } else {
    for (int e = tid; e < slots * 4; e += kGvThreads) {
      const int r = e / (units * 16), kk = e % (units * 16);
      xs[(e / 16) * kPitch + e % 16] =
          m0 + r < m && kk < k
              ? widen(x[static_cast<int64_t>(m0 + r) * k + kk]) : 0.0f;
    }
  }
  __syncthreads();

  float acc[kNr][MT];
#pragma unroll
  for (int r = 0; r < kNr; ++r)
#pragma unroll
    for (int i = 0; i < MT; ++i) acc[r][i] = 0.0f;
  for (int base = u_lo + lane; base < u_hi; base += 32 * kChunk) {
    if (base != u_lo + lane) load(base);
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      const int u = base + 32 * c;
      if (u >= u_hi) break;
#pragma unroll
      for (int q = 0; q < 4; ++q) {  // the unit's word q: values 4q .. 4q+3
        float wf[kNr][4];
#pragma unroll
        for (int r = 0; r < kNr; ++r) {
          const uint32_t word = q == 0   ? raw[c][r].x
                                : q == 1 ? raw[c][r].y
                                : q == 2 ? raw[c][r].z
                                         : raw[c][r].w;
          decode4(word, wf[r], W());
#pragma unroll
          for (int e = 0; e < 4; ++e) wf[r][e] = __fmul_rn(wf[r][e], sc[r]);
        }
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const float4 xv = *reinterpret_cast<const float4*>(
              xs + (i * units + u) * kPitch + 4 * q);
#pragma unroll
          for (int r = 0; r < kNr; ++r) {
            acc[r][i] = fmaf(xv.x, wf[r][0], acc[r][i]);
            acc[r][i] = fmaf(xv.y, wf[r][1], acc[r][i]);
            acc[r][i] = fmaf(xv.z, wf[r][2], acc[r][i]);
            acc[r][i] = fmaf(xv.w, wf[r][3], acc[r][i]);
          }
        }
      }
    }
  }

  // the warp's lanes, then the channel group's splits in split order
#pragma unroll
  for (int r = 0; r < kNr; ++r)
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      float v = acc[r][i];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, o);
      if (lane == 0) red[warp * kNr * MT + r * MT + i] = v;
    }
  __syncthreads();
  if (tid < groups * kNr * MT) {
    const int gi = tid / (kNr * MT), j = tid % (kNr * MT);
    const int r = j / MT, i = j % MT;
    const int gn = (chunk * groups + gi) * kNr + r, gm = m0 + i;
    float tot = red[gi * ks * kNr * MT + j];
    for (int sp = 1; sp < ks; ++sp) tot += red[(gi * ks + sp) * kNr * MT + j];
    if (gn < n && gm < m) out[static_cast<int64_t>(gm) * n + gn] = tot;
  }
}

// dynamic shared memory of the GEMV route: the staged x and the sums
__host__ __device__ constexpr int gemv_smem(int mt, int k) {
  return (mt * ((k + 15) / 16) * kPitch + kGvWarps * kNr * mt) * 4;
}

template <typename W, typename X, int MT>
int launch_gemv(const void* x, const void* w, const void* s, void* out,
                int m, int n, int k, int ks, cudaStream_t st) {
  const int bytes = gemv_smem(MT, k);
  cudaError_t err = cudaFuncSetAttribute(
      qfc_gemv<W, X, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int per_block = kNr * (kGvWarps / ks);
  const int64_t chunks = (n + per_block - 1) / per_block;
  const int64_t grid = chunks * ((m + MT - 1) / MT);  // one axis: any M
  if (grid > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const int vec_w = k % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  qfc_gemv<W, X, MT><<<unsigned(grid), kGvThreads, bytes, st>>>(
      static_cast<const X*>(x), static_cast<const uint8_t*>(w),
      static_cast<const float*>(s), static_cast<float*>(out), m, n, k, ks,
      vec_w);
  return static_cast<int>(cudaGetLastError());
}

// ==========================================================================
// Tiled route
// ==========================================================================
constexpr int kBM = 64, kBN = 64, kBK = 16, kThreads = 256, kPad = 4;

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
           int n, int k, int mt, int ks, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mt) {
    case 1: return launch_gemv<W, X, 1>(x, w, s, out, m, n, k, ks, st);
    case 2: return launch_gemv<W, X, 2>(x, w, s, out, m, n, k, ks, st);
    case 4: return launch_gemv<W, X, 4>(x, w, s, out, m, n, k, ks, st);
    case 0: break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (ks != 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  qfc_matmul_f32<W, X><<<grid, kThreads, 0, st>>>(
      static_cast<const X*>(x), static_cast<const uint8_t*>(w),
      static_cast<const float*>(s), static_cast<float*>(out), m, n, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (m, k) float32, w (n, k) one byte per weight, s (n,) float32 ->
// out (m, n) float32; contiguous, one device. The route: mt in {1, 2, 4}
// the GEMV route with mt rows of x a block and K split over ks in {1, 2, 4,
// 8} warps; mt = 0 (with ks = 1) the tiled route. Returns
// cudaGetLastError() (cudaErrorInvalidValue for another route).
extern "C" int mx_qfc_matmul_i8_f32(const void* x, const void* w,
                                    const void* s, void* out, int m, int n,
                                    int k, int mt, int ks, void* stream) {
  return launch<I8>(x, w, s, out, m, n, k, mt, ks, stream);
}

extern "C" int mx_qfc_matmul_e4m3_f32(const void* x, const void* w,
                                      const void* s, void* out, int m, int n,
                                      int k, int mt, int ks, void* stream) {
  return launch<E4M3>(x, w, s, out, m, n, k, mt, ks, stream);
}

// The same over bfloat16 or float16 x; s and out stay float32.
extern "C" int mx_qfc_matmul_i8_bf16(const void* x, const void* w,
                                     const void* s, void* out, int m, int n,
                                     int k, int mt, int ks, void* stream) {
  return launch<I8, __nv_bfloat16>(x, w, s, out, m, n, k, mt, ks, stream);
}

extern "C" int mx_qfc_matmul_e4m3_bf16(const void* x, const void* w,
                                       const void* s, void* out, int m,
                                       int n, int k, int mt, int ks,
                                       void* stream) {
  return launch<E4M3, __nv_bfloat16>(x, w, s, out, m, n, k, mt, ks, stream);
}

extern "C" int mx_qfc_matmul_i8_f16(const void* x, const void* w,
                                    const void* s, void* out, int m, int n,
                                    int k, int mt, int ks, void* stream) {
  return launch<I8, __half>(x, w, s, out, m, n, k, mt, ks, stream);
}

extern "C" int mx_qfc_matmul_e4m3_f16(const void* x, const void* w,
                                      const void* s, void* out, int m, int n,
                                      int k, int mt, int ks, void* stream) {
  return launch<E4M3, __half>(x, w, s, out, m, n, k, mt, ks, stream);
}
