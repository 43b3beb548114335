// Embedding row gather with a fused scale, for Hopper (sm_90a).
//
// Replaces: mxnet_tpu/ops/pallas_kernels.py _emb_gather_kernel, launched by
// _pl_embedding (scalar-prefetched ids pick the weight block per grid step).
// Computes out[i, :] = W[ids[i], :] * scale, the multiply in float32. Three
// instances: float32, and bfloat16 or float16 (the mixed-precision path),
// which widens
// each value exactly, scales it in float32 and rounds the product to
// nearest even once, as the TPU kernel's (x.astype(f32) * scale).astype(
// bf16) does; at scale 1 the row is copied exactly.
//
// Bound: bytes. Each output row costs one table row read and one row
// written (2 * N * D * sizeof(T) bytes; 32 KiB at the decode path's N=8,
// D=512 in float32), no arithmetic to speak of. Design: one warp per output
// row, with 16-byte accesses along the row (4 floats or 8 16-bit values,
// vec_io.cuh) when D is a multiple of that unit and both rows are 16-byte
// aligned (neighbouring lanes on neighbouring addresses), one value at a
// time otherwise. The block loads its own ids; there is no prefetch stage
// to carry over.
//
// Out-of-range ids never read outside the table: an id in [-V, 0) counts
// from the end and any other id outside [0, V) writes a NaN row, which is
// jnp.take's default fill in the composition (mxnet_tpu/ops/tensor.py).
#include <cuda_runtime.h>
#include <stdint.h>

#include "vec_io.cuh"

namespace {

using mxio::Io;

constexpr int kThreads = 256;  // 8 warps: 8 rows per block

// One warp per output row; each lane walks units of W values (W divides d).
template <typename T, int W>
__global__ void emb_gather(const int32_t* __restrict__ ids,
                           const T* __restrict__ w, T* __restrict__ out,
                           int n, int v, int d, float scale) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= n) return;
  int64_t id = ids[row];
  if (id < 0) id += v;
  T* dst = out + static_cast<int64_t>(row) * d;
  const int units = d / W;
  float f[W];
  if (id < 0 || id >= v) {
#pragma unroll
    for (int k = 0; k < W; ++k) f[k] = __int_as_float(0x7fc00000);
    for (int c = lane; c < units; c += 32) Io<T, W>::store(dst, c, f);
    return;
  }
  const T* src = w + id * static_cast<int64_t>(d);
  for (int c = lane; c < units; c += 32) {
    Io<T, W>::load(src, c, f);
#pragma unroll
    for (int k = 0; k < W; ++k) f[k] *= scale;
    Io<T, W>::store(dst, c, f);
  }
}

// W: the widest unit of 16 bytes (4 floats, 8 bfloat16) when every row can
// take it, else 1
template <typename T>
void launch(const void* ids, const void* w, void* out, int n, int v, int d,
            float scale, cudaStream_t st) {
  constexpr int kVec = 16 / sizeof(T);
  const int blocks = (n * 32 + kThreads - 1) / kThreads;
  const int32_t* i32 = static_cast<const int32_t*>(ids);
  const T* wt = static_cast<const T*>(w);
  T* ot = static_cast<T*>(out);
  if (d % kVec == 0 && mxio::aligned(w, 16) && mxio::aligned(out, 16))
    emb_gather<T, kVec><<<blocks, kThreads, 0, st>>>(i32, wt, ot, n, v, d,
                                                     scale);
  else
    emb_gather<T, 1><<<blocks, kThreads, 0, st>>>(i32, wt, ot, n, v, d,
                                                  scale);
}

}  // namespace

// ids (n,) int32, w (v, d) float32, out (n, d) float32, all contiguous on
// one device. Launches on `stream`; returns cudaGetLastError().
extern "C" int mx_embedding_f32(const void* ids, const void* w, void* out,
                                int n, int v, int d, float scale,
                                void* stream) {
  if (n > 0 && d > 0)
    launch<float>(ids, w, out, n, v, d, scale,
                  static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// The same over a bfloat16 table and output.
extern "C" int mx_embedding_bf16(const void* ids, const void* w, void* out,
                                 int n, int v, int d, float scale,
                                 void* stream) {
  if (n > 0 && d > 0)
    launch<__nv_bfloat16>(ids, w, out, n, v, d, scale,
                          static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// The same over a float16 table and output.
extern "C" int mx_embedding_f16(const void* ids, const void* w, void* out,
                                int n, int v, int d, float scale,
                                void* stream) {
  if (n > 0 && d > 0)
    launch<__half>(ids, w, out, n, v, d, scale,
                   static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
