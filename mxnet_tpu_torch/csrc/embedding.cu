// Embedding row gather with a fused scale, for Hopper (sm_90a).
//
// Replaces: mxnet_tpu/ops/pallas_kernels.py _emb_gather_kernel, launched by
// _pl_embedding (scalar-prefetched ids pick the weight block per grid step).
// Computes out[i, :] = W[ids[i], :] * scale, the multiply in float32.
//
// Bound: bytes. Each output row costs one table row read and one row
// written (2 * N * D * 4 bytes; 32 KiB at the decode path's N=8, D=512),
// no arithmetic to speak of. Design: one warp per output row, with 16-byte
// (float4) loads and stores along the row when D % 4 == 0 and both rows are
// 16-byte aligned (neighbouring lanes on neighbouring addresses), scalar
// accesses otherwise. The block loads its own ids; there is no prefetch
// stage to carry over.
//
// Out-of-range ids never read outside the table: an id in [-V, 0) counts
// from the end and any other id outside [0, V) writes a NaN row, which is
// jnp.take's default fill in the composition (mxnet_tpu/ops/tensor.py).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps: 8 rows per block

__global__ void emb_gather_f32(const int32_t* __restrict__ ids,
                               const float* __restrict__ w,
                               float* __restrict__ out, int n, int v, int d,
                               float scale) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= n) return;
  int64_t id = ids[row];
  if (id < 0) id += v;
  float* dst = out + static_cast<int64_t>(row) * d;
  if (id < 0 || id >= v) {
    const float nan = __int_as_float(0x7fc00000);
    for (int c = lane; c < d; c += 32) dst[c] = nan;
    return;
  }
  const float* src = w + id * static_cast<int64_t>(d);
  const bool vec = (d & 3) == 0 &&
                   ((reinterpret_cast<uintptr_t>(src) |
                     reinterpret_cast<uintptr_t>(dst)) & 15) == 0;
  if (vec) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int c = lane; c < (d >> 2); c += 32) {
      float4 x = s4[c];
      x.x *= scale;
      x.y *= scale;
      x.z *= scale;
      x.w *= scale;
      d4[c] = x;
    }
  } else {
    for (int c = lane; c < d; c += 32) dst[c] = src[c] * scale;
  }
}

}  // namespace

// ids (n,) int32, w (v, d) float32, out (n, d) float32, all contiguous on
// one device. Launches on `stream`; returns cudaGetLastError().
extern "C" int mx_embedding_f32(const void* ids, const void* w, void* out,
                                int n, int v, int d, float scale,
                                void* stream) {
  if (n > 0) {
    const int blocks = (n * 32 + kThreads - 1) / kThreads;
    emb_gather_f32<<<blocks, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(ids), static_cast<const float*>(w),
        static_cast<float*>(out), n, v, d, scale);
  }
  return static_cast<int>(cudaGetLastError());
}
