// Flash-attention forward (self-attention, optional causal mask), for
// Hopper (sm_90a).
//
// Replaces: mxnet_tpu/rtc.py _flash_kernel (partial=False), launched by
// _flash_call from flash_attention. For every (b, h) row and query t < T
// it computes
//   softmax_k( (q[t] * Dh^-1/2) . k[k] )  over k < T (and k <= t if causal)
// and the weighted sum of v over the same keys, with the TPU kernel's
// online softmax in float32: q is scaled before the product; per key tile
//   m_new = max(m, max_k s),  m_safe = m_new if finite else 0,
//   p = exp(s - m_safe) where s is finite else 0,
//   corr = exp(m - m_safe) where m is finite else 0,
//   l = l * corr + sum_k p,  acc = acc * corr + p . v
// and out = acc / max(l, 1e-30). q, k, v and out are (B*H, T, Dh).
// Three instances: float32, and bfloat16 or float16 (the mixed-precision path:
// q, k, v and out bfloat16), which widens each Q, K and V tile exactly as it
// stages it into the float32 shared tiles (16 bytes, 8 values, a load),
// scales q in float32 before the product and computes every product and
// the online softmax in float32 as the float32 instance does, and rounds
// the output to nearest even once. It uses no 16-bit tensor cores:
// they would round q * scale and p to 16 bits, which the TPU kernel
// (float32 operands at Precision.HIGHEST) does not; shared memory is the
// float32 instance's (117,760 bytes at Dh = 128).
//
// Bound: operations. The two products take 4 * T * T * Dh flops per
// (b, h) row (half of that under the causal mask), against 4 * T * Dh * 4
// bytes moved (half that in bfloat16); at T = 1024, Dh = 64 that is ~250
// flops per byte (~500 in bfloat16), far above the float32 line of ~20.
// Every product is a float32 FMA on the CUDA cores: no tensor cores and
// so no TF32, which the reference's Precision.HIGHEST rules out. Design:
// one block of 256 threads per (b*h, 64-query tile); the block LOOPS
// over 64-key tiles (the TPU kernel's sequential grid axis), staging the
// scaled Q tile once and each K and V tile in shared memory, keeping m, l
// and the output accumulator in registers. Each thread owns 4 query rows (the same rows in S and in the
// accumulator, so corr applies in place) and 4 keys of S, taken 16 apart
// so the float4 reads of K rows (padded by 4 floats) hit distinct banks;
// a row's max and sum reduce over the 16 lanes that share it. P goes
// through shared memory, stored key-major, for the P.V product. Causal key
// tiles wholly above the diagonal are not visited, and the query tiles
// with the most keys are scheduled first. Any T is taken: the last query
// and key tiles are masked in the kernel (keys past T get -inf scores,
// queries past T are not written). Dh is a template parameter, 64 or
// 128, and so is the element type.
//
// Partial mode (template flag PARTIAL; the mx_flash_attention_partial_*
// entry points). Replaces: mxnet_tpu/rtc.py _flash_kernel(partial=True),
// launched by _flash_call from flash_attention_partial, the local block
// of ring attention (mxnet_tpu/parallel/ring_attention.py
// _ring_attention_flash). q is one query shard (B*H, Tq, Dh) and k, v the
// K/V shard the ring position holds (B*H, Tk, Dh), Tq and Tk free; q_off
// and k_off are the shards' absolute sequence offsets, and the causal test
// is q_off + t >= k_off + key. The key loop is the same; at its end the
// kernel writes the registers it holds instead of acc / l: the
// unnormalized accumulator acc (B*H, Tq, Dh) and the running max m and
// normalizer l (B*H, Tq), all float32, whatever the element type. Key tiles
// wholly above the diagonal are not visited, so a query row that sees no
// key keeps the initial m = -inf, l = 0, acc = 0, as the TPU kernel's
// scratch does. Bound: operations, as above, at the block's share of the
// work (half a block on the diagonal, none above it).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "vec_io.cuh"

namespace {

using mxio::Io;

constexpr int kThreads = 256;
constexpr int kBq = 64;  // query rows per block
constexpr int kBk = 64;  // keys per shared-memory tile
constexpr int kPadP = kBq + 4;

template <int DH>
constexpr int smem_floats() {
  return kBq * (DH + 4) + kBk * (DH + 4) + kBk * DH + kBk * kPadP;
}

__device__ __forceinline__ float max16(float v) {
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float sum16(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Stage kBk rows of one (b, h) row's (T, DH) operand, from row r0 on, into
// a float32 shared tile with leading dimension ld, times `scale` (in
// float32, after the exact widening), zeros past T: units of W = 16 /
// sizeof(E) values, one 16-byte load each, stored as W / 4 float4s.
template <typename E, int DH>
__device__ __forceinline__ void stage(const E* __restrict__ src, int r0,
                                      int T_, float scale, float* dst,
                                      int ld) {
  constexpr int kW = 16 / sizeof(E);
  constexpr int kUnits = DH / kW;  // 16-byte units per row
  for (int e = threadIdx.x; e < kBk * kUnits; e += kThreads) {
    const int r = e / kUnits, u = e % kUnits;
    float f[kW];
    if (r0 + r < T_) {
      Io<E, kW>::load(src, static_cast<int64_t>(r0 + r) * kUnits + u, f);
#pragma unroll
      for (int i = 0; i < kW; ++i) f[i] *= scale;
    } else {
#pragma unroll
      for (int i = 0; i < kW; ++i) f[i] = 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kW; i += 4)
      *reinterpret_cast<float4*>(dst + r * ld + u * kW + i) =
          make_float4(f[i], f[i + 1], f[i + 2], f[i + 3]);
  }
}

// One launch's operands: q (bh, Tq, DH), k and v (bh, Tk, DH); out (bh,
// Tq, DH) in E for the normalized mode, acc (bh, Tq, DH), m and l (bh, Tq)
// float32 for the partial mode (the other outputs are null).
struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* acc;
  float* m;
  float* l;
  int bh, Tq, Tk, q_off, k_off, causal;
  float scale;
};

template <typename E, int DH, bool PARTIAL>
__global__ void __launch_bounds__(kThreads) flash_fwd(const Args op, int n_qt) {
  static_assert(kBq == kBk, "stage() walks kBk rows for Q tiles too");
  constexpr int kLd = DH + 4;    // padded row of the Q and K tiles
  constexpr int kNv = DH / 64;   // float4 groups of the accumulator
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [kBq][kLd], scaled
  float* ks = qs + kBq * kLd;                   // [kBk][kLd]
  float* vs = ks + kBk * kLd;                   // [kBk][DH]
  float* ps = vs + kBk * DH;                    // [kBk][kPadP], key-major

  const int t = threadIdx.x;
  const int tx = t & 15;   // keys tx + 16 i of S; columns of the output
  const int ty = t >> 4;   // query rows 4 ty .. 4 ty + 3
  const int bh = blockIdx.y;
  const int Tq = op.Tq, Tk = op.Tk, causal = op.causal;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x)) * kBq;
  const int64_t q_base = static_cast<int64_t>(bh) * Tq * DH;
  const int64_t k_base = static_cast<int64_t>(bh) * Tk * DH;
  const E* qb = static_cast<const E*>(op.q) + q_base;
  const E* kb = static_cast<const E*>(op.k) + k_base;
  const E* vb = static_cast<const E*>(op.v) + k_base;
  // the causal test in shard-local positions: key kp is live for query qp
  // when k_off + kp <= q_off + qp, i.e. kp <= qp + shift
  const int shift = op.q_off - op.k_off;

  stage<E, DH>(qb, q0, Tq, op.scale, qs, kLd);

  float m[4], l[4], acc[4][kNv * 4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    m[j] = -INFINITY;
    l[j] = 0.0f;
#pragma unroll
    for (int e = 0; e < kNv * 4; ++e) acc[j][e] = 0.0f;
  }

  // key tiles wholly above the tile's last query row are not visited
  const int k_end = causal ? min(Tk, q0 + kBq + shift) : Tk;
  for (int k0 = 0; k0 < k_end; k0 += kBk) {
    __syncthreads();  // the previous tile is consumed (and qs is ready)
    stage<E, DH>(kb, k0, Tk, 1.0f, ks, kLd);
    stage<E, DH>(vb, k0, Tk, 1.0f, vs, DH);
    __syncthreads();

    // S = (q * scale) . k for 4 rows x 4 keys
    float s[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
      float4 a[4], b[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        a[j] = *reinterpret_cast<const float4*>(qs + (ty * 4 + j) * kLd + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        b[i] = *reinterpret_cast<const float4*>(ks + (tx + 16 * i) * kLd + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[j][i] = fmaf(a[j].x, b[i].x, s[j][i]);
          s[j][i] = fmaf(a[j].y, b[i].y, s[j][i]);
          s[j][i] = fmaf(a[j].z, b[i].z, s[j][i]);
          s[j][i] = fmaf(a[j].w, b[i].w, s[j][i]);
        }
    }

    // mask, then the online-softmax update of each of the 4 rows
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int qp = q0 + ty * 4 + j;
      float mb = -INFINITY;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kp = k0 + tx + 16 * i;
        const bool live = kp < Tk && (!causal || kp <= qp + shift);
        s[j][i] = live ? s[j][i] : -INFINITY;
        mb = fmaxf(mb, s[j][i]);
      }
      const float m_new = fmaxf(m[j], max16(mb));
      const float m_safe = isfinite(m_new) ? m_new : 0.0f;
      const float corr = isfinite(m[j]) ? expf(m[j] - m_safe) : 0.0f;
      float psum = 0.0f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = isfinite(s[j][i]) ? expf(s[j][i] - m_safe) : 0.0f;
        s[j][i] = p;
        psum += p;
      }
      l[j] = l[j] * corr + sum16(psum);
      m[j] = m_new;
#pragma unroll
      for (int e = 0; e < kNv * 4; ++e) acc[j][e] *= corr;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(ps + (tx + 16 * i) * kPadP + ty * 4) =
          make_float4(s[0][i], s[1][i], s[2][i], s[3][i]);
    __syncthreads();

    // acc += P . V over the tile's keys
    const int kn = min(kBk, Tk - k0);
#pragma unroll 4
    for (int c = 0; c < kn; ++c) {
      const float4 p =
          *reinterpret_cast<const float4*>(ps + c * kPadP + ty * 4);
      const float pr[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int g = 0; g < kNv; ++g) {
        const float4 w =
            *reinterpret_cast<const float4*>(vs + c * DH + g * 64 + tx * 4);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[j][g * 4 + 0] = fmaf(pr[j], w.x, acc[j][g * 4 + 0]);
          acc[j][g * 4 + 1] = fmaf(pr[j], w.y, acc[j][g * 4 + 1]);
          acc[j][g * 4 + 2] = fmaf(pr[j], w.z, acc[j][g * 4 + 2]);
          acc[j][g * 4 + 3] = fmaf(pr[j], w.w, acc[j][g * 4 + 3]);
        }
      }
    }
  }

  // emit: acc / l in E, or (partial) the registers as they stand
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int qp = q0 + ty * 4 + j;
    if (qp >= Tq) continue;
    const int64_t row = static_cast<int64_t>(bh) * Tq + qp;
    if (PARTIAL) {
      float* arow = op.acc + row * DH;
#pragma unroll
      for (int g = 0; g < kNv; ++g)  // 4 values at tx * 4
        *reinterpret_cast<float4*>(arow + g * 64 + tx * 4) =
            make_float4(acc[j][g * 4], acc[j][g * 4 + 1], acc[j][g * 4 + 2],
                        acc[j][g * 4 + 3]);
      if (tx == 0) {  // the 16 lanes of a row hold the same m and l
        op.m[row] = m[j];
        op.l[row] = l[j];
      }
    } else {
      const float lj = fmaxf(l[j], 1e-30f);
      E* orow = static_cast<E*>(op.out) + row * DH;
#pragma unroll
      for (int g = 0; g < kNv; ++g) {
        float o[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) o[e] = acc[j][g * 4 + e] / lj;
        Io<E, 4>::store(orow + g * 64, tx, o);  // 4 values at tx * 4
      }
    }
  }
}

template <typename E, int DH, bool PARTIAL>
int launch(const Args& a, cudaStream_t st) {
  constexpr int bytes = smem_floats<DH>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<E, DH, PARTIAL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qt = (a.Tq + kBq - 1) / kBq;
  flash_fwd<E, DH, PARTIAL><<<dim3(n_qt, a.bh), kThreads, bytes, st>>>(
      a, n_qt);
  return static_cast<int>(cudaGetLastError());
}

template <typename E, bool PARTIAL>
int dispatch(const Args& a, int dh, void* stream) {
  if (a.bh == 0 || a.Tq == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dh == 64) return launch<E, 64, PARTIAL>(a, st);
  if (dh == 128) return launch<E, 128, PARTIAL>(a, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename E>
int normalized(const void* q, const void* k, const void* v, void* out,
               int bh, int T, int dh, int causal, float scale,
               void* stream) {
  const Args a{q, k, v, out, nullptr, nullptr, nullptr, bh, T, T, 0, 0,
               causal, scale};
  return dispatch<E, false>(a, dh, stream);
}

template <typename E>
int partial(const void* q, const void* k, const void* v, void* acc, void* m,
            void* l, int bh, int Tq, int Tk, int dh, int q_off, int k_off,
            int causal, float scale, void* stream) {
  const Args a{q, k, v, nullptr, static_cast<float*>(acc),
               static_cast<float*>(m), static_cast<float*>(l), bh, Tq, Tk,
               q_off, k_off, causal, scale};
  return dispatch<E, true>(a, dh, stream);
}

}  // namespace

// q, k, v, out (bh, T, dh) float32, contiguous, 16-byte aligned, one
// device; dh must be 64 or 128 and bh <= 65535. Returns
// cudaGetLastError() (cudaErrorInvalidValue for another dh).
extern "C" int mx_flash_attention_f32(const void* q, const void* k,
                                      const void* v, void* out, int bh,
                                      int T, int dh, int causal, float scale,
                                      void* stream) {
  return normalized<float>(q, k, v, out, bh, T, dh, causal, scale, stream);
}

// The same over bfloat16 q, k, v and out.
extern "C" int mx_flash_attention_bf16(const void* q, const void* k,
                                       const void* v, void* out, int bh,
                                       int T, int dh, int causal,
                                       float scale, void* stream) {
  return normalized<__nv_bfloat16>(q, k, v, out, bh, T, dh, causal, scale,
                                   stream);
}

// The same over float16 q, k, v and out.
extern "C" int mx_flash_attention_f16(const void* q, const void* k,
                                      const void* v, void* out, int bh,
                                      int T, int dh, int causal, float scale,
                                      void* stream) {
  return normalized<__half>(q, k, v, out, bh, T, dh, causal, scale, stream);
}

// Partial mode: q (bh, Tq, dh), k and v (bh, Tk, dh) float32, contiguous,
// 16-byte aligned, one device; acc (bh, Tq, dh), m and l (bh, Tq) float32
// out. dh must be 64 or 128 and bh <= 65535. Returns cudaGetLastError().
extern "C" int mx_flash_attention_partial_f32(
    const void* q, const void* k, const void* v, void* acc, void* m, void* l,
    int bh, int Tq, int Tk, int dh, int q_off, int k_off, int causal,
    float scale, void* stream) {
  return partial<float>(q, k, v, acc, m, l, bh, Tq, Tk, dh, q_off, k_off,
                        causal, scale, stream);
}

// The same over bfloat16 q, k and v (acc, m and l float32).
extern "C" int mx_flash_attention_partial_bf16(
    const void* q, const void* k, const void* v, void* acc, void* m, void* l,
    int bh, int Tq, int Tk, int dh, int q_off, int k_off, int causal,
    float scale, void* stream) {
  return partial<__nv_bfloat16>(q, k, v, acc, m, l, bh, Tq, Tk, dh, q_off,
                                k_off, causal, scale, stream);
}

// The same over float16 q, k and v (acc, m and l float32).
extern "C" int mx_flash_attention_partial_f16(
    const void* q, const void* k, const void* v, void* acc, void* m, void* l,
    int bh, int Tq, int Tk, int dh, int q_off, int k_off, int causal,
    float scale, void* stream) {
  return partial<__half>(q, k, v, acc, m, l, bh, Tq, Tk, dh, q_off, k_off,
                         causal, scale, stream);
}
