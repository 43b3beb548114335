// Cursor-bounded flash-decode attention read, for Hopper (sm_90a): the
// general route (WIDE), every Dh the tiles of decode_attention.cu do not
// take: above 128 in column groups of 128, or rows copied in units below
// 16 bytes. A source of its own so that nvcc builds its heavy instances
// in parallel with the tiles'; the design, the bound and the entry
// points' arguments are in decode_attention.cuh. It counts as
// decode_attention (the wrapper picks the library by
// cuda_kernels.decode_route).
#include "decode_attention.cuh"

namespace {

template <typename Cache, typename Q = float>
int launch_any(const Args& a) {
  if (a.bh == 0 || a.s_len == 0) return 0;
  if (!args_ok<Cache>(a) || !general_route(a))
    return static_cast<int>(cudaErrorInvalidValue);
  return a.s_len == 1 ? launch_rows<128, Cache, Q, 1, true>(a)
                      : launch_rows<128, Cache, Q, kWinRows, true>(a);
}

}  // namespace

MX_DECODE_ENTRY(mx_decode_attention_any_f32, launch_any, float)
MX_DECODE_ENTRY(mx_decode_attention_any_e4m3, launch_any, E4M3)
MX_DECODE_ENTRY(mx_decode_attention_any_e5m2, launch_any, E5M2)
MX_DECODE_ENTRY(mx_decode_attention_any_bf16, launch_any, __nv_bfloat16,
                __nv_bfloat16)
MX_DECODE_ENTRY(mx_decode_attention_any_f16, launch_any, __half, __half)
