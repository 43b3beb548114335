// Cursor-bounded flash-decode attention read, for Hopper (sm_90a): the Dh
// 32, 64 and 128 tiles over float32 caches, rows of whole 16-byte copies on
// 16-byte aligned caches. The design, the bound and the entry points'
// arguments are in decode_attention.cuh. The tiles are built from three
// sources by cache type (decode_attention.cu, decode_attention_fp8.cu,
// decode_attention_16.cu) and the general route from
// decode_attention_any.cu, so that nvcc builds them in parallel; the wrapper
// picks the library by the cache's type and cuda_kernels.decode_route, and
// every one counts as decode_attention.
#include "decode_attention.cuh"

MX_DECODE_ENTRY(mx_decode_attention_f32, launch_tiles, float)
