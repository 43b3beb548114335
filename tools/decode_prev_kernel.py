"""Time the decode read beside an earlier version of its kernel, on the card.

    git show <commit>:mxnet_tpu_torch/csrc/decode_attention.cu > DIR/decode_attention.cu
    git show <commit>:mxnet_tpu_torch/csrc/vec_io.cuh > DIR/vec_io.cuh
    python3 tools/decode_prev_kernel.py DIR

builds DIR's source with nvcc into DIR (a C entry point per instance with
the signature it had before the key range was split: q, k, v, pos, out,
batch, heads, S, C, Dh, scale, stream), then, for every instance, holds
its output to the current wrapper's and prints both device times (CUDA
events around each call after 1 GiB is written, as ``chip_smoke.py``
times a kernel; the two versions in turns, earlier, current, current,
earlier) at the served step (B 8, H 8, C 256, Dh 64, S 1, staggered
cursors), the prefill window (S 64) and the long-context rows (C 4096,
every cursor at its end, Dh 64 and 128). Needs a card; prints the card's
name and power limit first.
"""
import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs                                    # noqa: E402
from mxnet_tpu_torch.ops import cuda_kernels as ck         # noqa: E402
from mxnet_tpu_torch.rtc import fp8_cast                   # noqa: E402

ENTRY = {torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16",
         torch.float8_e4m3fn: "e4m3", torch.float8_e5m2: "e5m2"}
SERVED = [0, 1, 127, 128, 255, 63, 200, 31]


def build(src_dir):
    lib = os.path.join(src_dir, "libprev_decode.so")
    subprocess.run([ck._nvcc(), "-gencode", ck._ARCH, "-std=c++17", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-o", lib,
                    os.path.join(src_dir, "decode_attention.cu")],
                   check=True)
    return ctypes.CDLL(lib)


def prev_call(lib, q, kc, vc, pos):
    """The earlier kernel's launch, as its wrapper made it."""
    fn = getattr(lib, "mx_decode_attention_" + ENTRY[kc.dtype])
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, P, P, P, P, I, I, I, I, I, ctypes.c_float, P]
    B, H, S, Dh = q.shape
    out = torch.empty((B, H, S, Dh), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        err = fn(q.data_ptr(), kc.data_ptr(), vc.data_ptr(), pos.data_ptr(),
                 out.data_ptr(), B, H, S, kc.shape[2], Dh,
                 float(Dh) ** -0.5, stream)
        if err:
            raise RuntimeError(f"cudaError {err}")
        return out
    return call


def inputs(cache_dt, B, H, S, C, dh, cursors, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q_dt = cache_dt if cache_dt in (torch.bfloat16, torch.float16) \
        else torch.float32
    q = torch.randn(B, H, S, dh, device="cuda", generator=gen).to(q_dt)
    caches = []
    for _ in range(2):
        c = torch.randn(B, H, C, dh, device="cuda", generator=gen)
        caches.append(fp8_cast(c, cache_dt) if cache_dt.itemsize == 1
                      else c.to(cache_dt))
    return q, *caches, torch.tensor(cursors, dtype=torch.int32,
                                    device="cuda")


def main():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    lib = build(sys.argv[1])
    rows = [("served S=1", 1, 256, 64, SERVED),
            ("window S=64", 64, 256, 64, cs.WINDOW_CURSORS)]
    rows += [(f"long C=4096 Dh={dh}", 1, 4096, dh, [4095] * 8)
             for dh in (64, 128)]
    for label, S, C, dh, cur in rows:
        for dt in ENTRY:
            q, kc, vc, pos = inputs(dt, 8, 8, S, C, dh, cur, seed=S + C)
            old = prev_call(lib, q, kc, vc, pos)
            new = (lambda: ck.decode_attention(q, kc, vc, pos))
            err = cs._max_err(old(), new())
            t = [cs._device_ms(f) for f in (old, new, new, old)]
            print(f"{label} {str(dt)[6:]}: earlier {t[0]:.6f} / "
                  f"{t[3]:.6f} device ms, now {t[1]:.6f} / {t[2]:.6f} "
                  f"(earlier / now {(t[0] + t[3]) / (t[1] + t[2]):.2f}x); "
                  f"max |earlier - now| {err:.3g}")
            del q, kc, vc
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
