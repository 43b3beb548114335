"""Time the dequant-fused matmul and the float32 flash-attention forward
beside earlier versions of their kernels, on the card.

    for f in qfc_matmul.cu flash_attention.cu vec_io.cuh; do
        git show <commit>:mxnet_tpu_torch/csrc/$f > DIR/$f; done
    python3 tools/qfc_flash_prev_kernel.py DIR

builds DIR's two sources with nvcc into DIR (libprev_qfc_matmul.so,
libprev_flash_attention.so: the C entry points with the signatures they
had before the GEMV route, x, w, s, out, m, n, k, stream for the matmul),
then holds each earlier kernel's output to the current wrapper's and
prints both device times (CUDA events around each call after 1 GiB is
written, as ``chip_smoke.py`` times a kernel; the two versions in turns,
earlier, current, current, earlier) and the library call's beside them:

* the matmul at ResNet-50's head, (M, 2048) x (1000, 2048) for M in
  1, 2, 4, 8, every instance (float32, bfloat16 and float16 x; int8 and
  float8_e4m3fn weights), ``torch._weight_int8pack_mm`` beside the int8
  rows;
* the float32 flash forward at the LM's (8, 8, 1024, 64) causal and at
  (4, 8, 1024, 128) causal, SDPA's causal call beside;
* its partial mode at the ring's past shard (2, 8, 1024 x 1024, 64),
  offsets (2048, 1024), and at the diagonal (1024, 1024).

Then the current matmul alone: its route-break table, the GEMV and the
tiled route's device ms at (M, 2048) x (N, 2048) for N in 1000, 4096 and
32000 (int8 weights, float32 x; the wrapper's route beside), from which
``cuda_kernels.QFC_GEMV_PER_SM`` and ``QFC_GEMV_PER_TILE`` are fit; and
two rows of x a block (mt 2) against four with two masked (mt 4) at M =
2, every instance at N 1000, float32 x with int8 weights at N 32000.

Needs a card; prints the card's name and power limit first.
"""
import ctypes
import os
import subprocess
import sys

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs                                    # noqa: E402
from mxnet_tpu_torch.ops import cuda_kernels as ck         # noqa: E402

P, I, FL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
QFC_ENTRY = {torch.float32: "f32", torch.bfloat16: "bf16",
             torch.float16: "f16"}
QFC_STORAGE = {torch.int8: "i8", torch.float8_e4m3fn: "e4m3"}


def build(src_dir, stem):
    lib = os.path.join(src_dir, f"libprev_{stem}.so")
    subprocess.run([ck._nvcc(), "-gencode", ck._ARCH, "-std=c++17", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-o", lib,
                    os.path.join(src_dir, f"{stem}.cu")], check=True)
    return ctypes.CDLL(lib)


def _checked(fn, *args):
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"cudaError {err}")


def prev_qfc(lib, x, w, s):
    """The earlier matmul's launch, as its wrapper made it."""
    fn = getattr(lib, f"mx_qfc_matmul_{QFC_STORAGE[w.dtype]}_"
                      f"{QFC_ENTRY[x.dtype]}")
    fn.argtypes = [P, P, P, P, I, I, I, P]
    (m, k), n = x.shape, w.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)

    def call():
        _checked(fn, x.data_ptr(), w.data_ptr(), s.data_ptr(),
                 out.data_ptr(), m, n, k)
        return out
    return call


def prev_flash(lib, q, k, v, causal):
    fn = lib.mx_flash_attention_f32
    fn.argtypes = [P, P, P, P, I, I, I, I, FL, P]
    B, H, T, Dh = q.shape
    out = torch.empty_like(q)

    def call():
        _checked(fn, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 out.data_ptr(), B * H, T, Dh, int(causal),
                 float(Dh) ** -0.5)
        return out
    return call


def prev_partial(lib, q, k, v, q_off, k_off):
    fn = lib.mx_flash_attention_partial_f32
    fn.argtypes = [P, P, P, P, P, P, I, I, I, I, I, I, I, FL, P]
    B, H, Tq, Dh = q.shape
    acc = torch.empty_like(q)
    m = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)

    def call():
        _checked(fn, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 acc.data_ptr(), m.data_ptr(), l.data_ptr(), B * H, Tq,
                 k.shape[2], Dh, q_off, k_off, 1, float(Dh) ** -0.5)
        return acc, m, l
    return call


def turns(label, old, new, err, library=None, lib_label=""):
    t = [cs._device_ms(f) for f in (old, new, new, old)]
    lib = ""
    if library is not None:
        lib = f"; {lib_label} {cs._device_ms(library):.6f}"
    print(f"{label}: earlier {t[0]:.6f} / {t[3]:.6f} device ms, now "
          f"{t[1]:.6f} / {t[2]:.6f} (earlier / now "
          f"{(t[0] + t[3]) / (t[1] + t[2]):.2f}x){lib}; max |earlier - now| "
          f"{err:.3g}")


def qfc_rows(lib):
    gen = torch.Generator(device="cuda").manual_seed(0)
    k, n = 2048, 1000
    s = torch.rand(n, device="cuda", generator=gen) / 100 + 1e-3
    for storage in QFC_STORAGE:
        codes = torch.randint(-127, 128, (n, k), device="cuda",
                              generator=gen, dtype=torch.int32)
        w = codes.to(torch.int8) if storage == torch.int8 else \
            (codes.float() / 4).to(storage)
        for m in (1, 2, 4, 8):
            for dt in QFC_ENTRY:
                x = torch.randn(m, k, device="cuda", generator=gen).to(dt)
                old = prev_qfc(lib, x, w, s)
                new = (lambda x=x: ck.qfc_matmul(x, w, s))
                err = cs._max_err(old(), new())
                library, name = None, ""
                if storage == torch.int8:
                    sc = s.to(dt)
                    library = (lambda x=x, sc=sc:
                               torch._weight_int8pack_mm(x, w, sc))
                    name = "torch._weight_int8pack_mm"
                turns(f"qfc_matmul ({m}, {k}) x ({n}, {k}) "
                      f"{str(storage)[6:]} x {str(dt)[6:]} route "
                      f"{ck._qfc_route(m, n, k, ck._sm_count(0))}", old,
                      new, err, library, name)


def flash_rows(lib):
    gen = torch.Generator(device="cuda").manual_seed(1)
    for shape in ((8, 8, 1024, 64), (4, 8, 1024, 128)):
        q, k, v = (torch.randn(*shape, device="cuda", generator=gen)
                   for _ in range(3))
        old = prev_flash(lib, q, k, v, True)
        new = (lambda: ck.flash_attention(q, k, v, True))
        err = cs._max_err(old(), new())
        turns(f"flash_attention float32 {shape} causal", old, new, err,
              lambda: F.scaled_dot_product_attention(q, k, v,
                                                     is_causal=True),
              "SDPA causal")
    ts = 1024
    q, k, v = (torch.randn(2, 8, ts, 64, device="cuda", generator=gen)
               for _ in range(3))
    for label, offs in (("past shard", (2 * ts, ts)),
                        ("diagonal", (ts, ts))):
        old = prev_partial(lib, q, k, v, *offs)
        new = (lambda offs=offs:
               ck.flash_attention_partial(q, k, v, *offs, True))
        err = max(cs._max_err(a, b) for a, b in zip(old(), new()))
        turns(f"flash_attention_partial float32 (2, 8, {ts}, {ts}, 64) "
              f"{label} offsets {offs}", old, new, err)


def to_card(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a)).to("cuda", dtype)


#: the route-break sweep: N -> M
BREAK_MS = {1000: (1, 2, 4, 8, 16, 32, 64, 256, 512, 768, 960, 976, 977,
                   1024),
            4096: (8, 32, 64, 128, 192, 256, 384, 512, 1024),
            32000: (8, 32, 50, 51, 64, 65, 100, 101, 128, 256, 1024)}


def mt_rows():
    """mt 2 against mt 4 at M = 2 (the same ks, the plan's)."""
    rs = np.random.RandomState(2)
    k, sms = 2048, ck._sm_count(0)
    for n in (1000, 32000):
        s = torch.rand(n, device="cuda") / 100 + 1e-3
        for storage in QFC_STORAGE:
            w = cs._quant_weight(rs, to_card, n, k, storage)
            for dt in QFC_ENTRY:
                if n != 1000 and (dt, storage) != (torch.float32,
                                                   torch.int8):
                    continue
                x = torch.randn(2, k, device="cuda").to(dt)
                mt, ks = ck._qfc_gemv_plan(2, n, k, sms)
                two = cs._qfc_route_ms(ck, x, w, s, (2, ks))
                four = cs._qfc_route_ms(ck, x, w, s, (4, ks))
                print(f"qfc_matmul (2, {k}) x ({n}, {k}) "
                      f"{str(storage)[6:]} x {str(dt)[6:]}: mt 2 ks {ks} "
                      f"{two:.6f} mt 4 ks {ks} {four:.6f} device ms "
                      f"(mt 4 / mt 2 {four / two:.3f}); the wrapper's mt "
                      f"{mt}")


def main():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    qfc_rows(build(sys.argv[1], "qfc_matmul"))
    flash_rows(build(sys.argv[1], "flash_attention"))
    print("qfc_matmul route break, (M, 2048) x (N, 2048) int8, float32 x, "
          "device ms")
    cs._qfc_break_rows(ck, np.random.RandomState(1), to_card, BREAK_MS,
                       2048)
    mt_rows()


if __name__ == "__main__":
    main()
