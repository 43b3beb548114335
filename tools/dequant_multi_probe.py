"""Time the multi-weight conv dequant beside other versions of its kernel, on
the card.

    python3 tools/dequant_multi_probe.py [DIR ...]

Each DIR holds a ``dequant_rows.cu`` with the entry points
``mx_dequant_rows_multi_{i8,e4m3}_f32(table, bytes, blocks, stream)`` over
the launch table of ``cuda_kernels._DEQUANT_TABLE`` (its ``kChunk`` read
from the source), e.g. an earlier version (``git show``) or a candidate
design. Each is built with nvcc into DIR; then, over ResNet-50's 53 conv
weights (int8 and float8_e4m3fn), every version's output is held bit for
bit to the plain version, and each version's device time (CUDA events
around each call after 1 GiB is written, as ``chip_smoke.py`` times a
kernel) is taken in turns (current, DIR 1, ..., DIR n, DIR n, ..., DIR 1,
current), beside ``flat_i8.to(torch.float32)`` over one int8 buffer of
the same values (the same bytes in one PyTorch call) and the byte bound.
Needs a card; prints the card's name and power limit first.
"""
import ctypes
import os
import re
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs                                    # noqa: E402
from mxnet_tpu_torch.ops import cuda_kernels as ck         # noqa: E402

ENTRY = {torch.int8: "i8", torch.float8_e4m3fn: "e4m3"}


def build(src_dir):
    """The library built from DIR's source, and its kChunk."""
    src = os.path.join(src_dir, "dequant_rows.cu")
    chunk = int(re.search(r"constexpr int kChunk = (\d+);",
                          open(src).read()).group(1))
    lib = os.path.join(src_dir, "libdq_probe.so")
    subprocess.run([ck._nvcc(), "-gencode", ck._ARCH, "-std=c++17", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-o", lib, src],
                   check=True)
    return ctypes.CDLL(lib), chunk


def caller(fn, chunk, weights, scales):
    """A call of C entry point ``fn`` over the weights into one float32
    buffer (the tables made once, ``chunk`` values a block), and the
    outputs it fills."""
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    numels = [w.numel() for w in weights]
    padded = np.asarray([-(-n // 4) * 4 for n in numels], np.int64)
    offs = np.cumsum(padded) - padded
    flat = torch.empty(int(padded.sum()), dtype=torch.float32, device="cuda")
    tables = ck._dequant_tables(
        [w.data_ptr() for w in weights], [s.data_ptr() for s in scales],
        np.uint64(flat.data_ptr()) + 4 * offs.astype(np.uint64),
        [w.shape[0] for w in weights],
        [n // w.shape[0] for n, w in zip(numels, weights)], chunk)
    outs = [torch.as_strided(flat, w.shape, w.stride(), int(o))
            for w, o in zip(weights, offs)]

    def call():
        stream = torch.cuda.current_stream().cuda_stream
        for table, blocks in tables:
            err = fn(table.ctypes.data, table.nbytes, blocks, stream)
            if err:
                raise RuntimeError(f"cudaError {err}")
        return outs
    return call


def main():
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    rs = np.random.RandomState(0)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a)).to("cuda", dtype)
    shapes = [s for s in cs._resnet50_param_shapes(None, 1) if len(s) == 4]
    n_el = sum(int(np.prod(s)) for s in shapes)
    libs = {}
    for d in sys.argv[1:]:
        try:
            libs[d] = build(d)
        except subprocess.CalledProcessError as e:   # the candidate's own
            print(f"{d}: nvcc failed ({e.returncode}); left out")
    ck._fn("dequant_rows_multi", "f32:int8")      # builds and loads it
    for storage, key in ENTRY.items():
        weights = [cs._quant_weight(rs, t, s[0], int(np.prod(s[1:])),
                                    storage).reshape(s) for s in shapes]
        scales = [t(np.abs(rs.randn(s[0])).astype(np.float32) / 100 + 1e-3)
                  for s in shapes]
        plain = ck.dequant_rows_multi_plain(weights, scales)
        name = f"mx_dequant_rows_multi_{key}_f32"
        lib = ck._libs[ck._library("dequant_rows_multi")]
        calls = {"current": caller(getattr(lib, name), ck.DEQUANT_CHUNK,
                                   weights, scales)}
        for d, (dlib, chunk) in libs.items():
            calls[d] = caller(getattr(dlib, name), chunk, weights, scales)
        for label, call in calls.items():
            for got, want in zip(call(), plain):
                if not torch.equal(got.view(torch.int32),
                                   want.view(torch.int32)):
                    raise AssertionError(f"{label} {key}: not the plain "
                                         "version's bits")
        order = list(calls) + list(calls)[::-1]
        times = {label: [] for label in calls}
        for label in order:
            times[label].append(cs._device_ms(calls[label]))
        flat_i8 = t(rs.randint(-128, 128, n_el), torch.int8)
        yard = cs._device_ms(lambda: flat_i8.to(torch.float32))
        bound = cs._bound_ms(5 * n_el + 4 * sum(s[0] for s in shapes), n_el)
        print(f"dequant_rows_multi {key} over ResNet-50's {len(shapes)} conv "
              f"weights ({n_el} values): flat_i8.to(float32) {yard:.6f} "
              f"device ms, bound {bound[0]:.6f} ({bound[1]})")
        for label, ms in times.items():
            print(f"  {label}: device ms {' / '.join(f'{m:.6f}' for m in ms)}"
                  f" (mean / yardstick {np.mean(ms) / yard:.3f}, / bound "
                  f"{np.mean(ms) / bound[0]:.2f})")


if __name__ == "__main__":
    main()
