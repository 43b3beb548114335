"""Where ``bn_stats``' device time goes, on the card: each of the fused
ResNet-50 step's conv outputs (batch 32) alone, in float32, bfloat16 and
float16.

    python3 tools/bn_stats_probe.py [--blocks-per-sm N[,N...]] [DIR]

For every distinct shape of the step's 33 (times its count) it prints the
device ms of ``bn_stats`` (its plan beside), of ``torch.sum(x)`` (one read
of the same bytes by PyTorch's reduction: the read's floor under the same
timing), of ``torch.var_mean(x, (0, 2, 3), unbiased=False)`` and, with
DIR, of an earlier ``bn_stats.cu`` taken from DIR (the two-launch kernel's
C interface: x, partial sums, partial squares, sum, sq, n, c, hw, rows,
slices, stream; its (rows, slices) plan as its wrapper made it), beside
the byte bound; then the totals of a step. Every time is CUDA events
around each call alone after 1 GiB is written (``chip_smoke.py``'s
``_device_ms``: a flushed L2 left dirty, whose lines are written back as
the call's reads evict them), and again after 1 GiB is read (a flushed L2
left clean). ``--blocks-per-sm`` adds the kernel under other grid aims
than ``BN_STATS_BLOCKS_PER_SM`` (the plan's blocks an SM) to each row.
Then, as ``chip_smoke.py`` times a step's 33 calls (one pair of events
around all 33, the L2 flushed and left dirty once before them), each arm
over the step's tensors and over 33 one-value tensors (the per-call
floor). Needs a card; prints the card's name and power limit first.
"""
import ctypes
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs                                    # noqa: E402
import mxnet_tpu_torch as mx                               # noqa: E402
from mxnet_tpu_torch.ops import cuda_kernels as ck         # noqa: E402

ENTRY = {torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16"}


def device_ms(fn, clean, reps=30):
    """``chip_smoke._device_ms`` with the L2 flushed by a 1 GiB write
    (dirty) or a 1 GiB read (clean) before each call."""
    flush = torch.ones(1 << 28, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    spin = int(2e9 * (3 * host_s + 2e-4))
    sink = torch.empty((), device="cuda")
    pairs = []
    for _ in range(reps):
        if clean:
            torch.sum(flush, dim=0, out=sink)
        else:
            flush.fill_(1.0)
        torch.cuda._sleep(spin)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        pairs.append((start, stop))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / reps


def earlier(src_dir):
    """The earlier two-launch kernel from DIR, as its wrapper called it:
    ``call(x) -> (sum, sq)``."""
    lib_path = os.path.join(src_dir, "libprev_bn_stats.so")
    subprocess.run([ck._nvcc(), "-gencode", ck._ARCH, "-std=c++17", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-o", lib_path,
                    os.path.join(src_dir, "bn_stats.cu")], check=True)
    lib = ctypes.CDLL(lib_path)
    P, I = ctypes.c_void_p, ctypes.c_int

    def call(x):
        n, c, h, w = x.shape
        hw = h * w
        rows = min(n, max(1, -(-8192 // max(hw, 1))))
        rows = max(rows, -(-n // 65535), 1)
        slices = max(1, -(-n // rows))
        part = x.new_empty((2, slices, c), dtype=torch.float32)
        s = x.new_empty((c,), dtype=torch.float32)
        sq = x.new_empty((c,), dtype=torch.float32)
        fn = getattr(lib, "mx_bn_stats_" + ENTRY[x.dtype])
        fn.argtypes = [P, P, P, P, P, I, I, I, I, I, P]
        err = fn(x.data_ptr(), part[0].data_ptr(), part[1].data_ptr(),
                 s.data_ptr(), sq.data_ptr(), n, c, hw, rows, slices,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"earlier bn_stats: cudaError {err}")
        return s, sq
    return call


def aimed(x, aim):
    """``bn_stats`` planned for ``aim`` blocks an SM (the plan cache
    cleared before and after)."""
    keep = ck.BN_STATS_BLOCKS_PER_SM
    ck.BN_STATS_BLOCKS_PER_SM = aim
    ck._BN_PLAN.clear()
    try:
        return ck.bn_stats(x)
    finally:
        ck.BN_STATS_BLOCKS_PER_SM = keep
        ck._BN_PLAN.clear()


def main():
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    args = sys.argv[1:]
    aims = []
    if args[:1] == ["--blocks-per-sm"]:
        aims = [int(a) for a in args[1].split(",")]
        args = args[2:]
    prev = earlier(args[0]) if args else None
    shapes = cs._cbr_shapes(mx, cs.TRAIN_BATCH)
    counts = {}
    for s in shapes:
        counts[s] = counts.get(s, 0) + 1
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator().manual_seed(0)
    for dtype in ENTRY:
        total = {}
        for shape, count in counts.items():
            x = (2 * torch.randn(shape, generator=gen) + 0.5).to("cuda",
                                                                 dtype)
            n, c, h, w = shape
            plan = ck._bn_stats_plan(n, c, h * w, x.element_size(),
                                     x.data_ptr() % 16 == 0, sms)
            got, want = ck.bn_stats(x), ck.bn_stats_plain(x)
            err = float(torch.maximum((got[0] - want[0]).abs(),
                                      (got[1] - want[1]).abs()).div(
                want[1].clamp_min(1e-30)).max())
            arms = {"kernel": lambda: ck.bn_stats(x),
                    "torch.sum": lambda: torch.sum(x),
                    "var_mean": lambda: torch.var_mean(
                        x, dim=(0, 2, 3), unbiased=False)}
            if prev is not None:
                arms["earlier"] = lambda: prev(x)
            for aim in aims:
                arms[f"kernel@{aim}"] = lambda aim=aim: aimed(x, aim)
            line = []
            for clean in (False, True):
                for name, fn in arms.items():
                    ms = device_ms(fn, clean)
                    key = name + (" clean" if clean else "")
                    total[key] = total.get(key, 0.0) + count * ms
                    line.append(f"{key} {ms:.6f}")
            bound = cs._bound_ms(x.numel() * x.element_size() + 8 * c,
                                 3 * x.numel())[0]
            total["bound"] = total.get("bound", 0.0) + count * bound
            print(f"bn_stats probe {dtype} {shape} x{count} plan {plan} "
                  f"rel_err {err:.3g}: bound {bound:.6f}; " +
                  "; ".join(line))
            del x
        print(f"bn_stats probe {dtype}: a step's 33 tensors, device ms: " +
              "; ".join(f"{k} {v:.6f}" for k, v in total.items()))
        xs = [(2 * torch.randn(s, generator=gen) + 0.5).to("cuda", dtype)
              for s in shapes]
        tiny = [torch.ones((1, 1, 1, 1), device="cuda", dtype=dtype)
                for _ in shapes]
        arms = {"kernel": ck.bn_stats, "torch.sum": torch.sum,
                "var_mean": lambda x: torch.var_mean(x, dim=(0, 2, 3),
                                                     unbiased=False)}
        if prev is not None:
            arms["earlier"] = prev
        line = []
        for name, fn in arms.items():
            for label, group in (("step", xs), ("one-value", tiny)):
                ms = cs._device_ms(lambda: [fn(x) for x in group])
                line.append(f"{name} {label} {ms:.6f}")
        print(f"bn_stats probe {dtype}: 33 calls back to back, device ms: "
              + "; ".join(line))
        del xs


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("bn_stats_probe: needs a CUDA card")
    main()
