#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``mxnet_tpu_torch``).

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

1. build every CUDA kernel of the port from ``mxnet_tpu_torch/csrc`` (one
   ``nvcc`` per source, all fourteen in parallel), print the build seconds,
   the compiler's register report, the card's name and power limit, and
   the TF32 switches (held off for the decode phases: the reference
   computes in full float32);
2. hold each kernel against its plain PyTorch version on the card, at the
   shapes its path gives it and at edge shapes, and time kernel, device,
   plain version and — where one PyTorch call computes the same function
   — that library call;
3. serve the repo's transformer LM at full width (V=32000, d_model=512,
   8 layers, 8 heads, rotary, cache 256, slot ladder [1, 4, 8], random
   weights from a numpy seed) through ``serve_decoder``'s dispatch thread:
   8 requests of 16 prompt tokens and 64 new tokens, staggered so the
   rung switches; every decode kernel's counter is zeroed just before
   and must have risen while serving; one served stream is then
   teacher-forced on the card and on the CPU and the logits compared;
4. profile 16 full-rung decode steps: wall time per step, the device-busy
   share, and the kernels that take the most device time;
5. train ResNet-50 (1000 classes, 3x224x224, batch 32, numpy-seeded
   synthetic data through ``NDArrayIter``, Xavier init, SGD lr 0.1
   momentum 0.9 wd 1e-4) through ``Module.fit`` on ``gpu(0)`` for 8
   batches: images/s and p50/p99 step ms without the first batch, kernel
   launches per step (softmax 1, cross-entropy backward 1, sgd_mom 157),
   a finite loss and moved parameters;
6. one step of the same model at batch 2 on the card and on the CPU from
   the same parameters, TF32 off: the forward (probabilities, BatchNorm
   moving statistics) within 1e-4, and the updated weights within ten
   times the CPU's own spread under a 1e-6 relative perturbation of the
   starting weights (one ResNet-50 step at batch 2 amplifies rounding:
   a perturbation that small already moves conv0's gradient visibly);
7. two steps of the same fit with ``optimizer="adam"`` at batch 4 (the
   Adam kernel must launch, 157 times per step);
8. profile 4 ResNet-50 training steps: device-busy share, the kernels
   that take the most device time, ms per step;
9. train the repo's transformer LM at the bench's full width (V=32000,
   d_model=512, 8 layers, 8 heads, T=1024, batch 8, ``SyntheticLMIter``
   seed 0, Xavier init, SGD lr 0.05) through ``Module.fit`` on ``gpu(0)``
   for 8 batches: tokens/s and p50/p99 step ms without the first batch,
   peak device memory, kernel launches per step (embedding 1, LayerNorm
   17 forward + 17 dx + 17 dgamma/dbeta, GeLU 8 + 8, flash attention 8,
   softmax 1, cross-entropy backward 1), a finite loss and moved
   parameters;
10. one SGD step of the same LM at batch 2, T=128 on the card and on the
   CPU from the same numpy-seeded parameters, TF32 off: the
   probabilities within 1e-4, every gradient within 1e-4 of its array's
   largest magnitude, every updated weight within 1e-5;
11. profile 4 LM training steps: device-busy share, device time by group
   (the port's kernels / cuBLAS and the libraries / PyTorch elementwise /
   copies), the kernels that take the most device time;
12. serve ResNet-50 (1000 classes, 3x224x224, Xavier seed 0) bound on
   ``gpu(0)`` through ``mx.serve.serve`` at ladder [1, 2, 4, 8] three
   times — float32, int8, fp8 — each answering 24 scripted requests of
   1-3 rows, one every 4 ms, through ``run_scripted`` on a real clock:
   req/s, p50/p99 latency, occupancy, padding waste, the two quantized
   kernels' libraries (unloaded first) loaded by a quantized ladder's
   warmup and no kernel library loaded after it, exactly 53
   ``dequant_rows`` + 1 ``qfc_matmul`` launches per quantized forward
   (warmup's 2 per rung included) and none on the float ladder,
   quantized outputs within ``INT8_TOL`` / ``FP8_TOL`` of the float
   ladder's;
13. one int8 and one fp8 quantized ResNet-50 forward at batch 2 on the
   card, through the engine phase 12 served, and on the CPU from the
   same quantized parameters, TF32 off: probabilities within 1e-5, the
   logits within 1e-4 of their largest magnitude, and the same top-1;
14. rung-8 dispatches of the three ladders: wall per dispatch in turns
   (float32, int8, fp8, fp8, int8, float32; 8 each), then 8 of each
   under the profiler: device busy, launches per forward, and for int8
   the device time by group (cuDNN / the two quantized kernels / softmax
   / PyTorch elementwise / copies).

The line before the last is ``{"kernels": [...]}`` (one entry per kernel:
launches on its path — the decode kernels while serving, softmax /
cross-entropy / SGD-momentum while fitting ResNet-50 with SGD, Adam
while fitting with Adam, the LayerNorm and GeLU backward kernels and
flash attention while fitting the LM, the quantized kernels while
serving int8 and fp8 — max abs error against the plain version, kernel /
plain / library milliseconds and the bound); the last
line is ``{"ok": true, "device": {...}}``. Without CUDA, or outside a
checkout, the script exits non-zero and prints no result.
"""
import json
import os
import subprocess
import sys
import threading
import time

SEED = 0
V, D, N_LAYER, N_HEAD, CAP = 32000, 512, 8, 8, 256
LADDER = [1, 4, 8]
PROMPT, NEW, N_REQ = 16, 64, 8
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_FLOPS_PER_S = 67e12        # H100 SXM float32, outside the tensor cores
# ln_bwd_dparams: sums over up to 8192 rows reach a few hundred, where a
# float32 ulp is 3e-5, and the plain version sums in another order
# qfc_matmul's error is relative to the output's largest magnitude (it
# sums K products in another order than cuBLAS); dequant_rows is exact
TOL = {"embedding": 0.0, "layernorm": 2e-5, "bias_gelu": 2e-5,
       "decode_attention": 2e-5, "softmax": 2e-5, "softmax_ce_bwd": 2e-5,
       "sgd_mom": 1e-6, "adam": 1e-6, "ln_bwd_dx": 2e-5,
       "ln_bwd_dparams": 5e-4, "bias_gelu_dx": 2e-5,
       "flash_attention": 2e-5, "qfc_matmul": 1e-5, "dequant_rows": 0.0}
LOGIT_TOL = 2e-3               # card vs CPU logits, full model, float32
REPLACES = {
    "embedding": "mxnet_tpu/ops/pallas_kernels.py:858",
    "layernorm": "mxnet_tpu/ops/pallas_kernels.py:585",
    "bias_gelu": "mxnet_tpu/ops/pallas_kernels.py:746",
    "decode_attention": "mxnet_tpu/ops/pallas_kernels.py:953",
    "softmax": "mxnet_tpu/ops/pallas_kernels.py:104",
    "softmax_ce_bwd": "mxnet_tpu/ops/pallas_kernels.py:112",
    "sgd_mom": "mxnet_tpu/ops/pallas_kernels.py:497",
    "adam": "mxnet_tpu/ops/pallas_kernels.py:509",
    "ln_bwd_dx": "mxnet_tpu/ops/pallas_kernels.py:600",
    "ln_bwd_dparams": "mxnet_tpu/ops/pallas_kernels.py:612",
    "bias_gelu_dx": "mxnet_tpu/ops/pallas_kernels.py:751",
    "flash_attention": "mxnet_tpu/rtc.py:301",
    "qfc_matmul": "mxnet_tpu/ops/quant.py:151",
    "dequant_rows": "mxnet_tpu/ops/quant.py:234",
}
DECODE_KERNELS = ("embedding", "layernorm", "bias_gelu", "decode_attention")
TRAIN_CLASSES, TRAIN_IMAGE, TRAIN_BATCH, TRAIN_STEPS = 1000, (3, 224, 224), \
    32, 8
SGD = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
FWD_TOL = 1e-4          # card vs CPU forward (probabilities, moving stats)
SPREAD_FACTOR = 10.0    # card vs CPU weights, in units of the CPU's spread
LM_BATCH, LM_SEQ, LM_STEPS = 8, 1024, 8
LM_SGD = (("learning_rate", 0.05),)
LM_KERNELS = ("ln_bwd_dx", "ln_bwd_dparams", "bias_gelu_dx",
              "flash_attention")
#: LM launches per training step at the bench's 8 layers
LM_PER_STEP = {"embedding": 1, "layernorm": 2 * N_LAYER + 1,
               "ln_bwd_dx": 2 * N_LAYER + 1, "ln_bwd_dparams": 2 * N_LAYER + 1,
               "bias_gelu": N_LAYER, "bias_gelu_dx": N_LAYER,
               "flash_attention": N_LAYER, "softmax": 1, "softmax_ce_bwd": 1}
LM_PARITY_BATCH, LM_PARITY_SEQ = 2, 128
GRAD_RTOL = 1e-4        # card vs CPU LM gradients, of each array's max |g|
LM_WEIGHT_TOL = 1e-5    # card vs CPU LM weights after one step
QUANT_RUNGS = [1, 2, 4, 8]
QUANT_REQS = 24         # requests of 1-3 rows, one every QUANT_GAP_S
QUANT_GAP_S = 0.004
QUANT_KERNELS = ("qfc_matmul", "dequant_rows")
QUANT_PARITY_TOL = 1e-5  # card vs CPU quantized probabilities, TF32 off
QUANT_LOGIT_RTOL = 1e-4  # the same, on logits, of their largest magnitude


def _timed(fn, reps=200, warm=20):
    """Milliseconds per call on the card: CUDA events around ``reps``
    calls after ``warm`` untimed ones."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _device_ms(fn, reps=50):
    """Device milliseconds per call: the CUDA kernel time the profiler
    records over ``reps`` calls (host launch cost excluded), or None when
    the profiler records no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = sum(_self_device_us(e) for e in prof.key_averages())
    return total_us / 1e3 / reps if total_us > 0 else None


def _self_device_us(evt):
    return getattr(evt, "self_device_time_total", None) or \
        getattr(evt, "self_cuda_time_total", 0)


def _bound_ms(nbytes, flops):
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / F32_FLOPS_PER_S * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")


def _max_err(a, b):
    import torch
    a, b = a.float(), b.float()
    nan_a, nan_b = torch.isnan(a), torch.isnan(b)
    if not torch.equal(nan_a, nan_b):
        return float("inf")
    return float((a[~nan_a] - b[~nan_b]).abs().max()) if a.numel() else 0.0


def phase_build(ck):
    import torch
    secs = ck.build()
    print(f"build: {len(ck.KERNELS)} kernels in {secs:.1f} s "
          f"(0 when already built)")
    for name, log in sorted(ck.build_log.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(_tf32(False) + " float32_matmul_precision="
          f"{torch.get_float32_matmul_precision()} (decode phases)")
    return smi


def _tf32(on):
    """cuDNN's TF32 switch (PyTorch's default: on); matmuls stay full
    float32. Returns the line that records it."""
    import torch
    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = False
    return (f"tf32: cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
            f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")


def _resnet50_param_shapes(mx, batch):
    """ResNet-50's 157 parameter shapes at the training phase's input."""
    from mxnet_tpu_torch.models import resnet
    sym = resnet.get_symbol(TRAIN_CLASSES, 50, TRAIN_IMAGE)
    arg_shapes, _, _ = sym.infer_shape(data=(batch,) + TRAIN_IMAGE)
    return [s for n, s in zip(sym.list_arguments(), arg_shapes)
            if n not in ("data", "softmax_label")]


def phase_kernels(mx, ck):
    """Each kernel against its plain version at its path's shapes (and
    edge shapes). Returns {name: record} for the result line."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    dev = torch.device("cuda", 0)
    rs = np.random.RandomState(SEED)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a)).to(dev, dtype)

    rec = {}
    # 1. embedding: 8 ids into the (32000, 512) table, scale sqrt(512)
    ids = t(rs.randint(0, V, 8), torch.int32)
    w = t(rs.randn(V, D).astype(np.float32))
    scale = float(np.sqrt(D))
    err = _max_err(ck.embedding(ids, w, scale),
                   ck.embedding_plain(ids, w, scale))
    bad = t([-1, V, -V - 1, 5], torch.int32)        # out-of-range ids
    err = max(err, _max_err(ck.embedding(bad, w, scale),
                            ck.embedding_plain(bad, w, scale)))
    n = ids.numel()
    rec["embedding"] = dict(
        max_abs_err=err, ms=_timed(lambda: ck.embedding(ids, w, scale)),
        plain_ms=_timed(lambda: ck.embedding_plain(ids, w, scale)),
        library_ms=None,    # no single PyTorch call gathers AND scales
        bound=_bound_ms(n * 4 + 2 * n * D * 4, n * D))
    # 2. LayerNorm: (8, 512), eps 1e-5
    x = t(rs.randn(8, D).astype(np.float32))
    g = t(1 + 0.1 * rs.randn(D).astype(np.float32))
    b = t(0.1 * rs.randn(D).astype(np.float32))
    got, ref = ck.layernorm(x, g, b, 1e-5), ck.layernorm_plain(x, g, b, 1e-5)
    err = max(_max_err(p, q) for p, q in zip(got, ref))
    rec["layernorm"] = dict(
        max_abs_err=err, ms=_timed(lambda: ck.layernorm(x, g, b, 1e-5)),
        plain_ms=_timed(lambda: ck.layernorm_plain(x, g, b, 1e-5)),
        library_ms=_timed(lambda: F.layer_norm(x, (D,), g, b, 1e-5)),
        bound=_bound_ms(2 * x.numel() * 4 + 2 * D * 4 + 2 * 8 * 4,
                        8 * x.numel()))
    # 3. bias + GeLU: (8, 2048)
    h = t(rs.randn(8, 4 * D).astype(np.float32))
    hb = t(0.1 * rs.randn(4 * D).astype(np.float32))
    err = _max_err(ck.bias_gelu(h, hb), ck.bias_gelu_plain(h, hb))
    rec["bias_gelu"] = dict(
        max_abs_err=err, ms=_timed(lambda: ck.bias_gelu(h, hb)),
        plain_ms=_timed(lambda: ck.bias_gelu_plain(h, hb)),
        library_ms=None,    # bias add + GeLU is two PyTorch calls
        bound=_bound_ms(2 * h.numel() * 4 + hb.numel() * 4,
                        8 * h.numel()))
    # 4. decode attention: B=8, H=8, C=256, Dh=64, staggered cursors,
    #    S=1 (the served step) and S=16 (a window the kernel also takes)
    B, H, Dh = 8, N_HEAD, D // N_HEAD
    kc = t(rs.randn(B, H, CAP, Dh).astype(np.float32))
    vc = t(rs.randn(B, H, CAP, Dh).astype(np.float32))
    err = 0.0
    for S, cursors in ((1, [0, 1, 127, 128, 255, 63, 200, 31]),
                       (16, [0, 1, 127, 128, 240, 63, 200, 31])):
        q = t(rs.randn(B, H, S, Dh).astype(np.float32))
        pos = t(cursors, torch.int32)
        err = max(err, _max_err(ck.decode_attention(q, kc, vc, pos),
                                ck.decode_attention_plain(q, kc, vc, pos)))
        if S == 1:
            q1, pos1 = q, pos
    live = np.minimum(CAP, np.asarray([0, 1, 127, 128, 255, 63, 200, 31])
                      + 1)
    mask = (torch.arange(CAP, device=dev)[None, None, None, :]
            <= pos1.long()[:, None, None, None])
    rec["decode_attention"] = dict(
        max_abs_err=err,
        ms=_timed(lambda: ck.decode_attention(q1, kc, vc, pos1)),
        plain_ms=_timed(lambda: ck.decode_attention_plain(q1, kc, vc, pos1)),
        library_ms=_timed(lambda: F.scaled_dot_product_attention(
            q1, kc, vc, attn_mask=mask)),
        bound=_bound_ms(
            2 * q1.numel() * 4 + B * 4 + int(live.sum()) * H * Dh * 4 * 2,
            int(live.sum()) * H * Dh * 4))
    calls = {"embedding": lambda: ck.embedding(ids, w, scale),
             "layernorm": lambda: ck.layernorm(x, g, b, 1e-5),
             "bias_gelu": lambda: ck.bias_gelu(h, hb),
             "decode_attention": lambda: ck.decode_attention(q1, kc, vc,
                                                             pos1)}
    calls.update(_training_kernels(mx, ck, rs, t, rec))
    calls.update(_lm_kernels(ck, rs, t, rec))
    calls.update(_quant_kernels(mx, ck, rs, t, rec))
    for name, r in rec.items():
        dev_ms = _device_ms(calls[name])
        err = r.get("rel_err", r["max_abs_err"])
        print(f"kernel {name}: max_abs_err={r['max_abs_err']:.3g} "
              + (f"rel_err={err:.3g} " if "rel_err" in r else "")
              + f"(tol {TOL[name]}) kernel_ms={r['ms']:.5f} "
              f"device_ms={dev_ms} plain_ms={r['plain_ms']:.5f} "
              f"library_ms={r['library_ms']} "
              f"bound_ms={r['bound'][0]:.6f} ({r['bound'][1]})")
        if not err <= TOL[name]:
            raise AssertionError(f"kernel {name} disagrees with its plain "
                                 f"version: {err} > {TOL[name]}")
    return rec


def _training_kernels(mx, ck, rs, t, rec):
    """The four training kernels at the ResNet-50 path's shapes: the
    (32, 1000) head, and the optimizer over all 157 parameter arrays of
    one step (so ms and bound are per training step). Fills ``rec``;
    returns the timed calls."""
    import numpy as np
    import torch
    from mxnet_tpu_torch.ops.loss import softmax_output
    N, C = TRAIN_BATCH, TRAIN_CLASSES
    # 5. softmax: (32, 1000), then C = 1, 1025 (block-per-row), 65536, N = 1
    x = t(4 * rs.randn(N, C).astype(np.float32))
    err = _max_err(ck.softmax(x), ck.softmax_plain(x))
    for shape in ((4, 1), (3, 1025), (2, 65536), (1, C)):
        e = t(4 * rs.randn(*shape).astype(np.float32))
        err = max(err, _max_err(ck.softmax(e), ck.softmax_plain(e)))
    rec["softmax"] = dict(
        max_abs_err=err, ms=_timed(lambda: ck.softmax(x)),
        plain_ms=_timed(lambda: ck.softmax_plain(x)),
        library_ms=_timed(lambda: torch.softmax(x, -1)),
        bound=_bound_ms(2 * N * C * 4, 5 * N * C))
    # 6. cross-entropy backward: labels in range, past C and negative;
    #    the op's ignore mask and "valid" normalization through autograd
    p = ck.softmax_plain(x)
    lab = t(np.concatenate([rs.randint(0, C, N - 3), [C, -1, C - 1]])
            .astype(np.float32))
    err = max(_max_err(ck.softmax_ce_bwd(p, lab, s, u, -1.0),
                       ck.softmax_ce_bwd_plain(p, lab, s, u, -1.0))
              for s in (1.0, 1 / N) for u in (False, True))
    attrs = mx.ops.get_op("SoftmaxOutput").normalize_attrs(
        {"use_ignore": True, "normalization": "valid"})
    grads = []
    for fns in ({"softmax": ck.softmax, "ce_grad": ck.softmax_ce_bwd}, {}):
        xx = x.clone().requires_grad_(True)
        softmax_output(xx, lab, attrs, **fns).sum().backward()
        grads.append(xx.grad)
    err = max(err, _max_err(*grads))
    rec["softmax_ce_bwd"] = dict(
        max_abs_err=err, ms=_timed(lambda: ck.softmax_ce_bwd(p, lab, 1.0)),
        plain_ms=_timed(lambda: ck.softmax_ce_bwd_plain(p, lab, 1.0)),
        library_ms=None,     # no one PyTorch call emits this gradient
        bound=_bound_ms(2 * N * C * 4 + N * 4, 3 * N * C))
    # 7./8. the updates, over one step's 157 arrays, plus an odd length
    shapes = _resnet50_param_shapes(mx, N)
    n_el = sum(int(np.prod(s)) for s in shapes)
    big = max(shapes, key=lambda s: int(np.prod(s)))
    dev = x.device
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def arrays(k):
        return [[torch.randn(s, device=dev, generator=gen).abs_()
                 if j == 3 else torch.randn(s, device=dev, generator=gen)
                 for j in range(k)] for s in shapes]
    hp = dict(lr=0.1, momentum=0.9, wd=1e-4, rescale=1 / N, clip=-1.0)
    err = 0.0
    for s in (big, (1000003,)):
        w, g, m = (torch.randn(s, device=dev, generator=gen)
                   for _ in range(3))
        for clip in (-1.0, 0.01):
            h = dict(hp, clip=clip)
            err = max(err, max(_max_err(a, b) for a, b in zip(
                ck.sgd_mom_update(w.clone(), g, m.clone(), **h),
                ck.sgd_mom_update_plain(w, g, m, **h))))
    sgd = arrays(3)
    rec["sgd_mom"] = dict(
        max_abs_err=err,
        ms=_timed(lambda: [ck.sgd_mom_update(*a, **hp) for a in sgd],
                  reps=50, warm=5),
        plain_ms=_timed(lambda: [ck.sgd_mom_update_plain(*a, **hp)
                                 for a in sgd], reps=20, warm=2),
        library_ms=None,     # torch.optim.SGD keeps buf = mu*buf + g
        bound=_bound_ms(5 * 4 * n_el, 7 * n_el))
    ah = dict(lr=1e-3, beta1=0.9, beta2=0.999, epsilon=1e-8, wd=1e-4,
              rescale=1 / N, clip=-1.0)
    err = 0.0
    for s in (big, (1000003,)):
        w, g, mean = (torch.randn(s, device=dev, generator=gen)
                      for _ in range(3))
        var = torch.rand(s, device=dev, generator=gen)
        err = max(err, max(_max_err(a, b) for a, b in zip(
            ck.adam_update(w.clone(), g, mean.clone(), var.clone(), **ah),
            ck.adam_update_plain(w, g, mean, var, **ah))))
    adam = arrays(4)
    rec["adam"] = dict(
        max_abs_err=err,
        ms=_timed(lambda: [ck.adam_update(*a, **ah) for a in adam],
                  reps=50, warm=5),
        plain_ms=_timed(lambda: [ck.adam_update_plain(*a, **ah)
                                 for a in adam], reps=20, warm=2),
        library_ms=None,     # torch.optim.Adam places epsilon elsewhere
        bound=_bound_ms(7 * 4 * n_el, 14 * n_el))
    print(f"kernels: the updates are timed over one ResNet-50 step: "
          f"{len(shapes)} arrays, {n_el} elements, largest {big}")
    return {"softmax": lambda: ck.softmax(x),
            "softmax_ce_bwd": lambda: ck.softmax_ce_bwd(p, lab, 1.0),
            "sgd_mom": lambda: [ck.sgd_mom_update(*a, **hp) for a in sgd],
            "adam": lambda: [ck.adam_update(*a, **ah) for a in adam]}


def _lm_kernels(ck, rs, t, rec):
    """The four LM-training kernels at the full-width LM path's shapes:
    LayerNorm over (8192, 512), GeLU over (8192, 2048), causal flash
    attention over (8, 8, 1024, 64); plus edge shapes. Fills ``rec``;
    returns the timed calls."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    N, C = LM_BATCH * LM_SEQ, D

    def ln_case(n, c):
        x = t((3 * rs.randn(n, c) + 1).astype(np.float32))
        g = t((1 + 0.1 * rs.randn(c)).astype(np.float32))
        b = t((0.1 * rs.randn(c)).astype(np.float32))
        ct = t(rs.randn(n, c).astype(np.float32))
        _, mean, rstd = ck.layernorm_plain(x, g, b, 1e-5)
        return x, g, b, ct, mean, rstd
    cases = [ln_case(N, C)] + [ln_case(*e) for e in ((1, C), (64, 1),
                                                      (2, 65536))]
    err_dx = max(_max_err(ck.layernorm_bwd_dx(x, g, ct, m, r),
                          ck.layernorm_bwd_dx_plain(x, g, ct, m, r))
                 for x, g, _b, ct, m, r in cases)
    err_dp = max(max(_max_err(a, b) for a, b in zip(
        ck.layernorm_bwd_dparams(x, ct, m, r),
        ck.layernorm_bwd_dparams_plain(x, ct, m, r)))
        for x, _g, _b, ct, m, r in cases)
    x, g, b, ct, m, r = cases[0]
    # the library's LayerNorm backward computes dx, dgamma, dbeta in one
    # call: its time stands beside rows 11 and 12 together
    _, lm_mean, lm_rstd = torch.ops.aten.native_layer_norm(x, (C,), g, b,
                                                           1e-5)
    lib = _timed(lambda: torch.ops.aten.native_layer_norm_backward(
        ct, x, (C,), lm_mean, lm_rstd, g, b, [True, True, True]))
    rec["ln_bwd_dx"] = dict(
        max_abs_err=err_dx,
        ms=_timed(lambda: ck.layernorm_bwd_dx(x, g, ct, m, r)),
        plain_ms=_timed(lambda: ck.layernorm_bwd_dx_plain(x, g, ct, m, r)),
        library_ms=lib,
        bound=_bound_ms((3 * N * C + C + 2 * N) * 4, 11 * N * C))
    rec["ln_bwd_dparams"] = dict(
        max_abs_err=err_dp,
        ms=_timed(lambda: ck.layernorm_bwd_dparams(x, ct, m, r)),
        plain_ms=_timed(lambda: ck.layernorm_bwd_dparams_plain(x, ct, m, r)),
        library_ms=lib,
        bound=_bound_ms((2 * N * C + 2 * N + 2 * C) * 4, 4 * N * C))
    # GeLU backward: (8192, 2048), then (3, 13) and (1, 4)
    F4 = 4 * D
    h = t((3 * rs.randn(N, F4)).astype(np.float32))
    hb = t(rs.randn(F4).astype(np.float32))
    hct = t(rs.randn(N, F4).astype(np.float32))
    err = _max_err(ck.bias_gelu_dx(h, hb, hct),
                   ck.bias_gelu_dx_plain(h, hb, hct))
    for n, c in ((3, 13), (1, 4)):
        e = [t(rs.randn(*s).astype(np.float32)) for s in ((n, c), (c,),
                                                           (n, c))]
        err = max(err, _max_err(ck.bias_gelu_dx(*e),
                                ck.bias_gelu_dx_plain(*e)))
    rec["bias_gelu_dx"] = dict(
        max_abs_err=err, ms=_timed(lambda: ck.bias_gelu_dx(h, hb, hct)),
        plain_ms=_timed(lambda: ck.bias_gelu_dx_plain(h, hb, hct)),
        library_ms=None,     # no one PyTorch call takes GeLU' x ct
        bound=_bound_ms((3 * N * F4 + F4) * 4, 12 * N * F4))
    # flash attention: causal (8, 8, 1024, 64), then T = 1, T = 1000
    # (a ragged last tile), Dh = 128, and non-causal
    Dh = D // N_HEAD
    q, k, v = (t(rs.randn(LM_BATCH, N_HEAD, LM_SEQ, Dh).astype(np.float32))
               for _ in range(3))
    err = _max_err(ck.flash_attention(q, k, v, True),
                   ck.flash_attention_plain(q, k, v, True))
    for shape, causal in (((2, 2, 1, Dh), True), ((1, 2, 1000, Dh), True),
                          ((2, 2, 200, 128), True), ((2, 2, 256, Dh), False),
                          ((1, 2, 300, 128), False)):
        e = [t(rs.randn(*shape).astype(np.float32)) for _ in range(3)]
        err = max(err, _max_err(ck.flash_attention(*e, causal),
                                ck.flash_attention_plain(*e, causal)))
    pairs = LM_BATCH * N_HEAD * LM_SEQ * (LM_SEQ + 1) // 2
    rec["flash_attention"] = dict(
        max_abs_err=err,
        ms=_timed(lambda: ck.flash_attention(q, k, v, True), reps=50),
        plain_ms=_timed(lambda: ck.flash_attention_plain(q, k, v, True),
                        reps=20, warm=3),
        library_ms=_timed(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True), reps=50),
        bound=_bound_ms(4 * q.numel() * 4, 4 * pairs * Dh))
    print(f"kernels: LM rows at LayerNorm ({N}, {C}), GeLU ({N}, {F4}), "
          f"flash {tuple(q.shape)} causal; library_ms of ln_bwd_dx and "
          "ln_bwd_dparams is ONE native_layer_norm_backward call (dx, "
          "dgamma and dbeta together)")
    return {"ln_bwd_dx": lambda: ck.layernorm_bwd_dx(x, g, ct, m, r),
            "ln_bwd_dparams": lambda: ck.layernorm_bwd_dparams(x, ct, m, r),
            "bias_gelu_dx": lambda: ck.bias_gelu_dx(h, hb, hct),
            "flash_attention": lambda: ck.flash_attention(q, k, v, True)}


def _quant_weight(rs, t, n, k, storage):
    """(n, k) narrow weight on the card: random codes plus the extremes
    (+-127 / +-448), the e4m3 subnormals, 0 and -0."""
    import numpy as np
    import torch
    if storage == torch.int8:
        codes = rs.randint(-128, 128, n * k)
        codes[:min(4, codes.size)] = [127, -127, -128, 0][:codes.size]
        return t(codes.reshape(n, k), torch.int8)
    vals = (rs.randn(n * k) * 40).clip(-448, 448).astype(np.float32)
    edge = np.asarray([448.0, -448.0, 2.0 ** -9, -(2.0 ** -9), 2.0 ** -7,
                       7 * 2.0 ** -9, 0.0, -0.0], np.float32)
    vals[:min(edge.size, vals.size)] = edge[:vals.size]
    return t(vals.reshape(n, k)).to(torch.float8_e4m3fn)


def _dequant_library(wq, scale):
    """The row dequant as ONE PyTorch call, int8 weights only: int8 x
    float32 promotes to float32 and rounds each product once, as the
    kernel does (PyTorch refuses to promote float8_e4m3fn)."""
    import torch
    return torch.mul(wq, scale.unsqueeze(1))


def _quant_kernels(mx, ck, rs, t, rec):
    """The two quantized-serving kernels, int8 and float8_e4m3fn weights:
    the dequant-fused matmul at ResNet-50's fc1 rung 8 ((8, 2048) x (1000,
    2048)) and at edges (M = 1, 257; K = 13; N = 1, 1001), held within
    QFC_RTOL of the output's largest magnitude; the row dequant at the
    path's (512, 4608) and (2048, 512) and at edges (1 and 147 columns),
    held bit for bit to its plain version and, with int8 weights, to
    ``_dequant_library``. Timed with int8 weights (fp8 printed beside): the
    matmul per call, the dequant per ResNet-50 forward — all 53 conv
    weights, 53 launches. Fills ``rec``; returns the timed calls."""
    import numpy as np
    import torch
    storages = {"int8": torch.int8, "e4m3": torch.float8_e4m3fn}

    def scale(n):
        return t(np.abs(rs.randn(n)).astype(np.float32) / 100 + 1e-3)
    err_q = rel_q = 0.0
    for st in storages.values():
        for m, k, n in ((QUANT_RUNGS[-1], 2048, TRAIN_CLASSES),
                        (1, 2048, 1000), (257, 64, 33), (5, 13, 7),
                        (3, 300, 1), (4, 64, 1001)):
            x = t(rs.randn(m, k).astype(np.float32))
            w, s = _quant_weight(rs, t, n, k, st), scale(n)
            ref = ck.qfc_matmul_plain(x, w, s)
            err = _max_err(ck.qfc_matmul(x, w, s), ref)
            err_q = max(err_q, err)
            rel_q = max(rel_q, err / max(float(ref.abs().max()), 1e-30))
    err_d = 0.0
    for st in storages.values():
        for rows, cols in ((512, 4608), (2048, 512), (64, 147), (3, 1),
                           (5, 13)):
            w, s = _quant_weight(rs, t, rows, cols, st), scale(rows)
            got, ref = ck.dequant_rows(w, s), ck.dequant_rows_plain(w, s)
            if not torch.equal(got.view(torch.int32), ref.view(torch.int32)):
                err_d = max(err_d, _max_err(got, ref), 1e-30)
            if st == torch.int8 and not torch.equal(
                    got.view(torch.int32),
                    _dequant_library(w, s).view(torch.int32)):
                raise AssertionError(f"torch.mul differs from dequant_rows "
                                     f"at ({rows}, {cols}) int8")
    x8 = t(rs.randn(QUANT_RUNGS[-1], 2048).astype(np.float32))
    fc = {k: (_quant_weight(rs, t, TRAIN_CLASSES, 2048, st),
              scale(TRAIN_CLASSES)) for k, st in storages.items()}
    shapes = [s for s in _resnet50_param_shapes(mx, 1) if len(s) == 4]
    convs = {k: [(_quant_weight(rs, t, s[0], int(np.prod(s[1:])), st),
                  scale(s[0])) for s in shapes]
             for k, st in storages.items()}
    n_el = sum(int(np.prod(s)) for s in shapes)
    m, (n, k) = x8.shape[0], fc["int8"][0].shape
    qfc = {key: _timed(lambda key=key: ck.qfc_matmul(x8, *fc[key]))
           for key in storages}
    deq = {key: _timed(lambda key=key: [ck.dequant_rows(*a)
                                        for a in convs[key]],
                       reps=50, warm=5)
           for key in storages}
    big = convs["int8"][int(np.argmax([np.prod(s) for s in shapes]))]
    print(f"kernels: qfc_matmul ({m}, {k}) x ({n}, {k}) ms int8 "
          f"{qfc['int8']:.5f} e4m3 {qfc['e4m3']:.5f}; dequant_rows per "
          f"ResNet-50 forward ({len(shapes)} weights, {n_el} elements) ms "
          f"int8 {deq['int8']:.5f} e4m3 {deq['e4m3']:.5f}; one "
          f"{tuple(big[0].shape)} dequant "
          f"{_timed(lambda: ck.dequant_rows(*big)):.5f} ms")
    rec["qfc_matmul"] = dict(
        max_abs_err=err_q, rel_err=rel_q, ms=qfc["int8"],
        plain_ms=_timed(lambda: ck.qfc_matmul_plain(x8, *fc["int8"])),
        library_ms=None,    # torch._int_mm / _scaled_mm need narrow x too
        bound=_bound_ms(m * k * 4 + n * k + n * 4 + m * n * 4, 2 * m * n * k))
    rec["dequant_rows"] = dict(
        max_abs_err=err_d, ms=deq["int8"],
        plain_ms=_timed(lambda: [ck.dequant_rows_plain(*a)
                                 for a in convs["int8"]], reps=50, warm=5),
        library_ms=_timed(lambda: [_dequant_library(*a)
                                   for a in convs["int8"]], reps=50, warm=5),
        bound=_bound_ms(5 * n_el + 4 * sum(s[0] for s in shapes), n_el))
    return {"qfc_matmul": lambda: ck.qfc_matmul(x8, *fc["int8"]),
            "dequant_rows": lambda: [ck.dequant_rows(*a)
                                     for a in convs["int8"]]}


def _model(mx, rs):
    """The decode symbol at full width and random parameters (numpy)."""
    import numpy as np
    from mxnet_tpu_torch.models import transformer as tfm
    sym = tfm.get_decode_symbol(vocab_size=V, d_model=D, n_layer=N_LAYER,
                                n_head=N_HEAD, capacity=CAP, per_slot=True)
    arg_shapes, _, _ = sym.infer_shape(data=(1, 1))
    params = {}
    for name, shape in zip(sym.list_arguments(), arg_shapes):
        if name == "data":
            continue
        if name.endswith("gamma"):
            params[name] = (1 + 0.1 * rs.randn(*shape)).astype(np.float32)
        else:
            params[name] = (0.02 * rs.randn(*shape)).astype(np.float32)
    print(f"model: {sum(p.size for p in params.values())} parameters")
    return sym, params


def _decoder(mx, sym, params, ctx, slots=1):
    from mxnet_tpu_torch.models import transformer as tfm
    mod = mx.mod.Module(sym, data_names=("data",), label_names=[],
                        context=ctx)
    mod.bind([("data", (slots, 1))], None, for_training=False)
    mod.init_params(arg_params=mx.convert.params_from_numpy(params, ctx),
                    aux_params={}, allow_missing=True)
    return tfm.BatchedKVCacheDecoder(mod, CAP, slots=slots)


def phase_serve(mx, ck):
    """Full-width serve_decoder through its dispatch thread; returns the
    per-kernel launch counts of the served run."""
    import numpy as np
    rs = np.random.RandomState(SEED)
    sym, params = _model(mx, rs)
    prompts = [rs.randint(0, V, PROMPT).tolist() for _ in range(N_REQ)]
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    sched = mx.serve.serve_decoder(
        sym, mx.convert.params_from_numpy(params, mx.gpu(0)),
        name="lm-smoke", capacity=CAP, ladder=LADDER, context=mx.gpu(0),
        default_max_new=NEW)
    print(f"serve: engine built and warmed in "
          f"{time.perf_counter() - t0:.2f} s")
    after_warm = ck.launch_counts()
    try:
        handles = []
        t_serve = time.perf_counter()
        # staggered arrivals: 1, then 3 (rung 1 -> 4), then 4 (-> 8),
        # each wave once the previous one has streamed a few tokens
        for wave in ((0,), (1, 2, 3), (4, 5, 6, 7)):
            started = threading.Event()
            for i in wave:
                h = sched.submit(prompts[i])
                handles.append(h)
            # the event is bound now: a later wave rebinds `started`, and
            # this wave's handle keeps streaming after its wave is done
            h.add_token_callback(
                lambda _h, _tok, idx, ev=started: idx >= 3 and ev.set())
            if not started.wait(timeout=300):
                raise AssertionError("serving stalled: no tokens streamed")
        outs = [h.result(timeout=600) for h in handles]
        wall = time.perf_counter() - t_serve
    finally:
        sched.stop()
    counts = ck.launch_counts()
    stats = sched.stats()
    n_tok = sum(len(o) for o in outs)
    print(f"serve: {len(outs)} requests, {n_tok} tokens in {wall:.3f} s = "
          f"{n_tok / wall:.1f} tokens/s; step_ms={stats['step_ms']}; "
          f"migrations={stats['migrations']} iterations="
          f"{stats['iterations']}")
    print(f"serve: launches warmup={after_warm} total={counts}")
    if any(len(o) != NEW for o in outs):
        raise AssertionError(f"want {NEW} tokens per request, got "
                             f"{[len(o) for o in outs]}")
    if stats["migrations"] < 2:
        raise AssertionError("the rung never switched")
    for name in DECODE_KERNELS:
        if not counts[name] > after_warm[name]:
            raise AssertionError(f"kernel {name} was not launched while "
                                 "serving")
    for o in outs:
        if not ((o >= 0) & (o < V)).all():
            raise AssertionError("served token ids out of range")

    # teacher-force request 0's stream (prompt + 8 served tokens) on the
    # card and on the CPU; compare logits, and check each served token is
    # the CPU argmax or within LOGIT_TOL of it (a float32 near-tie)
    stream = prompts[0] + outs[0][:8].tolist()
    gpu, cpu = (_decoder(mx, sym, params, ctx)
                for ctx in (mx.gpu(0), mx.cpu()))
    worst = 0.0
    for d in (gpu, cpu):
        d.join(0)
    for i, tok in enumerate(stream[:-1]):
        a = gpu.step(np.asarray([[tok]])).asnumpy()[0, 0]
        b = cpu.step(np.asarray([[tok]])).asnumpy()[0, 0]
        if a.shape != (V,) or not np.isfinite(a).all():
            raise AssertionError(f"step {i}: logits {a.shape} not finite")
        worst = max(worst, float(np.abs(a - b).max()))
        if i >= PROMPT - 1:
            served = stream[i + 1]
            if b[served] < b.max() - LOGIT_TOL:
                raise AssertionError(
                    f"served token {served} at step {i} is not the CPU "
                    f"argmax {int(b.argmax())}")
    print(f"teacher-forced {len(stream) - 1} steps: max |logit card - "
          f"cpu| = {worst:.3g} (tol {LOGIT_TOL})")
    if not worst <= LOGIT_TOL:
        raise AssertionError("card and CPU logits disagree")
    return counts, sym, params


def phase_profile(mx, sym, params, steps=16):
    """Where a full-rung decode step's time goes: 8 active slots, one
    token each, ``steps`` steps under the profiler (device activity
    only). Prints the wall time per step, the device-busy share and the
    kernels that take the most device time."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    drv = _decoder(mx, sym, params, mx.gpu(0), slots=LADDER[-1])
    for s in range(LADDER[-1]):
        drv.join(s)
    tokens = np.random.RandomState(SEED).randint(0, V, (LADDER[-1], 1))
    for _ in range(4):
        drv.step(tokens).asnumpy()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            drv.step(tokens).asnumpy()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    rows = sorted(((_self_device_us(e), e.count, e.key)
                   for e in prof.key_averages() if _self_device_us(e) > 0),
                  reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3 / steps
    print(f"profile: rung {LADDER[-1]}, {steps} steps: wall {wall_ms:.3f} "
          f"ms/step, device busy {busy_ms:.3f} ms/step "
          f"({100 * busy_ms / wall_ms:.1f}% of wall)")
    for us, count, key in rows[:8]:
        print(f"  {us / 1e3 / steps:9.4f} ms/step  {count // steps:4d} "
              f"launches/step  {key[:90]}")


def _resnet50(mx):
    from mxnet_tpu_torch.models import resnet
    return resnet.get_symbol(TRAIN_CLASSES, 50, TRAIN_IMAGE)


def _images(n, seed):
    import numpy as np
    rs = np.random.RandomState(seed)
    return (rs.rand(n, *TRAIN_IMAGE).astype(np.float32),
            rs.randint(0, TRAIN_CLASSES, n).astype(np.float32))


def phase_train(mx, ck):
    """ResNet-50 through Module.fit on gpu(0). Returns (launch counts of
    the fit, the bound module for the profile phase)."""
    import numpy as np
    import torch
    print(_tf32(True) + " (PyTorch's default, for the training phases)")
    X, y = _images(TRAIN_BATCH * TRAIN_STEPS, SEED)
    it = mx.io.NDArrayIter(X, y, batch_size=TRAIN_BATCH)
    mod = mx.mod.Module(_resnet50(mx), context=mx.gpu(0))
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params(mx.initializer.Xavier(
        rng=torch.Generator().manual_seed(SEED)))
    args, _ = mod.get_params()
    before = {k: args[k].asnumpy() for k in ("conv0_weight", "fc1_weight")}
    stamps = []

    def step_end(_param):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
    metric = mx.metric.create(["acc", "ce"])
    torch.cuda.synchronize()
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    mod.fit(it, num_epoch=1, eval_metric=metric, optimizer_params=SGD,
            batch_end_callback=step_end)
    counts = ck.launch_counts()
    steps = np.diff(stamps) * 1e3          # the first batch excluded
    print(f"train: ResNet-50 {TRAIN_IMAGE} batch {TRAIN_BATCH}, "
          f"{len(stamps)} steps in {time.perf_counter() - t0:.2f} s "
          f"(first {1e3 * (stamps[0] - t0):.1f} ms); without the first: "
          f"{TRAIN_BATCH * len(steps) / (steps.sum() / 1e3):.1f} img/s, "
          f"step p50 {np.percentile(steps, 50):.2f} ms p99 "
          f"{np.percentile(steps, 99):.2f} ms; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    per_step = {k: v / len(stamps) for k, v in counts.items()}
    print(f"train: launches per step {per_step}")
    n_params = len(args)
    want = {"softmax": 1, "softmax_ce_bwd": 1, "sgd_mom": n_params}
    for k, v in want.items():
        if per_step[k] != v:
            raise AssertionError(f"{k}: {per_step[k]} launches per step, "
                                 f"want {v}")
    names, values = metric.get()
    print(f"train: {dict(zip(names, values))}")
    if not np.isfinite(values[1]):
        raise AssertionError("the training loss is not finite")
    for k, v in before.items():
        moved = float(np.abs(args[k].asnumpy() - v).max())
        print(f"train: {k} moved by up to {moved:.3g}")
        if not moved > 0:
            raise AssertionError(f"{k} did not move")
    return counts, mod, it


def _one_step(mx, sym, args, auxs, ctx, X, y, optimizer_params):
    mod = mx.mod.Module(sym, context=ctx)
    mod.fit(mx.io.NDArrayIter(X, y, batch_size=len(X)), num_epoch=1,
            arg_params=mx.convert.params_from_numpy(args, ctx),
            aux_params=mx.convert.params_from_numpy(auxs, ctx),
            optimizer_params=optimizer_params)
    a, x = mod.get_params()
    return (mod.get_outputs()[0].asnumpy(),
            {k: v.asnumpy() for k, v in a.items()},
            {k: v.asnumpy() for k, v in x.items()})


def phase_train_parity(mx):
    """One ResNet-50 step at batch 2, card vs CPU, TF32 off."""
    import numpy as np
    import torch
    print(_tf32(False) + " (parity phase)")
    sym = _resnet50(mx)
    X, y = _images(2, SEED + 1)
    init = mx.mod.Module(sym, context=mx.cpu())
    init.bind([("data", X.shape)], [("softmax_label", y.shape)])
    init.init_params(mx.initializer.Xavier(
        rng=torch.Generator().manual_seed(SEED)))
    args, auxs = ({k: v.asnumpy() for k, v in d.items()}
                  for d in init.get_params())
    rs = np.random.RandomState(SEED + 2)
    nudged = {k: (v * (1 + 1e-6 * rs.randn(*v.shape))).astype(np.float32)
              for k, v in args.items()}
    t0 = time.perf_counter()
    cpu = _one_step(mx, sym, args, auxs, mx.cpu(), X, y, SGD)
    spread = _one_step(mx, sym, nudged, auxs, mx.cpu(), X, y, SGD)
    t_cpu = time.perf_counter() - t0
    gpu = _one_step(mx, sym, args, auxs, mx.gpu(0), X, y, SGD)
    prob_err = float(np.abs(gpu[0] - cpu[0]).max())
    aux_err = max(float((np.abs(gpu[2][k] - v) / (1 + np.abs(v))).max())
                  for k, v in cpu[2].items())
    worst, worst_k, arg_err = -1.0, None, 0.0
    for k, v in cpu[1].items():
        d = float(np.abs(gpu[1][k] - v).max())
        floor = float(np.abs(spread[1][k] - v).max())
        arg_err = max(arg_err, d)
        ratio = d / (SPREAD_FACTOR * floor + 1e-5)
        if ratio > worst:
            worst, worst_k = ratio, (k, d, floor)
    print(f"parity: one step at batch 2 (CPU steps {t_cpu:.1f} s): max "
          f"|prob card - cpu| = {prob_err:.3g} (limit {FWD_TOL}); max "
          f"relative |aux card - cpu| = {aux_err:.3g} (limit {FWD_TOL}); "
          f"max |arg card - cpu| = {arg_err:.3g}; worst array {worst_k[0]}: "
          f"{worst_k[1]:.3g} against the CPU's 1e-6 spread {worst_k[2]:.3g}"
          f" (limit {SPREAD_FACTOR} x spread + 1e-5, ratio {worst:.3f})")
    if not (prob_err <= FWD_TOL and aux_err <= FWD_TOL and worst <= 1.0):
        raise AssertionError("card and CPU training steps disagree")


def phase_adam(mx, ck):
    """Two Adam steps of the same fit at batch 4; returns the counts."""
    import torch
    print(_tf32(True))
    X, y = _images(8, SEED + 3)
    mod = mx.mod.Module(_resnet50(mx), context=mx.gpu(0))
    ck.reset_launch_counts()
    mod.fit(mx.io.NDArrayIter(X, y, batch_size=4), num_epoch=1,
            optimizer="adam", initializer=mx.initializer.Xavier(
                rng=torch.Generator().manual_seed(SEED)),
            optimizer_params={"learning_rate": 1e-3, "wd": 1e-4})
    torch.cuda.synchronize()
    counts = ck.launch_counts()
    n_params = len(mod.get_params()[0])
    print(f"adam: 2 steps at batch 4: launches {counts}")
    if counts["adam"] != 2 * n_params or counts["sgd_mom"]:
        raise AssertionError(f"adam launched {counts['adam']} times, want "
                             f"{2 * n_params}")
    return counts


#: device kernels by who wrote them: the port's CUDA kernels (by their
#: names in csrc/ — PyTorch's own softmax kernels are softmax_warp_forward
#: / _backward, so no bare "softmax_" prefix), the convolution and GEMM
#: libraries (cuDNN, cuBLAS, CUTLASS), PyTorch's own elementwise /
#: reduction kernels, and copies
_PORT_KERNELS = ("softmax_warp_f32", "softmax_block_f32", "softmax_ce_bwd_f32",
                 "sgd_mom_f32", "adam_f32", "ln_fwd_f32", "bias_gelu_",
                 "emb_gather", "decode_attn", "ln_bwd_dx_f32", "ln_dparams_",
                 "flash_fwd_f32")


def _kernel_group(key):
    if any(k in key for k in _PORT_KERNELS):
        return "port kernels"
    if key.startswith("Memcpy") or key.startswith("Memset"):
        return "copies"
    if "at::native" in key or "softmax_warp_" in key:
        return "PyTorch elementwise/reduction"
    return "conv/GEMM libraries"


def phase_train_profile(mod, it, steps=4, label="train profile",
                        gemm_flops=None):
    """Where a training step's time goes (ResNet-50's, the LM's). With
    ``gemm_flops`` (the matmul flops of one step), also the rate the
    convolution/GEMM libraries reach over their device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    it.reset()
    batch = next(iter(it))
    mod.forward_backward(batch)
    mod.update()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            mod.forward_backward(batch)
            mod.update()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    rows = sorted(((_self_device_us(e), e.count, e.key)
                   for e in prof.key_averages() if _self_device_us(e) > 0),
                  reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3 / steps
    print(f"{label}: {steps} steps: wall {wall_ms:.2f} ms/step, "
          f"device busy {busy_ms:.2f} ms/step ({100 * busy_ms / wall_ms:.1f}%"
          f" of wall), {sum(r[1] for r in rows) // steps} kernel launches "
          "per step")
    groups = {}
    for us, count, key in rows:
        g = _kernel_group(key)
        t, c = groups.get(g, (0.0, 0))
        groups[g] = (t + us, c + count)
    for g, (us, count) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"  group {g}: {us / 1e3 / steps:.3f} ms/step "
              f"({100 * us / 1e3 / steps / busy_ms:.1f}% of device time), "
              f"{count // steps} launches/step")
    for us, count, key in rows[:12]:
        print(f"  {us / 1e3 / steps:9.4f} ms/step  {count // steps:5d} "
              f"launches/step  {key[:90]}")
    if gemm_flops:
        lib_s = groups["conv/GEMM libraries"][0] / 1e6 / steps
        print(f"  the libraries' GEMMs: {gemm_flops / 1e12:.3f} TFLOP per "
              f"step, {gemm_flops / lib_s / 1e12:.1f} TFLOP/s over their "
              f"device time ({100 * gemm_flops / lib_s / F32_FLOPS_PER_S:.1f}"
              f"% of the float32 peak outside the tensor cores)")
    for us, count, key in rows:
        if _kernel_group(key) == "port kernels":
            print(f"  port {us / 1e3 / steps:9.4f} ms/step  "
                  f"{count // steps:5d} launches/step  {key[:80]}")


def _lm_gemm_flops():
    """Matmul flops of one full-width LM step: 6 per weight per token
    (forward, data and weight gradients) over the FullyConnected weights
    (12 D^2 a layer) and the tied head (V D), plus the attention
    backward's recompute: 6 (T x T x Dh) products per (b, h) row."""
    weights = N_LAYER * 12 * D * D + V * D
    attn = N_LAYER * 6 * 2 * LM_BATCH * N_HEAD * LM_SEQ ** 2 * (D // N_HEAD)
    return 6 * weights * LM_BATCH * LM_SEQ + attn


def _lm_symbol(seq):
    from mxnet_tpu_torch.models import transformer as tfm
    return tfm.get_symbol(vocab_size=V, d_model=D, n_layer=N_LAYER,
                          n_head=N_HEAD, seq_len=seq)


def phase_lm_train(mx, ck):
    """The transformer LM at the bench's full width through Module.fit
    on gpu(0). Returns (launch counts of the fit, module, iterator)."""
    import numpy as np
    import torch
    from mxnet_tpu_torch.models import transformer as tfm
    print(_tf32(True) + " (PyTorch's default, for the LM training phase)")
    it = tfm.SyntheticLMIter(V, LM_BATCH, LM_SEQ, LM_STEPS, seed=SEED)
    mod = mx.mod.Module(_lm_symbol(LM_SEQ), context=mx.gpu(0))
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params(mx.initializer.Xavier(
        rng=torch.Generator().manual_seed(SEED)))
    args, _ = mod.get_params()
    watch = ("lm_tok_embed_weight", "lm_l0_qkv_weight", "lm_l0_ln1_beta",
             f"lm_l{N_LAYER - 1}_ffn2_weight", "lm_ln_f_gamma")
    before = {k: args[k].asnumpy() for k in watch}
    stamps = []

    def step_end(_param):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
    metric = mx.metric.create(["acc", "ce"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    mod.fit(it, num_epoch=1, eval_metric=metric, optimizer="sgd",
            optimizer_params=LM_SGD, batch_end_callback=step_end)
    counts = ck.launch_counts()
    steps = np.diff(stamps) * 1e3          # the first batch excluded
    tokens = LM_BATCH * LM_SEQ
    print(f"lm train: V={V} d_model={D} {N_LAYER} layers {N_HEAD} heads "
          f"T={LM_SEQ} batch {LM_BATCH}, {len(stamps)} steps in "
          f"{time.perf_counter() - t0:.2f} s (first "
          f"{1e3 * (stamps[0] - t0):.1f} ms); without the first: "
          f"{tokens * len(steps) / (steps.sum() / 1e3):.1f} tokens/s, step "
          f"p50 {np.percentile(steps, 50):.2f} ms p99 "
          f"{np.percentile(steps, 99):.2f} ms; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    per_step = {k: v / len(stamps) for k, v in counts.items()}
    print(f"lm train: launches per step {per_step}")
    want = {k: LM_PER_STEP.get(k, 0) for k in counts}
    if per_step != want:
        raise AssertionError(f"LM launches per step {per_step}, want {want}")
    names, values = metric.get()
    print(f"lm train: {dict(zip(names, values))}")
    if not np.isfinite(values[1]):
        raise AssertionError("the LM training loss is not finite")
    for k, v in before.items():
        moved = float(np.abs(args[k].asnumpy() - v).max())
        print(f"lm train: {k} moved by up to {moved:.3g}")
        if not moved > 0:
            raise AssertionError(f"{k} did not move")
    return counts, mod, it


def _lm_step(mx, sym, params, ctx, batch):
    """One forward/backward/update of the LM from ``params`` on ``ctx``:
    (probabilities, {name: gradient}, {name: updated weight}), numpy."""
    mod = mx.mod.Module(sym, context=ctx)
    mod.bind(batch.provide_data, batch.provide_label)
    mod.init_params(arg_params=mx.convert.params_from_numpy(params, ctx))
    mod.init_optimizer(optimizer="sgd", optimizer_params=LM_SGD)
    mod.forward_backward(batch)
    exe = mod._exec_group.executor
    grads = {k: v.asnumpy() for k, v in exe.grad_dict.items()}
    mod.update()
    return (mod.get_outputs()[0].asnumpy(), grads,
            {k: v.asnumpy() for k, v in mod.get_params()[0].items()})


def phase_lm_parity(mx):
    """One LM step at full width, batch 2, T=128, card vs CPU, TF32 off."""
    import numpy as np
    from mxnet_tpu_torch.models import transformer as tfm
    print(_tf32(False) + " (LM parity phase)")
    sym = _lm_symbol(LM_PARITY_SEQ)
    shapes, _, _ = sym.infer_shape(
        data=(LM_PARITY_BATCH, LM_PARITY_SEQ),
        softmax_label=(LM_PARITY_BATCH * LM_PARITY_SEQ,))
    rs = np.random.RandomState(SEED + 4)
    params = {n: ((1 + 0.1 * rs.randn(*s)) if n.endswith("gamma")
                  else 0.02 * rs.randn(*s)).astype(np.float32)
              for n, s in zip(sym.list_arguments(), shapes)
              if n not in ("data", "softmax_label")}
    batch = next(iter(tfm.SyntheticLMIter(V, LM_PARITY_BATCH, LM_PARITY_SEQ,
                                          1, seed=SEED + 5)))
    t0 = time.perf_counter()
    cpu = _lm_step(mx, sym, params, mx.cpu(), batch)
    t_cpu = time.perf_counter() - t0
    gpu = _lm_step(mx, sym, params, mx.gpu(0), batch)
    prob_err = float(np.abs(gpu[0] - cpu[0]).max())
    label = batch.label[0].asnumpy().astype(np.int64)
    rows = np.arange(len(label))
    loss = [float(-np.log(p[rows, label] + 1e-8).mean()) for p in (gpu[0],
                                                                   cpu[0])]
    worst_g, worst_w = (-1.0, None), (-1.0, None)
    for k, g in cpu[1].items():
        ratio = float(np.abs(gpu[1][k] - g).max()) / \
            (GRAD_RTOL * float(np.abs(g).max()) + 1e-12)
        worst_g = max(worst_g, (ratio, k))
        d = float(np.abs(gpu[2][k] - cpu[2][k]).max())
        worst_w = max(worst_w, (d, k))
    print(f"lm parity: one step at batch {LM_PARITY_BATCH}, T="
          f"{LM_PARITY_SEQ} (CPU step {t_cpu:.1f} s): loss card "
          f"{loss[0]:.7f} cpu {loss[1]:.7f}; max |prob card - cpu| = "
          f"{prob_err:.3g} (limit {FWD_TOL}); worst gradient "
          f"{worst_g[1]}: {worst_g[0]:.3g} of its limit ({GRAD_RTOL} x its "
          f"max |g|); worst weight {worst_w[1]}: |card - cpu| = "
          f"{worst_w[0]:.3g} (limit {LM_WEIGHT_TOL}); "
          f"{len(cpu[1])} gradients")
    if not (prob_err <= FWD_TOL and abs(loss[0] - loss[1]) <= FWD_TOL
            and worst_g[0] <= 1.0 and worst_w[0] <= LM_WEIGHT_TOL):
        raise AssertionError("card and CPU LM steps disagree")


class _PacedClock:
    """Real time for ``run_scripted``: ``now`` reads the monotonic clock
    and ``advance`` sleeps, so the scripted arrivals land at real
    instants and the latencies count the card's work. The script submits
    and dispatches on one thread, so an arrival due while a dispatch runs
    waits for it."""

    def now(self):
        return time.monotonic()

    def advance(self, seconds):
        time.sleep(max(0.0, seconds))
        return self.now()


def _unload(ck, names):
    """Forget the loaded libraries of kernels ``names`` (their built
    files stay), so that their next launch loads them again and counts
    in ``ck.libraries_loaded()``."""
    for name in names:
        ck._libs.pop(name, None)
    for key in [k for k in ck._fns if k[0] in names]:
        del ck._fns[key]


def _centered_log(prob):
    """Each row of log(prob) less its mean: log-softmax is the logits less
    one constant per row, so these are the logits less their row mean."""
    import numpy as np
    z = np.log(np.maximum(prob.astype(np.float64), 1e-300))
    return z - z.mean(axis=1, keepdims=True)


def _quant_request(i, rng):
    """Request i of the scripted mix: 1-3 rows (1 + i % 3), numpy-seeded."""
    import numpy as np
    return {"data": rng.rand(1 + i % 3, *TRAIN_IMAGE).astype(np.float32)}


def phase_quant_serve(mx, ck):
    """ResNet-50 (1000 classes, 3x224x224, Xavier seed 0) bound on gpu(0)
    and served through mx.serve.serve at ladder QUANT_RUNGS three times:
    float32, int8, fp8. Each serves QUANT_REQS scripted requests of 1-3
    rows, one every QUANT_GAP_S. Returns (the module, the quantized
    kernels' launches over the int8 and fp8 runs, {tier: server})."""
    import numpy as np
    import torch
    from mxnet_tpu_torch.ops import quant
    print(_tf32(True) + " (PyTorch's default, for the quantized-serving "
          "phase)")
    mod = mx.mod.Module(_resnet50(mx), context=mx.gpu(0))
    rung = QUANT_RUNGS[-1]
    mod.bind([("data", (rung,) + TRAIN_IMAGE)], [("softmax_label", (rung,))],
             for_training=False)
    mod.init_params(mx.initializer.Xavier(
        rng=torch.Generator().manual_seed(SEED)))
    ops = [n.op for n in mod._symbol._topo_nodes() if not n.is_variable]
    per_fwd = {"dequant_rows": ops.count("Convolution"),
               "qfc_matmul": ops.count("FullyConnected")}
    outs, launches, servers = {}, dict.fromkeys(QUANT_KERNELS, 0), {}
    for tier in (None, "int8", "fp8"):
        name = tier or "float32"
        # the kernel phase loaded every library already: unload the two
        # quantized kernels' so that this ladder's warmup must load them
        # again, and the zero read after it means the warmup ran them
        _unload(ck, QUANT_KERNELS)
        ck.reset_launch_counts()
        t0 = time.perf_counter()
        server = mx.serve.serve(mod, name=name, ladder=QUANT_RUNGS,
                                compute_dtype=tier, clock=_PacedClock(),
                                start=False)
        warm_s = time.perf_counter() - t0
        warm_loads = server.engine(name).warmup_compiles
        handles, submit = [], server.submit

        def keep(*a, submit=submit, handles=handles, **k):
            handles.append(submit(*a, **k))
            return handles[-1]
        server.submit = keep        # run_scripted's submits, kept
        now = server._clock.now()
        summary = mx.serve.run_scripted(
            server, [now + i * QUANT_GAP_S for i in range(QUANT_REQS)],
            _quant_request)
        counts = ck.launch_counts()
        stats = server.stats()
        m = stats["models"][name]
        forwards = 2 * len(QUANT_RUNGS) + m["dispatches"]
        ran = {k: counts[k] for k in QUANT_KERNELS}
        print(f"quant serve {name}: bound + warmed in {warm_s:.2f} s; "
              f"{summary['completed']} of {summary['offered']} requests, "
              f"{summary['req_per_sec']} req/s, latency ms p50 "
              f"{summary['latency_ms']['p50']} p99 "
              f"{summary['latency_ms']['p99']}; {m['dispatches']} dispatches"
              f", batch_occupancy {m['batch_occupancy']}, padding_waste_pct "
              f"{m['padding_waste_pct']}, kernel libraries loaded by "
              f"warmup {warm_loads}, compiles_since_warmup "
              f"{stats['compiles_since_warmup']}; exec_est_ms "
              f"{m['exec_est_ms']}; launches {ran} over {forwards} forwards "
              "(warmup included)")
        if stats["compiles_since_warmup"] != 0:
            raise AssertionError(f"{name}: kernels built after warmup")
        if warm_loads != (len(QUANT_KERNELS) if tier else 0):
            raise AssertionError(f"{name}: warmup loaded {warm_loads} "
                                 "kernel libraries")
        if summary["completed"] != QUANT_REQS or summary["errors"]:
            raise AssertionError(f"{name}: {summary}")
        for k in QUANT_KERNELS:
            want = per_fwd[k] * forwards if tier else 0
            if ran[k] != want:
                raise AssertionError(f"{name}: {k} launched {ran[k]} "
                                     f"times, want {want}")
            launches[k] += ran[k]
        outs[name] = [h.result(timeout=0)[0].asnumpy() for h in handles]
        for i, o in enumerate(outs[name]):
            if o.shape != (1 + i % 3, TRAIN_CLASSES) or \
                    not np.isfinite(o).all():
                raise AssertionError(f"{name}: request {i} answered "
                                     f"{o.shape}, finite "
                                     f"{np.isfinite(o).all()}")
        servers[name] = server
    for tier, tol in (("int8", quant.INT8_TOL), ("fp8", quant.FP8_TOL)):
        worst = max(float(np.abs(q - f).max())
                    for q, f in zip(outs[tier], outs["float32"]))
        zq, zf = (_centered_log(np.concatenate(outs[k]))
                  for k in (tier, "float32"))
        print(f"quant serve {tier}: max |prob - float32 ladder's| = "
              f"{worst:.3g} (tolerance {tol}); centered logits "
              f"{float(np.abs(zq - zf).max()) / float(np.abs(zf).max()):.3g}"
              " of the float32 ladder's largest apart (not gated)")
        if not all(np.allclose(q, f, **tol)
                   for q, f in zip(outs[tier], outs["float32"])):
            raise AssertionError(f"{tier} outputs leave {tol} of the float "
                                 "ladder's")
    return mod, launches, servers


def phase_quant_parity(mx, mod, servers):
    """One int8 and one fp8 quantized ResNet-50 forward at batch 2, TF32
    off: on the card through the engine that phase 12 served (its
    rewritten graph and kernels), against a CPU Module of the same
    rewrite from the same parameters. The random model's probabilities
    all lie near 1/1000, so beside them the logits the softmax saw are
    held, relative to their largest magnitude (``_centered_log``)."""
    import numpy as np
    from mxnet_tpu_torch.ops import quant
    print(_tf32(False) + " (quantized parity phase)")
    args, auxs = ({k: v.asnumpy() for k, v in d.items()}
                  for d in mod.get_params())
    X = _images(2, SEED + 6)[0]
    for tier in ("int8", "fp8"):
        card = servers[tier].engine(tier).forward(len(X), {"data": X})
        qsym, qargs = quant.quantize_symbol(mod._symbol, args, dtype=tier)
        m = mx.mod.Module(qsym, context=mx.cpu())
        m.bind([("data", X.shape)], [("softmax_label", (len(X),))],
               for_training=False)
        m.init_params(arg_params=qargs, aux_params=auxs)
        m.forward(mx.io.DataBatch([X], None), is_train=False)
        prob = [card[0].asnumpy(), m.get_outputs()[0].asnumpy()]
        err = float(np.abs(prob[0] - prob[1]).max())
        z = [_centered_log(p) for p in prob]
        z_err = float(np.abs(z[0] - z[1]).max()) / float(np.abs(z[1]).max())
        top = [p.argmax(1).tolist() for p in prob]
        print(f"quant parity {tier}: batch 2 through the served engine, "
              f"max |prob card - cpu| = {err:.3g} (limit "
              f"{QUANT_PARITY_TOL}); centered logits {z_err:.3g} of their "
              f"largest magnitude {float(np.abs(z[1]).max()):.4g} apart "
              f"(limit {QUANT_LOGIT_RTOL}); top-1 card {top[0]} cpu "
              f"{top[1]}; max prob {float(prob[1].max()):.4g}")
        if not (err <= QUANT_PARITY_TOL and z_err <= QUANT_LOGIT_RTOL
                and top[0] == top[1]):
            raise AssertionError(f"{tier}: card and CPU quantized forwards "
                                 "disagree")


def _quant_group(key):
    for name in ("dequant_rows", "qfc_matmul"):
        if name in key:
            return f"{name} kernel"
    if "softmax_warp_f32" in key or "softmax_block_f32" in key:
        return "softmax kernel"
    if key.startswith("Memcpy") or key.startswith("Memset"):
        return "copies"
    if "at::native" in key:
        return "PyTorch elementwise/reduction"
    return "cuDNN/cuBLAS"


def phase_quant_profile(servers, steps=8):
    """Where a rung-8 dispatch goes, per tier: ``steps`` full-rung
    submits, each dispatched at once by pump(). The three ladders' wall
    per dispatch is taken in turns (float32, int8, fp8, fp8, int8,
    float32) without the profiler; then each ladder's device time under
    it, with int8's split by kernel group."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    print(_tf32(True))
    rung = QUANT_RUNGS[-1]
    X = np.random.RandomState(SEED + 7).rand(rung, *TRAIN_IMAGE) \
        .astype(np.float32)

    def dispatch(server):
        h = server.submit({"data": X})
        if server.pump() != 1:
            raise AssertionError("a full-rung request did not dispatch")
        h.result(timeout=0)

    def wall_ms(server):
        t0 = time.perf_counter()
        for _ in range(steps):
            dispatch(server)
        return (time.perf_counter() - t0) * 1e3 / steps
    for server in servers.values():
        dispatch(server)
    turns = [(name, wall_ms(servers[name])) for name in
             ("float32", "int8", "fp8", "fp8", "int8", "float32")]
    print(f"quant turns, {steps} rung-{rung} dispatches each, wall "
          "ms/dispatch: " + ", ".join(f"{n} {ms:.3f}" for n, ms in turns))
    for name, server in servers.items():
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                dispatch(server)
            wall = (time.perf_counter() - t0) * 1e3 / steps
        rows = [(_self_device_us(e), e.count, e.key)
                for e in prof.key_averages() if _self_device_us(e) > 0]
        busy_ms = sum(r[0] for r in rows) / 1e3 / steps
        print(f"quant profile: {name} rung {rung}, {steps} dispatches: "
              f"wall {wall:.3f} ms/dispatch, device busy {busy_ms:.3f} "
              f"ms/dispatch ({100 * busy_ms / wall:.1f}% of wall), "
              f"{sum(r[1] for r in rows) / steps:.1f} kernel launches per "
              "forward")
        if name != "int8":
            continue
        groups = {}
        for us, count, key in rows:
            g = _quant_group(key)
            t, c = groups.get(g, (0.0, 0))
            groups[g] = (t + us, c + count)
        for g, (us, count) in sorted(groups.items(),
                                     key=lambda kv: -kv[1][0]):
            print(f"  group {g}: {us / 1e3 / steps:.4f} ms/dispatch "
                  f"({100 * us / 1e3 / steps / busy_ms:.1f}% of device "
                  f"time), {count / steps:.1f} launches/dispatch")
        for us, count, key in sorted(rows, reverse=True)[:8]:
            print(f"  {us / 1e3 / steps:9.4f} ms/dispatch  "
                  f"{count / steps:6.1f} launches/dispatch  {key[:90]}")


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "mxnet_tpu_torch", "csrc")):
        print("chip_smoke: run from the root of a checkout (no "
              "mxnet_tpu_torch/ beside this script)", file=sys.stderr)
        return 2
    sys.path.insert(0, here)
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import cuda_kernels as ck

    t_start = time.perf_counter()
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    smi = phase_build(ck)
    rec = phase_kernels(mx, ck)
    serve_counts, sym, params = phase_serve(mx, ck)
    phase_profile(mx, sym, params)
    train_counts, train_mod, train_it = phase_train(mx, ck)
    phase_train_parity(mx)
    adam_counts = phase_adam(mx, ck)
    phase_train_profile(train_mod, train_it)
    del train_mod, train_it
    lm_counts, lm_mod, lm_it = phase_lm_train(mx, ck)
    phase_lm_parity(mx)
    phase_train_profile(lm_mod, lm_it, label="lm profile",
                        gemm_flops=_lm_gemm_flops())
    del lm_mod, lm_it
    torch.cuda.empty_cache()
    q_mod, quant_counts, q_servers = phase_quant_serve(mx, ck)
    phase_quant_parity(mx, q_mod, q_servers)
    phase_quant_profile(q_servers)
    for server in q_servers.values():
        server.stop()
    launches = dict(train_counts)
    launches.update({k: serve_counts[k] for k in DECODE_KERNELS})
    launches["adam"] = adam_counts["adam"]
    launches.update({k: lm_counts[k] for k in LM_KERNELS})
    launches.update(quant_counts)
    kernels = []
    for name in ck.KERNELS:
        r = rec[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"mxnet_tpu_torch/csrc/{ck._SPECS[name][0]}",
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": r["library_ms"]})
    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
