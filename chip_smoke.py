#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``mxnet_tpu_torch``).

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

1. build every CUDA kernel of the decode path from ``mxnet_tpu_torch/csrc``
   (one ``nvcc`` per source, in parallel), print the build seconds, the
   compiler's register report, the card's name and power limit, and the
   TF32 switches (both held off: the reference computes in full float32);
2. hold each kernel against its plain PyTorch version on the card, at the
   shapes the decode path gives it, and time kernel, plain version and —
   where one PyTorch call computes the same function — that library call;
3. serve the repo's transformer LM at full width (V=32000, d_model=512,
   8 layers, 8 heads, rotary, cache 256, slot ladder [1, 4, 8], random
   weights from a numpy seed) through ``serve_decoder``'s dispatch thread:
   8 requests of 16 prompt tokens and 64 new tokens, staggered so the
   rung switches; every launch counter is zeroed just before and must
   have risen while serving; one served stream is then teacher-forced
   through the decoder on the card and on the CPU (plain versions) and
   the logits compared;
4. profile 16 full-rung decode steps: wall time per step, the device-busy
   share, and the kernels that take the most device time.

The line before the last is ``{"kernels": [...]}`` (one entry per kernel:
launches on the served path, max abs error against the plain version,
kernel / plain / library milliseconds and the bound); the last line is
``{"ok": true, "device": {...}}``. Without CUDA, or outside a checkout,
the script exits non-zero and prints no result.
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
TOL = {"embedding": 0.0, "layernorm": 2e-5, "bias_gelu": 2e-5,
       "decode_attention": 2e-5}
LOGIT_TOL = 2e-3               # card vs CPU logits, full model, float32
REPLACES = {
    "embedding": "mxnet_tpu/ops/pallas_kernels.py:858",
    "layernorm": "mxnet_tpu/ops/pallas_kernels.py:585",
    "bias_gelu": "mxnet_tpu/ops/pallas_kernels.py:746",
    "decode_attention": "mxnet_tpu/ops/pallas_kernels.py:953",
}


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
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"tf32: matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}"
          f" cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"float32_matmul_precision={torch.get_float32_matmul_precision()}")
    return smi


def phase_kernels(ck):
    """Each kernel against its plain version at the decode path's shapes.
    Returns {name: record} for the result line."""
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
    for name, r in rec.items():
        dev_ms = _device_ms(calls[name])
        print(f"kernel {name}: max_abs_err={r['max_abs_err']:.3g} "
              f"(tol {TOL[name]}) kernel_ms={r['ms']:.5f} "
              f"device_ms={dev_ms} plain_ms={r['plain_ms']:.5f} "
              f"library_ms={r['library_ms']} "
              f"bound_ms={r['bound'][0]:.6f} ({r['bound'][1]})")
        if not r["max_abs_err"] <= TOL[name]:
            raise AssertionError(f"kernel {name} disagrees with its plain "
                                 f"version: {r['max_abs_err']} > {TOL[name]}")
    return rec


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
            h.add_token_callback(
                lambda _h, _tok, idx: idx >= 3 and started.set())
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
    for name in ck.KERNELS:
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

    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    smi = phase_build(ck)
    rec = phase_kernels(ck)
    counts, sym, params = phase_serve(mx, ck)
    phase_profile(mx, sym, params)
    kernels = []
    for name in ck.KERNELS:
        r = rec[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"mxnet_tpu_torch/csrc/{ck._SPECS[name][0]}",
            "replaces": REPLACES[name], "launches": counts[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": r["library_ms"]})
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
