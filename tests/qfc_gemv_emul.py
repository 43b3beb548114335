"""The dequant-fused matmul's GEMV route (``csrc/qfc_matmul.cu``) in plain
PyTorch, its order of work, for the CPU tests
(``tests/test_torch_qfc_gemv.py``) and the card tests
(``tests/test_torch_cuda.py``). Torch only: the card machine has no JAX.

With the wrapper's own route (``cuda_kernels._qfc_route``: mt rows of x a
block, K split over ks warps), for every output channel n and row m: the
weights are decoded and scaled once (float32 product, one rounding); the
16-value units of K are cut into ks splits of ``per = ceil(units / ks)``
units; in split j, lane l sums units lo + l, lo + l + 32, ... in order, each
unit's 16 values in order, one FMA a value (a float32 product summed in
float64 and rounded once: the FMA's value, but for a double rounding that
can move a tie); the 32 lane partials are summed by the shuffle butterfly
(xor 16, 8, 4, 2, 1, float32 adds); the splits' sums are added in split
order. Units and x are zeros past K.
"""
import torch

from mxnet_tpu_torch.ops import cuda_kernels as ck

LANES = 32


def qfc_gemv(x2, wq, scale, sms=132):
    """The GEMV route's float32 output for x2 (M, K) float32, bfloat16 or
    float16, wq (N, K) int8 or float8_e4m3fn and scale (N,) float32, as
    on a card of ``sms`` SMs. CPU tensors; the route must be the GEMV."""
    (m, k), n = x2.shape, wq.shape[0]
    mt, ks = ck._qfc_route(m, n, k, sms)
    assert mt > 0, "the shapes take the tiled route"
    units = -(-k // 16)
    pad = units * 16 - k
    xf = torch.nn.functional.pad(x2.to(torch.float32), (0, pad))
    wf = torch.nn.functional.pad(
        wq.to(torch.float32) * scale.to(torch.float32)[:, None], (0, pad))
    xv = xf.reshape(m, units, 16).to(torch.float64)
    wv = wf.reshape(n, units, 16).to(torch.float64)
    per = -(-units // ks)
    lanes = torch.arange(LANES)
    total = None
    for split in range(ks):
        lo, hi = split * per, min(units, split * per + per)
        acc = torch.zeros(m, n, LANES, dtype=torch.float32)
        for base in range(lo, hi, LANES):
            u = base + lanes
            live = u < hi
            uc = torch.clamp(u, max=units - 1)
            for e in range(16):
                prod = xv[:, uc, e][:, None, :] * wv[:, uc, e][None, :, :]
                step = (prod + acc.to(torch.float64)).to(torch.float32)
                acc = torch.where(live, step, acc)
        for o in (16, 8, 4, 2, 1):
            acc = acc + acc[..., lanes ^ o]
        part = acc[..., 0]
        total = part if total is None else total + part
    return total
