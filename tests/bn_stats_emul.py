"""The BatchNorm statistics kernel's order of work (``csrc/bn_stats.cu``)
in numpy float32, for the CPU tests (``tests/test_torch_bn_stats.py``)
and the card tests (``tests/test_torch_cuda.py``, which hold the kernel
to it bit for bit). numpy and the port's plan only: the card machine has
no JAX.

The launch's plan is the wrapper's own ``_bn_stats_plan``: a grid of
(channel groups, splits of N). Planes (one channel a block): thread t of
256 takes the units t, t + 256, ... of the block's (n, c) planes walked
as one flat range (a unit: 16 bytes of values, or one value), sums each
unit's values as a balanced tree and adds it to its running sums. Slabs
(``group`` channels a block): lane j of channel g (thread g P + j, P =
256 / group) adds channel g's values j, j + P, ... of each row in order.
A channel's lanes then combine in a butterfly over min(P, 32) lanes and,
for P > 32, the channel's warps in order; the splits of a channel group
(one cluster) are then added in split order. Squares are float32 products
rounded before they are added. Every operation is a float32 add or
multiply in the kernel's order, so the emulation gives the kernel's bits.
"""
import numpy as np

from mxnet_tpu_torch.ops import cuda_kernels as ck

T = ck.BN_STATS_THREADS


def _tree(u):
    """Balanced-tree sums over the last axis (a power of two long)."""
    while u.shape[-1] > 1:
        u = u[..., 0::2] + u[..., 1::2]
    return u[..., 0]


def _lanes(v, P):
    """The kernel's ``lanes_reduce`` over the last axis (P lanes)."""
    idx = np.arange(P)
    o = min(P, 32) // 2
    while o:
        v = v + v[..., idx ^ o]
        o //= 2
    if P <= 32:
        return v[..., 0]
    warps = v[..., ::32]
    acc = warps[..., 0]
    for k in range(1, warps.shape[-1]):
        acc = acc + warps[..., k]
    return acc


def _planes(x, ch, n0, nr, vec):
    """One planes block's (s, q) of channel ``ch``: x (N, C, HW)."""
    units = x[n0:n0 + nr, ch, :].reshape(-1, vec)
    iters = -(-units.shape[0] // T)
    pad = np.zeros((iters * T, vec), np.float32)
    pad[:units.shape[0]] = units
    pad = pad.reshape(iters, T, vec)
    s = np.zeros(T, np.float32)
    q = np.zeros(T, np.float32)
    for i in range(iters):
        s = s + _tree(pad[i])
        q = q + _tree(pad[i] * pad[i])
    return _lanes(s, T), _lanes(q, T)


def _slabs(x, c0, gc, group, n0, nr):
    """One slabs block's (s, q) of channels c0 .. c0 + gc: (group,) each."""
    hw = x.shape[2]
    P = T // group
    s = np.zeros((group, P), np.float32)
    q = np.zeros((group, P), np.float32)
    for r in range(nr):
        for k in range(-(-hw // P)):
            h = np.arange(P) + k * P
            live = h < hw
            v = np.zeros((group, P), np.float32)
            v[:gc] = np.where(live, x[n0 + r, c0:c0 + gc][:, np.minimum(
                h, hw - 1)], 0.0)
            s = s + v
            q = q + v * v
    return _lanes(s, P), _lanes(q, P)


def bn_stats_emul(x, itemsize=4, aligned=True, sms=132):
    """The kernel's (sum, sum of squares) of x (N, C, H, W), given as float32
    values (16-bit data widened exactly first), as it sums data of
    ``itemsize`` bytes, 16-byte aligned or not, on a card of ``sms`` SMs."""
    n, c = x.shape[:2]
    x = np.ascontiguousarray(x, np.float32).reshape(n, c, -1)
    hw = x.shape[2]
    route, vec, group, _, rows, splits = ck._bn_stats_plan(
        n, c, hw, itemsize, aligned, sms)
    out = np.zeros((2, c), np.float32)
    for c0 in range(0, c, group):
        gc = min(group, c - c0)
        parts = []
        for sp in range(splits):
            n0 = sp * rows
            nr = max(0, min(rows, n - n0))
            if route == ck.BN_PLANES:
                s, q = _planes(x, c0, n0, nr, vec) if nr and hw else (
                    np.float32(0), np.float32(0))
                parts.append((np.array([s]), np.array([q])))
            else:
                parts.append(_slabs(x, c0, gc, group, n0, nr))
        s, q = parts[0]
        for ps, pq in parts[1:]:
            s, q = s + ps, q + pq
        out[0, c0:c0 + gc] = np.asarray(s)[:gc]
        out[1, c0:c0 + gc] = np.asarray(q)[:gc]
    return out[0], out[1]
