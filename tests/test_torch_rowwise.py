"""The reduction orders of the port's row kernels (softmax, LayerNorm
forward), emulated in numpy, against the JAX package's Pallas kernels and
the port's plain versions.

``csrc/softmax.cu`` and ``csrc/layernorm.cu`` hold each row in registers
and reduce it in a fixed order: a thread (a lane) sums its own values
unit by unit (units of W values, W from C, the type and 16-byte
alignment), then an xor butterfly over a warp's 32 lanes; the softmax's
block route takes its 16 warp partials through the same butterfly, and
its cluster route adds the blocks' partials in rank order. The emulations
below repeat that partition and that tree in float32 (``fmaf`` through
float64, exact for a product of two float32 values), round the output to
the 16-bit type once, and are held to the Pallas kernels (interpret mode,
as the JAX package's own tests run them off-TPU) and to the plain
versions with the kernels' tolerances: 2e-5 in float32 (sums in another
order), one ulp of the 16-bit type (a float32 sum in another order can
move a quotient across a rounding boundary). The kernels themselves run
only on a card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from mxnet_tpu.ops import pallas_kernels as pk
from mxnet_tpu.ops.registry import get_op as jax_op

from mxnet_tpu_torch.ops import cuda_kernels as ck

TOL = 2e-5
#: the kernels' constants (csrc/softmax.cu, csrc/layernorm.cu)
WARP_ROW_MAX = 1024          # longest row one warp holds
BLOCK_THREADS = 1024         # the softmax's block / cluster route
CLUSTER_ROW_MAX = BLOCK_THREADS * 16
#: type -> (torch dtype, jax dtype, mantissa bits, smallest normal exponent)
TYPES = {"float32": (torch.float32, jnp.float32, 23, -126),
         "bfloat16": (torch.bfloat16, jnp.bfloat16, 7, -126),
         "float16": (torch.float16, jnp.float16, 10, -14)}
SHAPES = [(16, 1), (16, 7), (16, 33), (16, 512), (16, 1000), (16, 1024),
          (16, 1025), (16, 4096), (2, 16386), (4, 32000), (1, 1000)]


def _unit(c, dtype):
    """W, the values a 16-byte-aligned row of C values is read in."""
    if dtype == "float32":
        return 4 if c % 4 == 0 else 1
    return 8 if c % 8 == 0 else (2 if c % 2 == 0 else 1)


def _itemsize(dtype):
    return 4 if dtype == "float32" else 2


def _butterfly(v, op):
    """The xor butterfly over the last axis (32 lanes): every lane ends
    with the same value; returns it."""
    lanes = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        v = op(v, v[..., lanes ^ o])
    return v[..., 0]


def _lane_values(vals, w, first, stride, k, end):
    """(values (rows, threads, k * w), held (threads, k * w)): each
    thread's values in the order it takes them, units ``first + t + j *
    stride`` (j < k) below ``end``."""
    rows = vals.shape[0]
    threads = np.arange(stride)
    idx = first + threads[:, None] + stride * np.arange(k)[None, :]
    live = idx < end
    per_unit = vals.reshape(rows, -1, w)
    out = np.zeros((rows, stride, k, w), np.float32)
    out[:, live] = per_unit[:, idx[live]]
    return out.reshape(rows, stride, k * w), np.repeat(live, w, axis=1)


def _seq(vals, held, op, fill):
    """A thread's sequential reduction of the values it holds."""
    acc = np.full(vals.shape[:-1], fill, np.float32)
    for j in range(vals.shape[-1]):
        acc = np.where(held[:, j], op(acc, vals[..., j]), acc).astype(
            np.float32)
    return acc


def _softmax_route(c, w, itemsize):
    """[(first unit, end unit)] per block of a row, and the threads a
    block uses (32: the warp route). One block holds 32 values a thread
    with 16-byte units, 16 with narrower ones; a cluster's blocks 16."""
    units = c // w
    if c <= WARP_ROW_MAX:
        return [(0, units)], 32
    if c <= BLOCK_THREADS * (32 if w * itemsize == 16 else 16):
        return [(0, units)], BLOCK_THREADS
    r = -(-c // CLUSTER_ROW_MAX)
    per = -(-units // r)
    return [(b * per, min(units, (b + 1) * per)) for b in range(r)], \
        BLOCK_THREADS


def _reduce_row(x, c, w, itemsize, op, fill):
    """The kernels' reduction (``op``) over each row of x."""
    parts = []
    blocks, threads = _softmax_route(c, w, itemsize)
    for first, end in blocks:
        k = max(1, -(-(end - first) // threads))
        vals, held = _lane_values(x, w, first, threads, k, end)
        per_thread = _seq(vals, held, op, fill)            # rows, threads
        warps = _butterfly(per_thread.reshape(x.shape[0], -1, 32), op)
        if threads == 32:
            parts.append(warps[:, 0])
            continue
        parts.append(_butterfly(warps, op))            # 32 warps
    total = parts[0]
    for p in parts[1:]:
        total = op(total, p).astype(np.float32)
    return total


def softmax_emulated(x, dtype):
    """y as csrc/softmax.cu computes it from x (rows, C) float32 (the
    values of a ``dtype`` row, widened exactly), in float32."""
    c = x.shape[1]
    w = _unit(c, dtype)
    size = _itemsize(dtype)
    m = _reduce_row(x, c, w, size, np.fmax, -np.inf)
    e = np.exp(x - m[:, None]).astype(np.float32)
    s = _reduce_row(e, c, w, size, np.add, 0.0)
    return (e / s[:, None]).astype(np.float32)


def _fma(a, b, c):
    return (a.astype(np.float64) * b + c).astype(np.float32)


def layernorm_emulated(x, g, b, eps, dtype):
    """(y, mean, rstd, std) as csrc/layernorm.cu computes them from x
    (rows, C), gamma and beta (float32 values of ``dtype`` arrays): one
    warp a row, lane-sequential sums, the butterfly, fmaf where the
    kernel has it (the squared deviations; y's last multiply-add, which
    nvcc contracts)."""
    rows, c = x.shape
    w = _unit(c, dtype)
    units = c // w
    k = -(-units // 32)
    inv_c = np.float32(1.0) / np.float32(c)
    vals, held = _lane_values(x, w, 0, 32, k, units)
    mean = (_butterfly(_seq(vals, held, np.add, 0.0), np.add) *
            inv_c).astype(np.float32)
    d = (vals - mean[:, None, None]).astype(np.float32)
    q = np.zeros((rows, 32), np.float32)
    for j in range(d.shape[-1]):
        q = np.where(held[:, j], _fma(d[..., j], d[..., j], q), q)
    var = (_butterfly(q, np.add) * inv_c).astype(np.float32)
    rstd = (np.float32(1.0) / np.sqrt(var + np.float32(eps))).astype(
        np.float32)
    t = ((x - mean[:, None]).astype(np.float32) * rstd[:, None]).astype(
        np.float32)
    y = _fma(t, np.broadcast_to(g, x.shape), np.broadcast_to(b, x.shape))
    return y, mean, rstd, (np.float32(1.0) / rstd).astype(np.float32)


def _typed(a, dtype):
    """numpy float32 -> (torch, jax, numpy float32 of the rounded values)
    in ``dtype``, rounded to nearest even from the same values."""
    t = torch.from_numpy(np.asarray(a, np.float32)).to(TYPES[dtype][0])
    return t, jnp.asarray(np.asarray(a, np.float32)).astype(
        TYPES[dtype][1]), t.float().numpy()


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _rounded(y, dtype):
    """float32 values rounded once to ``dtype`` (as the kernels store)."""
    return torch.from_numpy(y).to(TYPES[dtype][0]).float().numpy()


def _agree(a, b, dtype, atol=0.0):
    """float32: within 2e-5 (absolute and relative); 16-bit: within one
    ulp of the type at the larger magnitude beyond ``atol``."""
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    if dtype == "float32":
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)
        return
    bits, emin = TYPES[dtype][2:]
    mag = np.maximum(np.maximum(np.abs(a), np.abs(b)), 2.0 ** emin)
    ulp = 2.0 ** (np.floor(np.log2(mag)) - bits)
    assert float((np.maximum(np.abs(a - b) - atol, 0) / ulp).max()) <= 1


@pytest.mark.parametrize("dtype", list(TYPES))
@pytest.mark.parametrize("shape", SHAPES)
def test_softmax_emulation_matches_pallas_and_plain(shape, dtype):
    rs = np.random.RandomState(shape[1])
    tx, jx, x = _typed(4 * rs.randn(*shape), dtype)
    got = _rounded(softmax_emulated(x, dtype), dtype)
    _agree(got, pk._pl_softmax(jx), dtype)
    _agree(got, ck.softmax_plain(tx), dtype)


def test_softmax_emulation_cluster_route_at_the_bound():
    """C = 65536, the JAX eligibility bound: a cluster of four blocks."""
    rs = np.random.RandomState(7)
    for dtype in TYPES:
        tx, _, x = _typed(4 * rs.randn(2, ck.SOFTMAX_MAX_C), dtype)
        blocks, threads = _softmax_route(
            x.shape[1], _unit(x.shape[1], dtype), _itemsize(dtype))
        assert threads == BLOCK_THREADS
        assert len(blocks) == 4
        _agree(_rounded(softmax_emulated(x, dtype), dtype),
               ck.softmax_plain(tx), dtype)


def test_softmax_routes_split_where_the_kernel_does():
    """The route boundaries the emulation shares with the kernel: one
    warp to C = 1024, one block to 32768 with 16-byte units (the LM head's
    32000) and to 16384 without, a cluster above."""
    assert _softmax_route(1024, 4, 4) == ([(0, 256)], 32)
    assert _softmax_route(1025, 1, 4) == ([(0, 1025)], BLOCK_THREADS)
    assert _softmax_route(32000, 4, 4) == ([(0, 8000)], BLOCK_THREADS)
    assert _softmax_route(32000, 8, 2) == ([(0, 4000)], BLOCK_THREADS)
    assert _softmax_route(32768, 8, 2) == ([(0, 4096)], BLOCK_THREADS)
    assert _softmax_route(16384, 2, 2) == ([(0, 8192)], BLOCK_THREADS)
    assert _softmax_route(16386, 2, 2) == ([(0, 4097), (4097, 8193)],
                                           BLOCK_THREADS)
    assert _softmax_route(32769, 1, 4) == (
        [(0, 10923), (10923, 21846), (21846, 32769)], BLOCK_THREADS)


def test_softmax_emulation_rows_of_minus_infinity():
    """-inf columns give exact zeros; a row of -inf gives NaN, as the
    plain version's exp(-inf - -inf) does."""
    x = np.full((2, 33), -np.inf, np.float32)
    x[0, 5] = 1.0
    with np.errstate(invalid="ignore"):
        y = softmax_emulated(x, "float32")
    want = ck.softmax_plain(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(y, want)                 # NaN == NaN
    assert y[0, 5] == 1.0 and np.isnan(y[1]).all()


@pytest.mark.parametrize("dtype", list(TYPES))
@pytest.mark.parametrize("shape", SHAPES)
def test_layernorm_emulation_matches_pallas_and_plain(shape, dtype):
    rs = np.random.RandomState(shape[1] + 1)
    tx, jx, x = _typed(3 * rs.randn(*shape) + 1, dtype)
    tg, jg, g = _typed(1 + 0.1 * rs.randn(shape[1]), dtype)
    tb, jb, b = _typed(0.1 * rs.randn(shape[1]), dtype)
    y, mean, rstd, std = layernorm_emulated(x, g, b, 1e-5, dtype)
    y = _rounded(y, dtype)
    jy, jmean, jrstd = pk._pl_layernorm_fwd(jx, jg, jb, 1e-5)
    py, pmean, prstd = ck.layernorm_plain(tx, tg, tb, 1e-5)
    for want_y, want_mean, want_rstd in ((jy, np.asarray(jmean)[:, 0],
                                          np.asarray(jrstd)[:, 0]),
                                         (py, pmean, prstd)):
        _agree(y, want_y, dtype, atol=0.0 if dtype == "float32" else TOL)
        _agree(mean, want_mean, "float32")
        _agree(rstd, want_rstd, "float32")
    np.testing.assert_array_equal(std, np.float32(1.0) / rstd)


@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("dtype", list(TYPES))
def test_fused_layernorm_std_is_one_over_rstd_bit_for_bit(dtype, grad):
    """The op's std is ``1 / rstd`` bit for bit, from one statistics
    block (mean, rstd, std); its three outputs match the JAX op's, with
    and without a gradient recorded (the ``autograd.Function`` and the
    direct call)."""
    rs = np.random.RandomState(11)
    tx, jx, _ = _typed(2 * rs.randn(2, 3, 64) + 0.5, dtype)
    tg, jg, _ = _typed(1 + 0.1 * rs.randn(64), dtype)
    tb, jb, _ = _typed(0.1 * rs.randn(64), dtype)
    tg.requires_grad_(grad)
    y, mean, std = ck.fused_layernorm(tx, tg, tb, 1e-5)
    _, stats = ck.layernorm_stats(tx.reshape(-1, 64), tg, tb, 1e-5)
    assert stats.shape == (3, 6) and stats.dtype == torch.float32
    assert torch.equal(std.reshape(-1), 1.0 / stats[1])
    assert torch.equal(std.reshape(-1), stats[2])
    assert torch.equal(mean.reshape(-1), stats[0])
    assert y.requires_grad == grad and not std.requires_grad
    assert y.dtype == tx.dtype and mean.shape == std.shape == (2, 3)
    op = jax_op("LayerNorm")
    (jy, jmean, jstd), _ = op.forward(op.normalize_attrs({}), [jx, jg, jb],
                                      [], False, None)
    _agree(y, jy, dtype, atol=0.0 if dtype == "float32" else TOL)
    _agree(mean, jmean, "float32")
    _agree(std, jstd, "float32")


def test_layernorm_backward_makes_no_zeros_for_the_statistics():
    """The statistics' cotangents are not materialized: a training step's
    LayerNorm backward launches no zero fill for mean, rstd or std (three
    fills a LayerNorm on the card otherwise)."""
    rs = np.random.RandomState(5)
    x = torch.tensor(rs.randn(2, 3, 16).astype(np.float32),
                     requires_grad=True)
    g = torch.tensor(rs.randn(16).astype(np.float32), requires_grad=True)
    b = torch.tensor(rs.randn(16).astype(np.float32), requires_grad=True)
    y, _mean, _rstd, _std = ck.layernorm_fn(x, g, b, 1e-5)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        y.sum().backward()
    assert not [e.name for e in prof.events() if "zero" in e.name]
    assert x.grad.shape == x.shape and g.grad.shape == b.grad.shape == (16,)
