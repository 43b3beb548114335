"""The LayerNorm backward's one-call wrapper, ``layernorm_bwd`` (dx, dgamma
and dbeta from one kernel, ``csrc/ln_bwd.cu``), on the CPU.

* ``layernorm_bwd_plain`` — what a CPU tensor runs — against ``jax.vjp``
  of the JAX package's Pallas LayerNorm (``pk._ln_pl_fn``, interpret mode,
  as the JAX package's own tests run it off-TPU) in float32, bfloat16 and
  float16, on the same numpy-seeded inputs.
* A numpy emulation of the kernel's reduction order, held to the Pallas
  kernels and to the plain versions. The order: a lane's units (16-byte
  units where C and the pointers allow, else one value), the lane's sums
  of gy and gy * xh in unit order, an xor butterfly over the warp's 32
  lanes for each row mean; for dgamma / dbeta, on the register route (C
  <= 1024) each warp's running column sums over the rows it walks (rows
  w, w + G * warps, ...), the block's warps added in warp order, then
  each column over the blocks: lane l adds blocks l, l + 32, ... in order
  and the butterfly adds the lanes; on the walked route (C > 1024) chunks
  of 64 rows, 8 row lanes a chunk added in order, the chunks added in
  order. Every sum float32, ``fmaf`` through float64 (exact for a product
  of two float32 values), each output rounded once to its type.
* ``_LayerNormFn.backward`` calls ``layernorm_bwd`` once when x, gamma and
  beta all need gradients, and a single-half wrapper when only one half
  is needed.

Tolerances: float32 2e-5, absolute and relative (the frameworks sum in
other orders), and 1e-4 for dgamma / dbeta summed over a hundred rows or
more (the card tests' bound for these sums); dx within one ulp of the
16-bit type beyond 2e-5, dgamma / dbeta within one ulp of the array's
largest magnitude (``tests/test_torch_lm_bf16.py``'s bounds). The kernel
itself runs only on a card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from mxnet_tpu.ops import pallas_kernels as pk

from mxnet_tpu_torch.ops import cuda_kernels as ck

EPS = 1e-5
TOL = 2e-5
SUM_TOL = 1e-4
ATOL = 2e-5
#: type -> (torch dtype, jax dtype, mantissa bits, smallest normal exponent)
TYPES = {"float32": (torch.float32, jnp.float32, 23, -126),
         "bfloat16": (torch.bfloat16, jnp.bfloat16, 7, -126),
         "float16": (torch.float16, jnp.float16, 10, -14)}
SHAPES = [(16, 64), (5, 13), (1, 1), (3, 1000), (9, 512), (4, 1025),
          (2, 4096)]
#: the kernel's constants (csrc/ln_bwd.cu)
REG_ROW_MAX = 1024
WALK_LANES = 8


def _inputs(n, c, dtype, seed=0):
    """(torch, jax, numpy float32 of the rounded values) of x, gamma, beta
    and ct in ``dtype``, rounded to nearest even from the same values."""
    rs = np.random.RandomState(seed + c)
    out = []
    for a in (3 * rs.randn(n, c) + 1, 1 + 0.3 * rs.randn(c),
              0.3 * rs.randn(c), rs.randn(n, c)):
        a = np.asarray(a, np.float32)
        t = torch.from_numpy(a).to(TYPES[dtype][0])
        out.append((t, jnp.asarray(a).astype(TYPES[dtype][1]),
                    t.float().numpy()))
    return out


def _pallas(jx, jg, jb, jct):
    """dx, dgamma, dbeta of the JAX package's Pallas LayerNorm."""
    _, vjp = jax.vjp(lambda x_, g_, b_: pk._ln_pl_fn(x_, g_, b_, EPS),
                     jx, jg, jb)
    zeros = jnp.zeros((jx.shape[0], 1), jnp.float32)
    return vjp((jct, zeros, zeros))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _ulp(mag, dtype):
    bits, emin = TYPES[dtype][2:]
    return 2.0 ** (np.floor(np.log2(np.maximum(mag, 2.0 ** emin))) - bits)


def _agree_dx(a, b, dtype):
    """float32: within 2e-5; 16-bit: one ulp of the type beyond 2e-5."""
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    if dtype == "float32":
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)
        return
    over = np.maximum(np.abs(a - b) - ATOL, 0.0)
    assert float((over / _ulp(np.maximum(np.abs(a), np.abs(b)),
                              dtype)).max()) <= 1


def _agree_sum(a, b, dtype, tol=TOL):
    """float32: within ``tol``; 16-bit: one ulp of the type at the
    array's largest magnitude."""
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    if dtype == "float32":
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol)
        return
    assert float(np.abs(a - b).max() / _ulp(np.abs(b).max(), dtype)) <= 1


def _rounded(y, dtype):
    """float32 values rounded once to ``dtype`` (as the kernel stores)."""
    return torch.from_numpy(np.ascontiguousarray(y)).to(
        TYPES[dtype][0]).float().numpy()


# ------------------------------------------ the plain version against JAX
@pytest.mark.parametrize("dtype", list(TYPES))
@pytest.mark.parametrize("n,c", SHAPES)
def test_layernorm_bwd_plain_matches_pallas(n, c, dtype):
    (tx, jx, _), (tg, jg, _), (tb, jb, _), (tct, jct, _) = _inputs(n, c,
                                                                   dtype)
    dx, dg, db = _pallas(jx, jg, jb, jct)
    _, mean, rstd = ck.layernorm_plain(tx, tg, tb, EPS)
    got = ck.layernorm_bwd_plain(tx, tg, tct, mean, rstd)
    assert all(t.dtype == TYPES[dtype][0] for t in got)
    assert got[0].shape == (n, c) and got[1].shape == got[2].shape == (c,)
    _agree_dx(got[0], dx, dtype)
    _agree_sum(got[1], dg, dtype)
    _agree_sum(got[2], db, dtype)
    # the wrapper on CPU tensors is the plain version, bit for bit, and
    # the two single-half wrappers give the same halves
    ck.reset_launch_counts()
    for a, b in zip(ck.layernorm_bwd(tx, tg, tct, mean, rstd), got):
        assert torch.equal(a, b)
    assert torch.equal(ck.layernorm_bwd_dx(tx, tg, tct, mean, rstd), got[0])
    for a, b in zip(ck.layernorm_bwd_dparams(tx, tct, mean, rstd), got[1:]):
        assert torch.equal(a, b)
    assert not any(ck.launch_counts().values())


# ------------------------------------- the kernel's order, in numpy
def _unit(c, dtype):
    """W: 16-byte units (4 float32 or 8 16-bit values) where C allows."""
    w = 4 if dtype == "float32" else 8
    return w if c % w == 0 else 1


def _route(c, dtype):
    """("regs", W, K units a lane, warps a block) for C <= 1024, else
    ("walk", W, None, None), as ln_bwd.cu chooses."""
    w = _unit(c, dtype)
    if c > REG_ROW_MAX:
        return "walk", w, None, None
    vals = -(-(c // w) // 32) * w
    for most, warps in ((8, 16), (16, 16), (32, 8)):
        if vals <= most:
            return "regs", w, -(-most // w), warps
    raise AssertionError(vals)


def _butterfly(v):
    """The xor butterfly over the last axis (32 lanes), float32."""
    lanes = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        v = (v + v[..., lanes ^ o]).astype(np.float32)
    return v[..., 0]


def _fma(a, b, c):
    return (np.asarray(a, np.float64) * b + c).astype(np.float32)


def _lane_order(c, w):
    """The columns in the order the lanes take them: (32, k * w) column
    indices, lane l holding units l, l + 32, ... (-1 past the row)."""
    units = c // w
    k = -(-units // 32)
    idx = np.arange(32)[:, None] + 32 * np.arange(k)[None, :]
    cols = idx[:, :, None] * w + np.arange(w)[None, None, :]
    cols = np.where((idx < units)[:, :, None], cols, -1)
    return cols.reshape(32, k * w)


def _dx_emulated(x, g, ct, mean, rstd, dtype):
    """dx (float32, before the one rounding) as each warp computes it."""
    n, c = x.shape
    cols = _lane_order(c, _unit(c, dtype))
    live = cols >= 0
    safe = np.where(live, cols, 0)
    inv_c = np.float32(1.0) / np.float32(c)
    mu, rs = mean[:, None], rstd[:, None]
    xh = ((x - mu).astype(np.float32) * rs).astype(np.float32)
    gy = (ct * g[None, :]).astype(np.float32)
    s1 = np.zeros((n, 32), np.float32)
    s2 = np.zeros((n, 32), np.float32)
    for j in range(cols.shape[1]):
        on = live[:, j]
        a, b = gy[:, safe[:, j]], xh[:, safe[:, j]]
        s1 = np.where(on, (s1 + a).astype(np.float32), s1)
        s2 = np.where(on, _fma(a, b, s2), s2)
    m1 = (_butterfly(s1) * inv_c).astype(np.float32)[:, None]
    m2 = (_butterfly(s2) * inv_c).astype(np.float32)[:, None]
    return (rs * ((gy - m1).astype(np.float32) -
                  (xh * m2).astype(np.float32))).astype(np.float32)


def _column_sums(x, ct, mean, rstd, rows):
    """(sum of ct * xh by fmaf, sum of ct) over ``rows`` in that order,
    each column float32, from zero."""
    dg = np.zeros(x.shape[1], np.float32)
    db = np.zeros(x.shape[1], np.float32)
    for r in rows:
        xh = ((x[r] - mean[r]).astype(np.float32) * rstd[r]).astype(
            np.float32)
        dg = _fma(ct[r], xh, dg)
        db = (db + ct[r]).astype(np.float32)
    return np.concatenate([dg, db])


def _in_order(parts):
    acc = np.zeros(parts.shape[1:], np.float32)
    for p in parts:
        acc = (acc + p).astype(np.float32)
    return acc


def _dparams_emulated(x, ct, mean, rstd, dtype, sms=132):
    """(dgamma, dbeta) float32 sums in the kernel's order on a card with
    ``sms`` SMs (one block an SM on the register route)."""
    n, c = x.shape
    route, _w, _k, warps = _route(c, dtype)
    if route == "walk":
        rows, chunks = ck._dparams_chunks(n)
        parts = []
        for ch in range(chunks):
            r0, r1 = ch * rows, min(n, (ch + 1) * rows)
            lanes = [_column_sums(x, ct, mean, rstd,
                                  range(r0 + ty, r1, WALK_LANES))
                     for ty in range(WALK_LANES)]
            parts.append(_in_order(np.stack(lanes)))
        total = _in_order(np.stack(parts))
        return total[:c], total[c:]
    blocks = max(1, min(-(-n // warps), sms))
    stride = blocks * warps
    per_block = np.stack([
        _in_order(np.stack([
            _column_sums(x, ct, mean, rstd, range(b * warps + w, n, stride))
            for w in range(warps)]))
        for b in range(blocks)])                          # (blocks, 2c)
    lanes = np.zeros((2 * c, 32), np.float32)
    for lane in range(32):
        lanes[:, lane] = _in_order(per_block[lane::32]) if lane < blocks \
            else 0.0
    total = _butterfly(lanes)
    return total[:c], total[c:]


EMULATED = SHAPES + [(300, 512), (130, 1000), (200, 1024), (140, 1025),
                     (70, 13)]


@pytest.mark.parametrize("dtype", list(TYPES))
@pytest.mark.parametrize("n,c", EMULATED)
def test_ln_bwd_emulation_matches_pallas_and_plain(n, c, dtype):
    (tx, jx, x), (tg, jg, g), (tb, jb, _), (tct, jct, ct) = _inputs(
        n, c, dtype, seed=1)
    _, mean, rstd = ck.layernorm_plain(tx, tg, tb, EPS)
    mean_np, rstd_np = mean.numpy(), rstd.numpy()
    dx = _rounded(_dx_emulated(x, g, ct, mean_np, rstd_np, dtype), dtype)
    tol = TOL if n < 100 else SUM_TOL
    refs = (_pallas(jx, jg, jb, jct),
            ck.layernorm_bwd_plain(tx, tg, tct, mean, rstd))
    for sms in (132, 3):
        dg, db = (_rounded(v, dtype) for v in _dparams_emulated(
            x, ct, mean_np, rstd_np, dtype, sms))
        for want in refs:
            _agree_dx(dx, want[0], dtype)
            _agree_sum(dg, want[1], dtype, tol)
            _agree_sum(db, want[2], dtype, tol)


@pytest.mark.parametrize("dtype", list(TYPES))
def test_ln_bwd_emulation_at_the_bound(dtype):
    """C = 65536, the JAX eligibility bound: the walked route, its
    parameter sums over two chunks (N = 65 rows of 64-row chunks)."""
    n, c = 65, ck.LN_MAX_C
    (tx, _, x), (tg, _, g), (tb, _, _), (tct, _, ct) = _inputs(n, c, dtype,
                                                               seed=2)
    _, mean, rstd = ck.layernorm_plain(tx, tg, tb, EPS)
    assert ck._dparams_chunks(n) == (64, 2)
    plain = ck.layernorm_bwd_plain(tx, tg, tct, mean, rstd)
    _agree_dx(_rounded(_dx_emulated(x, g, ct, mean.numpy(), rstd.numpy(),
                                    dtype), dtype), plain[0], dtype)
    for got, want in zip(_dparams_emulated(x, ct, mean.numpy(),
                                           rstd.numpy(), dtype), plain[1:]):
        _agree_sum(_rounded(got, dtype), want, dtype, SUM_TOL)


def test_ln_bwd_routes_split_where_the_kernel_does():
    """The route boundaries the emulation shares with the kernel: the
    register route to C = 1024 (16 warps a block to 16 values a lane, 8
    above), the walked route beyond; and the scratch each needs."""
    assert _route(512, "float32") == ("regs", 4, 4, 16)
    assert _route(512, "bfloat16") == ("regs", 8, 2, 16)
    assert _route(256, "float32") == ("regs", 4, 2, 16)
    assert _route(13, "float16") == ("regs", 1, 8, 16)
    assert _route(1000, "float32") == ("regs", 4, 8, 8)
    assert _route(1024, "bfloat16") == ("regs", 8, 4, 8)
    assert _route(1023, "float32") == ("regs", 1, 32, 8)
    assert _route(1025, "float32") == ("walk", 1, None, None)
    assert _route(4096, "float16") == ("walk", 8, None, None)
    assert ck.LN_REG_ROW_MAX == REG_ROW_MAX
    assert ck._dparams_chunks(1) == (64, 1)
    assert ck._dparams_chunks(8192) == (64, 128)
    assert ck._dparams_chunks(0) == (64, 1)
    assert ck._dparams_chunks(65535 * 64 + 1) == (72, 58254)
    x = torch.empty(4, 1025)
    assert ck._ln_bwd_part_rows(x, 8192, 1025) == 128


def test_ln_bwd_emulation_repeats_bit_for_bit():
    """The order depends on N and the grid alone: the same inputs give
    the same bits, and another grid (another card) sums in another order
    within the float32 bound."""
    (tx, _, x), (tg, _, _), (tb, _, _), (tct, _, ct) = _inputs(
        300, 512, "float32", seed=3)
    _, mean, rstd = ck.layernorm_plain(tx, tg, tb, EPS)
    a = _dparams_emulated(x, ct, mean.numpy(), rstd.numpy(), "float32")
    b = _dparams_emulated(x, ct, mean.numpy(), rstd.numpy(), "float32")
    c3 = _dparams_emulated(x, ct, mean.numpy(), rstd.numpy(), "float32", 3)
    for u, v, w in zip(a, b, c3):
        np.testing.assert_array_equal(u, v)
        np.testing.assert_allclose(u, w, rtol=SUM_TOL, atol=SUM_TOL)


def test_ln_bwd_emulation_one_column_gives_zero_dx():
    """At C = 1, gy - mean(gy) is exactly 0 (gy and xh are rounded
    products, not fused into the subtraction): dx is 0 in every row, as
    in the plain version."""
    (tx, _, x), (tg, _, g), (tb, _, _), (tct, _, ct) = _inputs(
        6, 1, "float32", seed=4)
    _, mean, rstd = ck.layernorm_plain(tx, tg, tb, EPS)
    dx = _dx_emulated(x, g, ct, mean.numpy(), rstd.numpy(), "float32")
    assert not dx.any()
    assert not ck.layernorm_bwd_plain(tx, tg, tct, mean, rstd)[0].any()


# ------------------------------------------ the autograd function's calls
@pytest.mark.parametrize("need", [(True, True, True), (True, False, False),
                                  (False, True, True), (False, True, False),
                                  (True, False, True)])
def test_layernorm_function_calls_one_wrapper(monkeypatch, need):
    """``_LayerNormFn.backward``: one ``layernorm_bwd`` call when x and a
    parameter need gradients, ``layernorm_bwd_dx`` or
    ``layernorm_bwd_dparams`` alone when one half is needed; the
    gradients are the plain version's."""
    calls = []

    def spy(name):
        real = getattr(ck, name)

        def wrapped(*args):
            calls.append(name)
            return real(*args)
        monkeypatch.setattr(ck, name, wrapped)
    for name in ("layernorm_bwd", "layernorm_bwd_dx",
                 "layernorm_bwd_dparams"):
        spy(name)
    (tx, _, _), (tg, _, _), (tb, _, _), (tct, _, _) = _inputs(
        2 * 3, 16, "float32", seed=5)
    leaves = [t.reshape(2, 3, 16) if i == 0 else t
              for i, t in enumerate((tx, tg, tb))]
    leaves = [t.clone().requires_grad_(r) for t, r in zip(leaves, need)]
    y = ck.layernorm_fn(*leaves, EPS)[0]
    y.backward(tct.reshape(2, 3, 16))
    want = {(True, True): ["layernorm_bwd"], (True, False):
            ["layernorm_bwd_dx"], (False, True): ["layernorm_bwd_dparams"]}
    assert calls == want[(need[0], need[1] or need[2])]
    _, mean, rstd = ck.layernorm_plain(tx, tg, tb, EPS)
    ref = ck.layernorm_bwd_plain(tx, tg, tct, mean, rstd)
    for leaf, r, g in zip(leaves, need, ref):
        if r:
            assert torch.equal(leaf.grad.reshape(g.shape), g)
        else:
            assert leaf.grad is None
