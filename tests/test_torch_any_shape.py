"""Inputs the JAX package runs that the port's kernels once refused on the
card: ``mxnet_tpu_torch`` against ``mxnet_tpu`` on the CPU.

The card's kernels now take every head dim (``decode_attention``,
``flash_attention`` and its partial mode: up to 128 on the tile that holds
Dh, rows copied in the widest unit they allow; above 128 the wide routes,
column groups of 128 with the scores over Dh in 128-wide steps), decode
windows of any S (query tiles of 16 on the grid's y axis), attention with
Tq != Tk (the causal mask bottom-right aligned, a row with no key NaN as in
the reference) and any B*H, softmax rows past 65536 (the streaming route)
and LayerNorm-backward rows past it (the walked route),
``SoftmaxOutput(multi_output=True)`` (axis 1 moved last, the row kernels
over (N * d..., C)), ``LayerNorm`` over any axis (moved last) and fp8
weights under ``compute_dtype`` (kept as stored). The kernels run only on
a card; here the same numpy-seeded inputs go through:

* the public ops of both packages (``attention``, ``attention_decode``,
  ``SoftmaxOutput``, ``LayerNorm``, ``QuantizedFullyConnected``): the JAX
  op (its XLA composition; the Pallas kernels in interpret mode where
  their gates take the input) against the port's plain op and its
  ``"cuda"`` variant on CPU tensors, whose wrappers run their plain
  versions after the same layout changes the card takes; forward within
  2e-5, gradients within 1e-4 (the tolerances of
  ``tests/test_torch_train_ops.py``), NaN where the reference is NaN;
* CPU emulations of each new arithmetic: the decode read's wide route and
  its windows past 64 rows (``tests/decode_split_emul.py``), the float32
  flash forward's wide route and Tq != Tk (``tests/flash_f32_emul.py``),
  the streaming softmax (``softmax_stream_emulated`` below), held against
  the plain versions and, where a Pallas kernel takes the input, against
  it in interpret mode: 2e-5;
* the route functions: every bench-width input keeps the launch it had.
"""
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from mxnet_tpu import rtc as jrtc
from mxnet_tpu.ops import pallas_kernels as pk
from mxnet_tpu.ops.registry import get_op as jax_op

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.executor import Executor
from mxnet_tpu_torch.ops import cuda_kernels as ck
from mxnet_tpu_torch.ops.registry import get_op as torch_op

from decode_split_emul import decode_attention_split
from flash_f32_emul import flash_f32

TOL, GRAD_TOL = 2e-5, 1e-4
SMS = 132                       # an H100's SM count
#: head dims no multiple of 16 and above 128 (Dh 1 and 2: a row of one or
#: two values; 8, 24, 40: narrow copies; 136, 256: the wide routes)
ODD_DHS = [1, 2, 8, 24, 40, 136, 256]


def _close(got, want, tol=TOL, msg=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want),
                                  err_msg=msg)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol,
                               err_msg=msg)


# ---------------------------------------------------------------- routes
@pytest.mark.parametrize("itemsize", [4, 2, 1])
@pytest.mark.parametrize("S", [1, 64])
@pytest.mark.parametrize("dh", list(ck.HEAD_DIMS))
def test_bench_widths_keep_their_decode_routes(dh, S, itemsize):
    """Every multiple of 16 up to 128, S = 1 and the 64-row window, every
    cache width, on 16-byte aligned caches: the tile ``head_tile``, one
    column group, the S = 1 or 16-row block, 16-byte copies (the launch
    these inputs had before the narrow and wide routes); the split plan
    counts B*H alone (one group)."""
    assert ck.decode_route(dh, S, itemsize, 0, 4096) == \
        (min(t for t in (32, 64, 128) if t >= dh), 1, 1 if S == 1 else 16,
         16)
    assert ck.head_groups(dh) == 1
    assert ck._decode_splits(64, 1, 256, SMS) == (4, 64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("dh", [64, 128])
def test_bench_widths_keep_their_flash_operands(dh, dtype):
    """The bench LM's head dims (64, and 128) in every type reach the
    flash kernels as they are (no padded copy), on one column group."""
    q = torch.zeros(2, 2, 16, dh, dtype=dtype)
    got = ck._flash_operands(q, q, q)
    assert got[0] is q and got[3] == dh
    assert ck.head_groups(dh) == 1 and ck.head_tile(dh) == dh


@pytest.mark.parametrize("dh,itemsize,ptr,want", [
    (24, 4, 0, (32, 1, 16)), (24, 1, 0, (128, 1, 8)),
    (40, 2, 0, (64, 1, 16)), (40, 1, 0, (128, 1, 8)),
    (3, 1, 0, (128, 1, 1)), (3, 2, 0, (128, 1, 2)), (3, 4, 0, (128, 1, 4)),
    (130, 4, 0, (128, 2, 8)), (256, 2, 0, (128, 2, 16)),
    (520, 4, 0, (128, 5, 16)), (64, 4, 8, (128, 1, 8)),
    (64, 1, 2, (128, 1, 2))])
def test_narrow_and_wide_decode_routes(dh, itemsize, ptr, want):
    """The copy unit is the widest that divides a row's bytes and the
    caches' addresses; rows of whole 16-byte copies up to 128 on their
    tile, every other Dh on the general route: ceil(Dh / 128) groups of
    the Dh 128 tile."""
    tile, groups, _, unit = ck.decode_route(dh, 1, itemsize, 4096, ptr)
    assert (tile, groups, unit) == want


def test_lifted_refusals_are_gone_from_the_package():
    """The messages the wrappers raised for these inputs are gone from
    the package: head dims, windows past 64 rows, Tq != Tk, B*H past
    65535, rows past 65536, ``multi_output``, another LayerNorm axis, and
    the 16-byte alignment the attention wrappers asked for."""
    root = Path(ck.__file__).resolve().parents[1]
    text = "\n".join(p.read_text() for p in root.rglob("*.py"))
    for gone in ("window S=", "self-attention only", "B*H={B * H} > 65535",
                 "normalizes the last", "takes the per-position softmax",
                 "with C <= {SOFTMAX_MAX_C}", "C={c} > {LN_MAX_C}",
                 "the kernel takes a \"\n                         f\"multiple "
                 "of 16", "caches must be 16-byte",
                 "q, k, v must be 16-byte"):
        assert gone not in text, gone


# ----------------------------------------------------------- decode read
def _decode_case(dh, S, cache, C=160, B=2, H=2, seed=0):
    """Torch and JAX copies of q, k, v (this step's rows), the caches and
    the per-slot cursors, the cache cells of type ``cache``."""
    rs = np.random.RandomState(seed + dh + S)
    q = rs.randn(B, H, S, dh).astype(np.float32)
    k, v = (rs.randn(B, H, S, dh).astype(np.float32) for _ in range(2))
    kc, vc = (2 * rs.randn(B, H, C, dh).astype(np.float32)
              for _ in range(2))
    cur = np.asarray([[0], [C - S]], np.int32)[:B]
    np_dt = {"float32": np.float32, "e4m3": ml_dtypes.float8_e4m3fn}[cache]
    t_dt = {"float32": torch.float32, "e4m3": torch.float8_e4m3fn}[cache]
    tkc, tvc = (torch.from_numpy(a).to(t_dt) for a in (kc, vc))
    jkc, jvc = (jnp.asarray(t.float().numpy().astype(np_dt))
                for t in (tkc, tvc))
    torch_in = ([torch.from_numpy(a) for a in (q, k, v)],
                [tkc, tvc, torch.from_numpy(cur)])
    jax_in = ([jnp.asarray(a) for a in (q, k, v)],
              [jkc, jvc, jnp.asarray(cur)])
    return torch_in, jax_in


_DECODE_ATTRS = {"per_slot": True, "capacity": 160}


@pytest.mark.parametrize("cache", ["float32", "e4m3"])
@pytest.mark.parametrize("S", [1, 65, 128])
@pytest.mark.parametrize("dh", [1, 24, 40, 136, 256])
def test_attention_decode_op_matches_jax(dh, S, cache):
    """``attention_decode`` (per-slot cursors, no RoPE): the JAX op's
    composition (its Pallas gate declines S > 64) against the port's plain
    op and its CUDA variant on CPU tensors, output and written caches."""
    (t_in, t_aux), (j_in, j_aux) = _decode_case(dh, S, cache)
    jop, top = jax_op("attention_decode"), torch_op("attention_decode")
    jattrs = jop.normalize_attrs(_DECODE_ATTRS)
    tattrs = top.normalize_attrs(_DECODE_ATTRS)
    j_out, j_new = jop.forward(jattrs, j_in, j_aux, False, None)
    for run in (top.forward, top.variants["cuda"]["fn"]):
        aux = [a.clone() for a in t_aux]
        t_out, t_new = run(tattrs, [a.clone() for a in t_in], aux, False,
                           None)
        _close(t_out[0], j_out[0], msg="out")
        for got, want in zip(t_new[:2], j_new[:2]):
            _close(got.float(), np.asarray(want, np.float32))


@pytest.mark.parametrize("S", [1, 16, 64])
@pytest.mark.parametrize("dh", [136, 256, 520])
def test_decode_wide_route_emulation_matches_pallas_and_plain(dh, S):
    """The wide route's arithmetic: the scores of a chunk summed over
    their 128-column steps, the split plan over B*H * groups blocks,
    against the plain version and the JAX Pallas kernel (interpret mode;
    its gate takes Dh <= 512 and S <= 64)."""
    rs = np.random.RandomState(dh + S)
    B, H, C = 2, 2, 160
    q = rs.randn(B, H, S, dh).astype(np.float32)
    k, v = (2 * rs.randn(B, H, C, dh).astype(np.float32) for _ in range(2))
    pos = np.asarray([0, C - S], np.int32)
    t = [torch.from_numpy(a) for a in (q, k, v, pos)]
    got = decode_attention_split(*t, SMS)
    _close(got, ck.decode_attention_plain(*t))
    if dh <= 512:
        _close(got, pk.decode_attention(*(jnp.asarray(a)
                                          for a in (q, k, v, pos))))


@pytest.mark.parametrize("S", [65, 128, 200])
@pytest.mark.parametrize("dh", [40, 64])
def test_decode_windows_past_64_rows_emulation(dh, S):
    """Windows past 64 rows take more 16-row query tiles: the emulation of
    the kernel's order against the plain version and the JAX package's
    composition (``attention_decode``'s, via the ring module's
    reference attention over each row's live keys)."""
    rs = np.random.RandomState(S + dh)
    B, H, C = 2, 2, 256
    q = rs.randn(B, H, S, dh).astype(np.float32)
    k, v = (rs.randn(B, H, C, dh).astype(np.float32) for _ in range(2))
    pos = np.asarray([0, C - S], np.int32)
    t = [torch.from_numpy(a) for a in (q, k, v, pos)]
    got = decode_attention_split(*t, SMS)
    _close(got, ck.decode_attention_plain(*t))


# --------------------------------------------------------------- flash
def _qkv(B, H, tq, tk, dh, seed):
    rs = np.random.RandomState(seed + dh + tq + 3 * tk)
    return (rs.randn(B, H, tq, dh).astype(np.float32),
            rs.randn(B, H, tk, dh).astype(np.float32),
            rs.randn(B, H, tk, dh).astype(np.float32))


def _attention_both(q, k, v, causal):
    """The JAX ``attention`` op (composition) and the port's plain op and
    CUDA variant (on CPU tensors) on q, k, v, with gradients under one
    cotangent: [(out, grads)] for JAX, plain, variant."""
    attrs = {"causal": causal}
    jop, top = jax_op("attention"), torch_op("attention")
    ja, ta = jop.normalize_attrs(attrs), top.normalize_attrs(attrs)
    cot = np.random.RandomState(5).randn(*q.shape).astype(np.float32)
    out, vjp = jax.vjp(lambda *x: jop.forward(ja, list(x), [], True,
                                              None)[0][0],
                       *(jnp.asarray(a) for a in (q, k, v)))
    res = [(np.asarray(out), [np.asarray(g) for g in vjp(
        jnp.asarray(cot))])]
    for run in (top.forward, top.variants["cuda"]["fn"]):
        leaves = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
        o = run(ta, leaves, [], True, None)[0][0]
        o.backward(torch.from_numpy(cot))
        res.append((o.detach().numpy(), [x.grad.numpy() for x in leaves]))
    return res


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("tq,tk", [(24, 70), (70, 24), (1, 33), (33, 1)])
def test_attention_op_with_tq_ne_tk_matches_jax(tq, tk, causal):
    """Tq != Tk: the mask bottom-right aligned; under it a query row that
    sees no key (Tq > Tk) is NaN in both packages (its gradients then NaN
    too, so they are compared where Tq <= Tk)."""
    q, k, v = _qkv(2, 2, tq, tk, 16, seed=1)
    (jo, jg), *ports = _attention_both(q, k, v, causal)
    for out, grads in ports:
        _close(out, jo, msg="out")
        if tq <= tk or not causal:
            for g, w in zip(grads, jg):
                _close(g, w, GRAD_TOL)
    if causal and tq > tk:
        assert np.isnan(jo[:, :, :tq - tk]).all()
        assert not np.isnan(jo[:, :, tq - tk:]).any()


@pytest.mark.parametrize("dh", ODD_DHS)
def test_attention_op_at_any_head_dim_matches_jax(dh):
    """Head dims that are no multiple of 16, and above 128."""
    q, k, v = _qkv(1, 3, 40, 40, dh, seed=2)
    (jo, jg), *ports = _attention_both(q, k, v, True)
    for out, grads in ports:
        _close(out, jo)
        for g, w in zip(grads, jg):
            _close(g, w, GRAD_TOL)


def test_attention_op_over_b_times_h_past_65535():
    """B*H = 65536 rows of one query each, as the grid's x axis takes
    them."""
    q, k, v = _qkv(4096, 16, 1, 2, 8, seed=3)
    (jo, _), (po, _), (vo, _) = _attention_both(q, k, v, False)
    _close(po, jo)
    _close(vo, jo)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dh", [1, 24, 40, 136, 256, 520])
def test_flash_f32_any_head_dim_emulation(dh, causal):
    """The float32 kernel's arithmetic at any Dh (above 128 the wide
    route: Dh 128's tiles, the scores in 128-column steps), both modes,
    against the plain versions and, up to Dh 512, the Pallas kernel in
    interpret mode."""
    q, k, v = _qkv(1, 2, 70, 70, dh, seed=4)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = flash_f32(tq, tk, tv, causal=causal)
    _close(got, ck.flash_attention_plain(tq, tk, tv, causal))
    part = flash_f32(tq, tk, tv, 5, 3, causal, partial=True)
    plain = ck.flash_attention_partial_plain(tq, tk, tv, 5, 3, causal)
    for g, p in zip(part, plain):
        _close(g, p)
    if dh <= 512:
        ref = jrtc.flash_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                   causal=causal, block_q=70, block_k=70)
        _close(got, ref)


@pytest.mark.parametrize("tq,tk", [(24, 70), (70, 24), (130, 64)])
def test_flash_f32_tq_ne_tk_emulation(tq, tk):
    """The normalized mode at Tq != Tk through the partial mode's offsets
    (q_off = Tk - Tq, k_off = 0), a row with no key NaN: against the plain
    version and the reference's composition."""
    q, k, v = _qkv(1, 2, tq, tk, 40, seed=5)
    t = list(map(torch.from_numpy, (q, k, v)))
    got = flash_f32(*t, q_off=tk - tq, causal=True)
    _close(got, ck.flash_attention_plain(*t, causal=True))
    from mxnet_tpu.parallel.ring_attention import attention
    _close(got, attention(*(jnp.asarray(a) for a in (q, k, v)),
                          causal=True))


@pytest.mark.parametrize("dh", [4, 20, 40])
def test_16bit_operands_are_padded_where_tma_needs_it(dh):
    """The 16-bit tensor-core route takes a Dh that is a multiple of 8:
    another Dh goes through a zero-padded copy of q, k, v (the next
    multiple of 8), which leaves the attention unchanged; float32 and a
    multiple of 8 go as they are. (CPU tensors: the copy's rule only.)"""
    q = torch.randn(1, 2, 9, dh).to(torch.bfloat16)
    qk, kk, vk, dk = ck._flash_operands(q, q, q)
    assert dk == -(-dh // 8) * 8
    assert (qk is q) == (dh % 8 == 0)
    if dk != dh:
        assert torch.equal(qk[..., :dh], q) and not qk[..., dh:].any()
        scale = dh ** -0.5              # the real Dh's, as the kernel takes
        got = ck.flash_attention_partial_plain(qk, kk, vk, causal=True,
                                               scale=scale)
        want = ck.flash_attention_partial_plain(q, q, q, causal=True,
                                                scale=scale)
        _close(got[0][..., :dh], want[0])
        assert not got[0][..., dh:].any()
        for g, w in zip(got[1:], want[1:]):
            _close(g, w)
    f = q.float()
    assert ck._flash_operands(f, f, f)[0] is f


@pytest.mark.parametrize("dh,offset", [(2, 0), (6, 0), (40, 0), (40, 1),
                                       (64, 2), (130, 1)])
def test_float32_operands_are_padded_where_16_byte_copies_need_it(dh,
                                                                  offset):
    """The float32 route's copies are 16 bytes: a Dh up to 128 that is no
    multiple of 4, or an operand ``offset`` floats off 16 bytes, goes
    through a zero-padded copy (the next multiple of 4) that leaves the
    attention unchanged; above 128 (the wide route's plain loads) and at
    an aligned multiple of 4 the operands go as they are."""
    q = torch.randn(1, 2, 9 * dh + offset)[..., offset:].reshape(1, 2, 9, dh)
    assert q.data_ptr() % 16 == 4 * offset % 16
    qk, kk, vk, dk = ck._flash_operands(q, q, q)
    copied = dh <= 128 and (dh % 4 != 0 or offset % 4 != 0)
    assert (qk is not q) == copied
    assert dk == (-(-dh // 4) * 4 if copied else dh)
    if copied:
        assert qk.data_ptr() % 16 == 0
        assert torch.equal(qk[..., :dh], q) and not qk[..., dh:].any()
        scale = dh ** -0.5              # the real Dh's, as the kernel takes
        got = ck.flash_attention_partial_plain(qk, kk, vk, causal=True,
                                               scale=scale)
        want = ck.flash_attention_partial_plain(q, q, q, causal=True,
                                                scale=scale)
        _close(got[0][..., :dh], want[0])
        assert not got[0][..., dh:].any()
        for g, w in zip(got[1:], want[1:]):
            _close(g, w)


# --------------------------------------------------------------- softmax
STREAM_THREADS = 512


def softmax_stream_emulated(x):
    """The softmax kernel's streaming route (rows past 65536) in float32:
    thread t of a row's 512 takes values t, t + 512, ... (one value a
    unit); a running (max, sum) a thread, the sum rescaled by exp(m_old -
    m_new) when a value raises the max; the 512 pairs merged by an xor
    butterfly over each warp's 32 lanes, then the 16 warps' pairs in the
    same butterfly; y = exp(x - m) / s."""
    n, c = x.shape
    x = x.to(torch.float32)
    pad = -c % STREAM_THREADS
    xs = torch.cat([x, torch.full((n, pad), float("-inf"))], 1).reshape(
        n, -1, STREAM_THREADS)
    m = torch.full((n, STREAM_THREADS), float("-inf"))
    s = torch.zeros(n, STREAM_THREADS)
    for step in range(xs.shape[1]):
        v = xs[:, step]
        up = v > m
        s = torch.where(up, s * torch.where(torch.isneginf(m), 0.0,
                                            torch.exp(m - v)), s)
        m = torch.where(up, v, m)
        s = s + torch.where(torch.isneginf(v), 0.0, torch.exp(v - m))

    def merge(m, s, mo, so):
        mn = torch.maximum(m, mo)
        a = torch.where(torch.isneginf(m), 0.0, torch.exp(m - mn))
        b = torch.where(torch.isneginf(mo), 0.0, torch.exp(mo - mn))
        return mn, s * a + so * b

    def butterfly(m, s):          # over the last axis, of 32 lanes
        lanes = torch.arange(32)
        for o in (16, 8, 4, 2, 1):
            m, s = merge(m, s, m[..., lanes ^ o], s[..., lanes ^ o])
        return m, s

    m, s = butterfly(m.reshape(n, -1, 32), s.reshape(n, -1, 32))
    m, s = m[..., 0], s[..., 0]                         # (n, 16 warps)
    m = torch.cat([m, torch.full((n, 16), float("-inf"))], 1)
    s = torch.cat([s, torch.zeros(n, 16)], 1)
    m, s = butterfly(m, s)
    m, s = m[:, :1], s[:, :1]
    return torch.where(torch.isneginf(x), 0.0, torch.exp(x - m)) / s


@pytest.mark.parametrize("c", [65537, 128256])
def test_softmax_streaming_emulation_matches_plain_and_jax(c):
    """Rows past 65536 (a 128 K vocabulary's head): the streaming route's
    arithmetic against the plain version and the JAX package's softmax
    (its composition: the Pallas gate declines C > 65536)."""
    x = 4 * np.random.RandomState(c).randn(2, c).astype(np.float32)
    got = softmax_stream_emulated(torch.from_numpy(x))
    _close(got, ck.softmax_plain(torch.from_numpy(x)))
    _close(got, jax.nn.softmax(jnp.asarray(x), axis=-1))


def test_softmax_streaming_emulation_keeps_nan_and_minus_inf():
    """A NaN or +inf value makes its row NaN, -inf values take p = 0, a row
    of -inf alone is NaN: as the plain version."""
    x = np.random.RandomState(9).randn(4, 70000).astype(np.float32)
    x[0, 5] = np.nan
    x[1, 7] = np.inf
    x[2, ::3] = -np.inf
    x[3] = -np.inf
    t = torch.from_numpy(x)
    _close(softmax_stream_emulated(t), ck.softmax_plain(t))


def _op_fwd_bwd(name, attrs, inputs, runs):
    """The JAX op's outputs and input gradients (one cotangent on output
    0) against each of the port's ``runs`` (an op forward's signature)."""
    jop, top = jax_op(name), torch_op(name)
    ja, ta = jop.normalize_attrs(attrs), top.normalize_attrs(attrs)
    outs, vjp = jax.vjp(lambda *x: jop.forward(ja, list(x), [], True,
                                               None)[0],
                        *(jnp.asarray(a) for a in inputs))
    cot = np.random.RandomState(11).randn(*outs[0].shape).astype(
        np.float32)
    jg = vjp([jnp.asarray(cot)] + [jnp.zeros_like(o) for o in outs[1:]])
    for run in runs:
        leaves = [torch.tensor(a, requires_grad=True) for a in inputs]
        t_outs = run(ta, leaves, [], True, None)[0]
        t_outs[0].backward(torch.from_numpy(cot))
        assert len(t_outs) == len(outs)
        for t, j in zip(t_outs, outs):
            assert tuple(t.shape) == tuple(j.shape)
            _close(t.detach().numpy(), np.asarray(j))
        for x, g in zip(leaves, jg):
            if x.grad is not None:
                _close(x.grad.numpy(), np.asarray(g), GRAD_TOL)


@pytest.mark.parametrize("norm", ["null", "batch", "valid"])
@pytest.mark.parametrize("use_ignore", [False, True])
@pytest.mark.parametrize("shape", [(3, 5, 4, 6), (4, 7, 9), (5, 6)])
def test_softmax_output_multi_output_matches_jax(shape, use_ignore, norm):
    """``multi_output``: softmax over axis 1, a label a position, ignored
    positions and the three normalizations; on the card the row kernels
    over (N * d..., C)."""
    rs = np.random.RandomState(len(shape) + 3 * use_ignore)
    data = rs.randn(*shape).astype(np.float32)
    label = rs.randint(-1, shape[1], (shape[0],) + shape[2:]).astype(
        np.float32)
    attrs = {"multi_output": True, "use_ignore": use_ignore,
             "ignore_label": -1, "normalization": norm, "grad_scale": 1.5}
    top = torch_op("SoftmaxOutput")
    _op_fwd_bwd("SoftmaxOutput", attrs, [data, label],
                [top.forward, top.variants["cuda"]["fn"]])


# ------------------------------------------------------------- LayerNorm
@pytest.mark.parametrize("axis,shape", [(1, (3, 6, 5)), (-2, (2, 7, 4)),
                                        (0, (9, 4)), (1, (2, 5, 3, 4))])
def test_layernorm_over_any_axis_matches_jax(axis, shape):
    """``LayerNorm(axis)``: out, mean and std in the JAX op's shapes (the
    other axes in their order) and the gradients of data, gamma and beta;
    on the card the axis is moved last and the kernels run over it."""
    rs = np.random.RandomState(abs(axis) + len(shape))
    c = shape[axis]
    inputs = [rs.randn(*shape).astype(np.float32),
              (1 + 0.1 * rs.randn(c)).astype(np.float32),
              (0.1 * rs.randn(c)).astype(np.float32)]
    top = torch_op("LayerNorm")
    _op_fwd_bwd("LayerNorm", {"axis": axis, "eps": 1e-5}, inputs,
                [top.forward, top.variants["cuda"]["fn"]])


def test_ln_bwd_past_the_bound_matches_plain_and_jax():
    """C = 65537: the walked route's sums (``tests/test_torch_ln_bwd.py``'s
    emulation) against the plain version and the JAX package's
    composition (its Pallas gate stops at 65536)."""
    from test_torch_ln_bwd import _dparams_emulated, _dx_emulated
    n, c = 3, ck.LN_MAX_C + 1
    rs = np.random.RandomState(12)
    x, ct = (rs.randn(n, c).astype(np.float32) for _ in range(2))
    g = (1 + 0.1 * rs.randn(c)).astype(np.float32)
    tx, tg, tct = map(torch.from_numpy, (x, g, ct))
    _, mean, rstd = ck.layernorm_plain(tx, tg, tg, 1e-5)
    dx, dg, db = ck.layernorm_bwd_plain(tx, tg, tct, mean, rstd)
    _close(_dx_emulated(x, g, ct, mean.numpy(), rstd.numpy(), "float32"),
           dx, GRAD_TOL)
    for got, want in zip(_dparams_emulated(x, ct, mean.numpy(),
                                           rstd.numpy(), "float32"),
                         (dg, db)):
        _close(got, want, GRAD_TOL)
    jop = jax_op("LayerNorm")
    ja = jop.normalize_attrs({"eps": 1e-5})
    _, vjp = jax.vjp(lambda *a: jop.forward(ja, list(a), [], True,
                                            None)[0][0],
                     *(jnp.asarray(a) for a in (x, g, g)))
    jdx, jdg, jdb = vjp(jnp.asarray(ct))
    for got, want in ((dx, jdx), (dg, jdg), (db, jdb)):
        _close(got, np.asarray(want), GRAD_TOL)


# ------------------------------------------------ fp8 under compute_dtype
@pytest.mark.parametrize("half", ["bfloat16", "float16"])
def test_executor_keeps_fp8_weights_under_compute_dtype(half):
    """A float8_e4m3fn cell reaches its op as stored under
    ``compute_dtype``; a float32 one is cast, an int8 one is not."""
    data = mxt.sym.var("data")
    cpu = mxt.cpu()
    exe = Executor(mxt.sym.FullyConnected(data, num_hidden=4, name="fc"),
                   cpu, {"data": mxt.nd.zeros((2, 3), ctx=cpu),
                         "fc_weight": mxt.nd.zeros((4, 3), ctx=cpu),
                         "fc_bias": mxt.nd.zeros((4,), ctx=cpu)},
                   compute_dtype=half)
    want = getattr(torch, half)
    for dt, kept in ((torch.float8_e4m3fn, True), (torch.float8_e5m2, True),
                     (torch.int8, True), (torch.float32, False)):
        t = torch.zeros(4, 3, dtype=dt)
        assert exe._load("fc_weight", t).dtype == (dt if kept else want)


@pytest.mark.parametrize("half", ["bfloat16", "float16"])
def test_quantized_dense_variant_takes_e4m3_under_compute_dtype(half):
    """``QuantizedFullyConnected``'s CUDA variant on CPU tensors: 16-bit
    data with the e4m3 weight as stored and a 16-bit scale, against the
    JAX op on the weight widened to the compute dtype (exact): within the
    16-bit type's rounding of the output (one ulp at 1)."""
    from mxnet_tpu_torch.ops.quant import quantize_per_channel
    rs = np.random.RandomState(13)
    x, w = rs.randn(4, 24).astype(np.float32), rs.randn(6, 24).astype(
        np.float32)
    b = rs.randn(6).astype(np.float32)
    wq, scale = quantize_per_channel(torch.from_numpy(w), dtype="fp8")
    tdt = getattr(torch, half)
    jdt = {"bfloat16": jnp.bfloat16, "float16": jnp.float16}[half]
    attrs = {"num_hidden": 6}
    top, jop = torch_op("QuantizedFullyConnected"), \
        jax_op("QuantizedFullyConnected")
    t_in = [torch.from_numpy(x).to(tdt), wq, scale.to(tdt),
            torch.from_numpy(b).to(tdt)]
    got = top.variants["cuda"]["fn"](top.normalize_attrs(attrs), t_in, [],
                                     False, None)[0][0]
    assert got.dtype == tdt
    j_in = [jnp.asarray(x, jdt),
            jnp.asarray(wq.float().numpy(), jdt),
            jnp.asarray(scale.numpy(), jdt), jnp.asarray(b, jdt)]
    want = jop.forward(jop.normalize_attrs(attrs), j_in, [], False,
                       None)[0][0]
    bits = {"bfloat16": 7, "float16": 10}[half]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=4 * 2.0 ** -bits * max(
                                   1.0, float(np.abs(np.asarray(
                                       want, np.float32)).max())))
