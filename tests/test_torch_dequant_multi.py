"""The conv-weight dequant in one launch a forward: ``mxnet_tpu_torch``
against ``mxnet_tpu`` on the CPU.

``QuantizedConvolution`` declares a per-forward prologue: the executor
dequantizes every conv weight that comes straight from a variable with one
``cuda_kernels.dequant_rows_multi`` call before the nodes run (on the card
one launch of ``csrc/dequant_rows.cu``'s multi-weight kernel; here its
plain version), and each conv runs on its prepared weight. Held here:

* the multi plain version, weight by weight, bit for bit against the
  float32 weight the JAX package's ``_dequant_rows_kernel`` (Pallas,
  interpret mode) hands its convolution, for int8 and float8_e4m3fn
  weights of ResNet-like shapes and edges (one column, 147 columns);
* the launch-table plan in numpy: the chunk ends, the cap of weights a
  launch, the 16-byte route's flag and the scalar route, the table's
  layout against the C struct's size;
* a small quantized convnet (int8 and e4m3) through ``Module.forward``:
  one prologue call a forward holding every conv weight, outputs within
  2e-5 of the JAX package's from the same parameters; a conv whose weight
  the graph computes is left to the op itself.

Tolerance: exact for the dequant (one product a weight, rounded once
everywhere); 2e-5 for a forward (the frameworks sum in other orders).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.ops import quant as jq

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import cuda_kernels as ck
from mxnet_tpu_torch.ops import quant as tq

from test_torch_quant import _bytes, _close, _quantized, _t

CPU = mxt.cpu()
#: (O, C, kh, kw): a stem (147 columns), 3x3 and 1x1 convs, one column
SHAPES = [(64, 3, 7, 7), (64, 64, 3, 3), (256, 64, 1, 1), (8, 1, 1, 1),
          (5, 3, 1, 1)]


def _pallas_weight(monkeypatch, q, s):
    """The float32 weight ``_qconv_pallas_variant``'s Pallas pass hands its
    convolution for the quantized weight q (O, C, kh, kw)."""
    from mxnet_tpu.ops import nn as jnn
    seen = []
    real = jnn._convolution

    def spy(attrs, data, weight, bias=None):
        seen.append(np.asarray(weight))
        return real(attrs, data, weight, bias)
    o, c, kh, kw = q.shape
    with monkeypatch.context() as m:
        m.setattr(jnn, "_convolution", spy)
        attrs = mx.ops.registry.get_op(
            "QuantizedConvolution").normalize_attrs(
                {"kernel": (kh, kw), "num_filter": o, "no_bias": True})
        data = np.zeros((1, c, kh, kw), np.float32)
        jq._qconv_pallas_variant(attrs, [jnp.asarray(data), jnp.asarray(q),
                                         jnp.asarray(s)], [], False, None)
    return seen[0]


@pytest.mark.parametrize("dtype", ["int8", "fp8"])
def test_multi_plain_is_the_pallas_dequant_weight_by_weight(monkeypatch,
                                                            dtype):
    qs = [_quantized(sh[0], int(np.prod(sh[1:])), dtype, seed=i)
          for i, sh in enumerate(SHAPES)]
    ws = [q.reshape(sh) for (q, _), sh in zip(qs, SHAPES)]
    got = ck.dequant_rows_multi_plain([_t(w) for w in ws],
                                      [_t(s) for _, s in qs])
    wrapped = ck.dequant_rows_multi([_t(w) for w in ws],
                                    [_t(s) for _, s in qs])
    for w, (_, s), g, g2 in zip(ws, qs, got, wrapped):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        assert _bytes(g) == _bytes(_pallas_weight(monkeypatch, w, s))
        assert _bytes(g2) == _bytes(g)
        # the single-array plain version on the rows, the same bits
        assert _bytes(ck.dequant_rows_plain(_t(w).reshape(w.shape[0], -1),
                                            _t(s))) == _bytes(g)


def test_multi_wrapper_lists():
    """An empty list gives an empty list; lists of other lengths raise;
    CPU tensors launch nothing."""
    assert ck.dequant_rows_multi([], []) == []
    q, s = _quantized(4, 8, "int8")
    with pytest.raises(MXNetError, match="1 weights, 2 scales"):
        ck.dequant_rows_multi([_t(q)], [_t(s), _t(s)])
    ck.reset_launch_counts()
    ck.dequant_rows_multi([_t(q)], [_t(s)])
    assert ck.launch_counts()["dequant_rows_multi"] == 0


def _table_size():
    """sizeof(Table) in csrc/dequant_rows.cu: three pointers, a long long
    and three ints a weight, then count and pad."""
    return ck.DEQUANT_CAP * (3 * 8 + 8 + 3 * 4) + 2 * 4


def test_launch_table_plan():
    """Chunk ends, the cap of weights a launch (a longer list takes more
    launches, in order), zero-length weights left out, and the 16-byte
    route only where the columns are a multiple of 16 and the weight and
    its output lie on 16-byte boundaries."""
    assert ck._DEQUANT_TABLE.itemsize == _table_size()
    chunk, cap = ck.DEQUANT_CHUNK, ck.DEQUANT_CAP
    rows = [64, 512, 1, 0, 3] + [2] * (cap + 3)
    cols = [147, 4608, 16, 16, 32] + [16] * (cap + 3)
    n = len(rows)
    base = 1 << 32
    wptrs = [base + 16 * i for i in range(n)]
    wptrs[4] += 4                                 # an offset view
    sptrs = [2 * base + 64 * i for i in range(n)]
    optrs = [3 * base + 4096 * i for i in range(n)]
    optrs[2] += 8                                 # an output off 16 bytes
    tables = ck._dequant_tables(wptrs, sptrs, optrs, rows, cols)
    assert len(tables) == 2
    live = [i for i in range(n) if rows[i] * cols[i]]
    assert len(live) == n - 1
    first, second = tables
    t, blocks = first
    k = int(t["count"])
    assert k == cap
    pos = live[:cap]
    lens = np.asarray([rows[i] * cols[i] for i in pos])
    ends = np.cumsum(-(-lens // chunk))
    np.testing.assert_array_equal(t["chunk_end"][:k], ends)
    assert blocks == int(ends[-1])
    np.testing.assert_array_equal(t["n"][:k], lens)
    np.testing.assert_array_equal(t["cols"][:k], [cols[i] for i in pos])
    np.testing.assert_array_equal(t["w"][:k], [wptrs[i] for i in pos])
    np.testing.assert_array_equal(t["s"][:k], [sptrs[i] for i in pos])
    np.testing.assert_array_equal(t["out"][:k], [optrs[i] for i in pos])
    want_vec = [cols[i] % 16 == 0 and wptrs[i] % 16 == 0 and
                optrs[i] % 16 == 0 for i in pos]
    np.testing.assert_array_equal(t["vec"][:k].astype(bool), want_vec)
    assert want_vec[:4] == [False, True, False, False]
    assert not t["n"][k:].any() and not t["w"][k:].any()
    t2, blocks2 = second
    assert int(t2["count"]) == len(live) - cap
    assert blocks2 == int(t2["chunk_end"][int(t2["count"]) - 1])
    np.testing.assert_array_equal(
        t2["w"][:int(t2["count"])], [wptrs[i] for i in live[cap:]])


def _convnet(lib):
    """Three convs (a stem of 147 columns, a 3x3, a 1x1), pooling and a
    dense head."""
    data = lib.sym.var("data")
    c1 = lib.sym.Convolution(data=data, kernel=(7, 7), num_filter=16,
                             pad=(3, 3), stride=(2, 2), name="c1")
    a1 = lib.sym.Activation(c1, act_type="relu")
    c2 = lib.sym.Convolution(data=a1, kernel=(3, 3), num_filter=32,
                             pad=(1, 1), name="c2", no_bias=True)
    c3 = lib.sym.Convolution(data=lib.sym.Activation(c2, act_type="relu"),
                             kernel=(1, 1), num_filter=16, name="c3")
    p = lib.sym.Pooling(c3, global_pool=True, kernel=(1, 1), pool_type="avg")
    f = lib.sym.FullyConnected(lib.sym.flatten(p), num_hidden=10, name="f1")
    return lib.sym.SoftmaxOutput(f, name="softmax")


@pytest.mark.parametrize("dtype", ["int8", "fp8"])
def test_quantized_convnet_forward_one_prologue_call(monkeypatch, dtype):
    """The rewritten convnet through the port's Module on the CPU, from the
    JAX package's Xavier parameters: one ``dequant_rows_multi`` call a
    forward over the three conv weights (in graph order), and outputs
    within 2e-5 of the JAX package's Module."""
    shape = (2, 3, 16, 16)
    X = np.random.RandomState(0).rand(*shape).astype(np.float32)
    with mx.name.NameManager():
        jsym = _convnet(mx)
    with mxt.name.NameManager():
        tsym = _convnet(mxt)
    jmod = mx.mod.Module(jsym, context=mx.cpu())
    jmod.bind([("data", shape)], [("softmax_label", (2,))],
              for_training=False)
    jmod.init_params(mx.initializer.Xavier())
    jargs, _ = jmod.get_params()
    args = {k: v.asnumpy() for k, v in jargs.items()}
    jqsym, jqargs = jq.quantize_symbol(jsym, jargs, dtype=dtype)
    jm = mx.mod.Module(jqsym, context=mx.cpu())
    jm.bind([("data", shape)], [("softmax_label", (2,))], for_training=False)
    jm.init_params(initializer=None, arg_params=jqargs, aux_params={})
    jm.forward(mx.io.DataBatch([mx.nd.array(X)], []), is_train=False)
    want = jm.get_outputs()[0].asnumpy()

    tqsym, tqargs = tq.quantize_symbol(tsym, args, dtype=dtype)
    assert tqsym.tojson() == jqsym.tojson()
    calls = []
    real = ck.dequant_rows_multi

    def spy(weights, scales):
        calls.append([tuple(w.shape) for w in weights])
        return real(weights, scales)
    monkeypatch.setattr(ck, "dequant_rows_multi", spy)
    tm = mxt.mod.Module(tqsym, context=CPU)
    tm.bind([("data", shape)], [("softmax_label", (2,))], for_training=False)
    tm.init_params(arg_params=tqargs, aux_params={})
    for _ in range(2):
        tm.forward(mxt.io.DataBatch([X], None), is_train=False)
        _close(tm.get_outputs()[0].asnumpy(), want)
    assert calls == [[(16, 3, 7, 7), (32, 16, 3, 3), (16, 32, 1, 1)]] * 2


def test_a_computed_conv_weight_is_left_to_the_op(monkeypatch):
    """A QuantizedConvolution whose weight the graph computes (a Reshape of
    the variable) takes no part in the prologue and dequantizes its own
    weight; the forward equals the all-variable graph's bit for bit."""
    shape = (2, 4, 8, 8)
    rs = np.random.RandomState(1)
    q, s = _quantized(6, 4 * 9, "int8", seed=3)
    q = q.reshape(6, 4, 3, 3)
    q2, s2 = _quantized(5, 6, "int8", seed=4)
    q2 = q2.reshape(5, 6, 1, 1)
    X = rs.rand(*shape).astype(np.float32)
    params = {"c1_weight_q": _t(q), "c1_weight_scale": _t(s),
              "c2_weight_q": _t(q2), "c2_weight_scale": _t(s2)}

    def net(computed):
        data = mxt.sym.var("data")
        w1 = mxt.sym.var("c1_weight_q", dtype="int8")
        s1 = mxt.sym.var("c1_weight_scale")
        w2 = mxt.sym.var("c2_weight_q", dtype="int8")
        s2_ = mxt.sym.var("c2_weight_scale")
        if computed:
            w2 = mxt.sym.Reshape(w2, shape=(5, 6, 1, 1))
        c1 = mxt.sym.QuantizedConvolution(data, w1, s1, kernel=(3, 3),
                                          num_filter=6, no_bias=True,
                                          name="c1")
        return mxt.sym.QuantizedConvolution(c1, w2, s2_, kernel=(1, 1),
                                            num_filter=5, no_bias=True,
                                            name="c2")
    calls, outs = [], {}
    real = ck.dequant_rows_multi

    def spy(weights, scales):
        calls.append([tuple(w.shape) for w in weights])
        return real(weights, scales)
    monkeypatch.setattr(ck, "dequant_rows_multi", spy)
    for computed in (False, True):
        ex = net(computed).simple_bind(
            CPU, grad_req="null", data=shape, c1_weight_q=q.shape,
            c2_weight_q=q2.shape,
            type_dict={"c1_weight_q": "int8", "c2_weight_q": "int8"})
        for k, v in params.items():
            ex.arg_dict[k][:] = mxt.nd.NDArray(v)
        outs[computed] = ex.forward(data=X)[0].asnumpy()
    assert calls == [[(6, 4, 3, 3), (5, 6, 1, 1)], [(6, 4, 3, 3)]]
    assert _bytes(outs[True]) == _bytes(outs[False])
