"""The quantized tiers of ``mxnet_tpu_torch`` (int8, fp8) against
``mxnet_tpu`` on the CPU.

* ``quantize_per_channel``: the same bytes and bit-equal scales as the
  JAX package's numpy code, for int8 and float8_e4m3fn, over channels of
  ordinary, subnormal-range, zero and +-amax values and rounding ties;
* ``quantize_symbol``: byte-identical symbol JSON and the same
  ``quantizable_weights`` on the MLP and the convnet of
  ``tests/test_quant.py``, and the same quantized parameter bytes;
* the two kernels' plain versions against the Pallas kernels (interpret
  mode, as the JAX package's tests run them off-TPU) and the XLA
  compositions: ``qfc_matmul_plain`` within 2e-5, ``dequant_rows_plain``
  bit for bit against the dequant inside ``_qconv_pallas_variant``;
* both quantized ops through the registries (the JAX package's in both
  of its tiers; the port's plain forward and its ``"cuda"`` variant
  called on CPU tensors) within 2e-5;
* a quantized bottleneck ResNet (ResNet-50's widths, one unit per stage)
  forward through both packages within 2e-5, int8 and fp8.

Tolerance: 2e-5 absolute and relative for float32 sums (the frameworks
sum in other orders); exact for bytes and for the dequant, whose one
product per weight rounds the same everywhere.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import kernel_tier
from mxnet_tpu.models import resnet as jresnet
from mxnet_tpu.ops import quant as jq

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models import resnet as tresnet
from mxnet_tpu_torch.ops import cuda_kernels as ck
from mxnet_tpu_torch.ops import quant as tq

TOL = 2e-5
CPU = mxt.cpu()


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), atol=tol,
                               rtol=tol)


def _bytes(a):
    """The raw bytes of a numpy array (fp8 included) or a torch tensor."""
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(a).view(np.uint8).tobytes()


def _t(a):
    """numpy (int8, float32, or the JAX package's fp8) -> CPU tensor."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(a.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    return torch.from_numpy(a.copy())


@pytest.fixture(params=["xla", "pallas"])
def jax_tier(request, monkeypatch):
    """The JAX side's lowering: XLA composition or Pallas (interpret)."""
    monkeypatch.setenv("MXNET_KERNEL_TIER", request.param)
    kernel_tier.clear()
    yield request.param
    kernel_tier.clear()


def _weights(seed=0):
    """Per-channel ranges from 1e-9 to 1e3: an all-zero channel,
    subnormal-range channels (of float32 and of e4m3 after scaling), a
    channel whose amax is negative, and exact rounding ties."""
    rs = np.random.RandomState(seed)
    w = rs.randn(12, 40).astype(np.float32) * \
        np.logspace(-9, 3, 12).astype(np.float32)[:, None]
    w[0] = 0.0
    w[1, :] = 0.0
    w[1, 3] = -1e-40                         # one float32 subnormal
    w[2, 0] = -8 * np.abs(w[2]).max()        # amax from a negative value
    w[3] = (np.arange(40, dtype=np.float32) - 20) / 2 * 127 / 19.5
    w[4] = np.float32(448.0) * rs.choice([-1.0, 1.0], 40) * \
        np.float32(2.0) ** -rs.randint(0, 12, 40)
    return w


@pytest.mark.parametrize("dtype", ["int8", "fp8"])
@pytest.mark.parametrize("shape", [(12, 40), (12, 2, 4, 5), (7,)])
def test_quantize_per_channel_bytes_match_jax(dtype, shape):
    w = _weights().reshape(-1)[:int(np.prod(shape))].reshape(shape)
    jqv, js = jq.quantize_per_channel(w, dtype=dtype)
    tqv, ts = tq.quantize_per_channel(w, dtype=dtype)
    assert tqv.device.type == ts.device.type == "cpu"
    assert tqv.dtype == {"int8": torch.int8,
                         "fp8": torch.float8_e4m3fn}[dtype]
    assert tuple(tqv.shape) == shape and ts.dtype == torch.float32
    assert _bytes(tqv) == _bytes(jqv)
    assert _bytes(ts) == _bytes(js)
    # the same from an NDArray, and the dequant is the JAX one exactly
    tqv2, _ = tq.quantize_per_channel(mxt.nd.array(w, ctx=CPU), dtype=dtype)
    assert _bytes(tqv2) == _bytes(jqv)
    # the dequant equals the JAX one bit for bit, except where the
    # product is a float32 subnormal: XLA on the CPU flushes those to
    # zero, PyTorch (and the CUDA kernel, built without -ftz) keep them
    back = np.asarray(jq.dequantize(jnp.asarray(jqv), jnp.asarray(js)))
    got = tq.dequantize(tqv, ts).numpy()
    sub = (got != 0) & (np.abs(got) < np.finfo(np.float32).tiny)
    assert np.all(back[sub] == 0)
    assert _bytes(got[~sub]) == _bytes(back[~sub])


def test_quantize_rejects_unknown_dtype():
    with pytest.raises(MXNetError, match="int8 or fp8"):
        tq.quantize_per_channel(np.ones((2, 2), np.float32), dtype="int4")


def _mlp_symbol(lib):
    data = lib.sym.var("data")
    fc = lib.sym.FullyConnected(data=data, num_hidden=32, name="f1")
    act = lib.sym.Activation(fc, act_type="relu")
    fc2 = lib.sym.FullyConnected(act, num_hidden=10, name="f2")
    return lib.sym.SoftmaxOutput(fc2, name="softmax")


def _convnet_symbol(lib):
    data = lib.sym.var("data")
    c = lib.sym.Convolution(data=data, kernel=(3, 3), num_filter=8,
                            pad=(1, 1), name="c1")
    a = lib.sym.Activation(c, act_type="relu")
    f = lib.sym.FullyConnected(a, num_hidden=10, name="f1")
    return lib.sym.SoftmaxOutput(f, name="softmax")


def _params(sym, shape, seed=0):
    shapes, _, _ = sym.infer_shape(data=shape)
    rs = np.random.RandomState(seed)
    return {n: (0.3 * rs.randn(*s)).astype(np.float32)
            for n, s in zip(sym.list_arguments(), shapes)
            if n not in ("data", "softmax_label")}


@pytest.mark.parametrize("dtype", ["int8", "fp8"])
@pytest.mark.parametrize("build,shape", [(_mlp_symbol, (4, 16)),
                                         (_convnet_symbol, (4, 3, 8, 8))],
                         ids=["mlp", "convnet"])
def test_quantize_symbol_json_and_params_match_jax(build, shape, dtype):
    with mx.name.NameManager():         # auto-names count from 0 in both
        jsym = build(mx)
    with mxt.name.NameManager():
        tsym = build(mxt)
    params = _params(jsym, shape)
    jargs = {k: mx.nd.array(v) for k, v in params.items()}
    assert tq.quantizable_weights(tsym, params) == \
        jq.quantizable_weights(jsym, jargs)
    jqsym, jqargs = jq.quantize_symbol(jsym, jargs, dtype=dtype)
    tqsym, tqargs = tq.quantize_symbol(tsym, params, dtype=dtype)
    assert tqsym.tojson() == jqsym.tojson()
    assert sorted(tqargs) == sorted(jqargs)
    for k, v in jqargs.items():
        if k.endswith(("_q", "_scale")):
            assert _bytes(tqargs[k].astorch()) == \
                _bytes(np.asarray(v.asjax())), k
    # the narrow variables bind narrow cells in the port's executor
    mod = mxt.mod.Module(tqsym, context=CPU)
    mod.bind([("data", shape)], [("softmax_label", (shape[0],))],
             for_training=False)
    want = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}[dtype]
    cells = mod._exec_group.executor.arg_dict
    assert all(cells[n].astorch().dtype == want
               for n in cells if n.endswith("_q"))


def test_quantize_symbol_rejects_unquantizable():
    out = mxt.sym.Activation(mxt.sym.var("data"), act_type="relu")
    with pytest.raises(MXNetError, match="no quantizable"):
        tq.quantize_symbol(mxt.sym.SoftmaxOutput(out), {})


def _quantized(n, k, dtype, seed=0):
    w = np.random.RandomState(seed).randn(n, k).astype(np.float32)
    return jq.quantize_per_channel(w, dtype=dtype)


@pytest.mark.parametrize("dtype", ["int8", "fp8"])
@pytest.mark.parametrize("m,k,n", [(8, 64, 32), (5, 13, 7), (1, 1, 1),
                                   (3, 300, 100)])
def test_qfc_matmul_plain_matches_pallas_and_composition(m, k, n, dtype):
    x = np.random.RandomState(1).randn(m, k).astype(np.float32)
    q, s = _quantized(n, k, dtype)
    pallas = jq._pl_qfc_matmul(jnp.asarray(x), jnp.asarray(q),
                               jnp.asarray(s))
    attrs = {"num_hidden": n, "no_bias": True}
    comp = jq._qfc_xla(attrs, jnp.asarray(x), jnp.asarray(q),
                       jnp.asarray(s))
    got = ck.qfc_matmul_plain(_t(x), _t(q), _t(s))
    _close(pallas, got)
    _close(comp, got)
    _close(ck.qfc_matmul(_t(x), _t(q), _t(s)), got, 0)   # CPU: the plain


@pytest.mark.parametrize("dtype", ["int8", "fp8"])
@pytest.mark.parametrize("o,c,kh", [(8, 4, 3), (6, 3, 1), (16, 5, 7)])
def test_dequant_rows_plain_is_the_pallas_dequant(monkeypatch, o, c, kh,
                                                  dtype):
    """The float32 weight that ``_qconv_pallas_variant``'s Pallas pass
    hands its convolution equals ``dequant_rows_plain`` bit for bit."""
    from mxnet_tpu.ops import nn as jnn
    q, s = _quantized(o, c * kh * kh, dtype, seed=2)
    q = q.reshape(o, c, kh, kh)
    seen = []
    real = jnn._convolution

    def spy(attrs, data, weight, bias=None):
        seen.append(np.asarray(weight))
        return real(attrs, data, weight, bias)
    monkeypatch.setattr(jnn, "_convolution", spy)
    attrs = mx.ops.registry.get_op("QuantizedConvolution").normalize_attrs(
        {"kernel": (kh, kh), "num_filter": o, "no_bias": True})
    data = np.random.RandomState(3).rand(1, c, 9, 9).astype(np.float32)
    jq._qconv_pallas_variant(attrs, [jnp.asarray(data), jnp.asarray(q),
                                     jnp.asarray(s)], [], False, None)
    got = ck.dequant_rows_plain(_t(q).reshape(o, -1), _t(s))
    assert _bytes(got) == _bytes(seen[0].reshape(o, -1))
    assert _bytes(ck.dequant_rows(_t(q).reshape(o, -1), _t(s))) == \
        _bytes(got)


def _op_cases(dtype):
    rs = np.random.RandomState(4)
    qf, sf = _quantized(7, 12, dtype, seed=5)
    qc, sc = _quantized(8, 4 * 9, dtype, seed=6)
    return [
        ("QuantizedFullyConnected", {"num_hidden": 7},
         [rs.randn(5, 3, 2, 2).astype(np.float32), qf, sf,
          rs.randn(7).astype(np.float32)]),
        ("QuantizedFullyConnected", {"num_hidden": 7, "no_bias": True},
         [rs.randn(2, 12).astype(np.float32), qf, sf]),
        ("QuantizedConvolution", {"kernel": (3, 3), "num_filter": 8,
                                  "pad": (1, 1), "stride": (2, 2)},
         [rs.randn(2, 4, 9, 9).astype(np.float32),
          qc.reshape(8, 4, 3, 3), sc, rs.randn(8).astype(np.float32)]),
    ]


@pytest.mark.parametrize("dtype", ["int8", "fp8"])
def test_quantized_ops_match_jax_through_registry(jax_tier, dtype):
    from mxnet_tpu.ops.registry import get_op as jax_op
    for name, kw, ins in _op_cases(dtype):
        ref = getattr(mx.nd, name)(*[mx.nd.array(a) for a in ins], **kw)
        plain = getattr(mxt.nd, name)(*[mxt.nd.array(a, ctx=CPU)
                                        if a.dtype.name != "float8_e4m3fn"
                                        else mxt.nd.NDArray(_t(a))
                                        for a in ins], **kw)
        op = mxt.ops.get_op(name)
        (cuda_fn_out,), _ = op.variants["cuda"]["fn"](
            op.normalize_attrs(kw), [_t(a) for a in ins], [], False, None)
        _close(ref.asnumpy(), plain.asnumpy())
        _close(ref.asnumpy(), cuda_fn_out.numpy())
        assert jax_op(name).infer_shape is not None


def _bottleneck(lib):
    return lib.resnet(units=[1, 1, 1, 1], num_stages=4,
                      filter_list=[64, 256, 512, 1024, 2048],
                      num_classes=10, image_shape=[3, 40, 40],
                      bottle_neck=True)


@pytest.mark.parametrize("dtype", ["int8", "fp8"])
def test_quantized_bottleneck_resnet_forward_matches_jax(dtype):
    X = np.random.RandomState(0).rand(2, 3, 40, 40).astype(np.float32)
    with mx.name.NameManager():
        jsym = _bottleneck(jresnet)
    with mxt.name.NameManager():
        tsym = _bottleneck(tresnet)
    jmod = mx.mod.Module(jsym, context=mx.cpu())
    jmod.bind([("data", X.shape)], [("softmax_label", (2,))],
              for_training=False)
    jmod.init_params(mx.initializer.Xavier())
    jargs, jauxs = jmod.get_params()
    rs = np.random.RandomState(1)
    auxs = {k: (np.abs(v.asnumpy()) + 0.1 * np.abs(rs.randn(*v.shape)))
            .astype(np.float32) for k, v in jauxs.items()}
    args = {k: v.asnumpy() for k, v in jargs.items()}

    jqsym, jqargs = jq.quantize_symbol(jsym, jargs, dtype=dtype)
    jq_mod = mx.mod.Module(jqsym, context=mx.cpu())
    jq_mod.bind([("data", X.shape)], [("softmax_label", (2,))],
                for_training=False)
    jq_mod.init_params(initializer=None, arg_params=jqargs,
                       aux_params={k: mx.nd.array(v)
                                   for k, v in auxs.items()})
    jq_mod.forward(mx.io.DataBatch([mx.nd.array(X)], []), is_train=False)

    tqsym, tqargs = tq.quantize_symbol(tsym, args, dtype=dtype)
    assert tqsym.tojson() == jqsym.tojson()
    tq_mod = mxt.mod.Module(tqsym, context=CPU)
    tq_mod.bind([("data", X.shape)], [("softmax_label", (2,))],
                for_training=False)
    tq_mod.init_params(arg_params=tqargs, aux_params=auxs)
    tq_mod.forward(mxt.io.DataBatch([X], None), is_train=False)
    _close(jq_mod.get_outputs()[0].asnumpy(),
           tq_mod.get_outputs()[0].asnumpy())


def test_params_from_numpy_carries_fp8_bytes():
    q, s = _quantized(3, 5, "fp8")
    got = mxt.convert.params_from_numpy({"w_q": q, "w_scale": s,
                                         "i": q.view(np.int8)}, CPU)
    assert got["w_q"].astorch().dtype == torch.float8_e4m3fn
    assert _bytes(got["w_q"].astorch()) == _bytes(q)
    assert got["i"].astorch().dtype == torch.int8
    assert _bytes(got["w_scale"].astorch()) == _bytes(s)


def test_quant_wrappers_on_cpu_count_nothing():
    """A CPU tensor runs the plain version and launches no kernel."""
    ck.reset_launch_counts()
    q, s = _quantized(4, 8, "int8")
    ck.qfc_matmul(torch.ones(2, 8), _t(q), _t(s))
    ck.dequant_rows(_t(q), _t(s))
    assert ck.launch_counts()["qfc_matmul"] == 0
    assert ck.launch_counts()["dequant_rows"] == 0


# ------------------------------------- quantized graphs under compute_dtype
#: compute dtype -> (torch dtype, jax dtype, mantissa bits)
HALF = {"bfloat16": (torch.bfloat16, jnp.bfloat16, 7),
        "float16": (torch.float16, jnp.float16, 10)}


def _half_ulps(a, b, bits):
    """Largest |a - b| in ulps of a type with ``bits`` mantissa bits at
    the larger magnitude (at least 2^-14's)."""
    a, b = (np.asarray(x, np.float64) for x in (a, b))
    mag = np.maximum(np.maximum(np.abs(a), np.abs(b)), 2.0 ** -14)
    return float((np.abs(a - b) / 2.0 ** (np.floor(np.log2(mag)) -
                                          bits)).max())


@pytest.mark.parametrize("half", list(HALF))
@pytest.mark.parametrize("dtype", ["int8", "fp8"])
@pytest.mark.parametrize("m,k,n", [(8, 64, 32), (5, 13, 7), (3, 300, 100)])
def test_qfc_matmul_plain_half_matches_pallas(m, k, n, dtype, half):
    """Row 16's 16-bit instances: x read in bfloat16 or float16 (widened
    exactly), the product summed in float32 and returned float32, as the
    Pallas kernel's output is float32 whatever x's type."""
    tdt, jdt, _ = HALF[half]
    x = np.random.RandomState(1).randn(m, k).astype(np.float32)
    q, s = _quantized(n, k, dtype)
    jx = jnp.asarray(x).astype(jdt)
    pallas = jq._pl_qfc_matmul(jx, jnp.asarray(q), jnp.asarray(s))
    assert pallas.dtype == jnp.float32
    tx = _t(x).to(tdt)
    got = ck.qfc_matmul_plain(tx, _t(q), _t(s))
    assert got.dtype == torch.float32
    _close(pallas, got)
    assert torch.equal(ck.qfc_matmul(tx, _t(q), _t(s)), got)   # CPU: plain


@pytest.mark.parametrize("half", list(HALF))
def test_quantized_ops_half_match_jax_pallas_variants(half):
    """Both quantized ops on 16-bit data, scale and bias (as the executor
    hands them under compute_dtype) through the JAX package's Pallas
    variants and the port's plain forward and ``"cuda"`` variant on CPU
    tensors: outputs in the data's type. The dense op within one ulp of
    each value (float32 sums in another order, then one rounding); the
    convolution, which both run in the data's type through their
    library, within two ulps of the output's largest magnitude (the
    libraries accumulate in their own orders, and the JAX package rounds
    the convolution before it adds the bias)."""
    from mxnet_tpu.ops.registry import get_op as jax_op
    tdt, jdt, bits = HALF[half]
    for name, kw, ins in _op_cases("int8"):
        jop, top = jax_op(name), mxt.ops.get_op(name)
        jins = [jnp.asarray(a).astype(jdt) if a.dtype == np.float32
                else jnp.asarray(a) for a in ins]
        tins = [_t(a).to(tdt) if a.dtype == np.float32 else _t(a)
                for a in ins]
        (ref,), _ = jop.variants["pallas"]["fn"](jop.normalize_attrs(kw),
                                                 jins, [], False, None)
        tattrs = top.normalize_attrs(kw)
        (plain,), _ = top.forward(tattrs, tins, [], False, None)
        (cuda_fn_out,), _ = top.variants["cuda"]["fn"](tattrs, tins, [],
                                                       False, None)
        assert ref.dtype == jdt
        want = np.asarray(ref.astype(jnp.float32))
        for got in (plain, cuda_fn_out):
            assert got.dtype == tdt, name
            if name == "QuantizedFullyConnected":
                assert _half_ulps(want, got.float().numpy(), bits) <= 1
            else:
                ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - bits)
                assert np.abs(want - got.float().numpy()).max() <= 2 * ulp


@pytest.mark.parametrize("half", list(HALF))
@pytest.mark.parametrize("dtype", ["int8", "fp8"])
def test_quantized_module_under_compute_dtype_matches_jax(jax_tier, dtype,
                                                          half):
    """``Module(quantize_symbol(...), compute_dtype=...)``, the route to
    row 16's 16-bit instances: the convnet's probabilities in the compute
    dtype, within a few of its ulps (2.56 at 1, as ``test_torch_bf16.py``
    holds a ResNet) of the JAX package's in both of its tiers. An fp8
    weight is widened to the compute dtype by both executors (exactly)."""
    tdt, jdt, bits = HALF[half]
    shape = (4, 3, 8, 8)
    X = np.random.RandomState(2).rand(*shape).astype(np.float32)
    outs = []
    for lib, sym_lib, qmod, ctx, cd in (
            (mx, mx, jq, mx.cpu(), jdt), (mxt, mxt, tq, CPU, half)):
        sym = _convnet_symbol(sym_lib)
        params = _params(sym, shape)
        qsym, qargs = qmod.quantize_symbol(
            sym, {k: lib.nd.array(v) for k, v in params.items()}
            if lib is mx else params, dtype=dtype)
        mod = lib.mod.Module(qsym, context=ctx, compute_dtype=cd)
        mod.bind([("data", shape)], [("softmax_label", (4,))],
                 for_training=False)
        mod.init_params(initializer=None, arg_params=qargs, aux_params={},
                        allow_missing=False)
        mod.forward(lib.io.DataBatch([mx.nd.array(X) if lib is mx else X],
                                     []), is_train=False)
        out = mod.get_outputs()[0]
        outs.append(np.asarray(out.asnumpy(), np.float32))
        if lib is mxt:
            assert out.astorch().dtype == tdt
    np.testing.assert_allclose(outs[1], outs[0], atol=2.56 * 2.0 ** -bits)
    assert outs[1].argmax(1).tolist() == outs[0].argmax(1).tolist()
