"""The image classifiers AlexNet, VGG, Inception-BN and Inception-v3, and
the transformer LM with Dropout, against the JAX package on the CPU.

* each ``get_symbol`` gives the JAX package's symbol JSON byte for byte
  (VGG at 11 to 19 layers, with and without BatchNorm) and the same node
  list, in the order both executors index it;
* each net's inference forward, from the same parameters carried across
  with ``convert.params_from_numpy``, at the smallest input it takes
  (Inception-v3 needs 299 for its final 8 x 8 pool), within 1e-5 of the
  largest probability;
* the average ``Pooling`` with ``pad`` (counted in the divisor) and with
  ``global_pool``, as Inception uses both, forward within 1e-6 and
  gradient within 1e-6;
* two ``Module.fit`` steps of AlexNet and VGG-11, Dropout included, after
  the same ``mx.random.seed``: the port draws the JAX package's masks, and
  the parameters agree within 1e-6 (the two frameworks sum convolutions
  and matmuls in other orders);
* two fitted batches of the transformer LM with ``dropout=0.1`` (2
  layers, d_model 32, T 8) within 2e-5 of the JAX package's;
* the cost table of each net equals the JAX package's op for op, so
  ``mfu.model`` covers them.
"""
from __future__ import annotations

import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu.models import alexnet as jalex, vgg as jvgg, \
    inception_bn as jibn, inception_v3 as jiv3, transformer as jtfm
from mxnet_tpu.telemetry import mfu as jmfu

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.models import alexnet as talex, vgg as tvgg, \
    inception_bn as tibn, inception_v3 as tiv3, transformer as ttfm
from mxnet_tpu_torch.telemetry import mfu as tmfu

CPU = mxt.cpu()
#: net -> (JAX module, port module, get_symbol kwargs, smallest input side)
NETS = {"alexnet": (jalex, talex, {}, 67),
        "vgg16": (jvgg, tvgg, {"num_layers": 16}, 32),
        "inception_bn": (jibn, tibn, {}, 32),
        "inception_v3": (jiv3, tiv3, {}, 299)}
FIT_TOL = 1e-6
SGD = {"learning_rate": 0.01, "momentum": 0.9, "wd": 1e-4}


def _params(sym, shapes, seed=0):
    """numpy parameters for ``sym``: weights ~ N(0, 1 / fan-in), gamma
    near 1, moving variances near 1."""
    args, _, auxs = sym.infer_shape(**shapes)
    rs = np.random.RandomState(seed)
    arg = {n: (rs.randn(*s) / np.sqrt(max(1, np.prod(s[1:]))) +
               n.endswith("gamma")).astype("f")
           for n, s in zip(sym.list_arguments(), args) if n not in shapes}
    aux = {n: (0.1 * np.abs(rs.randn(*s)) + n.endswith("var")).astype("f")
           for n, s in zip(sym.list_auxiliary_states(), auxs)}
    return arg, aux


@pytest.mark.parametrize("net,kw", [
    ("alexnet", {}), ("vgg", {"num_layers": 11}), ("vgg", {"num_layers": 13}),
    ("vgg", {"num_layers": 16}), ("vgg", {"num_layers": 19}),
    ("vgg", {"num_layers": 16, "batch_norm": True}), ("inception_bn", {}),
    ("inception_v3", {})])
def test_symbol_json_equals_jax(net, kw):
    jm = {"alexnet": jalex, "vgg": jvgg, "inception_bn": jibn,
          "inception_v3": jiv3}[net]
    tm = {"alexnet": talex, "vgg": tvgg, "inception_bn": tibn,
          "inception_v3": tiv3}[net]
    with mx.name.NameManager():
        jsym = jm.get_symbol(num_classes=1000, **kw)
    with mxt.name.NameManager():
        tsym = tm.get_symbol(num_classes=1000, **kw)
    assert tsym.tojson() == jsym.tojson()
    # the node list the executors enumerate (a Dropout's key folds in its
    # index there) is the same, variables included
    assert [n.name for n in tsym._topo_nodes()] == \
        [n.name for n in jsym._topo_nodes()]


@pytest.mark.parametrize("name", list(NETS))
def test_inference_forward_matches_jax(name):
    jm, tm, kw, side = NETS[name]
    shapes = {"data": (1, 3, side, side), "softmax_label": (1,)}
    js, ts = jm.get_symbol(num_classes=10, **kw), \
        tm.get_symbol(num_classes=10, **kw)
    arg, aux = _params(js, shapes)
    X = np.random.RandomState(1).rand(1, 3, side, side).astype("f")
    je = js.simple_bind(mx.cpu(), grad_req="null", **shapes)
    te = ts.simple_bind(CPU, grad_req="null", **shapes)
    for k, v in arg.items():
        je.arg_dict[k][:] = v
    for k, v in aux.items():
        je.aux_dict[k][:] = v
    for cells, params in ((te.arg_dict, arg), (te.aux_dict, aux)):
        for k, v in mxt.convert.params_from_numpy(params, CPU).items():
            cells[k][:] = v
    want = je.forward(is_train=False, data=X)[0].asnumpy()
    got = te.forward(is_train=False, data=X)[0].asnumpy()
    assert got.shape == (1, 10) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("attrs", [
    {"kernel": (3, 3), "stride": (1, 1), "pad": (1, 1), "pool_type": "avg"},
    {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1), "pool_type": "max"},
    {"kernel": (7, 7), "global_pool": True, "pool_type": "avg"},
    {"kernel": (8, 8), "stride": (1, 1), "pool_type": "avg"},
], ids=["avg_pad", "max_pad_stride", "global_avg", "avg_8x8"])
def test_pooling_inception_uses_matches_jax(attrs):
    x = np.random.RandomState(2).randn(2, 3, 8, 8).astype("f")
    outs, grads = [], []
    for pkg in (mx, mxt):
        exe = pkg.sym.Pooling(pkg.sym.var("data"), **attrs).simple_bind(
            pkg.cpu(), grad_req="write", data=x.shape)
        exe.arg_dict["data"][:] = x
        o = exe.forward(is_train=True)[0]
        ct = np.sin(np.arange(np.prod(o.shape), dtype="f")).reshape(o.shape)
        exe.backward([pkg.nd.array(ct, ctx=pkg.cpu())])
        outs.append(o.asnumpy())
        grads.append(exe.grad_dict["data"].asnumpy())
    np.testing.assert_allclose(outs[1], outs[0], rtol=0, atol=1e-6)
    np.testing.assert_allclose(grads[1], grads[0], rtol=0, atol=1e-6)


def _fit(pkg, sym, arg, aux, it, seed=42, **fit_kw):
    """``sym`` fitted one epoch of ``it`` from the numpy parameters (the
    port's carried across with the converter) after ``mx.random.seed``."""
    pkg.random.seed(seed)
    mod = pkg.mod.Module(sym, context=pkg.cpu())
    if pkg is mx:
        a = {k: mx.nd.array(v) for k, v in arg.items()}
        x = {k: mx.nd.array(v) for k, v in aux.items()}
    else:
        a = mxt.convert.params_from_numpy(arg, CPU)
        x = mxt.convert.params_from_numpy(aux, CPU)
    mod.fit(it, num_epoch=1, arg_params=a, aux_params=x, **fit_kw)
    if pkg is mx:
        mod._sync_params_from_devices()
    return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


@pytest.mark.parametrize("name,side", [("alexnet", 67), ("vgg11", 32)])
def test_two_fit_steps_with_dropout_match_jax(name, side):
    jm, tm, kw = (jalex, talex, {}) if name == "alexnet" else \
        (jvgg, tvgg, {"num_layers": 11})
    shapes = {"data": (2, 3, side, side), "softmax_label": (2,)}
    js, ts = jm.get_symbol(num_classes=10, **kw), \
        tm.get_symbol(num_classes=10, **kw)
    arg, aux = _params(js, shapes)
    rs = np.random.RandomState(1)
    X = rs.rand(4, 3, side, side).astype("f")
    y = rs.randint(0, 10, 4).astype("f")
    want = _fit(mx, js, arg, aux, mx.io.NDArrayIter(X, y, batch_size=2),
                optimizer_params=SGD)
    got = _fit(mxt, ts, arg, aux, mxt.io.NDArrayIter(X, y, batch_size=2),
               optimizer_params=SGD)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=0, atol=FIT_TOL,
                                   err_msg=k)
        assert np.abs(v - arg[k]).max() > 0, k
    # another seed draws other masks: the fit moves elsewhere
    other = _fit(mxt, ts, arg, aux, mxt.io.NDArrayIter(X, y, batch_size=2),
                 seed=43, optimizer_params=SGD)
    assert max(np.abs(other[k] - got[k]).max() for k in got) > 1e-4


def test_transformer_lm_with_dropout_fits_as_jax():
    V, D, L, H, T, B = 64, 32, 2, 4, 8, 4
    js = jtfm.get_symbol(V, D, L, H, T, dropout=0.1)
    ts = ttfm.get_symbol(V, D, L, H, T, dropout=0.1)
    arg, _ = _params(js, {"data": (B, T), "softmax_label": (B * T,)}, 3)
    fit = dict(seed=8, optimizer="sgd",
               optimizer_params={"learning_rate": 0.1, "momentum": 0.9})
    want = _fit(mx, js, arg, {}, jtfm.SyntheticLMIter(V, B, T, 2, seed=5),
                **fit)
    got = _fit(mxt, ts, arg, {}, ttfm.SyntheticLMIter(V, B, T, 2, seed=5),
               **fit)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=2e-5, atol=2e-5,
                                   err_msg=k)
        assert np.abs(v - arg[k]).max() > 0, k


@pytest.mark.parametrize("name", list(NETS))
def test_cost_table_equals_jax(name):
    jm, tm, kw, side = NETS[name]
    shapes = {"data": (32, 3, side, side), "softmax_label": (32,)}
    want = jmfu.cost_table(jm.get_symbol(**kw), shapes)
    got = tmfu.cost_table(tm.get_symbol(**kw), shapes)
    assert got == want
    assert not got["uncovered"]
    assert got["covered_nodes"] == got["compute_nodes"]
