"""A loss written in the tensor ops, trained through ``MakeLoss`` (CPU).

The small LM (V 128, d_model 64, 2 layers, 4 heads, T 16, batch 4) with
its ``SoftmaxOutput`` head replaced by
``MakeLoss(mean(-pick(log_softmax(logits), label)))`` over the logits
from ``get_internals()["lm_logits_output"]``, grouped with
``BlockGrad(softmax(logits))``:

* the head's JSON is the JAX package's node for node;
* one ``Module.fit`` step in each package from the same ``.params``
  bytes ends on the same parameters within 1e-5;
* in the port its gradients equal the ``SoftmaxOutput(normalization=
  "batch")`` head's within 1e-6 of each array's largest magnitude (the
  same function: ``mean`` over the B*T rows is the batch normalization);
* ``MakeLoss`` ignores its head gradient and scales by ``grad_scale``
  under each ``normalization``, as the JAX package's ``custom_vjp``.
"""
import os

import numpy as np
import pytest

import mxnet_tpu as mxj
from mxnet_tpu.models import transformer as jtfm

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.models import transformer as ttfm

V, D, L, H, T, B = 128, 64, 2, 4, 16, 4
SGD = {"learning_rate": 0.1}


def custom_head(pkg, tfm):
    """The LM's logits under the loss written in ops, with the
    probabilities beside it."""
    logits = tfm.get_symbol(V, D, L, H, T).get_internals()["lm_logits_output"]
    label = pkg.sym.var("softmax_label")
    loss = pkg.sym.MakeLoss(pkg.sym.mean(-pkg.sym.pick(
        pkg.sym.log_softmax(logits), label)), name="ce")
    return pkg.sym.Group([loss, pkg.sym.BlockGrad(pkg.sym.softmax(logits),
                                                  name="prob")])


def _quiet(pkg):
    """A metric that reads nothing: the head's two outputs against one
    label would fail the stock metrics' count check in both packages."""
    class Quiet(pkg.metric.EvalMetric):
        def __init__(self):
            super().__init__("quiet")

        def update(self, labels, preds):
            pass
    return Quiet()


@pytest.fixture(scope="module")
def params_file(tmp_path_factory):
    """numpy-seeded parameters saved by the JAX package."""
    sym = jtfm.get_symbol(V, D, L, H, T)
    shapes, _, _ = sym.infer_shape(data=(B, T), softmax_label=(B * T,))
    rs = np.random.RandomState(5)
    params = {n: ((1 + 0.1 * rs.randn(*s)) if n.endswith("gamma")
                  else 0.05 * rs.randn(*s)).astype(np.float32)
              for n, s in zip(sym.list_arguments(), shapes)
              if n not in ("data", "softmax_label")}
    path = os.path.join(tmp_path_factory.mktemp("lm"), "lm.params")
    mxj.nd.save(path, {k: mxj.nd.array(v) for k, v in params.items()})
    return path


def test_custom_head_json_is_the_jax_packages():
    with mxj.name.NameManager():
        js = custom_head(mxj, jtfm).tojson()
    with mxt.name.NameManager():
        ts = custom_head(mxt, ttfm).tojson()
    assert ts == js
    assert mxt.symbol.load_json(js).list_outputs() == ["ce_output",
                                                       "prob_output"]


def _fit_one(pkg, tfm, path, ctx):
    mod = pkg.mod.Module(custom_head(pkg, tfm), context=ctx)
    mod.fit(tfm.SyntheticLMIter(V, B, T, 1, seed=11), num_epoch=1,
            arg_params=pkg.nd.load(path), optimizer="sgd",
            optimizer_params=SGD, eval_metric=_quiet(pkg))
    return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def test_one_fit_step_matches_jax(params_file):
    start = {k: v.asnumpy() for k, v in mxt.nd.load(params_file).items()}
    want = _fit_one(mxj, jtfm, params_file, mxj.cpu())
    got = _fit_one(mxt, ttfm, params_file, mxt.cpu())
    assert sorted(got) == sorted(want) == sorted(start)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)
        assert np.abs(got[k] - start[k]).max() > 0, k


def _grads(sym, params, batch):
    req = {k: "write" if k in params else "null"
           for k in sym.list_arguments()}
    ex = sym.simple_bind(ctx=mxt.cpu(), grad_req=req, data=(B, T),
                         softmax_label=(B * T,),
                         type_dict={"data": np.int32})
    ex.forward(is_train=True, data=batch.data[0],
               softmax_label=batch.label[0],
               **{k: v for k, v in params.items()})
    ex.backward()
    return ex, {k: ex.grad_dict[k].asnumpy() for k in params}


def test_port_gradients_equal_the_softmax_output_heads(params_file):
    params = mxt.nd.load(params_file)
    batch = next(iter(ttfm.SyntheticLMIter(V, B, T, 1, seed=11)))
    ex, got = _grads(custom_head(mxt, ttfm), params, batch)
    ref, want = _grads(ttfm.get_symbol(V, D, L, H, T), params, batch)
    np.testing.assert_allclose(ex.outputs[1].asnumpy(),
                               ref.outputs[0].asnumpy(), rtol=1e-6,
                               atol=1e-7)
    for k in want:
        scale = float(np.abs(want[k]).max())
        assert np.abs(got[k] - want[k]).max() <= 1e-6 * scale, k


@pytest.mark.parametrize("norm,scale", [("null", 1.0), ("batch", 0.25),
                                        ("valid", 1.0 / 12)])
def test_make_loss_gradient_matches_jax(norm, scale):
    x = np.random.RandomState(0).randn(4, 3).astype(np.float32)
    grads = []
    for pkg in (mxj, mxt):
        data = pkg.sym.var("data")
        sym = pkg.sym.MakeLoss(data * 3.0, grad_scale=2.0,
                               normalization=norm)
        ex = sym.simple_bind(ctx=pkg.cpu(), data=x.shape)
        out = ex.forward(is_train=True, data=pkg.nd.array(x, ctx=pkg.cpu()))
        np.testing.assert_allclose(out[0].asnumpy(), 3.0 * x, rtol=1e-6)
        ex.backward([pkg.nd.array(np.full(x.shape, 7.0, np.float32),
                                  ctx=pkg.cpu())])
        grads.append(ex.grad_dict["data"].asnumpy())
    np.testing.assert_allclose(grads[1], grads[0], rtol=1e-6)
    np.testing.assert_allclose(grads[1], np.full(x.shape, 6.0 * scale),
                               rtol=1e-6)
