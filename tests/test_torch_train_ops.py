"""Forward AND backward of the training path's ops: the PyTorch port's
registry against ``jax.vjp`` of the JAX package's, on the same
numpy-seeded inputs and head cotangents (CPU, plain versions).

Covers Convolution (stride, pad, no_bias), Pooling (max with ties after a
ReLU, padding, the ``full`` convention, global avg, sum), Activation,
Flatten, FullyConnected and elementwise add, BatchNorm in training and
inference (moving statistics after the step; gamma's zero gradient under
``fix_gamma``) and SoftmaxOutput, plus the optimizer ops' in-place
contract through ``mx.nd``. Tolerance: float32 2e-5 on outputs, 1e-4 on
gradients (each framework sums a convolution's or a normalization's
backward in its own order).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from mxnet_tpu.ops.registry import get_op as jax_op

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.ops.registry import get_op as torch_op

TOL, GRAD_TOL = 2e-5, 1e-4


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), atol=tol,
                               rtol=tol)


def _fwd_bwd(name, kwargs, inputs, aux=(), is_train=True, seed=0):
    """Both registries' forward of ``name`` and the gradient of every
    input under a random cotangent of output 0. Returns ((jax out, jax
    new aux, jax grads), (torch ...)) as numpy."""
    jop, top = jax_op(name), torch_op(name)
    jattrs, tattrs = jop.normalize_attrs(kwargs), top.normalize_attrs(kwargs)

    def f(*xs):
        outs, new_aux = jop.forward(jattrs, list(xs),
                                    [jnp.asarray(a) for a in aux],
                                    is_train, None)
        return outs[0], new_aux
    j_out, vjp, j_aux = jax.vjp(f, *[jnp.asarray(x) for x in inputs],
                                has_aux=True)
    cot = np.random.RandomState(seed + 100).randn(*j_out.shape).astype(
        np.float32)
    j_grads = vjp(jnp.asarray(cot))

    leaves = [torch.tensor(x, requires_grad=True) for x in inputs]
    t_outs, t_aux = top.forward(tattrs, leaves,
                                [torch.tensor(a) for a in aux], is_train,
                                None)
    t_outs[0].backward(torch.tensor(cot))
    t_grads = [torch.zeros_like(x) if x.grad is None else x.grad
               for x in leaves]
    return ((np.asarray(j_out), [np.asarray(a) for a in j_aux],
             [np.asarray(g) for g in j_grads]),
            (t_outs[0].detach().numpy(),
             [a.detach().numpy() for a in t_aux],
             [g.numpy() for g in t_grads]))


def _assert_same(name, kwargs, inputs, aux=(), is_train=True):
    (jo, ja, jg), (to, ta, tg) = _fwd_bwd(name, kwargs, inputs, aux,
                                          is_train)
    assert jo.shape == to.shape, (jo.shape, to.shape)
    _close(jo, to, TOL)
    assert len(ja) == len(ta)
    for a, b in zip(ja, ta):
        _close(a, b, TOL)
    for a, b in zip(jg, tg):
        _close(a, b, GRAD_TOL)
    return tg


RS = np.random.RandomState(0)


def _rand(*shape):
    return RS.randn(*shape).astype(np.float32)


# ------------------------------------------------------------ Convolution
@pytest.mark.parametrize("kwargs", [
    {"kernel": (3, 3), "num_filter": 4, "stride": (2, 2), "pad": (1, 1)},
    {"kernel": (1, 1), "num_filter": 5, "no_bias": True},
    {"kernel": (7, 7), "num_filter": 2, "stride": (2, 2), "pad": (3, 3),
     "no_bias": True},
    {"kernel": (3, 3), "num_filter": 6, "num_group": 3, "dilate": (2, 2)},
])
def test_convolution(kwargs):
    x = _rand(2, 3 if kwargs.get("num_group", 1) == 1 else 6, 9, 9)
    cin = x.shape[1] // kwargs.get("num_group", 1)
    w = _rand(kwargs["num_filter"], cin, *kwargs["kernel"])
    ins = [x, w] if kwargs.get("no_bias") else \
        [x, w, _rand(kwargs["num_filter"])]
    _assert_same("Convolution", kwargs, ins)


# ---------------------------------------------------------------- Pooling
@pytest.mark.parametrize("kwargs", [
    {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1), "pool_type": "max"},
    {"kernel": (2, 2), "stride": (2, 2), "pool_type": "max"},
    {"kernel": (3, 3), "stride": (2, 2), "pool_type": "max",
     "pooling_convention": "full"},
    {"kernel": (3, 3), "stride": (2, 2), "pad": (2, 2), "pool_type": "max"},
    {"kernel": (2, 2), "stride": (2, 2), "pad": (1, 1), "pool_type": "avg"},
    {"kernel": (3, 3), "stride": (2, 2), "pool_type": "avg",
     "pooling_convention": "full"},
    {"kernel": (7, 7), "global_pool": True, "pool_type": "avg"},
    {"kernel": (2, 2), "stride": (1, 1), "pool_type": "sum"},
])
def test_pooling_after_relu(kwargs):
    """After a ReLU most windows hold tied zeros: the gradient goes to
    the first maximum in both frameworks."""
    x = np.maximum(_rand(2, 3, 8, 8), 0)
    _assert_same("Pooling", kwargs, [x])


# ------------------------------------------------------------- Activation
@pytest.mark.parametrize("act", ["relu", "sigmoid", "tanh", "softrelu",
                                 "softsign"])
def test_activation(act):
    x = _rand(3, 4, 5)
    x[0, 0, :3] = 0.0          # relu's tie: half the gradient, as jnp
    _assert_same("Activation", {"act_type": act}, [x])


# ----------------------------------------- Flatten, FullyConnected, add
def test_flatten():
    _assert_same("Flatten", {}, [_rand(2, 3, 2, 2)])


@pytest.mark.parametrize("no_bias", [False, True])
def test_fully_connected(no_bias):
    x, w = _rand(4, 2, 3, 2), _rand(5, 12)
    ins = [x, w] if no_bias else [x, w, _rand(5)]
    _assert_same("FullyConnected", {"num_hidden": 5, "no_bias": no_bias},
                 ins)


def test_plus():
    _assert_same("_plus", {}, [_rand(2, 3, 4, 4), _rand(2, 3, 4, 4)])


# -------------------------------------------------------------- BatchNorm
def _bn_inputs():
    x = (3 * _rand(4, 3, 5, 5) + 1).astype(np.float32)
    gamma = (1 + 0.2 * _rand(3)).astype(np.float32)
    beta = _rand(3)
    aux = [_rand(3), (1 + np.abs(_rand(3))).astype(np.float32)]
    return [x, gamma, beta], aux


@pytest.mark.parametrize("fix_gamma", [False, True])
def test_batchnorm_train_moves_stats_by_biased_variance(fix_gamma):
    ins, aux = _bn_inputs()
    kw = {"fix_gamma": fix_gamma, "eps": 2e-5, "momentum": 0.9}
    tg = _assert_same("BatchNorm", kw, ins, aux, is_train=True)
    if fix_gamma:
        assert not np.any(tg[1])             # gamma's gradient is 0
    # the moving variance moves toward the BIASED batch variance
    _, t_aux = torch_op("BatchNorm").forward(
        torch_op("BatchNorm").normalize_attrs(kw),
        [torch.tensor(x) for x in ins], [torch.tensor(a) for a in aux],
        True, None)
    var = ins[0].var(axis=(0, 2, 3))
    _close(0.9 * aux[1] + 0.1 * var, t_aux[1].numpy(), TOL)


@pytest.mark.parametrize("kw", [{"fix_gamma": False},
                                {"use_global_stats": True,
                                 "fix_gamma": False}])
def test_batchnorm_inference_and_global_stats(kw):
    ins, aux = _bn_inputs()
    _assert_same("BatchNorm", kw, ins, aux, is_train=False)
    _assert_same("BatchNorm", kw, ins, aux, is_train=True)


def test_batchnorm_mean_var_outputs():
    ins, aux = _bn_inputs()
    attrs = {"output_mean_var": True, "fix_gamma": False}
    jop, top = jax_op("BatchNorm"), torch_op("BatchNorm")
    j, _ = jop.forward(jop.normalize_attrs(attrs),
                       [jnp.asarray(x) for x in ins],
                       [jnp.asarray(a) for a in aux], True, None)
    t, _ = top.forward(top.normalize_attrs(attrs),
                       [torch.tensor(x) for x in ins],
                       [torch.tensor(a) for a in aux], True, None)
    assert len(j) == len(t) == 3
    for a, b in zip(j, t):
        _close(a, b.numpy(), TOL)


# ---------------------------------------------------------- SoftmaxOutput
@pytest.mark.parametrize("kwargs", [{}, {"normalization": "batch"},
                                    {"use_ignore": True,
                                     "normalization": "valid"}])
def test_softmax_output_nd_data(kwargs):
    """4-D data without multi_output: softmax over all but the batch
    axis; the backward ignores the head cotangent."""
    x = _rand(3, 2, 2, 2)
    label = np.asarray([1, -1, 7], np.float32)
    _assert_same("SoftmaxOutput", kwargs, [x, label])


def test_softmax_output_multi_output_plain():
    x = _rand(2, 4, 3)
    label = np.asarray([[0, 1, 3], [2, -1, 0]], np.float32)
    _assert_same("SoftmaxOutput", {"multi_output": True, "use_ignore": True,
                                   "normalization": "valid"}, [x, label])


# ---------------------------------------------------- optimizer op surface
def test_update_ops_write_their_mutated_inputs():
    """``mx.nd.sgd_mom_update`` / ``adam_update`` write the new weight and
    state into the input handles, as the JAX package's ops do."""
    import mxnet_tpu as mxj
    rs = np.random.RandomState(1)
    w, g, m, v = (rs.randn(6).astype(np.float32) for _ in range(4))
    v = np.abs(v)
    kw = dict(lr=0.1, wd=1e-3, rescale_grad=0.5)
    with mxt.cpu():
        tw, tg, tm, tv = (mxt.nd.array(a) for a in (w, g, m, v))
        mxt.nd.sgd_mom_update(tw, tg, tm, momentum=0.9, **kw)
        mxt.nd.adam_update(tw, tg, tm, tv, **kw)
        mxt.nd.sgd_update(tw, tg, **kw)
    jw, jg, jm, jv = (mxj.nd.array(a) for a in (w, g, m, v))
    mxj.nd.sgd_mom_update(jw, jg, jm, momentum=0.9, **kw)
    mxj.nd.adam_update(jw, jg, jm, jv, **kw)
    mxj.nd.sgd_update(jw, jg, **kw)
    for a, b in ((jw, tw), (jm, tm), (jv, tv)):
        _close(a.asnumpy(), b.asnumpy(), TOL)
